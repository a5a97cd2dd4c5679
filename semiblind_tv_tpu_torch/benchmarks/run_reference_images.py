"""End-to-end parity sweep over the reference's own test photographs (port
of the JAX package's `benchmarks/run_reference_images.py`).

Runs the port's demo pipeline (observation synthesis → SAPG → SALSA MAP →
metrics, `cli/run_demo.py`) on every grayscale PNG the reference ships
(data/images: barbara, boat, bridge, goldhill, lake, man, mandrill, wheel —
run_Gaussian_demo.m:93-100), writing one results.json per image and a
runStats-style aggregate (`runtime/checkpoint.run_stats`, the reference's
SALSA/runStats.m: MSE and time averaged over a results directory).

    python -m semiblind_tv_tpu_torch.benchmarks.run_reference_images --psf gaussian \\
        --out build/parity_gaussian [--images wheel,boat] [--samples N] [--device cpu]
        [--image-dir DIR]

One process for all images; `--device` defaults to `cuda`.  The default
`--out` lies under the checkout's git-ignored build/.
"""
import argparse
import json
import os

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--psf", choices=["gaussian", "laplace", "moffat"], default="gaussian")
    p.add_argument("--out", default=os.path.join(_ROOT, "build", "parity_images"))
    p.add_argument("--images", default=None, help="comma list; default: all available")
    p.add_argument("--image-dir", default=None,
                   help="a directory of grayscale PNGs searched first (run_demo --image-dir)")
    p.add_argument("--samples", type=int, default=None)
    p.add_argument("--warmup", type=int, default=None)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--chains", type=int, default=1)
    p.add_argument("--no-fix-w", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from semiblind_tv_tpu_torch.cli.run_demo import main as demo_main
    from semiblind_tv_tpu_torch.runtime.checkpoint import run_stats
    from semiblind_tv_tpu_torch.utils.images import available_images

    names = args.images.split(",") if args.images else available_images(args.image_dir)
    if not names:
        raise SystemExit("no images found — set SEMIBLIND_TV_IMAGES")

    os.makedirs(args.out, exist_ok=True)
    per_image = {}
    for name in names:
        out = os.path.join(args.out, name)
        argv2 = ["--psf", args.psf, "--image", name, "--size", str(args.size),
                 "--chains", str(args.chains), "--out", out, "--device", args.device]
        if args.samples is not None:
            argv2 += ["--samples", str(args.samples)]
        if args.warmup is not None:
            argv2 += ["--warmup", str(args.warmup)]
        if args.no_fix_w:
            argv2 += ["--no-fix-w"]
        if args.image_dir is not None:
            argv2 += ["--image-dir", args.image_dir]
        print(f"=== {name} ===", flush=True)
        per_image[name] = demo_main(argv2)

    agg = run_stats(args.out)
    with open(os.path.join(args.out, "aggregate.json"), "w") as f:
        json.dump(agg, f, indent=2)
    print(json.dumps({"aggregate": agg}), flush=True)
    return agg, per_image


if __name__ == "__main__":
    main()
