"""The wavelet-synthesis L1 deblurring experiment's CLI (port of
`semiblind_tv_tpu/cli/run_wavelet_l1.py`).

The reference's SIAM 4.2.3 experiment (`SALSA/run_deblur_synthesis_L1.m`):
uniform 9-px blur, redundant 4-level Haar synthesis representation, L1
prior with SAPG Algorithm-1 θ estimation, SALSA MAP solve with the
Sherman–Morrison LS step.

Usage:
  python -m semiblind_tv_tpu_torch.cli.run_wavelet_l1 --image wheel --size 256 \
      --samples 3000 --levels 4

`--device` defaults to `cuda`; a CUDA request on a machine without a card
raises.  One torch.Generator on the device, seeded with `--seed`, draws the
observation noise and the chain's noise.
"""
from __future__ import annotations

import argparse
import json

import torch

from semiblind_tv_tpu_torch.runtime.problem import resolve_device
from semiblind_tv_tpu_torch.sapg.wavelet_l1 import WaveletL1Config, run_sapg_wavelet_l1
from semiblind_tv_tpu_torch.utils.images import load_image

__all__ = ["main"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--image", default="wheel")
    p.add_argument("--image-dir", default=None)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--samples", type=int, default=3000)
    p.add_argument("--burn-in", type=int, default=20)
    p.add_argument("--levels", type=int, default=4)
    p.add_argument("--filter-order", type=int, default=2,
                   help="daubcqf(N) Daubechies filter length (2 = Haar, the "
                        "reference configuration)")
    p.add_argument("--blur-length", type=int, default=9)
    p.add_argument("--bsnr", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--f64", action="store_true", help="float64 (the device keeps it)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)

    # full-precision fp32 matmuls and convolutions (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = resolve_device(args.device)
    dtype = torch.float64 if args.f64 else torch.float32
    cfg = WaveletL1Config(
        samples=args.samples,
        burn_in=args.burn_in,
        levels=args.levels,
        wavelet_order=args.filter_order,
        blur_length=args.blur_length,
        bsnr=args.bsnr,
    )
    image = load_image(args.image, args.image_dir, size=args.size)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    res = run_sapg_wavelet_l1(image, cfg, gen, dtype=dtype, device=device)
    out = {
        "theta_EB": res.theta_EB,
        "mse_db": res.mse_db,
        "mse_db_observation": res.mse_db_observation,
        "salsa_iters": res.salsa_iters,
        "samples": cfg.samples,
        "levels": cfg.levels,
        "wavelet_order": cfg.wavelet_order,
        "sapg_time_s": res.sapg_time_s,
        "salsa_time_s": res.salsa_time_s,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
