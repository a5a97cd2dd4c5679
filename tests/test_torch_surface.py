"""The port's surface: it imports neither jax nor the JAX package, its PNG
reader equals PIL on every vendored image, and a CUDA request on a machine
without a card raises instead of running on the CPU."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from semiblind_tv_tpu_torch.utils import images

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE_DIR = os.path.join(ROOT, "data", "images")
PNGS = sorted(f for f in os.listdir(IMAGE_DIR) if f.endswith(".png"))


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import semiblind_tv_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'semiblind_tv_tpu' or k.startswith('semiblind_tv_tpu.'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad or len(mods) < 20 else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_have_no_jax_imports():
    forbidden = re.compile(r"^\s*(from|import)\s+(jax|semiblind_tv_tpu)(\.|\s|$)")
    pkg = os.path.join(ROOT, "semiblind_tv_tpu_torch")
    sources = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs if f.endswith(".py")]
    sources.append(os.path.join(ROOT, "chip_smoke.py"))
    for path in sources:
        with open(path) as fh:
            for line in fh:
                assert not forbidden.match(line), (path, line)


def test_sapg_modules_do_not_import_the_sharded_entries():
    """The SAPG run loop lies below parallel/sapg_parallel.py, which calls it:
    no module under sapg/ imports that module, at its top or in a function."""
    imports = re.compile(r"^\s*(from|import)\s+\S*sapg_parallel\b"
                         r"|^\s*from\s+\S*parallel\s+import\s+.*\bsapg_parallel\b")
    pkg = os.path.join(ROOT, "semiblind_tv_tpu_torch", "sapg")
    sources = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs if f.endswith(".py")]
    assert len(sources) >= 3
    for path in sources:
        with open(path) as fh:
            for line in fh:
                assert not imports.match(line), (path, line)
    assert imports.match("    from semiblind_tv_tpu_torch.parallel.sapg_parallel import x")
    assert imports.match("from semiblind_tv_tpu_torch.parallel import mesh, sapg_parallel")


@pytest.mark.parametrize("name", PNGS)
def test_png_reader_equals_pil(name):
    from PIL import Image

    path = os.path.join(IMAGE_DIR, name)
    ours = images.read_png_gray8(path)
    ref = np.asarray(Image.open(path).convert("L"))
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(images.load_image(name[:-4]), ref.astype(np.float64))


def test_png_reader_refuses_other_formats(tmp_path):
    from PIL import Image

    rgb = tmp_path / "rgb.png"
    Image.new("RGB", (4, 4)).save(rgb)
    with pytest.raises(ValueError):
        images.read_png_gray8(str(rgb))
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png")
    with pytest.raises(ValueError):
        images.load_image(str(bad))   # no fallback to the phantom


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from semiblind_tv_tpu_torch.cli.run_demo import main, resolve_device

    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        main(["--size", "16", "--image", "synthetic", "--samples", "4", "--warmup", "2"])


def test_problem_entry_points_default_to_the_card():
    """build_problem and problem_from_arrays run on the card unless the
    caller asks for the CPU; without a card the default raises."""
    import inspect

    from semiblind_tv_tpu_torch.runtime import problem
    from semiblind_tv_tpu_torch.runtime.config import gaussian_preset

    for fn in (problem.build_problem, problem.problem_from_arrays):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    x = np.zeros((16, 16))
    assert problem.build_problem(x, gaussian_preset(), noise=x, device="cpu").device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            problem.build_problem(x, gaussian_preset(), noise=x)
        with pytest.raises(RuntimeError):
            problem.problem_from_arrays(gaussian_preset(), {})
