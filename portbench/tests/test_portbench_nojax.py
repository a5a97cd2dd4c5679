"""No benchmark run loads JAX or the JAX package (compared by whole top-level
names: the port's name begins with the JAX package's), the reference
imports nothing of the port, and without a card a run prints no result."""
import ast
import os
import subprocess
import sys

from portbench import harness

PB = os.path.join(harness.ROOT, "portbench")
JAX_SIDE = {"jax", "jaxlib", "flax", "semiblind_tv_tpu"}


def imported_tops(folder):
    tops = set()
    for base, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(base, f)) as fh:
                    tree = ast.parse(fh.read())
                for node in ast.walk(tree):
                    if isinstance(node, ast.Import):
                        tops |= {a.name.split(".")[0] for a in node.names}
                    elif isinstance(node, ast.ImportFrom) and node.level == 0:
                        tops.add(node.module.split(".")[0])
    return tops


def test_forbidden_names_are_whole_top_level_names():
    loaded = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "semiblind_tv_tpu",
              "semiblind_tv_tpu.ops.tv", "semiblind_tv_tpu_torch", "semiblind_tv_tpu_torch.ops",
              "jaxtyping", "flaxen", "numpy"]
    assert harness.forbidden_loaded(loaded) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "semiblind_tv_tpu",
        "semiblind_tv_tpu.ops.tv"]


def test_sources_import_no_jax_and_the_reference_none_of_the_port():
    assert not imported_tops(PB) & JAX_SIDE
    assert not imported_tops(os.path.join(PB, "reference")) & (JAX_SIDE | {
        "semiblind_tv_tpu_torch"})


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench import harness, inputs\n"
            "full = inputs.image\n"
            "inputs.image = lambda name: full(name)[:24, :24]\n"
            "c = harness.cell(harness.manifest(), 'moffat512-b1', 3, 'cpu')\n"
            "c.config['demo'].update(samples=4, warmup=3, burn_in=3)\n"
            "c.config['sapg_options'].update(samples=4, warmup=3)\n"
            "d = harness.driver(c); d.setup(); d.window(0.0, False); d.release(); d.check()\n"
            "print(harness.forbidden_loaded())\n" % harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=harness.ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_a_run_fails_and_prints_nothing():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "gaussian512-b1",
                          "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=harness.ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout == ""
