"""The check that decides `correct`, shown to fail.

On the CPU at 32² and a short budget: `harness.run` past its look for a
card, with the program's timed path broken underneath, comes out not
correct for each fault a cell can have (a step that returns its state
unchanged; half of the chains left out, the mean taken over the rest; an
answer altered where it is produced), and sound runs come out correct.
The control (the reference in TF32 in the program's place) fails every
cell's limits, here and, on the card, at each cell's own size on three
seeds."""
import dataclasses

import numpy as np
import pytest

from portbench import harness, inputs
from portbench.control import control

SAPG = ["gaussian512-b1", "moffat512-b1", "gaussian512-b16"]


@pytest.fixture
def small(monkeypatch):
    import torch

    torch.set_num_threads(1)
    full = inputs.image
    monkeypatch.setattr(inputs, "image", lambda name: full(name)[200:232, 200:232])
    real = harness.cell

    def cell(*args, **kw):
        c = real(*args, **kw)
        c.config["demo"].update(samples=30, warmup=15, burn_in=24)
        c.config["sapg_options"].update(samples=30, warmup=15)
        if "n_chains" in c.traffic:
            c.traffic["n_chains"] = min(c.traffic["n_chains"], 4)
        if "outer_iters" in c.traffic:
            c.traffic["outer_iters"] = 20
        return c

    monkeypatch.setattr(harness, "cell", cell)
    real_manifest = harness.manifest
    monkeypatch.setattr(harness, "manifest",
                        lambda root=harness.ROOT, held=True: real_manifest(root, held=True))


def run(workload, seed=2147483659):
    return harness.run(workload, seed, 0.0, False, device="cpu")


def spatial_patched(monkeypatch, fn):
    from semiblind_tv_tpu_torch.sapg import estimator

    real = estimator.myula_prox_tv_plain
    monkeypatch.setattr(estimator, "myula_prox_tv_plain", lambda *a, **k: fn(real, *a, **k))


@pytest.mark.parametrize("workload", ["gaussian512-b1", "gaussian512-b16", "gaussian512-map"])
def test_sound_runs_are_correct(small, workload):
    assert run(workload)["correct"]


@pytest.mark.parametrize("workload", SAPG)
def test_state_left_unchanged(small, monkeypatch, workload):
    from semiblind_tv_tpu_torch.ops.tv import tv_norm

    spatial_patched(monkeypatch, lambda real, x, prox, *a, **k: (x, prox, tv_norm(x)))
    assert not run(workload)["correct"]


def test_map_steps_left_unchanged(small, monkeypatch):
    from semiblind_tv_tpu_torch.solvers import salsa

    real = salsa.salsa_tv
    monkeypatch.setattr(salsa, "salsa_tv", lambda *a, **k: real(*a, **dict(k, max_iter=0)))
    assert not run("gaussian512-map")["correct"]


def test_half_the_chains_left_out(small, monkeypatch):
    def half(real, x, prox, grad, z, *a, **k):
        h = x.shape[0] // 2
        xn, pn, tv = real(x[:h], prox[:h], grad[:h], z[:h], *a, **k)
        return xn.repeat(2, 1, 1), pn.repeat(2, 1, 1), tv.repeat(2)

    spatial_patched(monkeypatch, half)
    assert not run("gaussian512-b16")["correct"]


def altered(field):
    field = np.array(field)
    field.reshape(-1)[0] += 0.05 * np.max(np.abs(field))
    return field


@pytest.mark.parametrize("workload", SAPG)
def test_an_answer_altered(small, monkeypatch, workload):
    from semiblind_tv_tpu_torch.sapg import estimator

    real = estimator.run_sapg

    def run_sapg(*a, **k):
        res = real(*a, **k)
        return dataclasses.replace(res, X_last=altered(res.X_last))

    monkeypatch.setattr(estimator, "run_sapg", run_sapg)
    assert not run(workload)["correct"]


def test_map_answer_altered(small, monkeypatch):
    from semiblind_tv_tpu_torch.solvers import salsa

    real = salsa.salsa_tv

    def salsa_tv(*a, **k):
        res = real(*a, **k)
        return dataclasses.replace(res, x=altered(res.x))

    monkeypatch.setattr(salsa, "salsa_tv", salsa_tv)
    assert not run("gaussian512-map")["correct"]


@pytest.mark.parametrize("workload", SAPG + ["gaussian512-map"])
def test_control_fails(small, workload):
    c = harness.cell(harness.manifest(held=True), workload, 2147483663, "cpu")
    checks, _, _ = control(c)
    assert not harness.judge(checks, 0), checks


@pytest.mark.card
@pytest.mark.parametrize("workload", SAPG + ["gaussian512-map"])
def test_control_fails_at_the_cells_size(card, workload):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in (2147483701, 2147483703, 2147483707):
        checks, _, _ = control(harness.cell(harness.manifest(held=True), workload, seed, card))
        assert not harness.judge(checks, 0), (seed, checks)
