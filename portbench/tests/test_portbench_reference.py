"""The reference against the port's plain PyTorch path, on the CPU at a small
size in float64: a few SAPG steps of each configuration (warm-up and main
loop, two chains) and a few SALSA iterations agree to rounding."""
import json
import os

import pytest
import torch

from portbench import compare, inputs, port
from portbench.reference import problem as refproblem
from portbench.reference import salsa as refsalsa
from portbench.reference import sapg as refsapg

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64


def config(name, **budget):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        c = json.load(f)
    c["demo"].update(budget)
    c["sapg_options"].update({k: budget[k] for k in ("samples", "warmup") if k in budget})
    return c


def small_problem(c, seed):
    img = inputs.image(c["image"])[180:220, 150:206]  # 40 x 56: rows and columns differ
    obs = inputs.normal_field(inputs.derive(seed, "observation"), img.shape, "cpu", F64)
    from semiblind_tv_tpu_torch.runtime.problem import build_problem

    prog = build_problem(img, port.demo_config(c), device="cpu", dtype=F64, noise=obs)
    return prog, refproblem.build(img, c["demo"], obs)


@pytest.mark.parametrize("name", ["gaussian-wheel-512", "moffat-wheel-512"])
def test_sapg_steps_agree(name):
    from semiblind_tv_tpu_torch.sapg.estimator import run_sapg

    c = config(name, samples=4, warmup=3, burn_in=3)
    prog, ref = small_problem(c, 7)
    noise = inputs.derive(7, "chains", 0)
    res = run_sapg(prog, n_chains=2, noise=inputs.Draws(noise, "cpu", F64))
    out = refsapg.run(ref, c["demo"], 2, inputs.Draws(noise, "cpu", F64))
    assert 2 <= out["sweeps"] <= 50
    free = [p["name"] for p in c["demo"]["psf_params"] if not p["fix"]]
    assert compare.trace_gap(res.thetas[1:], out["theta"]) < 1e-12
    assert compare.trace_gap(res.sigma2s[1:], out["sigma2"]) < 1e-12
    for n in free:
        assert compare.trace_gap(res.psf_param_traces[n][1:], out[n]) < 1e-12
    assert compare.field_gap(res.X_last, out["X_last"]) < 1e-12


def test_salsa_iterations_agree():
    from semiblind_tv_tpu_torch.solvers.salsa import salsa_tv

    c = config("gaussian-wheel-512")
    prog, ref = small_problem(c, 11)
    theta, demo = 0.0209, c["demo"]
    res = salsa_tv(prog.y, prog.H_true, tau=theta * float(prog.sigma_true) ** 2, mu=0.1 * theta,
                   blur=prog.blur, max_iter=6, tol=0.0, tv_iters=10)
    x, sweeps = refsalsa.solve(ref["y"], ref["H"], theta * ref["sigma"] ** 2, 0.1 * theta, 6, 10,
                               demo["chambolle_tau"], demo["chambolle_tol"])
    assert 1 <= sweeps <= 10
    assert compare.field_gap(res.x, x.numpy()) < 1e-12
