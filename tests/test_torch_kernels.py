"""The kernel modules of the port: ops/tv_cuda.py (kernel A) and
ops/fused_step_cuda.py (kernel B).

On the CPU the wrappers run their plain versions; those are held against
the JAX package's Pallas kernels in interpret mode (as
tests/test_pallas_interpret.py runs them), in float64 at 1e-12.  The CPU
emulation of the resident kernel's schedule (groups of chains, fixed-order
tile partials, the per-chain sum and exit) is held against the whole-image
plain prox, so the schedule's logic is tested off the card.  The kernels
themselves are tested on the card by tests/test_torch_on_card.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semiblind_tv_tpu.ops.fused_step_pallas import myula_prox_tv as j_myula_prox_tv
from semiblind_tv_tpu.ops.tv_pallas import chambolle_prox_pallas
from semiblind_tv_tpu_torch.ops import fused_step_cuda, tv_cuda

TOL = 1e-12
SCALES = (1e-5, 1e-4, 1.0)  # chains stop after 1, a few, and all sweeps


def _batch(shape=(3, 32, 32), seed=0):
    """A smooth field with a little noise, at one scale per chain."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[1], 0:shape[2]]
    base = np.sin(xx / 5.0) + np.cos(yy / 7.0)
    return np.stack([(base + 0.01 * rng.standard_normal(shape[1:])) * s
                     for s in SCALES[: shape[0]]])


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=tol, atol=tol)


@pytest.mark.parametrize("return_state", [True, False])
def test_prox_plain_fresh_matches_pallas_interpret(return_state):
    g = _batch()
    f, st = tv_cuda.chambolle_prox_plain(torch.from_numpy(g), 0.5, 25, return_state=return_state)
    jfx, jst = chambolle_prox_pallas(jnp.asarray(g), 0.5, 25, interpret=True,
                                     return_state=return_state)
    _close(f.numpy(), jfx)
    _close(st.px.numpy(), jst.px)
    _close(st.py.numpy(), jst.py)
    np.testing.assert_array_equal(st.iters.numpy(), np.asarray(jst.iters))
    assert len(set(st.iters.tolist())) == 3  # three different stopping sweeps
    # the Pallas kernel returns err through a float32 slot: float32 precision
    np.testing.assert_allclose(st.err.numpy(), np.asarray(jst.err), rtol=1e-7)


def test_prox_plain_warm_matches_pallas_interpret():
    g = _batch(seed=1)
    rng = np.random.default_rng(2)
    px0, py0 = (rng.standard_normal(g.shape) * 0.1 for _ in range(2))
    f, st = tv_cuda.chambolle_prox_plain(
        torch.from_numpy(g), 0.3, 10, duals=(torch.from_numpy(px0), torch.from_numpy(py0))
    )
    jfx, jst = chambolle_prox_pallas(jnp.asarray(g), 0.3, 10,
                                     duals=(jnp.asarray(px0), jnp.asarray(py0)), interpret=True)
    _close(f.numpy(), jfx)
    _close(st.px.numpy(), jst.px)
    _close(st.py.numpy(), jst.py)
    np.testing.assert_array_equal(st.iters.numpy(), np.asarray(jst.iters))


def test_prox_wrapper_on_cpu_is_the_plain_version():
    g = torch.from_numpy(_batch(seed=3))
    a = tv_cuda.chambolle_prox_cuda(g, 0.5, 25)
    b = tv_cuda.chambolle_prox_plain(g, 0.5, 25)
    _close(a[0].numpy(), b[0].numpy())
    np.testing.assert_array_equal(a[1].iters.numpy(), b[1].iters.numpy())
    f1, st1 = tv_cuda.chambolle_prox_cuda(g[0], 0.5, 25)  # a single image
    assert f1.shape == (32, 32) and st1.iters.shape == ()
    with pytest.raises(ValueError):
        tv_cuda.chambolle_prox_cuda(g, 0.5, 5, duals=(g, g), return_state=False)


def test_dual_ascent_loop_plain_matches_prox():
    g = torch.from_numpy(_batch(seed=4))
    z = torch.zeros_like(g)
    px, py, k, _ = tv_cuda.dual_ascent_loop(g / 0.5, 0.249, 1e-3, 25, z, z)
    f, st = tv_cuda.chambolle_prox_plain(g, 0.5, 25)
    _close((g - 0.5 * tv_cuda.neumann_div(px, py)).numpy(), f.numpy())
    np.testing.assert_array_equal(k.numpy(), st.iters.numpy())


def _step_inputs(seed=5, shape=(3, 32, 32)):
    rng = np.random.default_rng(seed)
    x = rng.random(shape) * 255
    prox = x + rng.standard_normal(shape) * 0.1
    grad = rng.standard_normal(shape) * 0.01
    z = rng.standard_normal(shape)
    return x, prox, grad, z


@pytest.mark.parametrize("positivity", [True, False])
def test_myula_prox_tv_plain_matches_pallas_interpret(positivity):
    x, prox, grad, z = _step_inputs()
    g, lam, lt = 1.9, 2.0, 0.02
    t = fused_step_cuda.myula_prox_tv_plain(
        *(torch.from_numpy(a) for a in (x, prox, grad, z)), g, lam, lt, 25,
        positivity=positivity,
    )
    j = j_myula_prox_tv(*(jnp.asarray(a) for a in (x, prox, grad, z)), g, lam, lt, 25,
                        positivity=positivity, interpret=True)
    _close(t[0].numpy(), j[0])
    _close(t[1].numpy(), j[1])
    np.testing.assert_allclose(t[2].numpy(), np.asarray(j[2]), rtol=1e-10)
    w = fused_step_cuda.myula_prox_tv(*(torch.from_numpy(a) for a in (x, prox, grad, z)),
                                      g, lam, lt, 25, positivity=positivity)
    for a, b in zip(w, t):
        _close(a.numpy(), b.numpy())


def test_wrappers_raise_on_other_devices():
    g = torch.zeros((1, 8, 8), device="meta")
    with pytest.raises(ValueError):
        tv_cuda.chambolle_prox_cuda(g, 0.5, 5)
    with pytest.raises(ValueError):
        fused_step_cuda.myula_prox_tv(g, g, g, g, 1.0, 1.0, 0.1)


# ---------------------------------------------------------------------------
# Emulation of the CUDA launch schedule (csrc/tv_kernels.cu)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 32, 32), (3, 20, 44), (3, 70, 130)])
@pytest.mark.parametrize("warm", [False, True])
def test_launch_schedule_emulation_matches_plain_prox(shape, warm):
    """The resident kernel's schedule (groups of chains, per-tile partials in
    the kernel's order, the per-chain fixed-order sum and the exit) against
    the whole-image plain prox; 70 × 130 is nine tiles a chain."""
    g = torch.from_numpy(_batch(shape, seed=6))
    duals = None
    if warm:
        rng = np.random.default_rng(7)
        duals = tuple(torch.from_numpy(rng.standard_normal(shape) * 1e-6) for _ in range(2))
    # 24 sweeps at most: the chains end on odd (1) and even (24) sweep counts;
    # a capacity of 18 blocks holds two chains of nine tiles, so 70 × 130 runs
    # in two groups
    cap = 18 if shape[1] > 32 else None
    f, st = tv_cuda.chambolle_prox_resident_emulated(g, 0.5, 24, duals=duals, capacity=cap)
    pf, pst = tv_cuda.chambolle_prox_plain(g, 0.5, 24, duals=duals)
    np.testing.assert_array_equal(st.iters.numpy(), pst.iters.numpy())
    assert {1, 24} <= set(st.iters.tolist())
    _close(f.numpy(), pf.numpy())
    _close(st.px.numpy(), pst.px.numpy())
    _close(st.py.numpy(), pst.py.numpy())
    np.testing.assert_allclose(st.err.numpy(), pst.err.numpy(), rtol=1e-12)
