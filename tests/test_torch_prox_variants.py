"""The Chambolle-sweep variant probe (TPU kernel J) of the port:
semiblind_tv_tpu_torch/benchmarks/probe_prox_variants.py against the JAX
package's benchmarks/probe_prox_variants.py.

The JAX side is J's own `make_kernel(mode)` in a `pallas_call` with
`build`'s BlockSpecs, run in interpret mode on the CPU; the JAX file is
loaded by path and not changed.  J's roll and rollmul use `pltpu.roll`
with a negative shift, which interpret mode refuses, so the port's roll
and rollmul are held against JAX's `while` (and against the port's own
`while`, exactly).  On the CPU `prox_variant` runs its plain version; the
kernel is held against that on the card (tests/test_torch_on_card.py).

Inputs: J's uniform [0, 255) field at two shapes, B=2 at 16×24 and B=3 at
33×40 (ragged against the 32×8 tile, chain 0 scaled by 0.25 so that it
stops earlier).  Bounds:
  * f, float32 modes: max|Δf| ≤ 1e-6 of max|f| (sum order and XLA's
    contraction of −upx + tmp·px move the last bits).
  * f, bfloat16 modes: max|Δf| ≤ 1e-2 of the JAX mode's own max|f − f_base|
    on the same inputs at J's λ: XLA's CPU rounds bfloat16 at other places
    than PyTorch (measured ratio ~1e-5).  At λ = 20 one dual rounded to the
    neighbouring bfloat16 value moves f by λ·2^-8 at that pixel, so there
    max|Δf| ≤ 2λ·2^-8 on at most 1% of the pixels.
  * Sweep counts equal at tol=0 and at a decisive tol (λ = 20, tol = 5:
    chains stop after 5–9 sweeps with the residual a few per cent above
    tol and far above round-off), where the last residual agrees to 1e-3
    relative in the float32 modes and 0.15 in the bfloat16 modes.
  * At J's own point (λ = 0.08, tol = 1e-3) the residual after 25 sweeps is
    ruled by round-off (0.00139 in JAX against 0.00194 in the port on one
    chain: summation order), so only f is compared there.
"""
import functools
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from semiblind_tv_tpu_torch.benchmarks import probe_prox_variants as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "jax_probe_prox_variants", os.path.join(ROOT, "benchmarks", "probe_prox_variants.py"))
J = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(J)

SWEEPS = 25
SHAPES = [(2, 16, 24), (3, 33, 40)]
LAM_PROBE = 0.02 * 4.0           # J's λ
LAM_DECISIVE, TOL_DECISIVE = 20.0, 5.0
F32_BOUND, BF16_BOUND = 1e-6, 1e-2
ERR_BOUND = {False: 1e-3, True: 0.15}   # keyed by "bfloat16 mode"
JAX_MODE = {"roll": "while", "rollmul": "while"}

_jitted = {}


def _jax(mode, g, lam, tol):
    """J's kernel for `mode` in interpret mode: (f, meta) as numpy."""
    B, M, N = g.shape
    key = (mode, g.shape)
    if key not in _jitted:
        img = lambda: pl.BlockSpec((1, M, N), lambda i: (i, 0, 0),  # noqa: E731
                                   memory_space=pltpu.VMEM)
        _jitted[key] = jax.jit(lambda g, s: pl.pallas_call(
            functools.partial(J.make_kernel(mode), max_iter=SWEEPS),
            grid=(B,),
            out_shape=(jax.ShapeDtypeStruct((B, M, N), jnp.float32),
                       jax.ShapeDtypeStruct((B, 2), jnp.float32)),
            in_specs=[img(), pl.BlockSpec(memory_space=pltpu.SMEM)],
            out_specs=(img(), pl.BlockSpec(memory_space=pltpu.SMEM)),
            interpret=True,
        )(g, s))
    f, meta = _jitted[key](jnp.asarray(g), jnp.asarray(_scal_np(lam, tol)))
    return np.asarray(f), np.asarray(meta)


def _scal_np(lam, tol):
    return np.array([lam, 0.249, tol], dtype=np.float32)


def _field(shape, seed=0):
    g = (np.random.default_rng(seed).random(shape) * 255.0).astype(np.float32)
    if shape[0] == 3:
        g[0] *= 0.25
    return g


def _port(mode, g, lam, tol):
    f, meta = P.prox_variant(mode, torch.from_numpy(g), torch.from_numpy(_scal_np(lam, tol)),
                             SWEEPS)
    return f.numpy(), meta.numpy()


def _check_f(mode, f, jf, g, lam, tol):
    d = np.abs(f - jf).max()
    if mode not in P.BF16_MODES:
        assert d <= F32_BOUND * np.abs(jf).max(), (mode, d)
    elif lam == LAM_PROBE:
        jbase = _jax("base", g, lam, tol)[0]
        assert d <= BF16_BOUND * np.abs(jf - jbase).max(), (mode, d)
    else:
        # at λ = 20 a dual that XLA and PyTorch round to neighbouring
        # bfloat16 values (one ulp, ≤ 2^-8 for |p| ≤ 1) moves f by λ·2^-8
        # at a few pixels (measured: 4 of 3960, bf16mix)
        assert d <= 2 * lam * 2.0 ** -8, (mode, d)
        assert (np.abs(f - jf) > 0).mean() <= 0.01, mode


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", P.MODES)
def test_mode_matches_jax_at_the_probe_point(mode, shape):
    g = _field(shape)
    for tol in (0.0, 1e-3):
        f, meta = _port(mode, g, LAM_PROBE, tol)
        jf, jmeta = _jax(JAX_MODE.get(mode, mode), g, LAM_PROBE, tol)
        _check_f(mode, f, jf, g, LAM_PROBE, tol)
        assert f.shape == shape and meta.shape == (shape[0], 2) and np.isfinite(f).all()
        if tol == 0.0:
            np.testing.assert_array_equal(meta[:, 0], jmeta[:, 0])
            np.testing.assert_array_equal(meta[:, 0], SWEEPS)
        # tol=1e-3: the last residual is ruled by round-off here; not bounded
        if mode in P.NO_RESIDUAL:
            np.testing.assert_array_equal(meta, [[SWEEPS, 0.0]] * shape[0])
            np.testing.assert_array_equal(jmeta, meta)
        if mode in JAX_MODE:
            wf, wmeta = _port("while", g, LAM_PROBE, tol)
            np.testing.assert_array_equal(f, wf)
            np.testing.assert_array_equal(meta, wmeta)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", P.MODES)
def test_mode_matches_jax_at_a_decisive_tol(mode, shape):
    g = _field(shape)
    f, meta = _port(mode, g, LAM_DECISIVE, TOL_DECISIVE)
    jf, jmeta = _jax(JAX_MODE.get(mode, mode), g, LAM_DECISIVE, TOL_DECISIVE)
    _check_f(mode, f, jf, g, LAM_DECISIVE, TOL_DECISIVE)
    np.testing.assert_array_equal(meta[:, 0], jmeta[:, 0])
    if mode in P.NO_RESIDUAL:
        np.testing.assert_array_equal(meta, [[SWEEPS, 0.0]] * shape[0])
        return
    k = meta[:, 0]
    if mode == "every5":
        # the exit can fire only on a multiple of 5: the first one at or
        # after the sweep where `while` stops
        k_while = _port("while", g, LAM_DECISIVE, TOL_DECISIVE)[1][:, 0]
        np.testing.assert_array_equal(k, [5 * math.ceil(t / 5) for t in k_while])
    else:
        assert ((k >= 2) & (k <= 9)).all(), k
    if shape[0] == 3:
        assert k[0] < k[1] or mode == "every5"
    assert (meta[:, 1] <= TOL_DECISIVE).all()
    rel = np.abs(meta[:, 1] / jmeta[:, 1] - 1.0).max()
    assert rel <= ERR_BOUND[mode in P.BF16_MODES], (mode, rel)


def _j_roll_form(g, lam, tau=0.249, sweeps=SWEEPS):
    """The arithmetic of J's roll mode as written (circular rolls with
    boundary masks), in numpy float64, and f from the concatenate form."""
    M, N = g.shape
    rows, cols = np.mgrid[0:M, 0:N]
    glam = g / lam

    def div(p1, p2):
        u = np.concatenate([p1[:1], p1[1:-1] - p1[:-2], -p1[-1:]], 0)
        v = np.concatenate([p2[:, :1], p2[:, 1:-1] - p2[:, :-2], -p2[:, -1:]], 1)
        return u + v

    px = np.zeros_like(g)
    py = np.zeros_like(g)
    for _ in range(sweeps):
        u = (np.where(rows < M - 1, px, 0) - np.where(rows > 0, np.roll(px, 1, 0), 0)
             + np.where(cols < N - 1, py, 0) - np.where(cols > 0, np.roll(py, 1, 1), 0) - glam)
        upx = np.where(rows < M - 1, np.roll(u, -1, 0) - u, 0)
        upy = np.where(cols < N - 1, np.roll(u, -1, 1) - u, 0)
        rden = 1.0 / (1.0 + tau * np.sqrt(upx * upx + upy * upy))
        px, py = (px + tau * upx) * rden, (py + tau * upy) * rden
    return g - lam * div(px, py)


def test_j_roll_form_takes_the_textbook_last_row():
    """J's roll form divides with −p[M−2] at the last row and column (the
    textbook divergence), not the reference's −p[M−1] that its concatenate
    form and the port keep: the same values at the probe's λ to within
    float32 round-off, not at a larger λ."""
    g = _field((1, 16, 24))[0].astype(np.float64)
    for lam, lo, hi in ((LAM_PROBE, 0.0, 1e-6), (LAM_DECISIVE, 1e-2, np.inf)):
        scal = torch.tensor([lam, 0.249, 0.0], dtype=torch.float64)
        f_while = P.prox_variant_plain("while", torch.from_numpy(g)[None], scal, SWEEPS)[0][0]
        rel = np.abs(_j_roll_form(g, lam) - f_while.numpy()).max() / np.abs(g).max()
        assert lo <= rel <= hi, (lam, rel)


def test_prox_variant_dispatch_and_checks():
    g = torch.from_numpy(_field((2, 16, 24)))
    scal = torch.from_numpy(_scal_np(LAM_PROBE, 1e-3))
    a = P.prox_variant("recip", g, scal, 7)
    b = P.prox_variant_plain("recip", g, scal, 7)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    np.testing.assert_array_equal(a[1][:, 0].numpy(), 7)
    with pytest.raises(ValueError):
        P.prox_variant("fast", g, scal, 5)
    with pytest.raises(ValueError):
        P.prox_variant("base", torch.zeros((1, 4, 4), device="meta"), scal, 5)
    f0, m0 = P.prox_variant("while", g, scal, 0)   # no sweep: zero duals, f = g
    assert torch.equal(f0, g) and m0[:, 0].tolist() == [0.0, 0.0]


def test_probe_inputs_and_main_need_a_card():
    g, scal = P.probe_inputs(2, 8, "cpu")
    assert g.shape == (2, 8, 8) and g.dtype == torch.float32
    assert 0.0 <= float(g.min()) and float(g.max()) < 255.0
    np.testing.assert_array_equal(scal.numpy(), np.float32([0.08, 0.249, 1e-3]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            P.main()
