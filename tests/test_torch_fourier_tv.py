"""Port vs JAX package: the rfft blur operator, Parseval sums, the Lipschitz
closed form, the TV norm, the Chambolle prox and the MYULA step.

Same float64 inputs from a numpy seed into both packages; single operations
agree to 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semiblind_tv_tpu.ops import fourier as jf
from semiblind_tv_tpu.ops import lipschitz as jl
from semiblind_tv_tpu.ops import tv as jtv
from semiblind_tv_tpu.samplers import myula as jm
from semiblind_tv_tpu_torch.ops import fourier as tf
from semiblind_tv_tpu_torch.ops import lipschitz as tl
from semiblind_tv_tpu_torch.ops import tv as ttv
from semiblind_tv_tpu_torch.samplers import myula as tm
from tests import oracles

TOL = 1e-12
SHAPES = [(32, 32), (24, 40), (32, 33)]


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=tol, atol=tol)


def _kernel(rng, s=7):
    k = rng.random((s, s))
    return k / k.sum()


@pytest.mark.parametrize("shape", SHAPES)
def test_otf_rfft_matches_jax_and_oracle(shape):
    rng = np.random.default_rng(0)
    k = _kernel(rng)
    jH = jf.otf_rfft(jnp.asarray(k), shape, jf.dft_factors(7, shape, jnp.complex128))
    tH = tf.otf_rfft(torch.from_numpy(k), shape)
    _close(tH.numpy(), jH)
    _close(tH.numpy(), oracles.np_otf(k, shape)[:, : shape[1] // 2 + 1])
    blur = tf.BlurOperator(shape, 7, torch.float64)
    _close(blur.otf_host(torch.from_numpy(k)).numpy(), tH.numpy())
    ks = np.stack([k, _kernel(rng), _kernel(rng)])
    jb = jf.BlurOperator(shape, 7, jnp.float64).otf_batched(jnp.asarray(ks))
    _close(blur.otf_batched(torch.from_numpy(ks)).numpy(), jb)


@pytest.mark.parametrize("shape", SHAPES)
def test_blur_operator_matches_jax(shape):
    rng = np.random.default_rng(1)
    k = _kernel(rng)
    x = rng.standard_normal((2,) + shape) * 50
    jb = jf.BlurOperator(shape, 7, jnp.float64)
    tb = tf.BlurOperator(shape, 7, torch.float64)
    jH = jb.otf(jnp.asarray(k))
    tH = tb.otf(torch.from_numpy(k))
    xt = torch.from_numpy(x)
    _close(tb.rfft(xt).numpy(), jb.rfft(jnp.asarray(x)))
    _close(tb.irfft(tb.rfft(xt)).numpy(), x)
    _close(tb.rfft_host(x).numpy(), np.fft.rfft2(x))
    _close(tb.apply(xt, tH).numpy(), jb.apply(jnp.asarray(x), jH))
    _close(tb.apply_adjoint(xt, tH).numpy(), jb.apply_adjoint(jnp.asarray(x), jH))
    H_full = oracles.np_otf(k, shape)
    _close(tb.apply(xt[0], tH).numpy(), oracles.np_blur(x[0], H_full))
    _close(tb.apply_adjoint(xt[0], tH).numpy(), oracles.np_blur_adj(x[0], H_full))


@pytest.mark.parametrize("shape", SHAPES)
def test_parseval_sums_match_spatial(shape):
    rng = np.random.default_rng(2)
    a, b = rng.standard_normal(shape), rng.standard_normal(shape)
    w = tf.rfft_weights(shape, torch.float64)
    _close(w.numpy(), jf.rfft_weights(shape, jnp.float64))
    ah, bh = torch.fft.rfft2(torch.from_numpy(a)), torch.fft.rfft2(torch.from_numpy(b))
    d = a.size
    np.testing.assert_allclose(float(tf.parseval_dot(ah, bh, w, d)), np.sum(a * b), rtol=1e-10)
    np.testing.assert_allclose(float(tf.parseval_norm_sq(ah, w, d)), np.sum(a * a), rtol=1e-12)
    jw = jf.rfft_weights(shape, jnp.float64)
    np.testing.assert_allclose(
        float(tf.parseval_dot(ah, bh, w, d)),
        float(jf.parseval_dot(jnp.asarray(ah.numpy()), jnp.asarray(bh.numpy()), jw, d)),
        rtol=TOL,
    )


def test_lipschitz_closed_form():
    rng = np.random.default_rng(3)
    H = tf.otf_rfft(torch.from_numpy(_kernel(rng)), (32, 32))
    ev = tl.max_eigenval_closed_form(H)
    np.testing.assert_allclose(
        float(ev), float(jl.max_eigenval_closed_form(jnp.asarray(H.numpy()))), rtol=TOL
    )


@pytest.mark.parametrize("shape", SHAPES)
def test_tv_norm_divergence_gradient(shape):
    rng = np.random.default_rng(4)
    x = rng.standard_normal(shape) * 10
    p1, p2 = rng.standard_normal(shape), rng.standard_normal(shape)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(float(ttv.tv_norm(xt)), oracles.np_tv(x), rtol=TOL)
    np.testing.assert_allclose(float(ttv.tv_norm(xt)), float(jtv.tv_norm(jnp.asarray(x))), rtol=TOL)
    _close(ttv.divergence(torch.from_numpy(p1), torch.from_numpy(p2)).numpy(),
           jtv.divergence(jnp.asarray(p1), jnp.asarray(p2)))
    _close(ttv.divergence(torch.from_numpy(p1), torch.from_numpy(p2)).numpy(),
           oracles._np_div(p1, p2))
    for a, b in zip(ttv.forward_gradient(xt), jtv.forward_gradient(jnp.asarray(x))):
        _close(a.numpy(), b)
    # batched: per-chain TV norms
    xb = np.stack([x, 2 * x])
    _close(ttv.tv_norm(torch.from_numpy(xb)).numpy(), [oracles.np_tv(x), oracles.np_tv(2 * x)])


@pytest.mark.parametrize("scale,lam,max_iter", [
    (10.0, 0.5, 25),     # runs all sweeps
    (1e-5, 0.5, 25),     # stops early
    (1.0, 2.0, 40),
])
def test_chambolle_prox_fresh_matches_jax_and_oracle(scale, lam, max_iter):
    rng = np.random.default_rng(5)
    g = rng.standard_normal((32, 32)) * scale
    f, st = ttv.chambolle_prox(torch.from_numpy(g), lam, max_iter)
    jfx, jst = jtv.chambolle_prox(jnp.asarray(g), lam, max_iter)
    of, opx, opy, ok, oerr = oracles.np_chambolle(g, lam, max_iter)
    _close(f.numpy(), jfx)
    _close(f.numpy(), of)
    _close(st.px.numpy(), opx)
    assert int(st.iters) == int(jst.iters) == ok
    assert (ok < max_iter) == (scale < 1e-3)
    np.testing.assert_allclose(float(st.err), oerr, rtol=1e-10)


def test_chambolle_prox_warm_duals_match_jax_and_oracle():
    rng = np.random.default_rng(6)
    g = rng.standard_normal((24, 40)) * 5
    _, st0 = jtv.chambolle_prox(jnp.asarray(g), 0.3, 10)
    px, py = np.array(st0.px), np.array(st0.py)
    f, st = ttv.chambolle_prox(torch.from_numpy(g), 0.3, 10,
                               duals=(torch.from_numpy(px), torch.from_numpy(py)))
    jfx, jst = jtv.chambolle_prox(jnp.asarray(g), 0.3, 10, duals=(st0.px, st0.py))
    of, opx, opy, ok, _ = oracles.np_chambolle(g, 0.3, 10, duals=(px, py))
    _close(f.numpy(), jfx)
    _close(f.numpy(), of)
    _close(st.px.numpy(), jst.px)
    _close(st.py.numpy(), opy)
    assert int(st.iters) == int(jst.iters) == ok


def test_chambolle_prox_batch_stops_each_chain_on_its_own():
    rng = np.random.default_rng(7)
    gs = np.stack([rng.standard_normal((32, 32)) * s for s in (1e-5, 1e-4, 1e-3, 1.0)])
    f, st = ttv.chambolle_prox(torch.from_numpy(gs), 0.5, 25)
    iters = []
    for i in range(4):
        jfx, jst = jtv.chambolle_prox(jnp.asarray(gs[i]), 0.5, 25)
        _close(f[i].numpy(), jfx)
        assert int(st.iters[i]) == int(jst.iters)
        iters.append(int(jst.iters))
    assert len(set(iters)) > 1  # the chains stop at different sweeps


def test_myula_kernel_step_matches_jax():
    rng = np.random.default_rng(8)
    x, prox, grad, z = (rng.standard_normal((2, 16, 16)) for _ in range(4))
    for positivity in (True, False):
        t = tm.myula_kernel_step(*(torch.from_numpy(a) for a in (x, prox, grad)),
                                 torch.tensor(0.7, dtype=torch.float64), 2.0,
                                 torch.from_numpy(z), positivity)
        j = jm.myula_kernel_step(*(jnp.asarray(a) for a in (x, prox, grad)), 0.7, 2.0,
                                 jnp.asarray(z), positivity)
        _close(t.numpy(), j)
