"""Port vs JAX package: `utils/signals.py`, the circular TV denoisers of
`ops/tv.py` and `ops/spatial_conv.py`, float64 on the CPU, within 1e-12
relative (`calctv`, `monotonize`, `sparse_pws` and `make_rd_squares` with
pinned `corners`/`draws`, `vectorized_operator`, `tv_denoise_circular`,
`projk_denoise`, `circ_conv`/`circ_corr`).

The card test at the end needs a CUDA card and skips without one:
`circ_conv`/`circ_corr` on the card in float32 against the same call on
the CPU within 1e-5 relative, with cuDNN's TF32 left on by the caller (the
functions switch it off for their convolution and restore it).  On a
machine without JAX (the card's) only it runs:

    python -m pytest --noconftest tests/test_torch_signals.py -q -k card
"""
import numpy as np
import pytest
import torch

from semiblind_tv_tpu_torch.ops import psf as tpsf
from semiblind_tv_tpu_torch.ops.fourier import BlurOperator
from semiblind_tv_tpu_torch.ops.spatial_conv import circ_conv, circ_corr
from semiblind_tv_tpu_torch.ops.tv import projk_denoise, tv_denoise_circular
from semiblind_tv_tpu_torch.utils import signals as ts

try:  # the card machine has no JAX: there only the card test runs
    import jax
    import jax.numpy as jnp

    from semiblind_tv_tpu.ops import fourier as jfourier
    from semiblind_tv_tpu.ops import psf as jpsf
    from semiblind_tv_tpu.ops import spatial_conv as jsc
    from semiblind_tv_tpu.ops import tv as jtv
    from semiblind_tv_tpu.utils import signals as js
    from tests import oracles
except ImportError:
    jax = None


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch's CPU FFT of a 32² field takes ~20× longer on eight threads
    than on one (and far longer when the test workers share the cores):
    the module runs on one thread and restores the count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _needs_jax(request):
    if jax is None and "cuda_device" not in request.fixturenames:
        pytest.skip("compares with the JAX package, which is not installed")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------- signals ---------------------------------

def test_calctv_matches_jax():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(13, 9))
    got = ts.calctv(_t(X))
    want = js.calctv(jnp.asarray(X))
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), rel=1e-12)
    assert float(got[0]) == pytest.approx(oracles.np_calctv(X)[0], rel=1e-12)
    flat = X.flatten(order="F")  # MATLAB vectorisation
    for g, w in zip(ts.calctv(_t(flat), shape=X.shape), want):
        assert float(g) == pytest.approx(float(w), rel=1e-12)
    with pytest.raises(ValueError):
        ts.calctv(_t(flat))


def test_monotonize_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=50).cumsum() + rng.normal(size=50)
    y = ts.monotonize(_t(x)).numpy()
    assert _rel(y, js.monotonize(jnp.asarray(x))) <= 1e-12
    assert np.all(np.diff(y) >= -1e-12) and y[0] == x[0]


def test_sparse_pws_matches_jax_with_pinned_corners():
    N, L, n = 32, 6, 5
    corners = np.round(np.random.default_rng(3).uniform(size=(L, 2)) * N).astype(int)
    edge = np.array([[0, N], [N, 0], [1, 1]])   # MATLAB's clamps at 0 and N
    for c in (corners, edge):
        got = ts.sparse_pws(None, N, len(c), n, corners=c)
        want = js.sparse_pws(jax.random.key(0), N, len(c), n, corners=c)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), oracles.np_sparse_pws(c, N, n))


def test_sparse_pws_draws_from_the_generator():
    gen = torch.Generator()
    gen.manual_seed(7)
    x = ts.sparse_pws(gen, 64, 4, 6).numpy()
    assert set(np.unique(x)) <= {0.0, 1.0} and 0 < x.sum() <= 4 * 36
    gen.manual_seed(7)
    np.testing.assert_array_equal(ts.sparse_pws(gen, 64, 4, 6).numpy(), x)


def test_make_rd_squares_matches_jax_with_pinned_draws():
    N, nbs, dyna = 64, 4, 40.0
    draws = np.random.default_rng(4).uniform(size=(nbs, 5))
    got = ts.make_rd_squares(None, N, nbs, dyna, draws=draws, dtype=torch.float64).numpy()
    assert _rel(got, js.make_rd_squares(jax.random.key(0), N, nbs, dyna, draws=draws)) <= 1e-12
    assert _rel(got, oracles.np_rd_squares(draws, N, nbs, dyna)) <= 1e-12


def test_make_rd_squares_draws_from_the_generator():
    gen = torch.Generator()
    gen.manual_seed(5)
    got = ts.make_rd_squares(gen, 64, 5, 30.0).numpy()
    supp = got > 0
    assert got.dtype == np.float32 and supp.any()
    assert got[supp].min() == pytest.approx(1.0, rel=1e-6)
    assert got[supp].max() == pytest.approx(10 ** 1.5, rel=1e-6)


def test_vectorized_operator_matches_jax():
    rng = np.random.default_rng(5)
    K = rng.normal(size=(6, 4))
    top = ts.vectorized_operator(lambda im: im @ _t(K).T, lambda im: im @ _t(K), (3, 4), (3, 6))
    jop = js.vectorized_operator(lambda im: im @ jnp.asarray(K).T, lambda im: im @ jnp.asarray(K),
                                 (3, 4), (3, 6))
    x = rng.normal(size=12)
    z = rng.normal(size=18)
    assert _rel(top(_t(x), 1), jop(jnp.asarray(x), 1)) <= 1e-12
    assert _rel(top(_t(z), 2), jop(jnp.asarray(z), 2)) <= 1e-12
    X = x.reshape((4, 3)).T     # column-major, as MATLAB
    np.testing.assert_allclose(top(_t(x), 1).numpy(), (X @ K.T).flatten(order="F"), rtol=1e-12)
    with pytest.raises(ValueError):
        top(_t(x), 3)


def test_ensure():
    ts.ensure(True)
    with pytest.raises(AssertionError, match="boom"):
        ts.ensure(False, "boom")


# ------------------------- the circular TV denoisers -----------------------

@pytest.mark.parametrize("fn,jfn,lam,n_iter", [
    (tv_denoise_circular, "tv_denoise_circular", 12.0, 30),
    (projk_denoise, "projk_denoise", 12.0, 30),
    (tv_denoise_circular, "tv_denoise_circular", 0.5, 5),
    (projk_denoise, "projk_denoise", 0.5, 5),
])
def test_circular_denoisers_match_jax(fn, jfn, lam, n_iter):
    rng = np.random.default_rng(6)
    y = np.kron(rng.random((6, 5)) * 100, np.ones((6, 6))) + 5 * rng.standard_normal((36, 30))
    got = fn(_t(y), lam, n_iter)
    assert _rel(got, getattr(jtv, jfn)(jnp.asarray(y), lam, n_iter)) <= 1e-12
    # a chain batch goes through the last two dimensions
    yb = np.stack([y, y[::-1]])
    np.testing.assert_allclose(fn(_t(yb), lam, n_iter)[0].numpy(), got.numpy(), rtol=1e-13,
                               atol=1e-11)


# ---------------------------- spatial convolution ---------------------------

@pytest.mark.parametrize("family", ["gaussian", "laplace", "moffat"])
def test_circ_conv_and_corr_match_jax_and_the_blur(family):
    rng = np.random.default_rng(8)
    shape = (32, 24)
    jk = {"gaussian": lambda: jpsf.gaussian_kernel(7, 0.4, 0.3, dtype=jnp.float64),
          "laplace": lambda: jpsf.laplace_kernel(7, 0.3, dtype=jnp.float64),
          "moffat": lambda: jpsf.moffat_kernel(7, 0.4, 3.5, dtype=jnp.float64)}[family]()
    k = _t(jk)
    x = rng.standard_normal((3,) + shape)
    conv, corr = circ_conv(_t(x), k), circ_corr(_t(x[0]), k)
    assert conv.shape == (3,) + shape and corr.shape == shape
    assert _rel(conv, jsc.circ_conv(jnp.asarray(x), jk)) <= 1e-12
    assert _rel(corr, jsc.circ_corr(jnp.asarray(x[0]), jk)) <= 1e-12
    blur = BlurOperator(shape, 7, torch.float64, "cpu")
    H = blur.otf(k)
    assert _rel(conv[1], blur.apply(_t(x[1]), H)) <= 1e-12
    assert _rel(corr, blur.apply_adjoint(_t(x[0]), H)) <= 1e-12
    jb = jfourier.BlurOperator(shape, 7, jnp.float64)
    assert _rel(conv[2], jb.apply(jnp.asarray(x[2]), jb.otf(jk))) <= 1e-12


def test_circ_conv_keeps_the_corner_translation():
    """A delta at the PSF centre translates by (s−1)/2, as the corner-pad
    Fourier path does (utils/resize.m:8, no ifftshift)."""
    k = torch.zeros((7, 7), dtype=torch.float64)
    k[3, 3] = 1.0
    x = np.random.default_rng(9).standard_normal((20, 16))
    np.testing.assert_array_equal(circ_conv(_t(x), k).numpy(), np.roll(x, (3, 3), (0, 1)))


# ------------------------------- on the card --------------------------------

def test_card_circ_conv_matches_the_cpu(cuda_device):
    rng = np.random.default_rng(10)
    k = tpsf.gaussian_kernel(7, 0.4, 0.3, dtype=torch.float32)
    x = torch.from_numpy(rng.random((2, 512, 512)).astype(np.float32) * 255)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True   # what a caller may leave on
    try:
        card = circ_conv(x.to(cuda_device), k.to(cuda_device)).cpu()
        card_t = circ_corr(x.to(cuda_device), k.to(cuda_device)).cpu()
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert _rel(card, circ_conv(x, k)) <= 1e-5
    assert _rel(card_t, circ_corr(x, k)) <= 1e-5
