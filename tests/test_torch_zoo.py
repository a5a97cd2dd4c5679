"""Port vs JAX package: the solver zoo (generic SALSA, C-SALSA, CoRAL, NESTA,
SPGL1), float64 on the CPU at 32² (dense problems of up to 100 unknowns
for SPGL1), the same numpy-seeded inputs through both packages.

Tolerances, relative to the largest magnitude of each compared array:
* 1e-10: `salsa`/`salsa_v1`, `csalsa` (default soft, custom Ψ/Φ, P/Pᵀ,
  tv_init, stop criterion 4, x0 = Aᵀy), `csalsa_synthesis`, `csalsa_tv`,
  `coral` and `coral_tv_l1` cold and warm, over their traces and equal
  `n_iters`;
* 1e-9: `nesta` (TV and L1) and the explicit adjoint of the forward
  gradient against `jax.vjp`;
* 1e-8: `spg_lasso` and `spgl1_bpdn`, real, weighted and complex.  Their
  Barzilai–Borwein steps amplify the last-bit differences of the two
  packages' dense products and sums by about 10× every 20–30 iterations
  (a 100-iteration lasso on the blur operator ends 2e-8 apart), so the
  cases are held at iteration budgets where that stays inside the bound.

Routes: on CPU tensors every forced kernel route runs its plain version
and gives the plain route's result.  The card tests at the end need a
CUDA card and skip without one: `csalsa_tv` and `coral_tv_l1` through
kernels A1/A2 against `prox_route='plain'` at 64², chambolle_tol=0,
within 1e-6.  On a machine without JAX (the card's) only they run:

    python -m pytest --noconftest tests/test_torch_zoo.py -q -k card
"""
import importlib

import numpy as np
import pytest
import torch

from semiblind_tv_tpu_torch.ops import psf as tpsf
from semiblind_tv_tpu_torch.ops.fourier import BlurOperator
from semiblind_tv_tpu_torch.ops.tv import chambolle_prox, forward_gradient_adjoint, tv_norm
from semiblind_tv_tpu_torch.ops.wavelet import ti_analysis, ti_synthesis
from semiblind_tv_tpu_torch.runtime.profiling import counters
from semiblind_tv_tpu_torch.solvers import coral as t_coral_fn
from semiblind_tv_tpu_torch.solvers.coral import coral_tv_l1
from semiblind_tv_tpu_torch.solvers.csalsa import csalsa, csalsa_synthesis, csalsa_tv
from semiblind_tv_tpu_torch.solvers.nesta import nesta
from semiblind_tv_tpu_torch.solvers.salsa import soft_threshold
from semiblind_tv_tpu_torch.solvers.salsa_generic import salsa, salsa_v1
from semiblind_tv_tpu_torch.solvers.spgl1 import (
    project_l1_ball,
    project_weighted_l1_ball,
    spg_lasso,
    spgl1_bpdn,
)

try:  # the card machine has no JAX: there only the card tests run
    import jax
    import jax.numpy as jnp

    from semiblind_tv_tpu.ops import fourier as jfourier
    from semiblind_tv_tpu.ops import psf as jpsf
    from semiblind_tv_tpu.ops import tv as jtv
    from semiblind_tv_tpu.ops import wavelet as jwavelet
    from semiblind_tv_tpu.solvers import soft_threshold as j_soft
    from tests import oracles

    J = {m: importlib.import_module(f"semiblind_tv_tpu.solvers.{m}")
         for m in ("salsa_generic", "csalsa", "coral", "nesta", "spgl1")}
except ImportError:
    jax = None

SHAPE = (32, 32)


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
        pytest.skip("needs a CUDA card: kernels A1/A2 run only there")
    return torch.device("cuda")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _close(a, b, tol, what=""):
    assert _rel(a, b) <= tol, f"{what}: {_rel(a, b)} > {tol}"


def _problem(seed=0, scale=50.0, sigma=1.0):
    """The 32² Gaussian-blur problem of tests/test_solver_zoo.py."""
    rng = np.random.default_rng(seed)
    jblur = jfourier.BlurOperator(SHAPE, 7, jnp.float64)
    k = jpsf.gaussian_kernel(7, 0.4, 0.3, dtype=jnp.float64)
    H = np.asarray(jblur.otf(k))
    H_full = oracles.np_otf(np.asarray(k), SHAPE)
    x = np.kron(rng.random((8, 8)) * scale, np.ones((4, 4)))
    y = oracles.np_blur(x, H_full) + sigma * rng.standard_normal(SHAPE)
    tblur = BlurOperator(SHAPE, 7, torch.float64, "cpu")
    return jblur, tblur, H, x, y


def _t(a):
    return torch.from_numpy(np.array(a))


def _dense(seed, m, n, complex_=False):
    rng = np.random.default_rng(seed)
    if complex_:
        A = (rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))) / np.sqrt(2 * m)
    else:
        A = rng.standard_normal((m, n)) / np.sqrt(m)
    x = np.zeros(n, A.dtype)
    idx = rng.choice(n, 6, replace=False)
    x[idx] = rng.standard_normal(6) * 3.0
    if complex_:
        x[idx] += 1j * rng.standard_normal(6) * 3.0
    noise = rng.standard_normal(m) + (1j * rng.standard_normal(m) if complex_ else 0)
    return A, x, A @ x + 0.01 * noise, rng.random(n) + 0.5


def _dense_ops(A):
    Aj, At = jnp.asarray(A), _t(A)
    return ((lambda v: Aj @ v, lambda r: Aj.conj().T @ r),
            (lambda v: At @ v, lambda r: At.conj().T @ r))


def _blur_ops(jblur, tblur, H):
    """(A, AT, inv_ls) on the rfft grid for both packages at µ."""
    Hj, Ht = jnp.asarray(H), _t(H)

    def j_ops(mu):
        return (lambda v: jblur.irfft(Hj * jblur.rfft(v)),
                lambda v: jblur.irfft(jnp.conj(Hj) * jblur.rfft(v)),
                lambda r: jblur.irfft(jblur.rfft(r) / (jnp.abs(Hj) ** 2 + mu)))

    def t_ops(mu):
        return (lambda v: tblur.irfft(Ht * tblur.rfft(v)),
                lambda v: tblur.irfft(torch.conj(Ht) * tblur.rfft(v)),
                lambda r: tblur.irfft(tblur.rfft(r) / (torch.abs(Ht) ** 2 + mu)))

    return j_ops, t_ops


# ------------------------------ generic SALSA ------------------------------

@pytest.mark.parametrize("crit,tol,max_iter", [(1, 1e-12, 40), (1, 1e-6, 400), (2, 1e-5, 60),
                                               (3, 0.0, 25)])
def test_salsa_l1_dense_matches_jax(crit, tol, max_iter):
    A, _, y, _ = _dense(1, 48, 96)
    mu = 0.1
    inv = np.linalg.inv(A.T @ A + mu * np.eye(96))
    (jA, jAT), (tA, tAT) = _dense_ops(A)
    kw = dict(tau=0.02, mu=mu, max_iter=max_iter, tol=tol, stop_criterion=crit)
    jr = J["salsa_generic"].salsa(jnp.asarray(y), jA, jAT, lambda r: jnp.asarray(inv) @ r, **kw)
    tr = salsa(_t(y), tA, tAT, lambda r: _t(inv) @ r, **kw)
    assert tr.n_iters == jr.n_iters
    if max_iter == 400:
        assert tr.n_iters < 400
    _close(tr.x, jr.x, 1e-10, "x")
    _close(tr.objective, jr.objective, 1e-10, "objective")
    assert len(tr.objective) == max_iter + 1


def test_salsa_tv_prox_with_an_analysis_pair_matches_jax():
    """A TV prox through caller operators, and an orthogonal P/Pᵀ pair."""
    jblur, tblur, H, _, y = _problem(2)
    j_ops, t_ops = _blur_ops(jblur, tblur, H)
    Q, _ = np.linalg.qr(np.random.default_rng(3).standard_normal((64, 64)))
    Qj, Qt = jnp.asarray(Q), _t(Q)
    kw = dict(tau=0.15, mu=0.015, max_iter=20, tol=1e-12)
    jr = J["salsa_generic"].salsa(
        jnp.asarray(y), *j_ops(0.015), prox=lambda v, t: jtv.chambolle_prox(v, t, 10)[0],
        phi=jtv.tv_norm, **kw)
    tr = salsa(_t(y), *t_ops(0.015), prox=lambda v, t: chambolle_prox(v, t, 10)[0],
               phi=tv_norm, **kw)
    assert tr.n_iters == jr.n_iters == 20
    _close(tr.x, jr.x, 1e-10, "x")
    _close(tr.objective, jr.objective, 1e-10, "objective")

    A, _, yd, _ = _dense(4, 32, 64)
    inv = np.linalg.inv(A.T @ A + 0.2 * np.eye(64))
    (jA, jAT), (tA, tAT) = _dense_ops(A)
    kw = dict(tau=0.05, mu=0.2, max_iter=30, tol=0.0)
    jr = J["salsa_generic"].salsa(jnp.asarray(yd), jA, jAT, lambda r: jnp.asarray(inv) @ r,
                                  P=lambda c: Qj @ c, PT=lambda v: Qj.T @ v, **kw)
    tr = salsa(_t(yd), tA, tAT, lambda r: _t(inv) @ r, P=lambda c: Qt @ c,
               PT=lambda v: Qt.T @ v, **kw)
    _close(tr.x, jr.x, 1e-10, "x with P/PT")
    _close(tr.objective, jr.objective, 1e-10, "objective with P/PT")


@pytest.mark.parametrize("inner,output,crit", [(1, "x", 1), (3, "x", 2), (2, "z", 1)])
def test_salsa_v1_matches_jax(inner, output, crit):
    A, _, y, _ = _dense(5, 32, 64)
    mu = 0.2
    inv = np.linalg.inv(A.T @ A + mu * np.eye(64))
    (jA, jAT), (tA, tAT) = _dense_ops(A)
    x0 = np.random.default_rng(6).standard_normal(64)
    kw = dict(tau=0.05, mu=mu, inner_iters=inner, max_iter=50, tol=1e-8, stop_criterion=crit,
              output=output)
    jr = J["salsa_generic"].salsa_v1(jnp.asarray(y), jA, jAT, lambda r: jnp.asarray(inv) @ r,
                                     x0=jnp.asarray(x0), **kw)
    tr = salsa_v1(_t(y), tA, tAT, lambda r: _t(inv) @ r, x0=_t(x0), **kw)
    assert tr.n_iters == jr.n_iters
    _close(tr.x, jr.x, 1e-10, "x")
    _close(tr.objective, jr.objective, 1e-10, "objective")


def test_generic_salsa_documented_call_shapes():
    """The kwargs MIGRATION.md writes for these callables
    (tests/test_migration_surface.py::DOCUMENTED_KWARGS)."""
    import inspect

    for fn, kws in ((salsa, ("A", "AT", "inv_ls", "tau", "mu", "prox", "phi", "P", "PT")),
                    (salsa_v1, ("A", "AT", "inv_ls", "tau", "mu", "inner_iters")),
                    (csalsa, ("A", "AT", "invLS", "mu1", "mu2", "epsilon"))):
        params = inspect.signature(fn).parameters
        assert all(k in params for k in kws), fn.__name__


# --------------------------------- C-SALSA ---------------------------------

def _eps(y, sigma=1.0):
    return float(np.sqrt(y.size + 8 * np.sqrt(y.size)) * sigma)


def _csalsa_ops(jblur, tblur, H):
    Hj, Ht = jnp.asarray(H), _t(H)
    j = (lambda v: jblur.irfft(Hj * jblur.rfft(v)),
         lambda v: jblur.irfft(jnp.conj(Hj) * jblur.rfft(v)),
         lambda r, m1, m2: jblur.irfft(jblur.rfft(r) / (m2 * jnp.abs(Hj) ** 2 + m1)))
    t = (lambda v: tblur.irfft(Ht * tblur.rfft(v)),
         lambda v: tblur.irfft(torch.conj(Ht) * tblur.rfft(v)),
         lambda r, m1, m2: tblur.irfft(tblur.rfft(r) / (m2 * torch.abs(Ht) ** 2 + m1)))
    return j, t


def _check_csalsa(tr, jr, tol=1e-10, distances=True):
    assert tr.n_iters == jr.n_iters
    _close(tr.x, jr.x, tol, "x")
    for f in ("objective", "criterion", "mses") + (("distance1", "distance2") if distances else ()):
        _close(getattr(tr, f), getattr(jr, f), tol, f)


def _csalsa_case(case):
    """(JAX kwargs, port kwargs) of one option of the generic surface."""
    if case == "soft":
        return dict(max_iter=25, tol=1e-4, delta=1.05), dict(max_iter=25, tol=1e-4, delta=1.05)
    if case == "psi_phi":
        common = dict(max_iter=20, tol=1e-12, stop_criterion=2)
        return (dict(prox=lambda v, t: v / (1.0 + t), phi=lambda v: 0.5 * jnp.sum(v * v), **common),
                dict(prox=lambda v, t: v / (1.0 + t), phi=lambda v: 0.5 * torch.sum(v * v),
                     **common))
    if case == "tv_init":
        common = dict(tv_init=True, tv_iters=10, max_iter=20, tol=1e-6, stop_criterion=1)
        return common, common
    if case == "crit4":
        common = dict(max_iter=30, tol=7, stop_criterion=4, x0="aty")
        return common, common
    raise ValueError(case)


@pytest.mark.parametrize("case", ["soft", "psi_phi", "tv_init", "crit4"])
def test_csalsa_generic_matches_jax(case):
    jblur, tblur, H, x, y = _problem(7, scale=100.0)
    (jA, jAT, jLS), (tA, tAT, tLS) = _csalsa_ops(jblur, tblur, H)
    jkw, tkw = _csalsa_case(case)
    jr = J["csalsa"].csalsa(jnp.asarray(y), jA, jAT, jLS, 0.05, 1.0, epsilon=_eps(y),
                            x_true=jnp.asarray(x), **jkw)
    tr = csalsa(_t(y), tA, tAT, tLS, 0.05, 1.0, epsilon=_eps(y), x_true=_t(x), **tkw)
    _check_csalsa(tr, jr)
    if case == "crit4":
        assert tr.n_iters == 6    # the minimum count 7 = k + 2 stops at k = 5


def test_csalsa_analysis_pair_matches_jax():
    """P/Pᵀ: an orthogonal P = Q1 ⊗ Q2 from flat coefficients to the image,
    soft prox in its domain."""
    jblur, tblur, H, x, y = _problem(8, scale=100.0)
    (jA, jAT, jLS), (tA, tAT, tLS) = _csalsa_ops(jblur, tblur, H)
    rng = np.random.default_rng(9)
    Q1, Q2 = (np.linalg.qr(rng.standard_normal((n, n)))[0] for n in SHAPE)
    j1, j2, t1, t2 = jnp.asarray(Q1), jnp.asarray(Q2), _t(Q1), _t(Q2)
    jr = J["csalsa"].csalsa(jnp.asarray(y), jA, jAT, jLS, 0.05, 1.0, epsilon=_eps(y),
                            P=lambda c: j1 @ c.reshape(SHAPE) @ j2.T,
                            PT=lambda v: (j1.T @ v @ j2).ravel(), max_iter=15, tol=1e-12)
    tr = csalsa(_t(y), tA, tAT, tLS, 0.05, 1.0, epsilon=_eps(y),
                P=lambda c: t1 @ c.reshape(SHAPE) @ t2.T,
                PT=lambda v: (t1.T @ v @ t2).reshape(-1), max_iter=15, tol=1e-12)
    _check_csalsa(tr, jr)


def test_csalsa_synthesis_matches_jax():
    jblur, tblur, H, _, y = _problem(10, scale=100.0)
    kw = dict(epsilon=_eps(y), max_iter=40, tol=1e-4)
    jr = J["csalsa"].csalsa_synthesis(
        jnp.asarray(y), H, jblur, lambda s: jwavelet.ti_synthesis(s, 1),
        lambda v: jwavelet.ti_analysis(v, 1), 0.3, 1.0, **kw)
    tr = csalsa_synthesis(_t(y), _t(H), tblur, lambda s: ti_synthesis(s, 1),
                          lambda v: ti_analysis(v, 1), 0.3, 1.0, **kw)
    _check_csalsa(tr, jr)


@pytest.mark.parametrize("crit,tol,max_iter,sigma", [(1, 1e-12, 30, 1.0), (1, 1e-3, 300, 1.1),
                                                     (2, 1e-4, 60, 1.0), (3, 1e-6, 60, 1.0)])
def test_csalsa_tv_matches_jax(crit, tol, max_iter, sigma):
    jblur, tblur, H, x, y = _problem(11, scale=100.0)
    kw = dict(mu1=0.05, mu2=1.0, max_iter=max_iter, tol=tol, stop_criterion=crit, tv_iters=10,
              sigma=sigma)
    jr = J["csalsa"].csalsa_tv(jnp.asarray(y), H, blur=jblur, x_true=jnp.asarray(x), **kw)
    tr = csalsa_tv(_t(y), _t(H), blur=tblur, x_true=_t(x), **kw)
    _check_csalsa(tr, jr, distances=False)
    if max_iter == 300:   # stops early, inside the ε-ball: the frozen tail
        assert tr.n_iters < 300 and tr.criterion[-1] <= _eps(y, sigma)


def test_csalsa_tv_continuation_matches_jax():
    jblur, tblur, H, x, y = _problem(12, scale=100.0)
    kw = dict(mu1=0.02, mu2=0.5, delta=1.1, max_iter=40, tol=1e-9, tv_iters=5)
    jr = J["csalsa"].csalsa_tv(jnp.asarray(y), H, blur=jblur, epsilon=_eps(y), **kw)
    tr = csalsa_tv(_t(y), _t(H), blur=tblur, epsilon=_eps(y), **kw)
    _check_csalsa(tr, jr, distances=False)


def test_csalsa_stop_quirks():
    """The generic loop may stop on its first pass; csalsa_tv only from the
    second (the JAX package's two loops, CSALSA_v2.m:520-545 against
    csalsa.py:337-339); an unknown criterion and a missing ε raise."""
    jblur, tblur, H, _, y = _problem(13, scale=100.0)
    _, (tA, tAT, tLS) = _csalsa_ops(jblur, tblur, H)
    big = 1e9
    gen = csalsa(_t(y), tA, tAT, tLS, 0.05, 1.0, epsilon=big, max_iter=10, tol=big)
    tv = csalsa_tv(_t(y), _t(H), 0.05, 1.0, tblur, epsilon=big, max_iter=10, tol=big)
    assert gen.n_iters == 1 and tv.n_iters == 2
    with pytest.raises(ValueError):
        csalsa(_t(y), tA, tAT, tLS, 0.05, 1.0, epsilon=1.0, stop_criterion=5)
    with pytest.raises(ValueError):
        csalsa_tv(_t(y), _t(H), 0.05, 1.0, tblur)


@pytest.mark.parametrize("route", ["A1", "F", "H"])
def test_csalsa_forced_routes_on_cpu_tensors_run_the_plain_versions(route):
    _, tblur, H, _, y = _problem(14, scale=100.0)
    kw = dict(mu1=0.05, mu2=1.0, blur=tblur, sigma=1.0, max_iter=20, tol=1e-9)
    plain = csalsa_tv(_t(y), _t(H), prox_route="plain", **kw)
    forced = csalsa_tv(_t(y), _t(H), prox_route=route, **kw)
    np.testing.assert_array_equal(forced.x, plain.x)
    assert forced.n_iters == plain.n_iters


# ---------------------------------- CoRAL ----------------------------------

@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("tol,max_iter", [(1e-10, 60), (1e-3, 400)])
def test_coral_tv_l1_matches_jax(warm, tol, max_iter):
    jblur, tblur, H, x, y = _problem(15)
    kw = dict(mu1=0.03, mu2=0.03, max_iter=max_iter, tol=tol, tv_warm_start=warm)
    jr = J["coral"].coral_tv_l1(jnp.asarray(y), H, 0.3, 0.01, jblur, x_true=jnp.asarray(x), **kw)
    tr = coral_tv_l1(_t(y), _t(H), 0.3, 0.01, tblur, x_true=_t(x), **kw)
    assert tr.n_iters == jr.n_iters
    if max_iter == 400:
        assert tr.n_iters < 400
    _close(tr.x, jr.x, 1e-10, "x")
    _close(tr.objective, jr.objective, 1e-10, "objective")
    _close(tr.mses, jr.mses, 1e-10, "mses")


@pytest.mark.parametrize("crit", [1, 2, 3])
def test_coral_generic_matches_jax(crit):
    """Two caller prox pairs: soft threshold (L1) and the quadratic
    v/(1+t) (½‖·‖²)."""
    jblur, tblur, H, x, y = _problem(16)
    kw = dict(mu1=0.05, mu2=0.02, max_iter=30, tol=1e-9, stop_criterion=crit)
    jr = J["coral"].coral(jnp.asarray(y), H, 0.2, 0.05, jblur,
                          lambda v, t: j_soft(v, t), lambda v: jnp.sum(jnp.abs(v)),
                          lambda v, t: v / (1.0 + t), lambda v: 0.5 * jnp.sum(v * v),
                          x_true=jnp.asarray(x), **kw)
    tr = t_coral_fn(_t(y), _t(H), 0.2, 0.05, tblur,
                    lambda v, t: soft_threshold(v, t), lambda v: torch.sum(torch.abs(v)),
                    lambda v, t: v / (1.0 + t), lambda v: 0.5 * torch.sum(v * v),
                    x_true=_t(x), **kw)
    assert tr.n_iters == jr.n_iters
    _close(tr.x, jr.x, 1e-10, "x")
    _close(tr.objective, jr.objective, 1e-10, "objective")
    _close(tr.mses, jr.mses, 1e-10, "mses")


@pytest.mark.parametrize("warm,route", [(False, "A2"), (False, "F"), (True, "A1"), (True, "H")])
def test_coral_forced_routes_on_cpu_tensors_run_the_plain_versions(warm, route):
    _, tblur, H, _, y = _problem(17)
    kw = dict(mu1=0.03, mu2=0.03, max_iter=20, tol=1e-9, tv_warm_start=warm)
    plain = coral_tv_l1(_t(y), _t(H), 0.3, 0.01, tblur, prox_route="plain", **kw)
    forced = coral_tv_l1(_t(y), _t(H), 0.3, 0.01, tblur, prox_route=route, **kw)
    np.testing.assert_array_equal(forced.x, plain.x)


# ---------------------------------- NESTA ----------------------------------

def test_forward_gradient_adjoint_matches_the_vjp():
    rng = np.random.default_rng(18)
    for shape in ((2, 2), (7, 5)):
        u = rng.standard_normal(shape)
        gx, gy = rng.standard_normal(shape), rng.standard_normal(shape)
        _, vjp = jax.vjp(lambda v: jnp.stack(jtv.forward_gradient(v)), jnp.asarray(u))
        (want,) = vjp(jnp.stack([jnp.asarray(gx), jnp.asarray(gy)]))
        got = forward_gradient_adjoint(_t(gx), _t(gy))
        _close(got, want, 1e-9, f"adjoint {shape}")
        # and it is the adjoint: <D u, g> = <u, Dᵀ g>
        dx, dy = (np.asarray(a) for a in jtv.forward_gradient(jnp.asarray(u)))
        np.testing.assert_allclose(np.sum(dx * gx + dy * gy), np.sum(u * got.numpy()), rtol=1e-12)


@pytest.mark.parametrize("type_min,muf,max_iter,legs", [("tv", 0.1, 30, 3), ("l1", 0.05, 30, 3)])
def test_nesta_matches_jax(type_min, muf, max_iter, legs):
    jblur, tblur, H, _, y = _problem(19)
    kw = dict(muf=muf, delta=np.sqrt(y.size), type_min=type_min, max_iter=max_iter,
              max_int_iter=legs)
    jr = J["nesta"].nesta(jnp.asarray(y), H, jblur, **kw)
    tr = nesta(_t(y), _t(H), tblur, **kw)
    assert tr.n_iters == jr.n_iters
    _close(tr.x, jr.x, 1e-9, "x")
    _close(tr.objective, jr.objective, 1e-9, "objective")
    _close(tr.residual, jr.residual, 1e-9, "residual")
    assert tr.mu_final == pytest.approx(jr.mu_final, rel=1e-14)


def test_nesta_objective_buffer_starts_at_float32_tiny():
    """The 10-entry buffer of the stop test starts at float32's tiny in any
    dtype (nesta.py:163).  On a constant image f_mu is 0 on every
    iteration; against the tiny seed its relative variation is 1, not 0/0,
    so with tol_var large the leg stops on its second iteration, as in JAX."""
    jblur, tblur, H, _, _ = _problem(20)
    y = np.full(SHAPE, 5.0)
    kw = dict(muf=0.1, delta=1.0, max_iter=30, max_int_iter=1, tol_var=1e9)
    jr = J["nesta"].nesta(jnp.asarray(y), H, jblur, **kw)
    tr = nesta(_t(y), _t(H), tblur, **kw)
    assert tr.n_iters == jr.n_iters == 2
    np.testing.assert_array_equal(tr.objective, 0.0)


# ---------------------------------- SPGL1 ----------------------------------

@pytest.mark.parametrize("complex_", [False, True])
def test_l1_ball_projections_match_jax(complex_):
    rng = np.random.default_rng(21)
    v = rng.standard_normal((16, 16)) * 5
    if complex_:
        v = v + 1j * rng.standard_normal((16, 16)) * 5
    w = rng.random((16, 16)) + 0.2
    for tau in (1.0, 10.0, 1e6):
        _close(project_l1_ball(_t(v), tau), J["spgl1"].project_l1_ball(jnp.asarray(v), tau),
               1e-12, "l1 ball")
        _close(project_weighted_l1_ball(_t(v), tau, _t(w)),
               J["spgl1"].project_weighted_l1_ball(jnp.asarray(v), tau, jnp.asarray(w)), 1e-12,
               "weighted l1 ball")


@pytest.mark.parametrize("weighted", [False, True])
def test_spg_lasso_on_the_blur_matches_jax(weighted):
    jblur, tblur, H, x, y = _problem(22)
    w = np.random.default_rng(23).random(SHAPE) + 0.5 if weighted else None
    tau = 0.5 * float(np.sum(np.abs(x)))
    kw = dict(max_iter=25)
    jx, jr, jg, jn = J["spgl1"].spg_lasso(jnp.asarray(y), H, jblur, tau,
                                          weights=None if w is None else jnp.asarray(w), **kw)
    tx, trr, tg, tn = spg_lasso(_t(y), _t(H), tblur, tau,
                                weights=None if w is None else _t(w), **kw)
    assert tn == jn
    _close(tx, jx, 1e-8, "x")
    _close(tg, jg, 1e-8, "grad")
    assert float(trr) == pytest.approx(float(jr), rel=1e-8)


@pytest.mark.parametrize("case", ["real", "weighted", "complex"])
def test_spgl1_bpdn_dense_matches_jax(case):
    A, _, b, w = _dense(24, 40, 100, complex_=case == "complex")
    (jops, tops) = _dense_ops(A)
    weighted = case == "weighted"
    kw = dict(sigma=0.05, max_newton=20, inner_iter=150, tol=1e-4)
    jr = J["spgl1"].spgl1_bpdn(jnp.asarray(b), None, None, A_ops=jops,
                               weights=jnp.asarray(w) if weighted else None, **kw)
    tr = spgl1_bpdn(_t(b), None, None, A_ops=tops, weights=_t(w) if weighted else None, **kw)
    assert (tr.n_iters, tr.n_newton) == (jr.n_iters, jr.n_newton)
    _close(tr.x, jr.x, 1e-8, "x")
    assert tr.tau == pytest.approx(jr.tau, rel=1e-8)
    assert tr.resid_norm == pytest.approx(jr.resid_norm, rel=1e-8)


def test_spg_lasso_subspace_min_on_a_dense_problem_matches_jax():
    """The active-face CGLS refinement (real data), once the support repeats."""
    A, x, b, _ = _dense(27, 60, 120)
    (jops, tops) = _dense_ops(A)
    tau = 0.9 * float(np.sum(np.abs(x)))
    kw = dict(max_iter=60, subspace_min=True)
    jx, jr, _, jn = J["spgl1"].spg_lasso(jnp.asarray(b), None, None, tau, A_ops=jops, **kw)
    tx, trr, _, tn = spg_lasso(_t(b), None, None, tau, A_ops=tops, **kw)
    assert tn == jn
    _close(tx, jx, 1e-8, "x")
    assert float(trr) == pytest.approx(float(jr), rel=1e-8)
    assert float(torch.sum(torch.abs(tx))) <= tau * (1 + 1e-10)


def test_spgl1_bpdn_on_the_blur_matches_jax():
    jblur, tblur, H, _, y = _problem(25)
    kw = dict(sigma=np.sqrt(y.size), max_newton=2, inner_iter=20)
    jr = J["spgl1"].spgl1_bpdn(jnp.asarray(y), H, jblur, **kw)
    tr = spgl1_bpdn(_t(y), _t(H), tblur, **kw)
    assert (tr.n_iters, tr.n_newton) == (jr.n_iters, jr.n_newton)
    _close(tr.x, jr.x, 1e-8, "x")
    assert tr.tau == pytest.approx(jr.tau, rel=1e-8)


# --------------------------- on the card (64²) -----------------------------

def _card_problem(dev, size=64, seed=26):
    """A 64² Gaussian-blur problem in float32 on the card, from numpy."""
    rng = np.random.default_rng(seed)
    blur = BlurOperator((size, size), 7, torch.float32, dev)
    H = blur.otf(tpsf.gaussian_kernel(7, 0.4, 0.3, dtype=torch.float32, device=dev))
    x = torch.from_numpy(np.kron(rng.random((size // 4, size // 4)) * 100, np.ones((4, 4))))
    y = blur.apply(x.to(dev, torch.float32), H) + torch.from_numpy(
        rng.standard_normal((size, size))).to(dev, torch.float32)
    return blur, H, y


def test_card_csalsa_tv_through_a1_equals_the_plain_route(cuda_device):
    blur, H, y = _card_problem(cuda_device)
    kw = dict(mu1=0.05, mu2=1.0, blur=blur, sigma=1.0, max_iter=60, tol=0.0, chambolle_tol=0.0)
    counters.reset("launches.A", "launches.A.fresh")
    kern = csalsa_tv(y, H, **kw)
    assert counters["launches.A"] == 60 and counters["launches.A.fresh"] == 0
    plain = csalsa_tv(y, H, prox_route="plain", **kw)
    assert _rel(kern.x, plain.x) <= 1e-6


@pytest.mark.parametrize("warm", [False, True])
def test_card_coral_tv_l1_through_a1_a2_equals_the_plain_route(cuda_device, warm):
    blur, H, y = _card_problem(cuda_device)
    kw = dict(mu1=0.03, mu2=0.03, max_iter=60, tol=0.0, chambolle_tol=0.0, tv_warm_start=warm)
    counters.reset("launches.A", "launches.A.fresh")
    kern = coral_tv_l1(y, H, 0.3, 0.01, blur, **kw)
    assert counters["launches.A"] == 60 and counters["launches.A.fresh"] == (0 if warm else 60)
    plain = coral_tv_l1(y, H, 0.3, 0.01, blur, prox_route="plain", **kw)
    assert _rel(kern.x, plain.x) <= 1e-6


# ------------------------------ the oracle sweep ----------------------------

def test_oracle_and_tau_sweeps_match_jax():
    """`oracle_sweep` and `tau_sweep` on the same 32² problem (the JAX
    Problem's fields) through both packages' SALSA: the MSE curves within
    1e-10, the same argmin."""
    import dataclasses

    from semiblind_tv_tpu.cli import oracle_sweep as j_os
    from semiblind_tv_tpu.runtime import build_problem as j_build_problem
    from semiblind_tv_tpu.runtime import config as jcfg
    from semiblind_tv_tpu.utils import synthetic_wheel
    from semiblind_tv_tpu_torch.cli import oracle_sweep as t_os
    from semiblind_tv_tpu_torch.runtime import config as tcfg
    from semiblind_tv_tpu_torch.runtime.problem import problem_from_arrays
    from tests.test_torch_sapg import jax_problem_arrays

    jc, tc = jcfg.gaussian_preset(), tcfg.gaussian_preset()
    js_ = dataclasses.replace(jc.salsa, outer_iters=40)
    ts_ = dataclasses.replace(tc.salsa, outer_iters=40)
    jp = j_build_problem(synthetic_wheel(32), jc, jax.random.key(0), dtype=jnp.float64)
    tp = problem_from_arrays(tc, jax_problem_arrays(jp), device="cpu", dtype=torch.float64)
    s2 = float(jp.sigma_true) ** 2
    thetas = [0.003, 0.03, 0.3]
    jr = j_os.oracle_sweep(jp, thetas, s2, js_)
    tr = t_os.oracle_sweep(tp, thetas, s2, ts_)
    _close(tr[0], jr[0], 1e-10, "theta curve")
    assert tr[1:] == pytest.approx(jr[1:], rel=1e-10)
    taus = [0.1 * s2, s2]
    jr = j_os.tau_sweep(jp, taus, js_)
    tr = t_os.tau_sweep(tp, taus, ts_)
    _close(tr[0], jr[0], 1e-10, "tau curve")
    assert tr[1:] == pytest.approx(jr[1:], rel=1e-10)


def test_oracle_sweep_cli_on_the_cpu(capsys):
    """`main` at 32² without SAPG, with the τ and σ² sweeps: the JAX CLI's
    keys and flags, the oracle at the curve's minimum."""
    import json

    from semiblind_tv_tpu_torch.cli import oracle_sweep as t_os

    out = t_os.main(["--image", "synthetic", "--size", "32", "--no-sapg", "--grid", "2",
                     "--tau-grid", "1", "--sigma-grid", "1", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(out))
    for k in ("theta_grid", "mse_db_curve", "oracle_theta", "oracle_mse_db", "tau_grid",
              "tau_mse_db_curve", "oracle_tau", "oracle_tau_mse_db", "sigma2_grid",
              "sigma2_mse_db_curve", "oracle_sigma2", "oracle_sigma2_mse_db", "sigma2_true"):
        assert k in out
    assert out["oracle_mse_db"] == min(out["mse_db_curve"])
    opts = {s for a in t_os.build_parser()._actions for s in a.option_strings}
    assert {"--tau-grid", "--sigma-grid", "--grid", "--psf", "--image", "--device"} <= opts
