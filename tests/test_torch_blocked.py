"""The blocked kernel family of the port (csrc/tv_blocked.cu):
ops/tv_blocked_cuda.chambolle_prox_blocked (the counterpart of the JAX
package's kernels F and H) and ops/fused_step_cuda.myula_prox_tv_blocked
(G and I).

On the CPU the wrappers run their plain versions.  Those are held against
the JAX package's tiled and streamed Pallas kernels in interpret mode (as
tests/test_pallas_interpret.py runs them) at 64², 16- and 32-row tiles,
float64: fields within 1e-12 relative at tol=0, equal sweep counts at
tol=1e-3, TV within 1e-12.  The JAX streamed kernel is itself inexact at
16-row tiles for moderate fields (its window applies the image's last-row
rule at a window edge inside the image; see
test_jax_streamed_window_edge_fault_is_not_ported), so the tol=0
comparisons with it use fields large enough that its error is below
rounding, as the JAX package's own interpret tests do.  The kernel's
launch schedule (the balanced pass split, clamped windows, per-tile sums in
the pass block's order, the folded reduce and the redo) is replayed by
chambolle_prox_blocked_emulated and held against the whole-image plain
prox: bit-equal at tol=0, and equal per-chain sweep counts (and fields) at
tol=1e-3, across pass splits, window widths that are not a multiple of 32,
images smaller than a window, ragged shapes, and chains that stop on every
sweep of a pass.  The kernels themselves run on the card in
tests/test_torch_on_card.py.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semiblind_tv_tpu.ops.fused_step_pallas import myula_prox_tv_streamed, myula_prox_tv_tiled
from semiblind_tv_tpu.ops.tv_pallas import chambolle_prox_streamed, chambolle_prox_tiled
from semiblind_tv_tpu_torch.ops import fused_step_cuda
from semiblind_tv_tpu_torch.ops import tv_blocked_cuda as tb

REL = 1e-12
SIZE = 64
K = tb.SWEEP_BLOCK


@pytest.fixture(autouse=True)
def one_thread():
    """The emulation runs many small elementwise operations, which several
    test workers sharing the cores slow down by orders of magnitude when
    each op is split across threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-300)


def _images(B=3, shape=(SIZE, SIZE), seed=0, scales=(1e-5, 1e-4, 1.0)):
    """A smooth field with a little noise, at one scale per chain: the
    chains stop after one, a few and all sweeps at tol=1e-3."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    base = np.sin(xx / 5.0) + np.cos(yy / 7.0)
    return np.stack([(base + 0.01 * rng.standard_normal(shape)) * s for s in scales[:B]])


# log10 of scales of the seeded noise field below at which the plain prox
# (λ, tol=1e-3) stops after the given sweep: each is the middle (in log s)
# of the run of scales that stop there, which is 0.025–0.07 decades wide,
# so that no residual lies on the edge of tol.
_STOP_LOG10 = {
    ((64, 64), 0.5): {1: -5.6994, 5: -4.8299, 8: -4.6780, 9: -4.6416, 12: -4.5544},
    ((64, 64), 0.8): {1: -5.5973, 5: -4.6258, 7: -4.5156},
    ((40, 56), 0.5): {3: -4.8922, 8: -4.5550, 9: -4.5183},
}


def _stopping_batch(lam, targets, shape=(SIZE, SIZE)):
    """Chains of one noise field, scaled to stop after `targets` sweeps at
    tol=1e-3 (25: scale 1, which never stops)."""
    base = np.random.default_rng(7).standard_normal(shape)
    table = _STOP_LOG10[(tuple(shape), lam)]
    return np.stack([base * (10.0 ** table[t] if t < 25 else 1.0) for t in targets])


def _duals(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape) * 0.1 for _ in range(2))


def _step_inputs(shape=(2, SIZE, SIZE), seed=5):
    rng = np.random.default_rng(seed)
    x = rng.random(shape) * 100
    prox = x + rng.standard_normal(shape) * 0.1
    grad = rng.standard_normal(shape)
    z = rng.standard_normal(shape)
    return x, prox, grad, z


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# The wrappers' CPU versions against the JAX tiled and streamed kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile_rows", [16, 32])
@pytest.mark.parametrize("warm", [False, True])
def test_prox_matches_jax_tiled(tile_rows, warm):
    """Kernel F: fresh form (the SAPG's initial prox) and warm form with
    the duals returned (SALSA's)."""
    duals = _duals((3, SIZE, SIZE), 1) if warm else None
    n = 10 if warm else 25
    for tol, g in ((0.0, _images()), (1e-3, _stopping_batch(0.5, (1, 5, 25)))):
        f, st = tb.chambolle_prox_blocked(
            torch.from_numpy(g), 0.5, n, tol=tol,
            duals=None if duals is None else tuple(_t(*duals)), return_state=warm,
        )
        jf, jst = chambolle_prox_tiled(
            jnp.asarray(g), 0.5, n, tol=tol, tile_rows=tile_rows, interpret=True,
            duals=None if duals is None else tuple(_j(*duals)),
        )
        np.testing.assert_array_equal(st.iters.numpy(), np.asarray(jst.iters))
        assert _rel(f.numpy(), jf) <= REL
        if warm:
            assert _rel(st.px.numpy(), jst.px) <= REL and _rel(st.py.numpy(), jst.py) <= REL
    if not warm:
        assert st.iters.tolist() == [1, 5, 25]


@pytest.mark.parametrize("tile_rows", [16, 32])
@pytest.mark.parametrize("warm", [False, True])
def test_prox_matches_jax_streamed(tile_rows, warm):
    """Kernel H: streamed_call modes plain and warm (duals returned).  The
    fields are large enough (×100) for the JAX kernel's window-edge error
    to fall below rounding, and the warm duals are those of a few plain
    sweeps on the same field, as SALSA hands them over; the fresh chains of
    the tol=1e-3 case stop within seven sweeps, before that error reaches a
    central row."""
    big = _images(seed=2, scales=(100.0, 300.0, 1000.0))
    duals, cases = None, ((0.0, big), (1e-3, _stopping_batch(0.8, (1, 5, 7))))
    if warm:
        st0 = tb.chambolle_prox_blocked_plain(torch.from_numpy(big), 0.8, 5)[1]
        duals, cases = (st0.px.numpy(), st0.py.numpy()), ((0.0, big), (1e-3, big))
    for tol, g in cases:
        f, st = tb.chambolle_prox_blocked(
            torch.from_numpy(g), 0.8, 25, tol=tol,
            duals=None if duals is None else tuple(_t(*duals)), return_state=warm,
        )
        jf, jst = chambolle_prox_streamed(
            jnp.asarray(g), 0.8, 25, tol=tol, tile_rows=tile_rows, interpret=True,
            duals=None if duals is None else tuple(_j(*duals)), return_state=warm,
        )
        np.testing.assert_array_equal(st.iters.numpy(), np.asarray(jst.iters))
        assert _rel(f.numpy(), jf) <= REL
        if warm:
            assert _rel(st.px.numpy(), jst.px) <= REL and _rel(st.py.numpy(), jst.py) <= REL
    if not warm:
        assert st.iters.tolist() == [1, 5, 7]


def test_jax_streamed_window_edge_fault_is_not_ported():
    """The JAX streamed kernel applies the image's last-row rule (−p1) at
    the last row of every window, also inside the image; after K sweeps
    the last central row of an interior tile depends on that value.  At
    16-row tiles on a moderate field it departs from the JAX whole-image
    prox by ~1e-6 relative.  The port's window leaves that term out
    instead, and its emulated schedule at 16-row tiles stays bit-equal to
    the whole-image prox."""
    from semiblind_tv_tpu.ops.tv import chambolle_prox as j_chambolle_prox

    g = _images(1, seed=2, scales=(1.0,))
    jx, _ = j_chambolle_prox(jnp.asarray(g[0]), 0.8, 25, tol=0.0)
    js, _ = chambolle_prox_streamed(jnp.asarray(g), 0.8, 25, tol=0.0, tile_rows=16,
                                    interpret=True)
    assert _rel(js[0], jx) > 1e-8
    f, _ = tb.chambolle_prox_blocked_emulated(torch.from_numpy(g), 0.8, 25, tol=0.0,
                                              geometry=(16, 16, K))
    pf, _ = tb.chambolle_prox_blocked_plain(torch.from_numpy(g), 0.8, 25, tol=0.0)
    assert torch.equal(f, pf)
    assert _rel(pf[0].numpy(), jx) <= REL


@pytest.mark.parametrize("tile_rows,positivity", [(16, True), (32, False)])
def test_fused_matches_jax_tiled(tile_rows, positivity):
    """Kernel G: the blocked fused step in the tiled kernel's form (the
    gradient divided by σ² before the call, σ² = 1 in the kernel)."""
    x, prox, grad, z = _step_inputs()
    sc = (0.03, 0.9, 0.04)
    for tol in (0.0, 1e-3):
        t = fused_step_cuda.myula_prox_tv_blocked(
            *_t(x, prox, grad, z), *sc, n_sweeps=25, tol=tol, positivity=positivity)
        j = myula_prox_tv_tiled(*_j(x, prox, grad, z), *sc, n_sweeps=25, tol=tol,
                                positivity=positivity, tile_rows=tile_rows, interpret=True)
        assert _rel(t[0].numpy(), j[0]) <= REL
        assert _rel(t[1].numpy(), j[1]) <= REL
        assert _rel(t[2].numpy(), j[2]) <= REL


@pytest.mark.parametrize("tile_rows,positivity", [(16, False), (32, True)])
def test_fused_matches_jax_streamed(tile_rows, positivity):
    """Kernel I: the raw gradient and σ² ≠ 1 go into the kernel."""
    x, prox, grad, z = _step_inputs(seed=6)
    sc = (0.03, 0.9, 0.04, 2.5)
    for tol in (0.0, 1e-3):
        t = fused_step_cuda.myula_prox_tv_blocked(
            *_t(x, prox, grad, z), *sc, n_sweeps=25, tol=tol, positivity=positivity)
        j = myula_prox_tv_streamed(*_j(x, prox, grad, z), *sc, n_sweeps=25, tol=tol,
                                   positivity=positivity, tile_rows=tile_rows,
                                   interpret=True)
        assert _rel(t[0].numpy(), j[0]) <= REL
        assert _rel(t[1].numpy(), j[1]) <= REL
        assert _rel(t[2].numpy(), j[2]) <= REL


# ---------------------------------------------------------------------------
# The kernel's launch schedule, emulated, against the whole-image prox
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,geometry", [
    ((3, 64, 64), (16, 16, K)),
    ((2, 64, 64), (24, 24, K)),     # a tile that does not divide the image
    ((2, 40, 56), (16, 16, K)),     # ragged
    ((1, 40, 56), None),            # the default 64x64 tile: one clamped window
])
@pytest.mark.parametrize("warm", [False, True])
def test_emulation_bit_equal_to_plain_at_tol0(shape, geometry, warm):
    g = torch.from_numpy(_images(shape[0], shape[1:], seed=4) * 255)
    duals = tuple(_t(*_duals(shape, 5))) if warm else None
    f, st = tb.chambolle_prox_blocked_emulated(g, 0.7, 25, tol=0.0, duals=duals,
                                               return_state=warm, geometry=geometry)
    pf, pst = tb.chambolle_prox_blocked_plain(g, 0.7, 25, tol=0.0, duals=duals,
                                              return_state=warm)
    assert torch.equal(f, pf)
    assert torch.equal(st.px, pst.px) and torch.equal(st.py, pst.py)
    assert st.iters.tolist() == pst.iters.tolist() == [25] * shape[0]


@pytest.mark.parametrize("shape,geometry,targets", [
    ((64, 64), (16, 16, K), (1, 5, K)),          # first sweep, mid-pass (redo), K
    ((64, 64), (24, 24, K), (K + 1, 12, 25)),    # K + 1, mid second pass, never
    ((40, 56), (16, 16, K), (3, K, K + 1)),      # ragged
])
def test_emulation_sweep_counts_match_plain(shape, geometry, targets):
    lam = 0.5
    g = torch.from_numpy(_stopping_batch(lam, targets, shape))
    f, st = tb.chambolle_prox_blocked_emulated(g, lam, 25, geometry=geometry)
    pf, pst = tb.chambolle_prox_blocked_plain(g, lam, 25)
    assert st.iters.tolist() == pst.iters.tolist() == list(targets)
    assert torch.equal(f, pf)   # the redo leaves each chain at its stopping sweep
    np.testing.assert_allclose(st.err.numpy(), pst.err.numpy(), rtol=1e-12)


def test_emulation_with_no_sweeps_returns_the_start():
    g = torch.from_numpy(_images(2, (40, 56)))
    duals = tuple(_t(*_duals(g.shape, 8)))
    for d in (None, duals):
        f, st = tb.chambolle_prox_blocked_emulated(g, 0.5, 0, duals=d, geometry=(16, 16, K))
        pf, pst = tb.chambolle_prox_blocked_plain(g, 0.5, 0, duals=d)
        assert torch.equal(f, pf) and torch.equal(st.px, pst.px)
        assert st.iters.tolist() == [0, 0] and torch.isinf(st.err).all()


def _hold_to_plain(g, lam, max_iter, geometry=None, duals=None):
    """The emulated schedule against the plain prox: bit-equal at tol=0;
    at tol=1e-3 the same sweep counts and fields.  Returns the counts."""
    for tol in (0.0, 1e-3):
        f, st = tb.chambolle_prox_blocked_emulated(g, lam, max_iter, tol=tol, duals=duals,
                                                   geometry=geometry)
        pf, pst = tb.chambolle_prox_blocked_plain(g, lam, max_iter, tol=tol, duals=duals)
        assert st.iters.tolist() == pst.iters.tolist()
        assert torch.equal(f, pf) and torch.equal(st.px, pst.px) and torch.equal(st.py, pst.py)
    return st.iters.tolist()


def _graded(B, shape, seed):
    """Chains of one field at decreasing scales: at λ = 0.5 and tol=1e-3
    the small ones stop early, the large ones run the whole budget."""
    g = _images(1, shape, seed=seed, scales=(1.0,))[0]
    return torch.from_numpy(np.stack([g * 10.0 ** (-4.9 + 1.2 * b) for b in range(B)]))


@pytest.mark.parametrize("max_iter", [0, 1, 7, 8, 9, 10, 25])
def test_emulation_follows_every_pass_split(max_iter):
    """blocked_geometry's halo and split for max_iter at a ragged shape of
    2 × 2 windows."""
    its = _hold_to_plain(_graded(3, (70, 150), 11), 0.5, max_iter)
    assert max(its) == max_iter


@pytest.mark.parametrize("geometry", [(20, 30, 8), (10, 51, 7), (34, 99, 7), (9, 17, 8)])
def test_emulation_at_window_widths_off_the_warp(geometry):
    """Windows 46, 65, 113 and 33 columns wide: the pass block's columns
    past the window are padding."""
    _hold_to_plain(_graded(3, (64, 96), 12), 0.5, 25, geometry=geometry)


@pytest.mark.parametrize("shape", [(2, 5, 7), (1, 2, 2), (2, 63, 3), (1, 64, 128), (2, 40, 100)])
@pytest.mark.parametrize("warm", [False, True])
def test_emulation_on_images_smaller_than_a_window(shape, warm):
    g = _graded(shape[0], shape[1:], 13) * 1e3
    duals = tuple(_t(*_duals(shape, 14))) if warm else None
    _hold_to_plain(g, 0.5, 10 if warm else 25, duals=duals)


@pytest.mark.parametrize("shape", [(2, 125, 191), (3, 100, 153)])
def test_emulation_on_ragged_shapes(shape):
    """1000 × 1528 at an eighth and a tenth: windows clamped at the right
    and bottom edges, tiles cut short by the image."""
    its = _hold_to_plain(_graded(shape[0], shape[1:], 15), 0.5, 25)
    assert len(set(its)) > 1


@functools.lru_cache(maxsize=None)
def _stop_scales(lam=0.5, shape=(48, 80), seed=16):
    """(base field, {t: a scale s at which the plain prox of s·base stops
    after t sweeps at tol=1e-3}), t = 1..25: a coarse grid of log-scales
    brackets the stops, a fine one resolves them, and each s is the middle
    of its run (at least 3 grid points), so no residual lies on the edge of
    tol."""
    base = np.random.default_rng(seed).standard_normal(shape)

    def iters(logs):
        g = torch.from_numpy(base[None] * 10.0 ** logs[:, None, None])
        return tb.chambolle_prox_blocked_plain(g, lam, 25)[1].iters.numpy()

    coarse = np.linspace(-8.0, 0.5, 86)
    its = iters(coarse)
    fine = np.linspace(coarse[np.nonzero(its == 1)[0].max() - 1],
                       coarse[np.nonzero(its == 25)[0].min()], 480)
    its = iters(fine)
    scales = {}
    for t in range(1, 26):
        idx = np.nonzero(its == t)[0]
        assert idx.size >= 3 and idx[-1] - idx[0] == idx.size - 1, (t, its)
        scales[t] = 10.0 ** fine[idx[idx.size // 2]]
    return base, scales


@pytest.mark.parametrize("first,last", [(1, 7), (8, 13), (20, 25)])
def test_emulation_with_a_chain_stopping_on_every_sweep_of_a_pass(first, last):
    """25 sweeps run as 7 + 6 + 6 + 6: one chain stops on each sweep of the
    first, second or last pass (the redo from the pass's source for every
    j* < limit, none at the pass's end), on 3 × 4 windows."""
    base, scales = _stop_scales()
    targets = list(range(first, last + 1))
    g = torch.from_numpy(np.stack([base * scales[t] for t in targets]))
    assert _hold_to_plain(g, 0.5, 25, geometry=(16, 24, 7)) == targets


# ---------------------------------------------------------------------------
# Wrappers, geometry, rungs
# ---------------------------------------------------------------------------

def test_wrappers_on_cpu_are_the_plain_versions():
    g = torch.from_numpy(_images(seed=9))
    f, st = tb.chambolle_prox_blocked(g, 0.5, 25)
    pf, pst = tb.chambolle_prox_blocked_plain(g, 0.5, 25)
    assert torch.equal(f, pf) and torch.equal(st.iters, pst.iters)
    f1, st1 = tb.chambolle_prox_blocked(g[0], 0.5, 25)   # a single image
    assert f1.shape == (SIZE, SIZE) and st1.iters.shape == ()
    x, prox, grad, z = _t(*_step_inputs())
    a = fused_step_cuda.myula_prox_tv_blocked(x, prox, grad, z, 0.03, 0.9, 0.04, 2.5)
    b = fused_step_cuda.myula_prox_tv_plain(x, prox, grad / 2.5, z, 0.03, 0.9, 0.04)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    with pytest.raises(ValueError):
        tb.chambolle_prox_blocked(g, 0.5, 5, duals=(g, g), return_state=False)


def test_wrappers_raise_on_other_devices():
    g = torch.zeros((1, 8, 8), device="meta")
    with pytest.raises(ValueError):
        tb.chambolle_prox_blocked(g, 0.5, 5)
    with pytest.raises(ValueError):
        fused_step_cuda.myula_prox_tv_blocked(g, g, g, g, 1.0, 1.0, 0.1)


def test_geometry_fits_shared_memory_and_the_kernel():
    """The pass block's 64 × 128 window (4 × 4 warps, 16-row strips); the
    halo is the longest pass of the split and the central tile the rest."""
    assert (tb.WINDOW_ROWS, tb.WINDOW_COLS) == (64, 128)
    assert tb.blocked_geometry(25) == (50, 114, 7, (7, 6, 6, 6))
    assert tb.blocked_geometry(10) == (54, 118, 5, (5, 5))
    assert tb.blocked_geometry(0) == (62, 126, 1, ())
    assert abs(tb.halo_factor(tb.blocked_geometry(25)) - 64 * 128 / (50 * 114)) < 1e-12
    assert tb.check_geometry((50, 114, 7), 1000, 1528, 25) == (50, 114, 7)
    assert tb.check_geometry((50, 114, 7), 5, 7, 25) == (50, 114, 7)      # one small window
    assert tb.check_geometry((60, 120, 7), 40, 56, 25) == (60, 120, 7)    # clamped to the image
    for geometry, max_iter in (((51, 114, 7), 25),    # a 65-row window
                               ((50, 115, 7), 25),    # a 129-column window
                               ((16, 16, 9), 9),      # K above the kernel's 8
                               ((16, 16, 6), 25)):    # a halo short of the 7-sweep pass
        with pytest.raises(ValueError):
            tb.check_geometry(geometry, 2048, 2048, max_iter)


@pytest.mark.parametrize("max_iter,split", [
    (0, ()), (1, (1,)), (7, (7,)), (8, (8,)), (9, (5, 4)), (10, (5, 5)), (17, (6, 6, 5)),
    (25, (7, 6, 6, 6)), (100, (8,) * 9 + (7,) * 4),
])
def test_pass_split(max_iter, split):
    assert tb.pass_split(max_iter) == split


def test_pass_split_is_balanced():
    for n in range(0, 130):
        split = tb.pass_split(n)
        assert sum(split) == n and len(split) == -(-n // tb.SWEEP_BLOCK)
        assert all(1 <= s <= tb.SWEEP_BLOCK for s in split)
        assert list(split) == sorted(split, reverse=True) and (not split or split[0] - split[-1] <= 1)


@pytest.mark.parametrize("shape,rung", [
    ((512, 512), None), ((480, 352), None), ((513, 512), "tiled"), ((1024, 1024), "tiled"),
    ((1000, 1048), "tiled"), ((1000, 1528), "streamed"), ((2048, 2048), "streamed"),
])
def test_blocked_rung(shape, rung):
    assert tb.blocked_rung(shape) == rung
