"""The resident kernel's schedule (csrc/tv_kernels.cu) on the CPU.

`tv_cuda.chambolle_prox_resident_emulated` replays the kernel's launch —
the groups of chains of `resident_geometry`, the stacked chains of a block
swept in turn between two barriers, per-tile residual partials in the
kernel's thread, warp and tile order, the per-chain fixed-order sum and
each chain's early exit — and `fused_step_cuda.myula_prox_tv_emulated` adds the
prologue's TV in the same order.  Both are held against the plain versions
in float64 (equal sweep counts, fields to 1e-12, the sums to 1e-12
relative: they differ only by their order of summation) and against the
JAX package's Pallas kernels in interpret mode.  The kernel itself is held
against the plain versions on the card by tests/test_torch_on_card.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semiblind_tv_tpu.ops.fused_step_pallas import myula_prox_tv as j_myula_prox_tv
from semiblind_tv_tpu.ops.tv_pallas import chambolle_prox_pallas
from semiblind_tv_tpu_torch.ops import fused_step_cuda, tv_cuda

TOL = 1e-12
SHAPES = [(3, 32, 32), (3, 20, 44), (2, 2, 2), (40, 16, 16)]
SMALL_CAPACITY = 16   # resident blocks: 40 chains of one 16×16 tile make three groups


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def _batch(shape, seed):
    """A smooth field with a little noise, the chains scaled from 1 down to
    1e-6, so that they stop on sweep 1, on odd and even sweeps and never."""
    B, M, N = shape
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:M, 0:N]
    base = np.sin(xx / 5.0) + np.cos(yy / 7.0)
    scales = np.logspace(0, -6, B) if B > 1 else np.ones(1)
    return np.stack([(base + 0.01 * rng.standard_normal((M, N))) * s for s in scales])


def _duals(shape, seed, scale):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape) * scale) for _ in range(2))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("warm", [False, True])
def test_resident_emulation_matches_plain_prox(shape, warm):
    g = torch.from_numpy(_batch(shape, seed=1))
    duals = _duals(shape, 2, 1e-6) if warm else None
    f, st = tv_cuda.chambolle_prox_resident_emulated(g, 0.5, 24, duals=duals,
                                                     capacity=SMALL_CAPACITY
                                                     if shape[1] <= 16 else None)
    pf, pst = tv_cuda.chambolle_prox_plain(g, 0.5, 24, duals=duals)
    np.testing.assert_array_equal(st.iters.numpy(), pst.iters.numpy())
    _close(f.numpy(), pf.numpy())
    _close(st.px.numpy(), pst.px.numpy())
    _close(st.py.numpy(), pst.py.numpy())
    np.testing.assert_allclose(st.err.numpy(), pst.err.numpy(), rtol=TOL)
    if shape[0] > 2:   # chains that stop early and chains that run all 24 sweeps
        assert min(st.iters.tolist()) < 24 == max(st.iters.tolist())


def test_resident_emulation_ends_on_sweep_one_odd_and_even_counts():
    """Chains that stop on sweep 1, on an odd count and on an even count,
    across three groups of one chain a block."""
    g = torch.from_numpy(_batch((40, 16, 16), seed=3))
    _, st = tv_cuda.chambolle_prox_resident_emulated(g, 0.5, 24, capacity=SMALL_CAPACITY,
                                                     stack_max=1)
    _, pst = tv_cuda.chambolle_prox_plain(g, 0.5, 24)
    its = st.iters.tolist()
    assert its == pst.iters.tolist()
    assert 1 in its and any(k % 2 and k > 1 for k in its) and any(k % 2 == 0 for k in its), its
    assert tv_cuda.resident_geometry(40, 16, 16, SMALL_CAPACITY, 1).groups == 3


# log10 of each chain's scale: at capacity 2 the 16x16 chains (one tile each)
# stack three to a block, block 0 holding chains 0, 2, 4 and block 1 chains
# 1, 3, 5 in the first group, chains 6 and 7 the second group
STACKED_SCALES = (-3.8, -3.72, -3.65, 0.0, -3.63, -3.69, -3.73, -3.67)
STACKED_ITERS = [1, 3, 15, 24, 20, 8, 2, 11]


def _stacked_batch():
    base = _batch((1, 16, 16), seed=3)[0]
    return torch.from_numpy(np.stack([base * 10.0 ** s for s in STACKED_SCALES]))


@pytest.mark.parametrize("warm", [False, True])
def test_stacked_emulation_chains_of_a_block_end_apart(warm):
    """The chains of one block stop on sweep 1, on an odd count and on an
    even count (block 0: 1, 15, 20); each leaves on its own residual while
    the block sweeps on, and the fields equal the plain prox's and the
    one-chain-a-block schedule's."""
    g = _stacked_batch()
    geo = tv_cuda.resident_geometry(*g.shape, 2, tv_cuda.DESIGN_STACK)
    assert (geo.stack, geo.chains, geo.groups, geo.grid) == (3, 6, 2, 2)
    duals = _duals(g.shape, 8, 1e-9) if warm else None
    f, st = tv_cuda.chambolle_prox_resident_emulated(g, 0.5, 24, duals=duals, capacity=2)
    f1, st1 = tv_cuda.chambolle_prox_resident_emulated(g, 0.5, 24, duals=duals, capacity=2,
                                                       stack_max=1)
    pf, pst = tv_cuda.chambolle_prox_plain(g, 0.5, 24, duals=duals)
    assert st.iters.tolist() == pst.iters.tolist() == st1.iters.tolist()
    if not warm:
        assert st.iters.tolist() == STACKED_ITERS
    for a, b in ((f, pf), (st.px, pst.px), (st.py, pst.py)):
        _close(a.numpy(), b.numpy())
    for a, b in ((f, f1), (st.px, st1.px), (st.py, st1.py), (st.err, st1.err)):
        assert torch.equal(a, b)
    np.testing.assert_allclose(st.err.numpy(), pst.err.numpy(), rtol=TOL)


@pytest.mark.parametrize("positivity", [True, False])
def test_stacked_emulated_fused_step_matches_plain(positivity):
    """Kernel B's launch with three chains a block (two groups): the TV rides
    on the shared first barrier; xn, proxn, tv and the sweeps as plain."""
    shape = (8, 16, 16)
    args = [torch.from_numpy(a) for a in _step_inputs(shape)]
    assert tv_cuda.resident_geometry(*shape, 2, tv_cuda.DESIGN_STACK).stack == 3
    xn, proxn, tv, iters = fused_step_cuda.myula_prox_tv_emulated(
        *args, 1.9, 2.0, 0.02, 25, positivity=positivity, capacity=2)
    pxn, pproxn, ptv = fused_step_cuda.myula_prox_tv_plain(*args, 1.9, 2.0, 0.02, 25,
                                                           positivity=positivity)
    _, pst = tv_cuda.chambolle_prox_plain(pxn, 0.02, 25)
    np.testing.assert_array_equal(xn.numpy(), pxn.numpy())
    _close(proxn.numpy(), pproxn.numpy())
    np.testing.assert_allclose(tv.numpy(), ptv.numpy(), rtol=TOL)
    np.testing.assert_array_equal(iters.numpy(), pst.iters.numpy())
    assert min(iters.tolist()) < 25


@pytest.mark.parametrize("warm", [False, True])
def test_resident_emulation_matches_pallas_interpret(warm):
    g = _batch((3, 32, 32), seed=4)
    if warm:
        px0, py0 = (d.numpy() for d in _duals(g.shape, 5, 0.1))
        f, st = tv_cuda.chambolle_prox_resident_emulated(
            torch.from_numpy(g), 0.3, 10, duals=(torch.from_numpy(px0), torch.from_numpy(py0)))
        jf, jst = chambolle_prox_pallas(jnp.asarray(g), 0.3, 10,
                                        duals=(jnp.asarray(px0), jnp.asarray(py0)),
                                        interpret=True)
    else:
        f, st = tv_cuda.chambolle_prox_resident_emulated(torch.from_numpy(g), 0.5, 25,
                                                         return_state=False)
        jf, jst = chambolle_prox_pallas(jnp.asarray(g), 0.5, 25, interpret=True,
                                        return_state=False)
    _close(f.numpy(), jf)
    _close(st.px.numpy(), jst.px)
    _close(st.py.numpy(), jst.py)
    np.testing.assert_array_equal(st.iters.numpy(), np.asarray(jst.iters))


def _step_inputs(shape, seed=6):
    rng = np.random.default_rng(seed)
    x = rng.random(shape) * 255
    x *= np.logspace(0, -6, shape[0])[:, None, None] if shape[0] > 1 else 1.0
    prox = x + rng.standard_normal(shape) * 0.1
    grad = rng.standard_normal(shape) * 0.01
    z = rng.standard_normal(shape)
    return x, prox, grad, z


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("positivity", [True, False])
def test_emulated_fused_step_matches_plain(shape, positivity):
    args = [torch.from_numpy(a) for a in _step_inputs(shape)]
    cap = SMALL_CAPACITY if shape[1] <= 16 else None
    xn, proxn, tv, iters = fused_step_cuda.myula_prox_tv_emulated(
        *args, 1.9, 2.0, 0.02, 25, positivity=positivity, capacity=cap)
    pxn, pproxn, ptv = fused_step_cuda.myula_prox_tv_plain(*args, 1.9, 2.0, 0.02, 25,
                                                           positivity=positivity)
    _, pst = tv_cuda.chambolle_prox_plain(pxn, 0.02, 25)
    np.testing.assert_array_equal(xn.numpy(), pxn.numpy())
    _close(proxn.numpy(), pproxn.numpy())
    np.testing.assert_allclose(tv.numpy(), ptv.numpy(), rtol=TOL)
    np.testing.assert_array_equal(iters.numpy(), pst.iters.numpy())


def test_emulated_fused_step_matches_pallas_interpret():
    x, prox, grad, z = _step_inputs((3, 32, 32))
    xn, proxn, tv, _ = fused_step_cuda.myula_prox_tv_emulated(
        *(torch.from_numpy(a) for a in (x, prox, grad, z)), 1.9, 2.0, 0.02, 25)
    j = j_myula_prox_tv(*(jnp.asarray(a) for a in (x, prox, grad, z)), 1.9, 2.0, 0.02, 25,
                        interpret=True)
    _close(xn.numpy(), j[0])
    _close(proxn.numpy(), j[1])
    np.testing.assert_allclose(tv.numpy(), np.asarray(j[2]), rtol=1e-10)


def test_sums_follow_the_kernels_order():
    """tile_sums and chain_total against sums written out in the kernel's
    order: thread strips, warp shuffle trees, warps; then the block's
    threads' strided sums, trees and warps."""
    TH, TW, R = tv_cuda.TILE_ROWS, tv_cuda.TILE_COLS, tv_cuda.STRIP_ROWS
    WX, WY, BT = tv_cuda.WARPS_X, tv_cuda.WARPS_Y, tv_cuda.BLOCK_THREADS
    rng = np.random.default_rng(7)
    M, N = TH + 8, TW + 6
    v = torch.from_numpy(rng.random((M, N)))
    sums = tv_cuda.tile_sums(v)
    assert sums.shape == (2 * 2,)
    pad = torch.zeros((2 * TH, 2 * TW), dtype=v.dtype)
    pad[:M, :N] = v
    for tile in range(4):
        ty, tx = divmod(tile, 2)
        t = pad[TH * ty:TH * (ty + 1), TW * tx:TW * (tx + 1)]
        warps = []
        for w in range(WX * WY):
            wy, wx = divmod(w, WX)
            lanes = [sum((t[R * wy + i, 32 * wx + lane] for i in range(1, R)),
                         t[R * wy, 32 * wx + lane]) for lane in range(32)]
            warps.append(tv_cuda._tree(torch.stack(lanes)))
        want = warps[0]
        for w in warps[1:]:
            want = want + w
        assert float(sums[tile]) == float(want)
    n = 2 * BT + 44
    parts = torch.from_numpy(rng.random(n))
    lanes = torch.zeros(BT, dtype=parts.dtype)
    for k in range(n):
        lanes[k % BT] = lanes[k % BT] + parts[k]
    warps = [tv_cuda._tree(lanes[32 * w:32 * w + 32]) for w in range(BT // 32)]
    want = warps[0]
    for w in warps[1:]:
        want = want + w
    assert float(tv_cuda.chain_total(parts)) == float(want)


@pytest.mark.parametrize("stack_max", [1, tv_cuda.DESIGN_STACK])
@pytest.mark.parametrize("B,M,N,capacity", [
    (1, 512, 512, None), (16, 512, 512, None), (3, 480, 353, None), (40, 256, 256, None),
    (2, 20, 44, None), (1, 2, 2, None), (40, 16, 16, SMALL_CAPACITY), (7, 100, 130, 20),
    (5, 512, 512, 396),
    # the walk form: one chain's tiles exceed the capacity
    (4, 1024, 1024, None), (1, 2048, 2048, None), (3, 1000, 1528, None), (1, 512, 512, 100),
    (2, 100, 130, 4), (1, 5000, 300, None),
])
def test_resident_geometry_covers_tiles_and_chains(B, M, N, capacity, stack_max):
    geo = tv_cuda.resident_geometry(B, M, N, capacity, stack_max)
    cap = tv_cuda.DESIGN_CAPACITY if capacity is None else capacity
    TH, TW = geo.tile
    assert (TH, TW) == (tv_cuda.TILE_ROWS, tv_cuda.TILE_COLS) == (32, 64)
    # the tiles cover the image, each pixel once
    gy, gx = -(-M // TH), -(-N // TW)
    assert geo.tiles == gy * gx and (gy - 1) * TH < M <= gy * TH and (gx - 1) * TW < N <= gx * TW
    # the grid fits the resident capacity
    assert geo.grid <= cap
    assert (geo.walk == 1) == (geo.tiles <= cap)
    # one chain a block whenever every chain fits so, else up to stack_max
    assert 1 <= geo.stack <= stack_max
    assert (geo.stack == 1) == (B * geo.tiles <= cap or stack_max == 1 or geo.walk > 1)
    if geo.walk == 1:
        per = cap // geo.tiles
        slots = geo.chains // geo.stack
        assert geo.chains == slots * geo.stack and geo.grid == slots * geo.tiles
        assert slots == min(B, per)
        if geo.stack > 1:
            assert geo.stack == min(-(-B // per), stack_max)
        # block k handles tile k mod T of chains g·C + j·slots + k / T, j <
        # stack: every chain once
        seen = [g * geo.chains + j * slots + k // geo.tiles for g in range(geo.groups)
                for k in range(0, geo.grid, geo.tiles) for j in range(geo.stack)
                if g * geo.chains + j * slots + k // geo.tiles < B]
    else:
        # one chain a group; block k sweeps tiles k, k + K, ...: every tile once
        assert geo.chains == 1 and geo.grid < geo.tiles and geo.stack == 1
        tiles = sorted(t for k in range(geo.grid) for t in range(k, geo.tiles, geo.grid))
        assert tiles == list(range(geo.tiles))
        assert max(len(range(k, geo.tiles, geo.grid)) for k in range(geo.grid)) == geo.walk
        seen = list(range(geo.groups))
    assert sorted(seen) == list(range(B))
    assert geo.groups == -(-B // geo.chains)
    if (B, M, N, capacity) == (16, 512, 512, None):   # the B = 16 cells: 8 groups, or 3
        assert (geo.groups, geo.stack) == ((8, 1) if stack_max == 1 else (3, 3))


def test_resident_geometry_rejects_what_does_not_fit():
    with pytest.raises(ValueError):
        tv_cuda.resident_geometry(0, 512, 512)       # no chain
    with pytest.raises(ValueError):
        tv_cuda.resident_geometry(1, 512, 512, 0)    # a card that holds no block
    with pytest.raises(ValueError):
        tv_cuda.resident_geometry(1, 1, 8)
    with pytest.raises(ValueError):
        tv_cuda.resident_geometry(16, 512, 512, None, 0)   # a kernel that holds no chain
    with pytest.raises(ValueError):
        fused_step_cuda.myula_prox_tv_emulated(*(torch.zeros((1, 64, 64)),) * 4, 1.0, 1.0, 0.1,
                                               capacity=0)


@pytest.mark.parametrize("B,M,N,capacity,stack_max,floats", [
    (16, 512, 512, None, 1, 2 * 256 * (288 + 2)),                     # resident: C·T = 256
    (16, 512, 512, None, 3, 2 * 768 * (288 + 2)),                     # stacked: C·T = 6·128
    (1, 2048, 2048, None, 3, 2 * 2048 * (288 + 2) + 2 * 2048 * 2048),  # walk: the duals too
])
def test_resident_workspace_floats(B, M, N, capacity, stack_max, floats):
    geo = tv_cuda.resident_geometry(B, M, N, capacity, stack_max)
    assert tv_cuda.BORDER_FLOATS == 288
    assert tv_cuda.resident_floats(geo, M, N) == floats


@pytest.mark.parametrize("warm", [False, True])
def test_resident_emulation_walk_form_matches_plain_prox(warm):
    """Chains of six tiles on a card of four blocks: the walk form, one chain
    a group, two tiles a block."""
    shape = (3, 40, 140)
    geo = tv_cuda.resident_geometry(*shape, 4)
    assert (geo.tiles, geo.chains, geo.groups, geo.grid, geo.walk) == (6, 1, 3, 3, 2)
    g = torch.from_numpy(_batch(shape, seed=5))
    duals = _duals(shape, 6, 1e-6) if warm else None
    f, st = tv_cuda.chambolle_prox_resident_emulated(g, 0.5, 24, duals=duals, capacity=4)
    pf, pst = tv_cuda.chambolle_prox_plain(g, 0.5, 24, duals=duals)
    np.testing.assert_array_equal(st.iters.numpy(), pst.iters.numpy())
    _close(f.numpy(), pf.numpy())
    _close(st.px.numpy(), pst.px.numpy())
    _close(st.py.numpy(), pst.py.numpy())
    np.testing.assert_allclose(st.err.numpy(), pst.err.numpy(), rtol=TOL)
