"""The CUDA kernels of the port against their plain versions, on the card.

Every test here needs a CUDA card and skips without one.  The file imports
neither jax nor the JAX package, so it runs on a machine that has only the
port's dependencies:

    python -m pytest --noconftest tests/test_torch_on_card.py -q

Inputs are float32; the kernels are built with --fmad=false.  The
resident kernel of csrc/tv_kernels.cu (A1, A2, B and C, one launch a call)
gives f, the duals, xn and proxn bit-equal to the plain versions, at tol=0
and at tol=1e-3 on chains that stop on different sweeps (B=40 at 256² in
several groups of chains, ragged 480×353 and 20×44, and chains of more
tiles than the card holds at once, in the walk form), also where operands
leave its fast quotient's range; the TV and the last residual, summed in
another order, within 1e-5; its barrier error code stays 0, ptxas reports
no spill, it gets the blocks an SM its design names, and a grid the card
cannot hold at once is refused and raises.  The other kernels' f, duals,
xn and proxn agree with the plain versions to 1e-5 of their largest
magnitude at a fixed sweep count (tol=0) — the residual and TV sums are
taken in another order — and the early exit stops on the same sweep.  The
blocked kernel (csrc/tv_blocked.cu) runs at shapes of several tiles with
ragged edges, and stops each chain on the same sweep as the plain version
and as its schedule's emulation on the CPU
(ops/tv_blocked_cuda.chambolle_prox_blocked_emulated).  λ goes in as a
device tensor: PyTorch's CUDA division by a Python number multiplies by
its reciprocal, which the kernel does not.

The blocked kernel also runs every pass split of tests/test_torch_blocked.py,
images smaller than its window, and chains outside its fast operators'
range (which rerun their passes on the IEEE operators); its occupancy and
fast operators are checked against their design.

The in-kernel noise (kernel C and I's seeds form) is held against the
plain versions run on the card, whose philox_normals uses the same IEEE
log/sqrt/sin/cos.  Kernels D and E sum their DFT products in another
order than torch.matmul, so at tol=0 their fields are held to 1e-5 of the
largest magnitude and their deviation from a float64 plain version to at
most twice the float32 plain version's; at tol=1e-3 their sweep counts
are held within one of the plain version's.  Their products alone
(`fused_dft_cuda.dft_products`, the 3×TF32 wgmma GEMM) are held to
torch.matmul with the same bounds, at a ragged 480×353 (B=3), at 256²
(B=1, the split-K plan) and at 512² (B=2), and their scratch buffers to
the layouts of the CPU emulation (`dft_products_emulated`).

Kernel J (csrc/prox_variants.cu) runs every mode of the probe against its
plain version with the bounds of tests/test_torch_prox_variants.py: f
within 1e-6 of max|f| in the float32 modes, within 1e-2 of the mode's own
distance from base in the bfloat16 modes, equal sweep counts; roll and
rollmul equal while exactly.

The run surface on the card (64²): a SAPG run interrupted after a
checkpoint and resumed equals the uninterrupted run within 1e-6 relative
through kernel B and through kernel D (fft_mode='dft'), and the resumed
run launches no warm-up step; TV-FISTA through A2 agrees with its plain
route on the card within 1e-5 of the largest magnitude; the posterior
moments at B=4 are finite, var ≥ 0, and equal the brute-force moments of
the same run's samples within 1e-5.

Per-chain scalars (the problems of a sharded run in one launch): A1, A2,
B, C, F and G called with one λ (and γ, λθ, σ²) a chain, as (B,) tensors,
equal their plain versions fed the same vectors bit for bit at a fixed
sweep count (tol 0), and each chain equals a call of that chain alone with
0-d scalars.
"""
import numpy as np
import pytest
import torch

from semiblind_tv_tpu_torch.benchmarks import probe_prox_variants
from semiblind_tv_tpu_torch.ops import fused_dft_cuda, fused_step_cuda, tv_blocked_cuda, tv_cuda
from semiblind_tv_tpu_torch.ops.fourier import irfft2_matmul, rdft_matrices, rfft2_matmul
from semiblind_tv_tpu_torch.ops.rng import philox_normals

REL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels of csrc/tv_kernels.cu run only there")
    return torch.device("cuda")


def _rel_err(a, b):
    """The largest per-chain relative deviation (a chain of small values is
    held to its own scale; (B,) vectors element by element)."""
    if a.ndim < 2:
        a, b = a.reshape(-1, 1), b.reshape(-1, 1)
    elif a.ndim == 2:
        a, b = a[None], b[None]
    d = (a - b).abs().flatten(1).amax(1)
    return float((d / b.abs().flatten(1).amax(1).clamp_min(1e-30)).max())


def _field(rng, shape, dev, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)


# ---------------------------------------------------------------------------
# The resident kernel (csrc/tv_kernels.cu): A1, A2, B and C, one launch a call
# ---------------------------------------------------------------------------

RESIDENT_SHAPES = [(1, 64, 64), (3, 48, 40), (2, 17, 33), (2, 20, 44), (1, 2, 2), (2, 100, 200)]
# chains of more tiles than the card's 264 blocks: the walk form (342 and 512 tiles)
WALK_SHAPES = [(2, 600, 1100), (1, 1024, 1024)]
_STEP_SCALARS = (1.9, 2.0, 0.02)


def _step_fields(rng, shape, dev):
    x = torch.from_numpy((rng.random(shape) * 255).astype(np.float32)).to(dev)
    return x, x + _field(rng, shape, dev, 0.1), _field(rng, shape, dev, 0.01)


def _resident_call(form, shape, dev, tol, seed=0, scales=None):
    """(kernel outputs, plain outputs, launches the call made) of one form
    on the same inputs; scales multiply the chains' inputs."""
    rng = np.random.default_rng(seed)
    sc = torch.ones(shape[0], 1, 1, device=dev) if scales is None else scales.to(dev)[:, None, None]
    if form in ("A1", "A2"):
        g = (torch.from_numpy((rng.random(shape) * 255).astype(np.float32)).to(dev) * sc)
        if form == "A1":
            duals = (_field(rng, shape, dev) * sc, _field(rng, shape, dev) * sc)
            args = (g, torch.tensor(20.0, device=dev), 10, 0.249, tol, duals)
        else:
            args = (g, torch.tensor(0.5, device=dev), 25, 0.249, tol, None, False)
        before = tv_cuda.LAUNCHES
        f, st = tv_cuda.chambolle_prox_cuda(*args)
        launches = tv_cuda.LAUNCHES - before
        pf, pst = tv_cuda.chambolle_prox_plain(*args)
        kernel = (f, st.px, st.py, st.iters, st.err)
        return kernel, (pf, pst.px, pst.py, pst.iters, pst.err), launches
    x, prox, grad = (v * sc for v in _step_fields(rng, shape, dev))
    scal = tuple(torch.tensor(v, device=dev) for v in _STEP_SCALARS)
    if form == "B":
        z = _field(rng, shape, dev)
        before = fused_step_cuda.LAUNCHES
        k = fused_step_cuda.myula_prox_tv(x, prox, grad, z, *scal, 25, tol=tol)
        launches = fused_step_cuda.LAUNCHES - before
        p = fused_step_cuda.myula_prox_tv_plain(x, prox, grad, z, *scal, 25, tol=tol)
    else:
        seeds = _seeds(rng, shape[0], dev)
        before = fused_step_cuda.RNG_LAUNCHES
        k = fused_step_cuda.myula_prox_tv_rng(x, prox, grad, seeds, *scal, 25, tol=tol)
        launches = fused_step_cuda.RNG_LAUNCHES - before
        p = fused_step_cuda.myula_prox_tv_rng_plain(x, prox, grad, seeds, *scal, 25, tol=tol)
    return k, p, launches


def _assert_resident_matches(form, k, p):
    """Fields bit-equal; sums (the TV, the last residual) within REL, as
    they are taken in another order; sweep counts equal."""
    if form in ("A1", "A2"):
        for a, b in zip(k[:3], p[:3]):
            assert torch.equal(a, b)
        assert torch.equal(k[3].cpu(), p[3].cpu())
        done = k[3] > 0
        assert _rel_err(k[4][done], p[4][done]) <= REL
    else:
        assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
        assert _rel_err(k[2], p[2]) <= REL
    assert tv_cuda.barrier_error() == 0


@pytest.mark.parametrize("shape", RESIDENT_SHAPES + WALK_SHAPES)
@pytest.mark.parametrize("form", ["A1", "A2", "B", "C"])
def test_resident_forms_bit_equal_to_plain(cuda_device, form, shape):
    """tol=0: every chain runs every sweep; one launch a call."""
    k, p, launches = _resident_call(form, shape, cuda_device, 0.0)
    torch.cuda.synchronize()
    assert launches == 1
    _assert_resident_matches(form, k, p)


@pytest.mark.parametrize("shape", [(40, 256, 256), (3, 480, 353), (2, 20, 44), (6, 100, 130),
                                   (4, 700, 1100)])
@pytest.mark.parametrize("form", ["A1", "A2", "B"])
def test_resident_sweep_counts_match_plain(cuda_device, form, shape):
    """tol=1e-3 on chains scaled from 1 down to 1e-9, which stop on sweep 1,
    on later sweeps or never; B=40 at 256² runs in five groups of chains
    (8 chains of 32 tiles a group at 264 blocks), 700×1100 in the walk
    form (396 tiles a chain)."""
    scales = torch.logspace(0, -9, shape[0]) if shape[0] > 1 else torch.ones(1)
    k, p, _ = _resident_call(form, shape, cuda_device, 1e-3, seed=3, scales=scales)
    torch.cuda.synchronize()
    _assert_resident_matches(form, k, p)
    if form == "A2" and shape[0] > 2:
        its = k[3].tolist()
        assert 1 in its and min(its) < max(its), its
    geo = tv_cuda.resident_geometry(*shape, tv_cuda.resident_capacity(cuda_device))
    if shape == (40, 256, 256):
        assert geo.groups > 1
    assert (geo.walk > 1) == (shape == (4, 700, 1100))


@pytest.mark.parametrize("scale", [1e-30, 1e30])
@pytest.mark.parametrize("form", ["A1", "A2"])
def test_resident_outside_the_fast_range_matches_plain(cuda_device, scale, form):
    """Operands below 2^-94 or quotients' denominators past 2^31: those warps
    take div_rn_exact through shared memory, the others the fast path."""
    shape = (2, 150, 260)
    scales = torch.tensor([scale, 1.0])
    k, p, _ = _resident_call(form, shape, cuda_device, 0.0, seed=10, scales=scales)
    torch.cuda.synchronize()
    for a, b in zip(k[:3], p[:3]):
        assert torch.equal(a, b)
    assert bool(torch.isfinite(k[0]).all())
    assert tv_cuda.barrier_error() == 0


def test_resident_occupancy_spills_and_exact_operators(cuda_device):
    """The resident kernel gets the blocks an SM its __launch_bounds__
    names, ptxas reports no spill in any of its four forms, and its exact quotient
    and root are IEEE's on a sample (chip_smoke.py checks every root)."""
    from semiblind_tv_tpu_torch._build import kernel_usage, load_library

    occ = tv_cuda.resident_occupancy(cuda_device)
    assert occ["blocks_per_sm"] == occ["launch_bounds_blocks"]
    assert occ["registers"] * occ["threads"] * occ["blocks_per_sm"] <= 65536
    usage = kernel_usage("resident_")
    assert sorted(usage) == ["resident_prox", "resident_prox_walk", "resident_step",
                             "resident_step_walk"], usage
    assert all(u["spill_stores"] == u["spill_loads"] == 0 for u in usage.values()), usage
    geo = tv_cuda.resident_geometry(16, 512, 512, tv_cuda.resident_capacity(cuda_device))
    assert geo.grid <= occ["blocks_per_sm"] * occ["sms"]
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    m = 1 << 22
    a = (torch.randint(0, 0x7F800000, (m,), generator=gen, device=cuda_device,
                       dtype=torch.int32).view(torch.float32))
    b = torch.cat([torch.exp2(torch.rand(m // 2, generator=gen, device=cuda_device) * 40 - 4),
                   a[torch.randperm(m // 2, generator=gen, device=cuda_device)]])
    zero = torch.zeros(2, device=cuda_device)
    a = torch.cat([a, -a[:1000], zero, -zero])   # −0 keeps its sign under '/'
    b = torch.cat([b, b[:1000], zero[:1], b[:1], b[:1], -b[:1]])
    q, r = torch.empty_like(a), torch.empty_like(a)
    lib = load_library()
    assert lib.sb_resident_exact_ops(a.data_ptr(), b.data_ptr(), q.data_ptr(), r.data_ptr(),
                                     a.numel(), torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    want = a / b
    same = (q.view(torch.int32) == want.view(torch.int32)) | (torch.isnan(q) & torch.isnan(want))
    assert bool(same.all())
    pos = a >= 0
    assert torch.equal(r[pos].view(torch.int32), torch.sqrt(a[pos]).view(torch.int32))


def test_resident_wrapper_raises_on_a_refused_launch(cuda_device, monkeypatch):
    """A grid larger than the card holds at once is refused by the
    cooperative launch: the wrapper raises, nothing falls back, and the
    next call runs."""
    cap = tv_cuda.resident_capacity(cuda_device)
    T = tv_cuda.resident_geometry(1, 512, 512, cap).tiles
    C = cap // T + 1
    g = torch.rand((C, 512, 512), device=cuda_device)
    geo = tv_cuda.ResidentGeometry((tv_cuda.TILE_ROWS, tv_cuda.TILE_COLS), T, C, 1, C * T, 1)
    before = tv_cuda.LAUNCHES
    with monkeypatch.context() as m:
        m.setattr(tv_cuda, "resident_geometry", lambda *args: geo)
        with pytest.raises(RuntimeError):
            tv_cuda.chambolle_prox_cuda(g, torch.tensor(0.5, device=cuda_device), 5)
    assert tv_cuda.LAUNCHES == before
    f, _ = tv_cuda.chambolle_prox_cuda(g[:1], torch.tensor(0.5, device=cuda_device), 5, tol=0.0)
    pf, _ = tv_cuda.chambolle_prox_plain(g[:1], torch.tensor(0.5, device=cuda_device), 5, tol=0.0)
    assert torch.equal(f, pf) and tv_cuda.barrier_error() == 0


@pytest.mark.parametrize("shape", [(1, 64, 64), (3, 48, 40), (2, 17, 33)])
def test_kernel_a_warm_matches_plain(cuda_device, shape):
    k, p, launches = _resident_call("A1", shape, cuda_device, 0.0)
    torch.cuda.synchronize()
    assert launches == 1
    _assert_resident_matches("A1", k, p)


def test_kernel_a_fresh_early_exit_matches_plain(cuda_device):
    yy, xx = np.mgrid[0:64, 0:64]
    base = (np.sin(xx / 5.0) + np.cos(yy / 7.0)).astype(np.float32)
    g = torch.from_numpy(np.stack([base * s for s in (1e-5, 1e-4, 1.0)])).to(cuda_device)
    lam = torch.tensor(0.5, device=cuda_device)
    f, st = tv_cuda.chambolle_prox_cuda(g, lam, 25, return_state=False)
    pf, pst = tv_cuda.chambolle_prox_plain(g, lam, 25, return_state=False)
    torch.cuda.synchronize()
    assert torch.equal(st.iters.cpu(), pst.iters.cpu())
    assert st.iters[0] < 25 and st.iters[2] == 25
    assert torch.equal(f, pf)
    assert float(st.px.abs().max()) == 0.0


@pytest.mark.parametrize("positivity", [True, False])
def test_kernel_b_matches_plain(cuda_device, positivity):
    rng = np.random.default_rng(1)
    shape = (2, 48, 40)
    x, prox, grad = _step_fields(rng, shape, cuda_device)
    z = _field(rng, shape, cuda_device)
    args = tuple(torch.tensor(v, device=cuda_device) for v in _STEP_SCALARS)
    before = fused_step_cuda.LAUNCHES
    k = fused_step_cuda.myula_prox_tv(x, prox, grad, z, *args, 25, tol=0.0,
                                      positivity=positivity)
    p = fused_step_cuda.myula_prox_tv_plain(x, prox, grad, z, *args, 25, tol=0.0,
                                            positivity=positivity)
    torch.cuda.synchronize()
    assert fused_step_cuda.LAUNCHES == before + 1
    _assert_resident_matches("B", k, p)


@pytest.mark.parametrize("shape", [(1, 200, 300), (2, 130, 70), (3, 75, 64)])
@pytest.mark.parametrize("warm", [False, True])
def test_blocked_prox_matches_plain(cuda_device, shape, warm):
    rng = np.random.default_rng(2)
    g = torch.from_numpy((rng.random(shape) * 255).astype(np.float32)).to(cuda_device)
    duals = (_field(rng, shape, cuda_device, 0.1), _field(rng, shape, cuda_device, 0.1)) \
        if warm else None
    lam = torch.tensor(20.0, device=cuda_device)
    before = tv_blocked_cuda.LAUNCHES
    f, st = tv_blocked_cuda.chambolle_prox_blocked(g, lam, 25, tol=0.0, duals=duals,
                                                   return_state=warm)
    pf, pst = tv_blocked_cuda.chambolle_prox_blocked_plain(g, lam, 25, tol=0.0, duals=duals,
                                                           return_state=warm)
    torch.cuda.synchronize()
    assert tv_blocked_cuda.LAUNCHES == before + 1
    assert _rel_err(f, pf) <= REL
    assert _rel_err(st.px, pst.px) <= REL and _rel_err(st.py, pst.py) <= REL
    assert st.iters.tolist() == pst.iters.tolist() == [25] * shape[0]


def test_blocked_prox_early_exit_matches_plain_and_emulation(cuda_device):
    """Chains that stop at sweep 1, inside a pass (the redo) and never."""
    rng = np.random.default_rng(7)
    base = rng.standard_normal((96, 160)).astype(np.float32)
    scales = np.array([1e-7, 0.0, 1.0], dtype=np.float32)
    # a scale that stops inside the second pass (sweeps 8-13 of 7+6+6+6),
    # found with the plain version
    logs = np.linspace(-6, 0, 121, dtype=np.float32)
    probe = torch.from_numpy(base[None] * 10.0 ** logs[:, None, None]).to(cuda_device)
    its = tv_blocked_cuda.chambolle_prox_blocked_plain(probe, 0.5, 25)[1].iters.cpu().numpy()
    mid = np.nonzero((its > 7) & (its < 13))[0]
    assert mid.size, its
    scales[1] = 10.0 ** logs[mid[mid.size // 2]]
    g = torch.from_numpy(base[None] * scales[:, None, None]).to(cuda_device)
    f, st = tv_blocked_cuda.chambolle_prox_blocked(g, 0.5, 25)
    pf, pst = tv_blocked_cuda.chambolle_prox_blocked_plain(g, 0.5, 25)
    ef, est = tv_blocked_cuda.chambolle_prox_blocked_emulated(g.cpu(), 0.5, 25)
    torch.cuda.synchronize()
    assert st.iters.tolist() == pst.iters.tolist() == est.iters.tolist()
    assert st.iters[0] == 1 and 7 < st.iters[1] < 13 and st.iters[2] == 25
    assert _rel_err(f, pf) <= REL
    # PyTorch's CPU and CUDA elementwise operations differ in the last bit
    # now and then, so the CPU emulation is held to the kernel by tolerance
    assert _rel_err(f.cpu(), ef) <= REL
    np.testing.assert_allclose(st.err.cpu().numpy(), est.err.numpy(), rtol=1e-5)


@pytest.mark.parametrize("sigma2,positivity", [(1.0, True), (2.5, False), (0.7, True)])
def test_blocked_fused_step_matches_plain(cuda_device, sigma2, positivity):
    rng = np.random.default_rng(3)
    shape = (2, 150, 210)
    x = torch.from_numpy((rng.random(shape) * 255).astype(np.float32)).to(cuda_device)
    prox = x + _field(rng, shape, cuda_device, 0.1)
    grad = _field(rng, shape, cuda_device, 0.01)
    z = _field(rng, shape, cuda_device)
    args = tuple(torch.tensor(v, device=cuda_device) for v in (1.9, 2.0, 0.02, sigma2))
    before = fused_step_cuda.BLOCKED_LAUNCHES
    k = fused_step_cuda.myula_prox_tv_blocked(x, prox, grad, z, *args, n_sweeps=25, tol=0.0,
                                              positivity=positivity)
    p = fused_step_cuda.myula_prox_tv_blocked_plain(x, prox, grad, z, *args, n_sweeps=25,
                                                    tol=0.0, positivity=positivity)
    torch.cuda.synchronize()
    assert fused_step_cuda.BLOCKED_LAUNCHES == before + 1
    for a, b in zip(k, p):
        assert _rel_err(a, b) <= REL


@pytest.mark.parametrize("max_iter", [0, 1, 7, 8, 9, 10, 25])
def test_blocked_prox_pass_splits_match_plain(cuda_device, max_iter):
    """Each budget's balanced split and halo (blocked_geometry), ragged 2 × 3
    windows: the fields at tol=0, the sweep counts at tol=1e-3."""
    rng = np.random.default_rng(9)
    g = torch.from_numpy((rng.random((2, 130, 270)) * 255).astype(np.float32)).to(cuda_device)
    g[1] *= 1e-4
    lam = torch.tensor(0.5, device=cuda_device)
    for tol in (0.0, 1e-3):
        f, st = tv_blocked_cuda.chambolle_prox_blocked(g, lam, max_iter, tol=tol)
        pf, pst = tv_blocked_cuda.chambolle_prox_blocked_plain(g, lam, max_iter, tol=tol)
        torch.cuda.synchronize()
        assert st.iters.tolist() == pst.iters.tolist()
        assert _rel_err(f, pf) <= REL
        assert _rel_err(st.px, pst.px) <= REL and _rel_err(st.py, pst.py) <= REL


@pytest.mark.parametrize("shape", [(2, 5, 7), (1, 2, 2), (2, 63, 3), (1, 64, 128)])
@pytest.mark.parametrize("warm", [False, True])
def test_blocked_prox_on_images_smaller_than_a_window(cuda_device, shape, warm):
    test_blocked_prox_matches_plain(cuda_device, shape, warm)


@pytest.mark.parametrize("scale", [1e-30, 1e30])
def test_blocked_prox_outside_the_fast_range_matches_plain(cuda_device, scale):
    """Operands below 2^-94 or above the 2^20 input bound: those tiles rerun
    their passes on the IEEE operators, the others keep the fast paths."""
    rng = np.random.default_rng(10)
    g = torch.from_numpy((rng.random((2, 150, 260)) * 255).astype(np.float32)).to(cuda_device)
    g[0] *= scale
    lam = torch.tensor(0.5, device=cuda_device)
    f, st = tv_blocked_cuda.chambolle_prox_blocked(g, lam, 25, tol=0.0)
    pf, pst = tv_blocked_cuda.chambolle_prox_blocked_plain(g, lam, 25, tol=0.0)
    torch.cuda.synchronize()
    assert _rel_err(f, pf) <= REL and _rel_err(st.px, pst.px) <= REL
    assert bool(torch.isfinite(f).all())


def test_blocked_pass_occupancy_and_fast_operators(cuda_device):
    """The pass kernel gets the blocks per SM its __launch_bounds__ names,
    spills nothing, and its fast quotient and root are IEEE's on a sample of
    their range (chip_smoke.py checks the whole root range)."""
    import ctypes

    from semiblind_tv_tpu_torch._build import load_library

    lib = load_library()
    occ = (ctypes.c_int * 5)()
    assert lib.sb_blocked_occupancy(occ) == 0
    blocks, regs, local, threads, bound_blocks = list(occ)
    assert blocks == bound_blocks and local == 0 and threads == 32 * 4 * 4
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    m = 1 << 24
    a = torch.exp2(torch.rand(m, generator=gen, device=cuda_device) * 154 - 94)
    a = torch.cat([a, -a[:1000], torch.zeros(2, device=cuda_device)])
    b = torch.exp2(torch.rand(a.numel(), generator=gen, device=cuda_device) * 31)
    q, r = torch.empty_like(a), torch.empty_like(a)
    assert lib.sb_blocked_fast_ops(a.data_ptr(), b.data_ptr(), q.data_ptr(), r.data_ptr(),
                                   a.numel(), torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(q.view(torch.int32), (a / b).view(torch.int32))
    pos = a >= 0
    assert torch.equal(r[pos].view(torch.int32), torch.sqrt(a[pos]).view(torch.int32))


def _seeds(rng, B, dev):
    return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (B, 2)).astype(np.int32)).to(dev)


@pytest.mark.parametrize("shape,positivity", [((2, 48, 40), True), ((1, 17, 33), False)])
def test_kernel_c_matches_plain(cuda_device, shape, positivity):
    rng = np.random.default_rng(4)
    x, prox, grad = _step_fields(rng, shape, cuda_device)
    seeds = _seeds(rng, shape[0], cuda_device)
    args = tuple(torch.tensor(v, device=cuda_device) for v in _STEP_SCALARS)
    before = fused_step_cuda.RNG_LAUNCHES
    k = fused_step_cuda.myula_prox_tv_rng(x, prox, grad, seeds, *args, 25, tol=0.0,
                                          positivity=positivity)
    p = fused_step_cuda.myula_prox_tv_rng_plain(x, prox, grad, seeds, *args, 25, tol=0.0,
                                                positivity=positivity)
    torch.cuda.synchronize()
    assert fused_step_cuda.RNG_LAUNCHES == before + 1
    _assert_resident_matches("C", k, p)
    # x = prox = grad = 0, γ = 0.5, no positivity: xn is the raw noise field
    zero = torch.zeros_like(x)
    xn = fused_step_cuda.myula_prox_tv_rng(zero, zero, zero, seeds, 0.5, 1.0, 0.02, 1,
                                           positivity=False)[0]
    assert _rel_err(xn, philox_normals(seeds, shape[1:])) <= REL


@pytest.mark.parametrize("sigma2,positivity", [(1.0, True), (2.5, False)])
def test_blocked_seeds_form_matches_plain(cuda_device, sigma2, positivity):
    rng = np.random.default_rng(5)
    shape = (2, 150, 210)
    x = torch.from_numpy((rng.random(shape) * 255).astype(np.float32)).to(cuda_device)
    prox = x + _field(rng, shape, cuda_device, 0.1)
    grad = _field(rng, shape, cuda_device, 0.01)
    seeds = _seeds(rng, 2, cuda_device)
    args = tuple(torch.tensor(v, device=cuda_device) for v in (1.9, 2.0, 0.02, sigma2))
    before = fused_step_cuda.BLOCKED_SEEDS_LAUNCHES
    k = fused_step_cuda.myula_prox_tv_blocked(x, prox, grad, None, *args, n_sweeps=25,
                                              tol=0.0, positivity=positivity, seeds=seeds)
    p = fused_step_cuda.myula_prox_tv_blocked_plain(x, prox, grad, None, *args, n_sweeps=25,
                                                    tol=0.0, positivity=positivity, seeds=seeds)
    torch.cuda.synchronize()
    assert fused_step_cuda.BLOCKED_SEEDS_LAUNCHES == before + 1
    for a, b in zip(k, p):
        assert _rel_err(a, b) <= REL


@pytest.mark.parametrize("shape", [(1, 64, 64), (2, 48, 35), (3, 40, 56)])
@pytest.mark.parametrize("kernel", ["D", "E"])
def test_dft_kernels_match_plain(cuda_device, shape, kernel):
    rng = np.random.default_rng(6)
    B, M, N = shape
    x = torch.from_numpy((rng.random(shape) * 255).astype(np.float32)).to(cuda_device)
    prox = x + _field(rng, shape, cuda_device, 0.1)
    z = _field(rng, shape, cuda_device)
    ghat = torch.fft.rfft2(_field(rng, shape, cuda_device, 0.025)).contiguous()
    mats = rdft_matrices((M, N), torch.float32, cuda_device)
    mats64 = rdft_matrices((M, N), torch.float64, cuda_device)
    args = tuple(torch.tensor(v, device=cuda_device) for v in (1.9, 2.0, 0.02, 2.5))
    fn, plain, counter = {
        "D": (fused_dft_cuda.myula_prox_tv_dft, fused_dft_cuda.myula_prox_tv_dft_plain,
              "DFT_LAUNCHES"),
        "E": (fused_dft_cuda.myula_prox_tv_irdft, fused_dft_cuda.myula_prox_tv_irdft_plain,
              "IRDFT_LAUNCHES"),
    }[kernel]
    before = getattr(fused_dft_cuda, counter)
    k = fn(ghat, x, prox, z, mats, *args, tol=0.0)
    p = plain(ghat, x, prox, z, mats, *args, tol=0.0)
    p64 = plain(ghat.to(torch.complex128), x.double(), prox.double(), z.double(), mats64,
                *(a.double() for a in args), tol=0.0)
    torch.cuda.synchronize()
    assert getattr(fused_dft_cuda, counter) == before + 1
    for i in (0, 1, 3)[:len(k) - 1]:   # xn, proxn, x̂
        a, b, c = (t if not t.is_complex() else torch.view_as_real(t) for t in (k[i], p[i], p64[i]))
        assert _rel_err(a, b) <= REL
        assert _rel_err(a.double(), c) <= 2 * _rel_err(b.double(), c)
    assert _rel_err(k[2], p[2]) <= REL
    # tol=1e-3: sweep counts within one of the plain version's
    ki = fn(ghat, x, prox, z, mats, *args, return_iters=True)[-1]
    pi = plain(ghat, x, prox, z, mats, *args, return_iters=True)[-1]
    assert (ki.cpu() - pi.cpu()).abs().max() <= 1


@pytest.mark.parametrize("shape", [(1, 256, 256), (3, 480, 353), (2, 512, 512)])
@pytest.mark.parametrize("kernel", ["D", "E"])
def test_dft_kernels_match_plain_at_the_gemm_plans(cuda_device, shape, kernel):
    """D and E through each tile plan of the GEMM (split-K, 64×64, 128×128
    grids of several waves) with the bounds of test_dft_kernels_match_plain."""
    test_dft_kernels_match_plain(cuda_device, shape, kernel)


@pytest.mark.parametrize("shape", [(3, 480, 353), (1, 256, 256), (2, 512, 512)])
def test_dft_gemm_products_match_torch_matmul(cuda_device, shape):
    B, M, N = shape
    rng = np.random.default_rng(10)
    x = torch.from_numpy((rng.random(shape) * 255).astype(np.float32)).to(cuda_device)
    ghat = torch.fft.rfft2(_field(rng, shape, cuda_device)).contiguous()
    mats = rdft_matrices((M, N), torch.float32, cuda_device)
    mats64 = rdft_matrices((M, N), torch.float64, cuda_device)
    before = fused_dft_cuda.PRODUCTS_LAUNCHES
    grad, xhat, scratch = fused_dft_cuda.dft_products(ghat, x, mats, return_scratch=True)
    torch.cuda.synchronize()
    assert fused_dft_cuda.PRODUCTS_LAUNCHES == before + 1
    real = lambda t: torch.view_as_real(t) if t.is_complex() else t  # noqa: E731
    ref32 = (irfft2_matmul(ghat, mats), rfft2_matmul(x, mats))
    ref64 = (irfft2_matmul(ghat.to(torch.complex128), mats64), rfft2_matmul(x.double(), mats64))
    for a, b, c in zip((grad, xhat), ref32, ref64):
        a, b, c = real(a), real(b), real(c)
        assert _rel_err(a, b) <= REL
        assert _rel_err(a.double(), c) <= 2 * _rel_err(b.double(), c)
    # the scratch in the layouts of the CPU emulation: the repack and the
    # split exactly, the products' outputs within REL
    g = fused_dft_cuda.dft_geometry(B, M, N)
    _, _, emu = fused_dft_cuda.dft_products_emulated(
        ghat, x, fused_dft_cuda.packed_factors(mats), return_scratch=True)
    for name, K in (("gbuf", 2 * M), ("xbuf", N), ("ybuf", 2 * g["Nhp"]), ("fbuf", 2 * M)):
        got, want = scratch[name][..., :K], emu[name][..., :K]
        if name in ("gbuf", "xbuf"):
            assert torch.equal(got, want), name
        else:
            assert _rel_err((got[0] + got[1])[None], (want[0] + want[1])[None]) <= REL, name
    # E's products alone leave x̂ out
    g_e, none = fused_dft_cuda.dft_products(ghat, x, mats, forward=False)
    assert none is None and _rel_err(g_e, grad) <= REL


@pytest.mark.parametrize("mode", probe_prox_variants.MODES)
def test_prox_variant_matches_plain(cuda_device, mode):
    pv = probe_prox_variants
    g = (np.random.default_rng(8).random((3, 64, 64)) * 255.0).astype(np.float32)
    g[0] *= 0.25   # stops earlier at the decisive tol
    g = torch.from_numpy(g).to(cuda_device)
    for lam, tol in ((0.08, 0.0), (20.0, 8.0)):
        scal = torch.tensor([lam, 0.249, tol], device=cuda_device)
        before = pv.LAUNCHES
        f, meta = pv.prox_variant(mode, g, scal, 25)
        pf, pmeta = pv.prox_variant_plain(mode, g, scal, 25)
        torch.cuda.synchronize()
        assert pv.LAUNCHES == before + 1
        d = float((f - pf).abs().max())
        if mode in pv.BF16_MODES:
            f_base = pv.prox_variant_plain("base", g, scal, 25)[0]
            assert d <= 1e-2 * float((pf - f_base).abs().max())
        else:
            assert d <= 1e-6 * float(pf.abs().max())
        assert torch.equal(meta[:, 0], pmeta[:, 0])
        if tol and mode not in pv.NO_RESIDUAL:
            k = meta[:, 0].tolist()
            assert max(k) < 25 and (k[0] < k[1] or mode == "every5"), k
            assert _rel_err(meta[:, 1], pmeta[:, 1]) <= 1e-3
        if mode in ("roll", "rollmul"):
            wf, wmeta = pv.prox_variant("while", g, scal, 25)
            assert torch.equal(f, wf) and torch.equal(meta, wmeta)
    with pytest.raises(ValueError):
        pv.prox_variant(mode, g, scal[:2].contiguous(), 25)


def test_wrappers_raise_on_bad_inputs(cuda_device):
    g = torch.zeros((1, 16, 16), device=cuda_device)
    with pytest.raises(TypeError):
        tv_cuda.chambolle_prox_cuda(g.double(), 0.5, 5)
    with pytest.raises(ValueError):
        tv_cuda.chambolle_prox_cuda(g.transpose(1, 2), 0.5, 5)
    with pytest.raises(ValueError):
        tv_cuda.chambolle_prox_cuda(g, torch.tensor(0.5), 5)  # λ on the host
    with pytest.raises(TypeError):
        tv_blocked_cuda.chambolle_prox_blocked(g.double(), 0.5, 5)
    with pytest.raises(ValueError):
        fused_step_cuda.myula_prox_tv_blocked(g, g, g, g.transpose(1, 2), 1.0, 1.0, 0.1)
    with pytest.raises(ValueError):
        fused_step_cuda.myula_prox_tv_rng(g, g, g, torch.zeros((2, 2), dtype=torch.int32,
                                                               device=cuda_device), 1.0, 1.0, 0.1)
    with pytest.raises(ValueError):
        fused_dft_cuda.myula_prox_tv_dft(torch.zeros((1, 16, 9), dtype=torch.complex64,
                                                     device=cuda_device), g, g, g,
                                         rdft_matrices((16, 16), torch.float64, cuda_device),
                                         1.0, 1.0, 0.1, 1.0)


def _card_run_problem(cuda_device, size=64, **sapg):
    import dataclasses

    from semiblind_tv_tpu_torch.runtime.config import gaussian_preset
    from semiblind_tv_tpu_torch.runtime.problem import build_problem
    from semiblind_tv_tpu_torch.utils.images import synthetic_wheel

    cfg = gaussian_preset(fix_w1=False, fix_w2=False)
    cfg = dataclasses.replace(cfg, sapg=dataclasses.replace(cfg.sapg, **sapg))
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    return build_problem(synthetic_wheel(size), cfg, gen, device=cuda_device)


class _Preempted(Exception):
    pass


@pytest.mark.parametrize("fft_mode,row", [("fft", "B"), ("dft", "D")])
def test_resume_equals_uninterrupted_run_on_the_card(cuda_device, tmp_path, fft_mode, row):
    from semiblind_tv_tpu_torch.sapg.estimator import run_sapg

    samples, every = 40, 10
    problem = _card_run_problem(cuda_device, samples=samples, warmup=10, burn_in=32,
                                fft_mode=fft_mode)

    def gen():
        return torch.Generator(device=cuda_device).manual_seed(2)

    def launches():
        return (fused_step_cuda.LAUNCHES if row == "B" else fused_dft_cuda.DFT_LAUNCHES)

    full = run_sapg(problem, gen())
    ckpt = str(tmp_path / "sapg.npz")

    def preempt(seg_idx, carry):
        if seg_idx == 2:
            raise _Preempted()
        return carry

    with pytest.raises(_Preempted):
        run_sapg(problem, gen(), checkpoint_every=every, checkpoint_path=ckpt,
                 fault_hook=preempt)
    before = launches()
    resumed = run_sapg(problem, torch.Generator(device=cuda_device).manual_seed(9),
                       checkpoint_every=every, checkpoint_path=ckpt)
    assert launches() - before == samples - 1 - 2 * every   # no warm-up step
    for a, b in ((resumed.thetas, full.thetas), (resumed.sigma2s, full.sigma2s),
                 (resumed.psf_param_traces["w1"], full.psf_param_traces["w1"]),
                 (resumed.X_last, full.X_last)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * np.abs(b).max())


def test_fista_through_a2_matches_the_plain_route_on_the_card(cuda_device):
    from semiblind_tv_tpu_torch.solvers.fista import fista_tv

    problem = _card_run_problem(cuda_device, samples=2, warmup=1)
    kw = dict(tau=0.05 * float(problem.sigma_true) ** 2, blur=problem.blur, max_iter=40, tol=0.0)
    before = tv_cuda.FRESH_LAUNCHES
    kern = fista_tv(problem.y, problem.H_true, **kw)
    assert tv_cuda.FRESH_LAUNCHES - before == 40
    plain = fista_tv(problem.y, problem.H_true, prox_route="plain", **kw)
    assert kern.n_iters == plain.n_iters == 40
    scale = np.abs(plain.x).max()
    assert np.abs(kern.x - plain.x).max() <= 1e-5 * scale
    np.testing.assert_allclose(kern.objective, plain.objective, rtol=1e-5)


def test_posterior_moments_on_the_card(cuda_device):
    from semiblind_tv_tpu_torch.sapg.estimator import run_sapg

    problem = _card_run_problem(cuda_device, samples=30, warmup=5, burn_in=10,
                                track_posterior_moments=True)
    seen = []

    def record(seg_idx, carry):
        seen.append(carry[0].cpu().numpy())
        return carry

    res = run_sapg(problem, torch.Generator(device=cuda_device).manual_seed(2), n_chains=4,
                   checkpoint_every=1, fault_hook=record)
    assert res.posterior_mean.shape == (4, 64, 64)
    assert np.all(np.isfinite(res.posterior_mean)) and np.all(np.isfinite(res.posterior_var))
    assert np.all(res.posterior_var >= 0)
    xs = np.stack(seen[10:] + [res.X_last]).astype(np.float64)
    scale = np.abs(xs).max()
    assert np.abs(res.posterior_mean - xs.mean(0)).max() <= 1e-5 * scale
    assert np.abs(res.posterior_var - xs.var(0, ddof=1)).max() <= 1e-5 * scale ** 2


# ---------------------------------------------------------------------------
# Per-chain scalars: one value a chain, as the sharded path's batched step
# gives them
# ---------------------------------------------------------------------------

def _chain_scalar_call(form, dev, sl=slice(None)):
    """(kernel outputs, plain outputs) of `form` with (B,) scalars on the
    chains `sl` of fixed inputs (tol 0: a fixed sweep count)."""
    rng = np.random.default_rng(11)
    big = form in ("F", "G")
    shape = (3, 520, 600) if big else (3, 96, 130)
    vec = {k: torch.tensor(v, device=dev)[sl] for k, v in (
        ("lam", [20.0, 3.0, 60.0]), ("gam", [1.9, 1.2, 0.7]), ("lam_step", [2.0, 1.0, 3.0]),
        ("lt", [0.02, 0.5, 0.1]), ("s2", [1.0, 4.0, 0.5]))}
    g = torch.from_numpy((rng.random(shape) * 255).astype(np.float32)).to(dev)[sl].contiguous()
    if form in ("A1", "A2", "F"):
        duals = (_field(rng, shape, dev)[sl].contiguous(), _field(rng, shape, dev)[sl].contiguous())
        fn = tv_blocked_cuda.chambolle_prox_blocked if form == "F" else tv_cuda.chambolle_prox_cuda
        if form == "A2":
            args = (g, vec["lam"] / 40, 25, 0.249, 0.0, None, False)
        else:
            args = (g, vec["lam"], 10, 0.249, 0.0, duals)
        k = fn(*args)
        p = tv_cuda.chambolle_prox_plain(*args)
        return (k[0], k[1].px, k[1].py), (p[0], p[1].px, p[1].py)
    x, prox, grad = (v[sl].contiguous() for v in _step_fields(rng, shape, dev))
    scal = (vec["gam"], vec["lam_step"], vec["lt"])
    kw = dict(n_sweeps=25, tol=0.0)
    if form == "B":
        z = _field(rng, shape, dev)[sl].contiguous()
        k = fused_step_cuda.myula_prox_tv(x, prox, grad, z, *scal, **kw)
        p = fused_step_cuda.myula_prox_tv_plain(x, prox, grad, z, *scal, **kw)
    elif form == "C":
        seeds = _seeds(rng, shape[0], dev)[sl].contiguous()
        k = fused_step_cuda.myula_prox_tv_rng(x, prox, grad, seeds, *scal, **kw)
        p = fused_step_cuda.myula_prox_tv_rng_plain(x, prox, grad, seeds, *scal, **kw)
    else:
        z = _field(rng, shape, dev)[sl].contiguous()
        k = fused_step_cuda.myula_prox_tv_blocked(x, prox, grad, z, *scal, vec["s2"], **kw)
        p = fused_step_cuda.myula_prox_tv_blocked_plain(x, prox, grad, z, *scal, vec["s2"], **kw)
    return k[:2], p[:2]


@pytest.mark.parametrize("form", ["A1", "A2", "B", "C", "F", "G"])
def test_chain_scalars_kernel_matches_plain(cuda_device, form):
    k, p = _chain_scalar_call(form, cuda_device)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    for b in range(3):
        one, _ = _chain_scalar_call(form, cuda_device, slice(b, b + 1))
        for a, c in zip(k, one):
            assert torch.equal(a[b], c[0]), (form, b)
    assert tv_cuda.barrier_error() == 0
