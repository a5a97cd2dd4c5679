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
cannot hold at once is refused and raises.  Where the chains outnumber
what the card holds at one a block, its stacked form (three chains a
block; 512² B=16 and 256² B=40, A1, A2, B and C) gives every output of a
one-chain-a-block launch bit for bit, sums and sweep counts included, also
where the chains of one block stop on different sweeps.  The other kernels' f, duals,
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

Kernel J (csrc/prox_variants.cu, one resident launch a call) runs every
mode of the probe against its plain version: f bit-equal, equal sweep
counts, the last residual within 1e-3 (another summation order); roll and
rollmul equal while exactly; base and while in the walk form (640×1152,
more tiles than the card holds) bit-equal too, and base's f equal to A2's.

The run surface on the card (64²): a SAPG run interrupted after a
checkpoint and resumed equals the uninterrupted run within 1e-6 relative
through kernel B and through kernel D (fft_mode='dft'), and the resumed
run launches no warm-up step; TV-FISTA through A2 agrees with its plain
route on the card within 1e-5 of the largest magnitude; the posterior
moments at B=4 are finite, var ≥ 0, and equal the brute-force moments of
the same run's samples within 1e-5.  With the recorder on
(runtime/profiling.py), `sweeps.B` counts the sweeps kernel B ran, as the
plain version counts them, and over a run the sum of its iters tensors.

CUDA graphs (sapg/estimator.py, route B): a run_sapg that replays its
iterations as captured graphs gives the eager step's traces and X_last bit
for bit at 512² B=1 (Gaussian pinned, Moffat free), 64² B=16 and 64² B=1
(isotropic Gaussian: its width free, σ² pinned, θ in log scale), in the
capturing run and the next; each iteration is a replay or an eager step;
kernel B's launches and sweep counts are the eager run's (25 sweeps a call
at 512²); a preempted and resumed graphed run and a NaN-guard restore
through fault_hook end on the eager trajectory; the barrier error stays 0.

The SAPG step's residual, statistics and update (csrc/sapg_stats.cu) at
512² B=1 and 16, a ragged 100×130 of three problems and 512² with two free
PSF parameters: the residual within 1e-6 of a chain's largest magnitude
(PyTorch's products may be contracted into FMAs), the statistics within
1e-5 of the magnitude of each one's terms (float32 sums in another order;
G_σ cancels), the update within 1e-6 relative in every branch (CUDA's
logf/expf against PyTorch's); two launches give the same bits, each of four
problems in one launch gets the bits of its own launch, and a run of four
problems × two chains the bits of each problem's own run; no spills.

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
from semiblind_tv_tpu_torch.runtime.profiling import counters

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
        before = counters["launches.A"]
        f, st = tv_cuda.chambolle_prox_cuda(*args)
        launches = counters["launches.A"] - before
        pf, pst = tv_cuda.chambolle_prox_plain(*args)
        kernel = (f, st.px, st.py, st.iters, st.err)
        return kernel, (pf, pst.px, pst.py, pst.iters, pst.err), launches
    x, prox, grad = (v * sc for v in _step_fields(rng, shape, dev))
    scal = tuple(torch.tensor(v, device=dev) for v in _STEP_SCALARS)
    if form == "B":
        z = _field(rng, shape, dev)
        before = counters["launches.B"]
        k = fused_step_cuda.myula_prox_tv(x, prox, grad, z, *scal, 25, tol=tol)
        launches = counters["launches.B"] - before
        p = fused_step_cuda.myula_prox_tv_plain(x, prox, grad, z, *scal, 25, tol=tol)
    else:
        seeds = _seeds(rng, shape[0], dev)
        before = counters["launches.C"]
        k = fused_step_cuda.myula_prox_tv_rng(x, prox, grad, seeds, *scal, 25, tol=tol)
        launches = counters["launches.C"] - before
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
    on later sweeps or never; B=40 at 256² runs in two groups of chains
    (8 slots of 32 tiles at 264 blocks, three chains a block: the stacked
    form), 700×1100 in the walk form (396 tiles a chain)."""
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


def _stacked_call(form, shape, dev, tol, scales):
    """One form's kernel outputs on fixed inputs, as tensors: A1/A2 (f, px,
    py, sweeps, last residual), B/C (xn, proxn, tv, sweeps, last residual);
    and the plain version's (A1/A2: the same; B/C: xn, proxn, tv and the
    plain prox's sweeps on xn).  Counts `groups.<kernel>` around the
    kernel's call."""
    rng = np.random.default_rng(11)
    sc = scales.to(dev)[:, None, None]
    if form in ("A1", "A2"):
        g = torch.from_numpy((rng.random(shape) * 255).astype(np.float32)).to(dev) * sc
        if form == "A1":
            duals = (_field(rng, shape, dev) * sc, _field(rng, shape, dev) * sc)
            args = (g, torch.tensor(20.0, device=dev), 10, 0.249, tol, duals)
        else:
            args = (g, torch.tensor(0.5, device=dev), 25, 0.249, tol, None, True)
        before = counters["groups.A"]
        f, st = tv_cuda.chambolle_prox_cuda(*args)
        groups = counters["groups.A"] - before
        pf, pst = tv_cuda.chambolle_prox_plain(*args)
        return ((f, st.px, st.py, st.iters, st.err), (pf, pst.px, pst.py, pst.iters),
                groups)
    x, prox, grad = (v * sc for v in _step_fields(rng, shape, dev))
    # γ a chain, so that the noise √(2γ)·Z scales with the chain
    scal = (torch.tensor(_STEP_SCALARS[0], device=dev) * scales.to(dev) ** 2,
            *(torch.tensor(v, device=dev) for v in _STEP_SCALARS[1:]))
    noise = _field(rng, shape, dev) if form == "B" else _seeds(rng, shape[0], dev)
    z, seeds = (noise, None) if form == "B" else (None, noise)
    before = counters["groups." + form]
    k = fused_step_cuda._launch_step(x, prox, grad, z, seeds, *scal, 25, 0.249, tol, True, form)
    groups = counters["groups." + form] - before
    plain = (fused_step_cuda.myula_prox_tv_plain if form == "B"
             else fused_step_cuda.myula_prox_tv_rng_plain)
    p = plain(x, prox, grad, noise, *scal, 25, tol=tol)
    _, pst = tv_cuda.chambolle_prox_plain(p[0], scal[2], 25, tol=tol)
    return k, (*p, pst.iters), groups


@pytest.mark.parametrize("shape,tol,spread", [((16, 512, 512), 0.0, False),
                                              ((16, 512, 512), 1e-3, True),
                                              ((40, 256, 256), 1e-3, True)])
@pytest.mark.parametrize("form", ["A1", "A2", "B", "C"])
def test_stacked_forms_bit_equal_to_one_chain_a_block(cuda_device, monkeypatch, form, shape,
                                                      tol, spread):
    """Where the chains outnumber the card's one-chain-a-block capacity, the
    wrappers launch the stacked form (three chains a block: 512² B=16 in 3
    groups, 256² B=40 in 2); every output equals a launch of one chain a
    block (8 and 5 groups) bit for bit, sums and sweep counts included, and
    the fields, sweeps and TV equal the plain version's, also where the
    chains of one block stop on different sweeps (tol 1e-3 on chains scaled
    from 1 down to 1e-9)."""
    cap = tv_cuda.resident_capacity(cuda_device)
    B = shape[0]
    geo = tv_cuda.resident_geometry(*shape, cap, tv_cuda.resident_stack(cuda_device))
    one = tv_cuda.resident_geometry(*shape, cap, 1)
    assert geo.stack == 3 and geo.groups < one.groups
    scales = torch.logspace(0, -9, B) if spread else torch.ones(B)
    k, p, groups = _stacked_call(form, shape, cuda_device, tol, scales)
    with monkeypatch.context() as m:
        m.setattr(tv_cuda, "resident_stack", lambda device: 1)
        k1, _, groups1 = _stacked_call(form, shape, cuda_device, tol, scales)
    torch.cuda.synchronize()
    assert (groups, groups1) == (geo.groups, one.groups)
    for a, b in zip(k, k1):
        assert torch.equal(a, b)
    for a, b in zip(k[:2], p[:2]):
        assert torch.equal(a, b)
    if form in ("A1", "A2"):
        assert torch.equal(k[2], p[2])
    else:
        assert _rel_err(k[2], p[2]) <= REL
    assert torch.equal(k[3].cpu(), p[3].cpu())
    its = k[3].tolist()
    if spread:   # some block holds chains that stop on different sweeps
        slots = geo.chains // geo.stack
        blocks = [[its[b] for b in range(g * geo.chains + s, min(B, (g + 1) * geo.chains), slots)]
                  for g in range(geo.groups) for s in range(slots)]
        assert any(len(set(c)) > 1 for c in blocks), blocks
    else:
        assert set(its) == {10 if form == "A1" else 25}
    assert tv_cuda.barrier_error() == 0


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
    names, its stacked forms keep them with three chains a block, ptxas
    reports no spill in any of its six forms, and its exact quotient and
    root are IEEE's on a sample (chip_smoke.py checks every root)."""
    from semiblind_tv_tpu_torch._build import kernel_usage, load_library

    occ = tv_cuda.resident_occupancy(cuda_device)
    assert occ["blocks_per_sm"] == occ["launch_bounds_blocks"]
    assert occ["registers"] * occ["threads"] * occ["blocks_per_sm"] <= 65536
    assert occ["stack_max"] == tv_cuda.DESIGN_STACK == 3
    usage = kernel_usage("resident_")
    assert sorted(usage) == ["resident_prox", "resident_prox_stacked", "resident_prox_walk",
                             "resident_step", "resident_step_stacked",
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
    before = counters["launches.A"]
    with monkeypatch.context() as m:
        m.setattr(tv_cuda, "resident_geometry", lambda *args: geo)
        with pytest.raises(RuntimeError):
            tv_cuda.chambolle_prox_cuda(g, torch.tensor(0.5, device=cuda_device), 5)
    assert counters["launches.A"] == before
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
    before = counters["launches.B"]
    k = fused_step_cuda.myula_prox_tv(x, prox, grad, z, *args, 25, tol=0.0,
                                      positivity=positivity)
    p = fused_step_cuda.myula_prox_tv_plain(x, prox, grad, z, *args, 25, tol=0.0,
                                            positivity=positivity)
    torch.cuda.synchronize()
    assert counters["launches.B"] == before + 1
    _assert_resident_matches("B", k, p)


@pytest.mark.parametrize("shape", [(1, 200, 300), (2, 130, 70), (3, 75, 64)])
@pytest.mark.parametrize("warm", [False, True])
def test_blocked_prox_matches_plain(cuda_device, shape, warm):
    rng = np.random.default_rng(2)
    g = torch.from_numpy((rng.random(shape) * 255).astype(np.float32)).to(cuda_device)
    duals = (_field(rng, shape, cuda_device, 0.1), _field(rng, shape, cuda_device, 0.1)) \
        if warm else None
    lam = torch.tensor(20.0, device=cuda_device)
    before = counters["launches.blocked_prox"]
    f, st = tv_blocked_cuda.chambolle_prox_blocked(g, lam, 25, tol=0.0, duals=duals,
                                                   return_state=warm)
    pf, pst = tv_blocked_cuda.chambolle_prox_blocked_plain(g, lam, 25, tol=0.0, duals=duals,
                                                           return_state=warm)
    torch.cuda.synchronize()
    assert counters["launches.blocked_prox"] == before + 1
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
    before = counters["launches.blocked_step"]
    k = fused_step_cuda.myula_prox_tv_blocked(x, prox, grad, z, *args, n_sweeps=25, tol=0.0,
                                              positivity=positivity)
    p = fused_step_cuda.myula_prox_tv_blocked_plain(x, prox, grad, z, *args, n_sweeps=25,
                                                    tol=0.0, positivity=positivity)
    torch.cuda.synchronize()
    assert counters["launches.blocked_step"] == before + 1
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
    before = counters["launches.C"]
    k = fused_step_cuda.myula_prox_tv_rng(x, prox, grad, seeds, *args, 25, tol=0.0,
                                          positivity=positivity)
    p = fused_step_cuda.myula_prox_tv_rng_plain(x, prox, grad, seeds, *args, 25, tol=0.0,
                                                positivity=positivity)
    torch.cuda.synchronize()
    assert counters["launches.C"] == before + 1
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
    before = counters["launches.blocked_step.seeds"]
    k = fused_step_cuda.myula_prox_tv_blocked(x, prox, grad, None, *args, n_sweeps=25,
                                              tol=0.0, positivity=positivity, seeds=seeds)
    p = fused_step_cuda.myula_prox_tv_blocked_plain(x, prox, grad, None, *args, n_sweeps=25,
                                                    tol=0.0, positivity=positivity, seeds=seeds)
    torch.cuda.synchronize()
    assert counters["launches.blocked_step.seeds"] == before + 1
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
    fn, plain = {
        "D": (fused_dft_cuda.myula_prox_tv_dft, fused_dft_cuda.myula_prox_tv_dft_plain),
        "E": (fused_dft_cuda.myula_prox_tv_irdft, fused_dft_cuda.myula_prox_tv_irdft_plain),
    }[kernel]
    counter = "launches." + kernel
    before = counters[counter]
    k = fn(ghat, x, prox, z, mats, *args, tol=0.0)
    p = plain(ghat, x, prox, z, mats, *args, tol=0.0)
    p64 = plain(ghat.to(torch.complex128), x.double(), prox.double(), z.double(), mats64,
                *(a.double() for a in args), tol=0.0)
    torch.cuda.synchronize()
    assert counters[counter] == before + 1
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
    before = counters["launches.dft_products"]
    grad, xhat, scratch = fused_dft_cuda.dft_products(ghat, x, mats, return_scratch=True)
    torch.cuda.synchronize()
    assert counters["launches.dft_products"] == before + 1
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
        before = counters["launches.J"]
        f, meta = pv.prox_variant(mode, g, scal, 25)
        pf, pmeta = pv.prox_variant_plain(mode, g, scal, 25)
        torch.cuda.synchronize()
        assert counters["launches.J"] == before + 1
        assert torch.equal(f, pf), float((f - pf).abs().max())
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


@pytest.mark.parametrize("mode", ["base", "while"])
def test_prox_variant_walk_form_and_a2(cuda_device, mode):
    """640×1152 is 360 tiles, more than the card's resident blocks: the walk
    form, bit-equal to the plain version; at 128² base's f is A2's (both
    divide)."""
    pv = probe_prox_variants
    g = torch.from_numpy((np.random.default_rng(9).random((1, 640, 1152)) * 255.0)
                         .astype(np.float32)).to(cuda_device)
    assert tv_cuda.resident_geometry(1, 640, 1152, tv_cuda.resident_capacity(cuda_device)).walk > 1
    for lam, tol in ((0.08, 0.0), (20.0, 5.0 * (640 * 1152 / (33 * 40)) ** 0.5)):
        scal = torch.tensor([lam, 0.249, tol], device=cuda_device)
        f, meta = pv.prox_variant(mode, g, scal, 25)
        pf, pmeta = pv.prox_variant_plain(mode, g, scal, 25)
        assert torch.equal(f, pf) and torch.equal(meta[:, 0], pmeta[:, 0])
    if mode == "base":   # two divides, as A2
        g2 = g[:, :128, :128].contiguous()
        scal = torch.tensor([0.08, 0.249, 1e-3], device=cuda_device)
        a2 = tv_cuda.chambolle_prox_cuda(g2, scal[0], 25, tol=1e-3, return_state=False)[0]
        assert torch.equal(pv.prox_variant(mode, g2, scal, 25)[0], a2)


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
        return (counters["launches.B"] if row == "B" else counters["launches.D"])

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
    before = counters["launches.A.fresh"]
    kern = fista_tv(problem.y, problem.H_true, **kw)
    assert counters["launches.A.fresh"] - before == 40
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


def test_sweep_counter_is_kernel_b_sweeps(cuda_device, monkeypatch):
    """With the recorder on, a call's `sweeps.B` equals the plain version's
    sweep counts on the same inputs (tol 1e-3, chains scaled apart), and
    after a run `sweeps.B` is the sum of every iters tensor kernel B wrote in
    it, each copied when written (the kept tensors are not overwritten
    before the fold), with `chain_calls.B` its chains."""
    from semiblind_tv_tpu_torch.runtime import profiling
    from semiblind_tv_tpu_torch.sapg.estimator import run_sapg

    rng = np.random.default_rng(12)
    shape = (3, 64, 64)
    sc = torch.tensor([1e-5, 1e-3, 1.0], device=cuda_device)[:, None, None]
    x, prox, grad = (v * sc for v in _step_fields(rng, shape, cuda_device))
    z = _field(rng, shape, cuda_device) * sc
    scal = tuple(torch.tensor(v, device=cuda_device) for v in _STEP_SCALARS)
    profiling.reset()
    profiling.enable(in_sessions=False)
    try:
        counts = []
        for fn in (fused_step_cuda.myula_prox_tv, fused_step_cuda.myula_prox_tv_plain):
            profiling.reset()
            fn(x, prox, grad, z, *scal, 25, tol=1e-3)
            profiling.fold_sweeps()
            counts.append((counters["sweeps.B"], counters["chain_calls.B"]))
        assert counts[0] == counts[1] and counts[0][1] == 3 and 3 <= counts[0][0] <= 75

        written = []
        real = profiling.count_sweeps

        def spy(kernel, iters):
            # a CUDA graph's capture runs nothing: each replay reports a copy
            if kernel == "B" and not torch.cuda.is_current_stream_capturing():
                written.append(iters.clone())
            real(kernel, iters)

        monkeypatch.setattr(profiling, "count_sweeps", spy)
        problem = _card_run_problem(cuda_device, samples=30, warmup=10, burn_in=24)
        profiling.reset()
        launched = counters["launches.B"]
        run_sapg(problem, torch.Generator(device=cuda_device).manual_seed(3), n_chains=2)
        assert counters["launches.B"] - launched == len(written) == 9 + 29
        assert counters["sweeps.B"] == int(torch.cat(written).sum())
        assert counters["chain_calls.B"] == 2 * len(written)
    finally:
        profiling.disable()
        profiling.reset()


# ---------------------------------------------------------------------------
# run_sapg's iterations as CUDA graphs (route B): the replays against the
# eager step, bit for bit
# ---------------------------------------------------------------------------

def _graph_problem(cuda_device, name, size, **sapg):
    import dataclasses

    from semiblind_tv_tpu_torch.runtime.config import preset
    from semiblind_tv_tpu_torch.runtime.problem import build_problem
    from semiblind_tv_tpu_torch.utils.images import load_image, synthetic_wheel

    cfg = preset(name)
    cfg = dataclasses.replace(cfg, sapg=dataclasses.replace(cfg.sapg, **sapg))
    image = load_image("wheel") if size == 512 else synthetic_wheel(size)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    return build_problem(image, cfg, gen, device=cuda_device)


def _draws(cuda_device, seed):
    gen = torch.Generator(device=cuda_device).manual_seed(seed)
    return lambda shape: torch.randn(shape, generator=gen, device=cuda_device)


def _assert_bit_equal(a, b):
    pairs = [(a.thetas, b.thetas), (a.sigma2s, b.sigma2s), (a.logPiTrace, b.logPiTrace),
             (a.logPiTrace_warmup, b.logPiTrace_warmup), (a.X_last, b.X_last)]
    pairs += [(a.psf_param_traces[n], b.psf_param_traces[n]) for n in a.psf_param_traces]
    for x, y in pairs:
        assert np.array_equal(x, y)


@pytest.mark.parametrize("name,size,B", [("gaussian", 512, 1), ("moffat", 512, 1),
                                         ("gaussian", 64, 16), ("isotropic_gaussian", 64, 1),
                                         ("gaussian", 512, 16)])
def test_graphed_run_is_bit_equal_to_the_eager_run(cuda_device, name, size, B):
    """run_sapg replays its iterations as CUDA graphs on route B: traces and
    X_last equal the eager step's bit for bit, in the capturing run and in
    the next (which replays every iteration), each iteration is a replay or
    an eager step, kernel B's launches, chain groups and sweeps and the SAPG
    statistics kernels' launches are the eager run's (512² B=16: the stacked
    form, three groups a call, inside the captured step), and the resident
    kernel's barriers complete."""
    from semiblind_tv_tpu_torch.runtime import profiling
    from semiblind_tv_tpu_torch.sapg.estimator import run_sapg

    warmup, samples = 30, 60
    problem = _graph_problem(cuda_device, name, size, samples=samples, warmup=warmup,
                             burn_in=40)
    steps = (warmup - 1) + (samples - 1)
    profiling.reset()
    profiling.enable(in_sessions=False)
    try:
        runs, counts = [], []
        for graphs in (False, True, True):
            profiling.reset()
            runs.append(run_sapg(problem, n_chains=B, noise=_draws(cuda_device, 5),
                                 _graphs=graphs))
            counts.append(profiling.snapshot()["counters"])
    finally:
        profiling.disable()
        profiling.reset()
    eager, first, second = counts
    assert first["graph.captures"] == 2 and "graph.captures" not in second
    assert first["graph.replays"] + first["graph.eager_steps"] == steps
    assert second["graph.replays"] == steps and "graph.eager_steps" not in second
    assert eager["graph.eager_steps"] == steps and "graph.replays" not in eager
    sapg = ("launches.sapg_residual", "launches.sapg_stats", "launches.sapg_update")
    for c in (first, second):
        for k in ("launches.B", "groups.B", "sweeps.B", "chain_calls.B") + sapg:
            assert c[k] == eager[k], k
    assert eager["chain_calls.B"] == B * steps
    # the residual and the statistics every iteration, logπ once at the
    # warm-up's end, the update every SAPG iteration
    assert [eager[k] for k in sapg] == [steps, steps + 1, samples - 1]
    assert eager["groups.B"] == eager["launches.B"] * (3 if (size, B) == (512, 16) else 1)
    if size == 512:
        assert eager["sweeps.B"] == 25 * eager["chain_calls.B"]
    _assert_bit_equal(runs[1], runs[0])
    _assert_bit_equal(runs[2], runs[0])
    assert tv_cuda.barrier_error() == 0


def test_an_earlier_runs_graphs_go_before_the_next_capture(cuda_device):
    """A problem keeps its graphed run in step_graphs, and the run holds
    its problems weakly, so the run's graphs are freed by reference
    counting when the problem goes, with the cycle collector off, and not
    by a collection inside a later capture (which would invalidate it).
    With a collection due at nearly every allocation, the next problem's
    graphed run captures and replays as its eager run does."""
    import gc
    import weakref

    from semiblind_tv_tpu_torch.sapg.estimator import run_sapg

    first = _graph_problem(cuda_device, "moffat", 64, samples=12, warmup=6, burn_in=8)
    run_sapg(first, n_chains=2, noise=_draws(cuda_device, 3))
    its = weakref.ref(first.step_graphs["run"].iterations)
    assert its().graphs
    gc.disable()
    try:
        del first
        assert its() is None
    finally:
        gc.enable()
    second = _graph_problem(cuda_device, "moffat", 64, samples=12, warmup=6, burn_in=8)
    eager = run_sapg(second, n_chains=2, noise=_draws(cuda_device, 3), _graphs=False)
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        graphed = run_sapg(second, n_chains=2, noise=_draws(cuda_device, 3))
    finally:
        gc.set_threshold(*threshold)
    assert second.step_graphs
    _assert_bit_equal(graphed, eager)


def test_graphed_run_resumes_and_restores_as_the_eager_run(cuda_device, tmp_path):
    """With checkpoints: a graphed run preempted after its second segment
    and resumed, and a graphed run whose NaN-poisoned carry (fault_hook)
    the guard restores from the checkpoint, each end bit-equal to the
    uninterrupted eager run."""
    from semiblind_tv_tpu_torch.sapg.estimator import run_sapg

    problem = _graph_problem(cuda_device, "moffat", 64, samples=40, warmup=10, burn_in=32)

    def gen():
        return torch.Generator(device=cuda_device).manual_seed(2)

    full = run_sapg(problem, gen(), _graphs=False)

    def preempt(seg_idx, carry):
        if seg_idx == 2:
            raise _Preempted()
        return carry

    ckpt = str(tmp_path / "resume.npz")
    with pytest.raises(_Preempted):
        run_sapg(problem, gen(), checkpoint_every=10, checkpoint_path=ckpt, fault_hook=preempt)
    resumed = run_sapg(problem, torch.Generator(device=cuda_device).manual_seed(9),
                       checkpoint_every=10, checkpoint_path=ckpt)
    _assert_bit_equal(resumed, full)

    fired = []

    def poison(seg_idx, carry):
        if seg_idx == 2 and not fired:
            fired.append(seg_idx)
            return (torch.full_like(carry[0], float("nan")),) + tuple(carry[1:])
        return carry

    restored = run_sapg(problem, gen(), checkpoint_every=10,
                        checkpoint_path=str(tmp_path / "nan.npz"), fault_hook=poison)
    assert fired == [2]
    _assert_bit_equal(restored, full)
    assert tv_cuda.barrier_error() == 0


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


# ---------------------------------------------------------------------------
# The SAPG step's residual, statistics and update (csrc/sapg_stats.cu)
# ---------------------------------------------------------------------------

# (D, C, M, N, free PSF parameters): 512² at B = 1 and 16 with the PSF
# pinned, a ragged shape of three problems, 512² with Moffat's two free
# parameters
SAPG_SHAPES = [(1, 1, 512, 512, 0), (1, 16, 512, 512, 0), (3, 2, 100, 130, 2),
               (1, 1, 512, 512, 2)]
# the residual: elementwise products and sums, which PyTorch's kernels may
# contract into FMAs (the kernel rounds each alone): a few float32 ulps of a
# chain's largest magnitude
RESIDUAL_REL = 1e-6
# the statistics: float32 sums of a chain's M·(N/2+1) values taken in
# another order (a tree of 256, then the blocks' partials, against
# torch.sum's): within 1e-5 of the magnitude of each statistic's terms
# (Σ|terms| in float64), as G_σ = res2/(2σ⁴) − d/(2σ²) cancels
STATS_REL = 1e-5
# the update: the same float32 operations, CUDA's logf/expf against
# PyTorch's in the log-scale branches: a few ulps
UPDATE_REL = 1e-6


def _sapg_inputs(dev, D, C, M, N, P, seed=0):
    from semiblind_tv_tpu_torch.ops.fourier import rfft_weights

    g = torch.Generator().manual_seed(seed)
    Nh = N // 2 + 1

    def cplx(shape, scale):
        return (torch.complex(torch.randn(shape, generator=g), torch.randn(shape, generator=g))
                * scale).to(dev)

    def unif(shape, lo, hi):
        return (torch.rand(shape, generator=g) * (hi - lo) + lo).to(dev)

    return dict(
        xhat=cplx((D, C, M, Nh), 1e3), h=cplx((M, Nh) if P == 0 else (D, M, Nh), 0.5),
        yhat=cplx((D, M, Nh), 1e3), tv=unif((D, C), 1e5, 1e6), theta=unif((D,), 0.005, 0.05),
        sigma2=unif((D,), 1.0, 20.0),
        dhs={n: cplx((D, M, Nh), 0.1) for n in ("alpha", "beta")[:P]},
        weights=rfft_weights((M, N), device=dev), dim=M * N)


def _stats_args(a, theta=None):
    return (a["xhat"], a["h"], a["yhat"], a["tv"], a["theta"] if theta is None else theta,
            a["sigma2"], a["dhs"], a["weights"], a["dim"])


def _stat_scales(a, logpi_only=False):
    """(K, D): each problem's mean over its chains of the magnitude of each
    statistic's terms, in float64 (ops/sapg_stats.stat_scales)."""
    from semiblind_tv_tpu_torch.ops import sapg_stats as ss

    return ss.stat_scales(*_stats_args(a), logpi_only=logpi_only)


def _sapg_rule(dev, name, logs=(), sigma_fix=False):
    import dataclasses

    from semiblind_tv_tpu_torch.ops import sapg_stats as ss
    from semiblind_tv_tpu_torch.runtime.config import preset
    from semiblind_tv_tpu_torch.sapg.estimator import sa_step_coefficients

    cfg = preset(name)
    cfg = dataclasses.replace(cfg, sapg=dataclasses.replace(
        cfg.sapg, samples=100, **{f"{k}_log_scale": True for k in logs}))
    table = torch.from_numpy(sa_step_coefficients(cfg, 512 * 512)).float().to(dev)
    return ss.sa_rule(cfg, sigma_fix, torch.float32, dev), table


@pytest.mark.parametrize("shape", SAPG_SHAPES, ids=lambda s: "D{}C{}-{}x{}-P{}".format(*s))
def test_sapg_residual_and_stats_match_plain(cuda_device, shape):
    """One launch a call; twice the same inputs give the same bits."""
    from semiblind_tv_tpu_torch.ops import sapg_stats as ss

    a = _sapg_inputs(cuda_device, *shape)
    before = counters["launches.sapg_residual"], counters["launches.sapg_stats"]
    g = ss.sapg_residual(a["xhat"], a["h"], a["yhat"])
    packed = ss.sapg_stats(*_stats_args(a))
    warm = ss.sapg_stats(a["xhat"], a["h"] if a["h"].ndim == 2 else a["h"][0].contiguous(),
                         a["yhat"], a["tv"], a["theta"][:1].expand(shape[0]), a["sigma2"], {},
                         a["weights"], a["dim"], logpi_only=True)
    torch.cuda.synchronize()
    assert (counters["launches.sapg_residual"] - before[0],
            counters["launches.sapg_stats"] - before[1]) == (1, 2)
    assert _rel_err(g, ss.sapg_residual_plain(a["xhat"], a["h"], a["yhat"])) <= RESIDUAL_REL
    plain = torch.stack(list(ss.sapg_stats_plain(*_stats_args(a)).values()))
    assert packed.shape == plain.shape == (4 + shape[4], shape[0])
    scale = _stat_scales(a)
    assert float(((packed - plain).double().abs() / scale).max()) <= STATS_REL
    wa = dict(a, h=a["h"] if a["h"].ndim == 2 else a["h"][0], theta=a["theta"][:1].expand(shape[0]),
              dhs={})
    wplain = ss.sapg_stats_plain(*_stats_args(wa), logpi_only=True)["logPi"]
    assert float(((warm[0] - wplain).double().abs() / _stat_scales(wa, True)[0]).max()) <= STATS_REL
    assert torch.equal(ss.sapg_residual(a["xhat"], a["h"], a["yhat"]), g)
    assert torch.equal(ss.sapg_stats(*_stats_args(a)), packed)


UPDATE_CASES = [("gaussian", (), False), ("moffat", (), False), ("gaussian", (), True),
                ("moffat", ("theta", "sigma", "psf"), False), ("moffat", ("theta",), True),
                ("gaussian", ("sigma",), False)]


@pytest.mark.parametrize("D", [1, 3])
@pytest.mark.parametrize("case", UPDATE_CASES, ids=lambda c: f"{c[0]}-{'+'.join(c[1]) or 'linear'}"
                         f"{'-sigma-pinned' if c[2] else ''}")
def test_sapg_update_matches_plain(cuda_device, case, D):
    """Every branch of the update, from the same packed block summed over a
    group of 1 or 4 ranks, at a host column and at a device index."""
    from semiblind_tv_tpu_torch.ops import sapg_stats as ss

    rule, table = _sapg_rule(cuda_device, *case)
    g = torch.Generator().manual_seed(D)

    def unif(lo, hi, n=D):
        return (torch.rand((n,), generator=g) * (hi - lo) + lo).to(cuda_device)

    K = 4 + len(rule.free_names)
    packed = (torch.rand((K, D), generator=g) * 2e5 - 1e5).to(cuda_device)
    lo = unif(0.5, 1.0)
    consts = dict(sigma2_lo=lo, sigma2_hi=lo + unif(5.0, 50.0), sigma2_init=unif(1.0, 5.0))
    params = {s.name: unif(*s.box) for s in rule.psf_specs if not s.fix}
    theta, sigma2 = unif(*rule.theta_spec.box), unif(1.0, 20.0)
    for n_group, ii in ((1, 2), (4, 57)):
        summed = packed * n_group
        before = counters["launches.sapg_update"]
        for col in (ii, torch.tensor([ii], device=cuda_device)):
            rows = ss.sapg_update(summed, n_group, table, col, theta, sigma2, params, consts,
                                  rule)
            stats = dict(zip(ss.stat_names(rule.free_names), (summed / n_group).unbind(0)))
            want = ss.sapg_update_plain(stats, ss.coefficient_column(table, ii), theta, sigma2,
                                        params, consts, rule)
            assert rows.shape == want.shape == (len(ss.trace_names(rule.psf_names)), D)
            assert bool(((rows - want).abs() <= UPDATE_REL * want.abs()).all()), (rows, want)
            assert torch.equal(rows, ss.sapg_update(summed, n_group, table, col, theta, sigma2,
                                                    params, consts, rule))
        assert counters["launches.sapg_update"] - before == 4


def test_sapg_kernels_give_each_problem_its_own_bits(cuda_device):
    """D = 4 problems of C = 4 chains in one launch against each problem's
    launch alone: the residual, the statistics (each problem's chains summed
    in their own order) and the update, bit for bit."""
    from semiblind_tv_tpu_torch.ops import sapg_stats as ss

    D, C = 4, 4
    a = _sapg_inputs(cuda_device, D, C, 512, 512, 2, seed=3)
    rule, table = _sapg_rule(cuda_device, "moffat")
    consts = dict(sigma2_lo=a["sigma2"] * 0.5, sigma2_hi=a["sigma2"] * 2,
                  sigma2_init=a["sigma2"])
    params = {n: torch.full((D,), 2.0, device=cuda_device) for n in rule.free_names}
    g_all = ss.sapg_residual(a["xhat"], a["h"], a["yhat"])
    p_all = ss.sapg_stats(*_stats_args(a))
    r_all = ss.sapg_update(p_all, 1, table, 9, a["theta"], a["sigma2"], params, consts, rule)
    for d in range(D):
        one = {k: (v[d:d + 1].contiguous() if torch.is_tensor(v) and k != "weights" else v)
               for k, v in a.items()}
        one["dhs"] = {n: v[d:d + 1].contiguous() for n, v in a["dhs"].items()}
        assert torch.equal(ss.sapg_residual(one["xhat"], one["h"], one["yhat"]), g_all[d:d + 1])
        p = ss.sapg_stats(*_stats_args(one))
        assert torch.equal(p, p_all[:, d:d + 1])
        r = ss.sapg_update(p, 1, table, 9, one["theta"], one["sigma2"],
                           {n: v[d:d + 1] for n, v in params.items()},
                           {k: v[d:d + 1] for k, v in consts.items()}, rule)
        assert torch.equal(r, r_all[:, d:d + 1])


def test_sapg_data_axis_run_gives_each_problem_its_own_run(cuda_device):
    """run_sapg_layout over 4 problems × 2 chains on the card (one launch of
    every kernel a step for all 8 chains, its iterations as CUDA graphs)
    against each problem's own run_sapg, on the same noise: traces and
    X_last bit for bit."""
    from semiblind_tv_tpu_torch.parallel.mesh import RankLayout
    from semiblind_tv_tpu_torch.sapg.estimator import run_sapg, run_sapg_layout

    D, C = 4, 2
    problems = [_graph_problem(cuda_device, "gaussian", 128, samples=30, warmup=10, burn_in=20)
                for _ in range(D)]
    for d, p in enumerate(problems):   # four observations of one image
        p.yhat.mul_(1.0 + 0.01 * d)
    layout = RankLayout(problems=range(D), rows=slice(0, C), device=problems[0].device)
    together = run_sapg_layout(problems, layout, noise=[_draws(cuda_device, 7 + d)
                                                        for d in range(D)])
    for d, p in enumerate(problems):
        alone = run_sapg(p, n_chains=C, noise=_draws(cuda_device, 7 + d))
        _assert_bit_equal(together[d], alone)


def test_sapg_kernels_spill_nothing(cuda_device):
    from semiblind_tv_tpu_torch import _build

    usage = _build.kernel_usage("sapg_")
    assert {k for k in usage if "residual" in k} and {k for k in usage if "stats" in k} \
        and {k for k in usage if "update" in k}, usage
    for name, u in usage.items():
        assert u["spill_stores"] == 0 and u["spill_loads"] == 0, (name, u)
