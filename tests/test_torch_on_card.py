"""The CUDA kernels of the port against their plain versions, on the card.

Every test here needs a CUDA card and skips without one.  The file imports
neither jax nor the JAX package, so it runs on a machine that has only the
port's dependencies:

    python -m pytest --noconftest tests/test_torch_on_card.py -q

Inputs are float32; the kernels are built with --fmad=false, so f, the
duals, xn and proxn agree with the plain versions to 1e-5 of their largest
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


@pytest.mark.parametrize("shape", [(1, 64, 64), (3, 48, 40), (2, 17, 33)])
def test_kernel_a_warm_matches_plain(cuda_device, shape):
    rng = np.random.default_rng(0)
    g = torch.from_numpy((rng.random(shape) * 255).astype(np.float32)).to(cuda_device)
    px0, py0 = _field(rng, shape, cuda_device), _field(rng, shape, cuda_device)
    lam = torch.tensor(20.0, device=cuda_device)
    before = tv_cuda.LAUNCHES
    f, st = tv_cuda.chambolle_prox_cuda(g, lam, 10, tol=0.0, duals=(px0, py0))
    pf, pst = tv_cuda.chambolle_prox_plain(g, lam, 10, tol=0.0, duals=(px0, py0))
    torch.cuda.synchronize()
    assert tv_cuda.LAUNCHES == before + 1
    assert _rel_err(f, pf) <= REL
    assert _rel_err(st.px, pst.px) <= REL and _rel_err(st.py, pst.py) <= REL
    assert torch.equal(st.iters.cpu(), pst.iters.cpu())


def test_kernel_a_fresh_early_exit_matches_plain(cuda_device):
    yy, xx = np.mgrid[0:64, 0:64]
    base = (np.sin(xx / 5.0) + np.cos(yy / 7.0)).astype(np.float32)
    g = torch.from_numpy(np.stack([base * s for s in (1e-5, 1e-4, 1.0)])).to(cuda_device)
    f, st = tv_cuda.chambolle_prox_cuda(g, 0.5, 25, return_state=False)
    pf, pst = tv_cuda.chambolle_prox_plain(g, 0.5, 25, return_state=False)
    torch.cuda.synchronize()
    assert torch.equal(st.iters.cpu(), pst.iters.cpu())
    assert st.iters[0] < 25 and st.iters[2] == 25
    assert _rel_err(f, pf) <= REL
    assert float(st.px.abs().max()) == 0.0


@pytest.mark.parametrize("positivity", [True, False])
def test_kernel_b_matches_plain(cuda_device, positivity):
    rng = np.random.default_rng(1)
    shape = (2, 48, 40)
    x = torch.from_numpy((rng.random(shape) * 255).astype(np.float32)).to(cuda_device)
    prox = x + _field(rng, shape, cuda_device, 0.1)
    grad = _field(rng, shape, cuda_device, 0.01)
    z = _field(rng, shape, cuda_device)
    args = tuple(torch.tensor(v, device=cuda_device) for v in (1.9, 2.0, 0.02))
    before = fused_step_cuda.LAUNCHES
    k = fused_step_cuda.myula_prox_tv(x, prox, grad, z, *args, 25, tol=0.0,
                                      positivity=positivity)
    p = fused_step_cuda.myula_prox_tv_plain(x, prox, grad, z, *args, 25, tol=0.0,
                                            positivity=positivity)
    torch.cuda.synchronize()
    assert fused_step_cuda.LAUNCHES == before + 1
    for a, b in zip(k, p):
        assert _rel_err(a, b) <= REL


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
    x = torch.from_numpy((rng.random(shape) * 255).astype(np.float32)).to(cuda_device)
    prox = x + _field(rng, shape, cuda_device, 0.1)
    grad = _field(rng, shape, cuda_device, 0.01)
    seeds = _seeds(rng, shape[0], cuda_device)
    args = tuple(torch.tensor(v, device=cuda_device) for v in (1.9, 2.0, 0.02))
    before = fused_step_cuda.RNG_LAUNCHES
    k = fused_step_cuda.myula_prox_tv_rng(x, prox, grad, seeds, *args, 25, tol=0.0,
                                          positivity=positivity)
    p = fused_step_cuda.myula_prox_tv_rng_plain(x, prox, grad, seeds, *args, 25, tol=0.0,
                                                positivity=positivity)
    torch.cuda.synchronize()
    assert fused_step_cuda.RNG_LAUNCHES == before + 1
    for a, b in zip(k, p):
        assert _rel_err(a, b) <= REL
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
