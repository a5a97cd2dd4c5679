"""What surrounds the 3×TF32 GEMM of kernels D and E (csrc/dft_kernels.cu),
on the CPU, where the kernel itself cannot run.

* The TF32 arithmetic: `tf32_round` against a numpy model of
  `cvt.rna.tf32.f32` (ties away from zero), `split_tf32` (hi + lo within
  2⁻²² relative, both exact tf32).
* The layouts: the packed factor operands reconstruct the stacked, signed
  block matrices [CM −SM; SM CM], [CM SM; −SM CM], [WCTᵀ −WSTᵀ] and
  [CNᵀ; −SNᵀ] (hi exactly tf32 of the value, hi + lo within 2⁻²²
  relative, zero pads); the Ĝ repack and the Y and F scratch layouts give
  back the spectra and products they hold.
* The arithmetic through the layouts: `dft_products_emulated` (the
  products in the kernel's order) at 64², 256² and a ragged 48×37 deviates
  from the JAX package's float64 matmul transforms at most 2× as much as
  `torch.matmul` in float32; the GEMM emulation alone, split along K and
  on sums of one sign.  The emulation rounds each k8 step's sum toward zero
  as the tensor cores do, so the bounds see the one-sign drift that rounding
  causes: on a DC column of one sign a one-accumulator 3-pass GEMM misses
  the bound here, as it did on the card, and the shipped per-k-block hi·hi
  form keeps it.
* `gemm_plan`: large grids take 128×128 tiles, small ones split-K.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semiblind_tv_tpu.ops import fourier as jf
from semiblind_tv_tpu_torch.ops import fused_dft_cuda as fd
from semiblind_tv_tpu_torch.ops.fourier import irfft2_matmul, rdft_matrices, rfft2_matmul

SHAPES = [(64, 64), (256, 256), (48, 37)]
EPS22 = 2.0 ** -22


@pytest.fixture(autouse=True)
def one_thread():
    """The emulation rounds every k8 step of every product on its own: many
    small operations, which several test workers sharing the cores slow by
    orders of magnitude when each is split across threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rna_model(x: np.ndarray) -> np.ndarray:
    """Round float32 to 10 mantissa bits, to nearest, ties away from zero."""
    bits = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    sign, mag = bits & 0x80000000, bits & 0x7FFFFFFF
    mag = ((mag + 0x1000) & 0x7FFFE000)
    return (sign | mag).astype(np.uint32).view(np.float32)


def _low_bits_zero(t: torch.Tensor) -> bool:
    return bool(((t.contiguous().view(torch.int32) & 0x1FFF) == 0).all())


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 255.0, 1e30])
def test_tf32_round_is_round_to_nearest_ties_away(scale):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096) * scale).astype(np.float32)
    # exact ties in [1, 2): the 13 dropped bits are 1000000000000b; scaled by
    # a power of two near `scale`, both signs
    mant = rng.integers(0, 2 ** 10, 64).astype(np.uint32)
    ties = (np.uint32(0x3F800000) | mant << 13 | np.uint32(0x1000)).view(np.float32)
    ties = np.ldexp(ties, int(np.round(np.log2(scale)))).astype(np.float32)
    ties = np.concatenate([ties, -ties])
    x = np.concatenate([x, ties, np.float32([0.0, -0.0, 1.0, -1.0])])
    got = fd.tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), _rna_model(x).view(np.uint32))
    assert np.all(np.abs(got.astype(np.float64) - x) <= 2.0 ** -11 * np.abs(x))


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e4])
def test_split_tf32_reconstructs_to_2_pow_minus_22(scale):
    x = torch.from_numpy((np.random.default_rng(1).standard_normal(8192) * scale)
                         .astype(np.float32))
    hi, lo = fd.split_tf32(x)
    assert _low_bits_zero(hi) and _low_bits_zero(lo)
    assert torch.equal(hi, fd.tf32_round(x))
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= EPS22 * x.double().abs()).all())


def _zero(t: torch.Tensor) -> bool:
    return t.numel() == 0 or float(t.abs().max()) == 0.0


def _check_planes(planes, value, ld):
    """planes (2, rows, ld) hold value (rows × K) split, zeros beyond K."""
    rows, K = value.shape
    assert planes.shape == (2, rows, ld) and planes.dtype == torch.float32
    hi, lo = planes[0, :, :K], planes[1, :, :K]
    assert torch.equal(hi, fd.tf32_round(value.to(torch.float32)))
    assert _low_bits_zero(lo)
    err = (hi.double() + lo.double() - value.double()).abs()
    assert bool((err <= EPS22 * value.double().abs()).all())
    assert _zero(planes[:, :, K:])


@pytest.mark.parametrize("shape", SHAPES)
def test_packed_factors_reconstruct_the_stacked_signed_blocks(shape):
    M, N = shape
    mats = rdft_matrices(shape, torch.float32)
    g = fd.dft_geometry(1, M, N)
    nh, nhp = g["Nh"], g["Nhp"]
    assert nhp % 2 == 0 and g["ld1"] % 4 == 0 and g["ldN"] % 4 == 0
    p = fd.pack_factors(mats)
    cm, sm = mats["CM"], mats["SM"]
    _check_planes(p["fac_inv"], torch.cat([torch.cat([cm, -sm], 1), torch.cat([sm, cm], 1)]),
                  g["ld1"])
    _check_planes(p["fac_fwd"], torch.cat([torch.cat([cm, sm], 1), torch.cat([-sm, cm], 1)]),
                  g["ld1"])
    w = torch.zeros((N, 2 * nhp))
    w[:, :nh], w[:, nhp:nhp + nh] = mats["WCT"].T, -mats["WST"].T
    _check_planes(p["w_t"], w, 2 * nhp)
    c = torch.zeros((2 * nhp, N))
    c[:nh], c[nhp:nhp + nh] = mats["CN"].T, -mats["SN"].T
    _check_planes(p["cns_t"], c, g["ldN"])
    # E's matrices alone pack the inverse operands only; the cache keys on
    # the matrices' identity and version
    inv = {k: mats[k] for k in ("CM", "SM", "WCT", "WST")}
    assert set(fd.pack_factors(inv)) == {"fac_inv", "w_t"}
    assert fd.packed_factors(mats) is fd.packed_factors(mats)
    first = fd.packed_factors(mats)
    mats["CM"].mul_(1.0)
    assert fd.packed_factors(mats) is not first


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("B", [1, 3])
def test_repack_and_scratch_layouts_give_back_what_they_hold(shape, B):
    M, N = shape
    g = fd.dft_geometry(B, M, N)
    nh, nhp = g["Nh"], g["Nhp"]
    rng = np.random.default_rng(2)
    ghat = torch.complex(*(torch.from_numpy(rng.standard_normal((B, M, nh)).astype(np.float32))
                           for _ in range(2)))
    # Ĝ repack: row b·Nhp + j = [Ĝre[b, :, j], Ĝim[b, :, j]], zero pad rows
    gbuf = fd._repack_spectrum(ghat, g)
    want = torch.zeros((B, nhp, 2 * M))
    for b in range(B):
        for j in range(nh):
            want[b, j] = torch.cat([ghat[b, :, j].real, ghat[b, :, j].imag])
    _check_planes(gbuf, want.reshape(B * nhp, 2 * M), g["ld1"])
    # Y (2M × B·Nhp) in ybuf: row b·M + i = [Yre[b, i, :], Yim[b, i, :]]
    y = torch.from_numpy(rng.standard_normal((2 * M, B * nhp)).astype(np.float32))
    ybuf = fd._store_y(y, g)
    yv = y.reshape(2, M, B, nhp)
    want = torch.cat([yv[0].permute(1, 0, 2), yv[1].permute(1, 0, 2)], 2).reshape(B * M, -1)
    _check_planes(ybuf, want, 2 * nhp)
    # F (B·M × 2Nhp) in fbuf: row b·Nhp + j = [Fre[b, :, j], Fim[b, :, j]]
    f = torch.from_numpy(rng.standard_normal((B * M, 2 * nhp)).astype(np.float32))
    fbuf = fd._store_f(f, g)
    fv = f.reshape(B, M, 2, nhp)
    want = torch.cat([fv[:, :, 0].transpose(1, 2), fv[:, :, 1].transpose(1, 2)], 2)
    _check_planes(fbuf, want.reshape(B * nhp, 2 * M), g["ld1"])
    # X̂ (2M × B·Nhp) back to the complex (B, M, Nh)
    xh = fd._xhat_of(y, g)
    assert xh.shape == (B, M, nh)
    assert torch.equal(xh.real, yv[0].permute(1, 0, 2)[..., :nh])
    assert torch.equal(xh.imag, yv[1].permute(1, 0, 2)[..., :nh])


def _rel(a, b):
    a, b = (torch.view_as_real(t) if t.is_complex() else t for t in (a, b))
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("B", [1, 2])
def test_emulated_products_deviate_from_f64_at_most_twice_torch_matmul(shape, B):
    M, N = shape
    rng = np.random.default_rng(3)
    x = (rng.random((B, M, N)) * 255.0).astype(np.float32)
    ghat = np.fft.rfft2(rng.standard_normal((B, M, N))).astype(np.complex64)
    mats = rdft_matrices(shape, torch.float32)
    xt, gt = torch.from_numpy(x), torch.from_numpy(ghat)
    grad, xhat = fd.dft_products_emulated(gt, xt, fd.packed_factors(mats))
    # the reference: the JAX package's matmul transforms in float64
    mj = jf.rdft_matrices(shape, jnp.float64)
    g64 = torch.from_numpy(np.array(jf.irfft2_matmul(jnp.asarray(ghat, jnp.complex128), mj)))
    x64 = torch.from_numpy(np.array(jf.rfft2_matmul(jnp.asarray(x, jnp.float64), mj)))
    g32, x32 = irfft2_matmul(gt, mats), rfft2_matmul(xt, mats)
    assert grad.shape == (B, M, N) and xhat.shape == (B, M, N // 2 + 1)
    assert _rel(grad, g32) <= 1e-5 and _rel(xhat, x32) <= 1e-5
    assert _rel(grad, g64) <= 2.0 * _rel(g32, g64)
    assert _rel(xhat, x64) <= 2.0 * _rel(x32, x64)
    # the wrapper's CPU path is the emulation, and E's products stop early
    got = fd.dft_products(gt, xt, mats)
    assert torch.equal(got[0], grad) and torch.equal(got[1], xhat)
    inv = fd.dft_products(gt, xt, mats, forward=False, return_scratch=True)
    assert torch.equal(inv[0], grad) and inv[1] is None and set(inv[2]) == {"gbuf", "ybuf"}


@pytest.mark.parametrize("splits", [1, 3, 7])
@pytest.mark.parametrize("offset", [0.0, 100.0])
def test_gemm_emulation_in_kahan_blocks_and_splits(splits, offset):
    rng = np.random.default_rng(4)
    K = 200   # 7 k-blocks, the last one ragged
    # offset: sums of one sign, as the DC column of a positive image
    a = torch.from_numpy((rng.standard_normal((40, K)) + offset).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((24, K)) + offset).astype(np.float32))
    got = fd.gemm_tf32x3_emulated(fd._planes(a, 204), fd._planes(b, 204), K, splits)
    want = a.double() @ b.double().T
    assert _rel(got, want) <= 2.0 * _rel(a @ b.T, want)
    # TF32 alone (hi·hi) would be ~1e-3 away
    assert _rel(fd.tf32_round(a) @ fd.tf32_round(b).T, want) > 100 * _rel(got, want)


@pytest.mark.parametrize("B,M,N", [(1, 256, 256), (2, 256, 256), (1, 512, 512),
                                   (16, 512, 512), (3, 480, 353)])
def test_gemm_plan_fills_the_card(B, M, N):
    plan, ws = fd.gemm_plan(B, M, N)
    assert len(plan) == 8
    need = 0
    for (cfg, splits), (rows, cols, K) in zip(zip(plan[0::2], plan[1::2]),
                                              fd._product_dims(fd.dft_geometry(B, M, N))):
        nk = -(-K // fd.BK)
        assert 1 <= splits <= nk
        if cfg == 1:
            assert splits == 1 and -(-rows // 128) * -(-cols // 128) >= 100
        else:
            blocks = -(-rows // 64) * -(-cols // 64) * splits
            assert blocks >= fd.SMS or splits == nk
        if splits > 1:
            need = max(need, splits * rows * cols)
    assert ws == need
    # the kernel gets the plan and the layout's widths in one host array
    g, host, ws_floats = fd._host_plan(B, M, N)
    assert tuple(host) == plan + (g["Nhp"], g["ld1"], g["ldN"]) and ws_floats == ws
    if (B, M, N) == (16, 512, 512):   # the large grid: 128×128 tiles, no split
        assert plan[0::2] == (1, 1, 1, 1)
    if (B, M, N) == (1, 256, 256):    # one chain: every product split along K
        assert all(s > 1 for s in plan[1::2])


def _one_accumulator_3pass(a, b, K):
    """The design the card refused: lo·hi, hi·lo and hi·hi of every k8 step
    summed into one accumulator across all of K, each step rounded toward
    zero as the tensor cores do."""
    acc = torch.zeros((a.shape[1], b.shape[1]), dtype=torch.float32)
    for k in range(0, K, 8):
        s = slice(k, min(K, k + 8))
        acc = fd._mma_k8(acc, a[1, :, s], b[0, :, s])
        acc = fd._mma_k8(acc, a[0, :, s], b[1, :, s])
        acc = fd._mma_k8(acc, a[0, :, s], b[0, :, s])
    return acc


@pytest.mark.parametrize("K", [512, 1024])   # 2M of D's column products at 256², 512²
def test_one_sign_dc_column_fails_one_accumulator_and_keeps_the_shipped_form(K):
    """x̂'s DC term of a positive image: rows of [0, 255) values against a
    factor row of ones (cos 0), beside rows of cosines.  Rounding each k8
    step toward zero makes a single running sum drift one way, past twice
    torch.matmul's deviation from float64; the shipped form sums each
    k-block's hi·hi in a fresh accumulator (exact here) and stays within."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy((rng.random((48, K)) * 255.0).astype(np.float32))
    k = np.arange(K)
    b = torch.from_numpy(np.stack([np.cos(2 * np.pi * f * k / K) for f in range(24)])
                         .astype(np.float32))
    assert bool((b[0] == 1.0).all())
    pa, pb = fd._planes(a, K), fd._planes(b, K)
    want = a.double() @ b.double().T
    bound = 2.0 * _rel(a @ b.T, want)
    assert _rel(_one_accumulator_3pass(pa, pb, K), want) > bound
    assert _rel(fd.gemm_tf32x3_emulated(pa, pb, K), want) <= bound
