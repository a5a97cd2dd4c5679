"""The whole-iteration DFT steps on the card: kernels D and E of
`csrc/dft_kernels.cu`.

Replaces `semiblind_tv_tpu/ops/fused_step_pallas.py::myula_prox_tv_dft`
(kernel D, `_kernel_dft`) and `myula_prox_tv_irdft` (kernel E,
`_kernel_irdft`), which run one VMEM-resident launch per chain:

    grad  = irfft2(Ĝ) by six DFT matmuls            (Ĝ = conj(H)·R̂)
    xn, proxn, tv = kernel B's step with gradF = grad/σ²
    x̂     = rfft2(xn) by six DFT matmuls           (D only)

On Hopper the (M, M) factor matrices alone exceed one SM's shared memory,
so each is a short launch sequence on one stream with no host sync: the
inverse transform as two products, kernel B's one persistent launch with σ²
(csrc/tv_kernels.cu), and for D the forward transform as two more, which
write x̂ straight into the complex output.  The products run on the port's
own GEMM: wgmma in 3×TF32 (each value split into tf32 hi and lo, the sum
lo·hi + hi·lo + hi·hi in fp32; no library GEMM), every operand K-major,
the chains stacked into one product.  Its operands are laid out here:

  * `pack_factors`: the stacked, signed, transposed factor operands,
    packed once per set of `ops/fourier.py::rdft_matrices` and cached
    (`packed_factors`), already split;
  * `dft_geometry`: the padded widths of the scratch buffers;
  * `gemm_plan`: tile size and split-K factor of each product.

`tf32_round`, `split_tf32`, `gemm_tf32x3_emulated` and
`dft_products_emulated` are the plain PyTorch emulation of that arithmetic
and of the layouts, in the kernel's order and with the tensor cores'
rounding (each k8 step's sum rounded toward zero), which the CPU tests hold
against float64; `dft_products` runs the products alone (the card's timing
and tests; the emulation for a CPU tensor).

`myula_prox_tv_dft` and `myula_prox_tv_irdft` take their plain versions
(`*_plain`: the JAX kernels' bodies on `torch.matmul`) for a CPU tensor and
the kernel for a CUDA tensor; anything else raises.  With
return_iters=True each also returns the prox's per-chain sweep counts
(int32), which the JAX kernels keep to themselves.  Launch counters
(profiling.counters): `launches.D`, `launches.E`, `launches.dft_products`;
while the recorder is on, D and E (and their plain versions) hand the
prox's sweep counts to profiling.count_sweeps.
"""
from __future__ import annotations

import ctypes
import functools
import math
import weakref
from typing import Tuple

import torch

from semiblind_tv_tpu_torch.ops.tv import chambolle_prox, tv_norm
from semiblind_tv_tpu_torch.ops.tv_cuda import (
    chain_scalars,
    check_fields,
    check_status,
    per_chain,
    resident_launch,
)
from semiblind_tv_tpu_torch.runtime import profiling
from semiblind_tv_tpu_torch.samplers.myula import myula_kernel_step

__all__ = [
    "myula_prox_tv_dft", "myula_prox_tv_dft_plain", "myula_prox_tv_irdft",
    "myula_prox_tv_irdft_plain", "dft_products", "dft_products_emulated", "dft_geometry",
    "gemm_plan", "gemm_tf32x3_emulated", "pack_factors", "packed_factors", "split_tf32",
    "tf32_round",
]

_INVERSE = ("CM", "SM", "WCT", "WST")
_FORWARD = ("CN", "SN")

BK = 32          # the GEMM's k-block (one 128-byte swizzle row of fp32)
SMS = 132        # streaming multiprocessors of an H100 SXM


# ---- the plain versions ---------------------------------------------------------


def _grad_plain(ghat, mats, sigma2):
    """irfft2(Ĝ)/σ² in the operation order of _kernel_dft: the inverse
    columns scaled by the value of 1/M, then the inverse rows."""
    cm, sm = mats["CM"], mats["SM"]
    zre, zim = ghat.real, ghat.imag
    inv_m = 1.0 / cm.shape[0]
    yre = (torch.matmul(cm, zre) - torch.matmul(sm, zim)) * inv_m
    yim = (torch.matmul(cm, zim) + torch.matmul(sm, zre)) * inv_m
    return (torch.matmul(yre, mats["WCT"]) - torch.matmul(yim, mats["WST"])) / sigma2


def myula_prox_tv_irdft_plain(
    ghat, x, prox_cache, z, rdft_mats, gamma, lam, lam_theta, sigma2,
    n_sweeps: int = 25, tau: float = 0.249, tol: float = 1e-3, positivity: bool = True,
    return_iters: bool = False,
):
    """The plain PyTorch version of kernel E (the body of _kernel_irdft); a
    scalar of one value a chain broadcasts over its chain."""
    out = _irdft_plain("E", ghat, x, prox_cache, z, rdft_mats, gamma, lam, lam_theta, sigma2,
                       n_sweeps, tau, tol, positivity)
    return out if return_iters else out[:3]


def _irdft_plain(kernel, ghat, x, prox_cache, z, rdft_mats, gamma, lam, lam_theta, sigma2,
                 n_sweeps, tau, tol, positivity):
    """(xn, proxn, tv, sweeps) of E's body, its sweeps counted as `kernel`'s."""
    gamma, lam, lam_theta, sigma2 = (per_chain(v, x) for v in (gamma, lam, lam_theta, sigma2))
    grad = _grad_plain(ghat, rdft_mats, sigma2)
    xn = myula_kernel_step(x, prox_cache, grad, gamma, lam, z, positivity)
    proxn, st = chambolle_prox(xn, lam_theta, n_sweeps, tau=tau, tol=tol)
    profiling.count_sweeps(kernel, st.iters)
    return xn, proxn, tv_norm(xn), st.iters


def myula_prox_tv_dft_plain(
    ghat, x, prox_cache, z, rdft_mats, gamma, lam, lam_theta, sigma2,
    n_sweeps: int = 25, tau: float = 0.249, tol: float = 1e-3, positivity: bool = True,
    return_iters: bool = False,
):
    """The plain PyTorch version of kernel D (the body of _kernel_dft)."""
    xn, proxn, tv, iters = _irdft_plain(
        "D", ghat, x, prox_cache, z, rdft_mats, gamma, lam, lam_theta, sigma2, n_sweeps, tau, tol,
        positivity)
    cm, sm = rdft_mats["CM"], rdft_mats["SM"]
    fre = torch.matmul(xn, rdft_mats["CN"])
    fim = -torch.matmul(xn, rdft_mats["SN"])
    xhat = torch.complex(torch.matmul(cm, fre) + torch.matmul(sm, fim),
                         torch.matmul(cm, fim) - torch.matmul(sm, fre))
    out = (xn, proxn, tv, xhat)
    return out + (iters,) if return_iters else out


# ---- 3×TF32 arithmetic and the operand layouts -------------------------------------


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as `cvt.rna.tf32.f32`: the low 13 bits of the pattern."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(t: torch.Tensor):
    """(hi, lo) with hi = tf32(t) and lo = tf32(t − hi): t − hi is exact in
    float32, and hi + lo is t to 2⁻²² relative."""
    hi = tf32_round(t)
    return hi, tf32_round(t - hi)


def _planes(a: torch.Tensor, ld: int) -> torch.Tensor:
    """(2, rows, ld): a's hi and lo planes, zero beyond its columns."""
    out = torch.zeros((2, a.shape[0], ld), dtype=torch.float32, device=a.device)
    out[0, :, :a.shape[1]], out[1, :, :a.shape[1]] = split_tf32(a.to(torch.float32))
    return out


def dft_geometry(B: int, M: int, N: int) -> dict:
    """Widths of the products' operands (csrc/dft_kernels.cu::Geo): Nh =
    N//2+1 columns of the half-spectrum, Nhp = Nh rounded up to even, and
    the row strides ld1 (2M) and ldN (N) rounded up to multiples of 4, so
    that every TMA stride is a multiple of 16 bytes.  Buffers, each (2,
    rows, ld) as hi and lo planes: gbuf and fbuf (B·Nhp, ld1), ybuf (B·M,
    2·Nhp), xbuf (B·M, ldN)."""
    nh = N // 2 + 1
    return dict(B=B, M=M, N=N, Nh=nh, Nhp=nh + (nh & 1), ld1=-(-2 * M // 4) * 4,
                ldN=-(-N // 4) * 4)


def pack_factors(rdft_mats) -> dict:
    """The products' factor operands from rdft_matrices (rows × K, K-major,
    split): fac_inv = [CM −SM; SM CM] and fac_fwd = [CM SM; −SM CM] (2M
    rows), w_t = [WCTᵀ −WSTᵀ] (N rows, K = 2·Nhp: WCT's rows at 0, WST's at
    Nhp), cns_t = [CNᵀ; −SNᵀ] (2·Nhp rows, CN's columns at 0, SN's at Nhp);
    fac_fwd and cns_t only when CN and SN are given."""
    cm, sm, wct, wst = (rdft_mats[k].to(torch.float32) for k in _INVERSE)
    M, (nh, N) = cm.shape[0], wct.shape
    g = dft_geometry(1, M, N)
    nhp = g["Nhp"]
    out = dict(fac_inv=_planes(torch.cat([torch.cat([cm, -sm], 1), torch.cat([sm, cm], 1)]),
                               g["ld1"]))
    w = torch.zeros((N, 2 * nhp), dtype=torch.float32, device=cm.device)
    w[:, :nh], w[:, nhp:nhp + nh] = wct.T, -wst.T
    out["w_t"] = _planes(w, 2 * nhp)
    if all(k in rdft_mats for k in _FORWARD):
        cn, sn = (rdft_mats[k].to(torch.float32) for k in _FORWARD)
        out["fac_fwd"] = _planes(torch.cat([torch.cat([cm, sm], 1), torch.cat([-sm, cm], 1)]),
                                 g["ld1"])
        c = torch.zeros((2 * nhp, N), dtype=torch.float32, device=cm.device)
        c[:nh], c[nhp:nhp + nh] = cn.T, -sn.T
        out["cns_t"] = _planes(c, g["ldN"])
    return out


_PACKED: dict = {}


def packed_factors(rdft_mats) -> dict:
    """pack_factors(rdft_mats), cached on the matrices themselves (their
    identity and version), so a problem packs once."""
    names = _INVERSE + tuple(k for k in _FORWARD if k in rdft_mats)
    mats = [rdft_mats[k] for k in names]
    key = tuple((id(m), m._version) for m in mats)
    hit = _PACKED.get(key)
    if hit is not None and all(r() is m for r, m in zip(hit[0], mats)):
        return hit[1]
    packed = pack_factors(dict(zip(names, mats)))
    for k, (refs, _) in list(_PACKED.items()):   # drop packings of gone or changed matrices
        if any(r() is None or r()._version != v for r, (_, v) in zip(refs, k)):
            del _PACKED[k]
    _PACKED[key] = ([weakref.ref(m) for m in mats], packed)
    return packed


def _product_dims(g):
    """(rows, cols, K) of products 1 (inverse columns), 2 (inverse rows),
    4 (forward rows) and 5 (forward columns)."""
    B, M, N, nhp = g["B"], g["M"], g["N"], g["Nhp"]
    return [(2 * M, B * nhp, 2 * M), (B * M, N, 2 * nhp), (B * M, 2 * nhp, N),
            (2 * M, B * nhp, 2 * M)]


@functools.lru_cache(maxsize=64)
def gemm_plan(B: int, M: int, N: int):
    """(plan, workspace floats) of the four products: plan = (cfg, splits)
    per product.  cfg 1 is the 128×128 tile, taken when it gives at least
    100 blocks; else cfg 0, the 64×64 tile, split along K until the blocks
    cover the SMs (at most one split per k-block)."""
    plan, ws = [], 0
    for rows, cols, K in _product_dims(dft_geometry(B, M, N)):
        if -(-rows // 128) * -(-cols // 128) >= 100:
            cfg, splits = 1, 1
        else:
            tiles = -(-rows // 64) * -(-cols // 64)
            cfg, splits = 0, max(1, min(-(-K // BK), -(-SMS // tiles)))
        plan += [cfg, splits]
        if splits > 1:
            ws = max(ws, splits * rows * cols)
    return tuple(plan), ws


def _round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 to float32, rounded toward zero."""
    y = x.to(torch.float32)
    over = y.to(torch.float64).abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def _mma_k8(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One k8 step of a tf32 wgmma: acc + a·bᵀ over (at most) 8 columns of
    K, the sum taken exactly (float64: the tf32 products and their sum fit)
    and rounded toward zero to float32, as the tensor cores do."""
    return _round_toward_zero(acc.to(torch.float64) + a.to(torch.float64) @ b.to(torch.float64).T)


def gemm_tf32x3_emulated(a: torch.Tensor, b: torch.Tensor, K: int,
                         splits: int = 1) -> torch.Tensor:
    """C = A·Bᵀ from the hi/lo planes a (2, rows, ≥K) and b (2, cols, ≥K) in
    the kernel's order and rounding: per k-block of BK, big = hi·hi in a
    fresh accumulator and small = −(the running compensation) + lo·hi +
    hi·lo (interleaved per k8 step), each k8 step of either rounded toward
    zero (`_mma_k8`); then big + small added to the split's sum in float32
    with Kahan compensation; the splits (whole k-blocks) added in order."""
    nk = -(-K // BK)
    total = None
    for z in range(splits):
        acc = small = torch.zeros((a.shape[1], b.shape[1]), dtype=torch.float32,
                                  device=a.device)
        for kb in range(nk * z // splits, nk * (z + 1) // splits):
            steps = [slice(k, min(K, k + 8)) for k in range(kb * BK, min(K, (kb + 1) * BK), 8)]
            big = torch.zeros_like(acc)
            for s in steps:
                big = _mma_k8(big, a[0, :, s], b[0, :, s])
            for s in steps:
                small = _mma_k8(small, a[1, :, s], b[0, :, s])
                small = _mma_k8(small, a[0, :, s], b[1, :, s])
            y = big + small
            t = acc + y
            small = y - (t - acc)
            acc = t
        acc = acc + small   # Kahan's estimate: the sum with its outstanding compensation
        total = acc if total is None else total + acc
    return total


def _repack_spectrum(ghat, g):
    """gbuf: row b·Nhp + j = [Ĝre[b, :, j], Ĝim[b, :, j]], zero rows j ≥ Nh."""
    B, M, nh, nhp = g["B"], g["M"], g["Nh"], g["Nhp"]
    st = torch.zeros((B, nhp, 2 * M), dtype=torch.float32, device=ghat.device)
    st[:, :nh, :M], st[:, :nh, M:] = ghat.real.transpose(1, 2), ghat.imag.transpose(1, 2)
    return _planes(st.reshape(B * nhp, 2 * M), g["ld1"])


def _store_y(y, g):
    """ybuf from Y (2M × B·Nhp): row b·M + i = [Yre[b, i, :], Yim[b, i, :]]."""
    B, M, nhp = g["B"], g["M"], g["Nhp"]
    y = y.reshape(2, M, B, nhp).permute(2, 1, 0, 3).reshape(B * M, 2 * nhp)
    return _planes(y, 2 * nhp)


def _store_f(f, g):
    """fbuf from F (B·M × 2Nhp): row b·Nhp + j = [Fre[b, :, j], Fim[b, :, j]]."""
    B, M, nhp = g["B"], g["M"], g["Nhp"]
    f = f.reshape(B, M, 2, nhp).permute(0, 3, 2, 1).reshape(B * nhp, 2 * M)
    return _planes(f, g["ld1"])


def _xhat_of(xt, g):
    """The complex (B, M, Nh) x̂ from X̂ (2M × B·Nhp)."""
    B, M, nh, nhp = g["B"], g["M"], g["Nh"], g["Nhp"]
    xt = xt.reshape(2, M, B, nhp)[..., :nh].permute(0, 2, 1, 3)
    return torch.complex(xt[0], xt[1])


def dft_products_emulated(ghat: torch.Tensor, x: torch.Tensor, packed: dict,
                          forward: bool = True, return_scratch: bool = False):
    """The products of kernels D and E (grad = irfft2(Ĝ), x̂ = rfft2(x)) as
    csrc/dft_kernels.cu runs them at gemm_plan's splits, on any device: the
    repack of Ĝ, the four products through `gemm_tf32x3_emulated` and the
    epilogues' layouts.  Returns (grad, x̂ or None[, scratch dict of gbuf,
    ybuf, xbuf, fbuf])."""
    B, M, N = x.shape
    g = dft_geometry(B, M, N)
    splits = gemm_plan(B, M, N)[0][1::2]
    dims = _product_dims(g)
    scratch = dict(gbuf=_repack_spectrum(ghat, g))
    y = gemm_tf32x3_emulated(packed["fac_inv"], scratch["gbuf"], dims[0][2], splits[0])
    scratch["ybuf"] = _store_y(y * (1.0 / M), g)
    grad = gemm_tf32x3_emulated(scratch["ybuf"], packed["w_t"], dims[1][2], splits[1])
    grad, xhat = grad.reshape(B, M, N), None
    if forward:
        scratch["xbuf"] = _planes(x.reshape(B * M, N), g["ldN"])
        f = gemm_tf32x3_emulated(scratch["xbuf"], packed["cns_t"], dims[2][2], splits[2])
        scratch["fbuf"] = _store_f(f, g)
        xt = gemm_tf32x3_emulated(packed["fac_fwd"], scratch["fbuf"], dims[3][2], splits[3])
        xhat = _xhat_of(xt, g)
    return (grad, xhat, scratch) if return_scratch else (grad, xhat)


# ---- the card --------------------------------------------------------------------


def _check_mats(rdft_mats, names, M, N, like, what):
    nh = N // 2 + 1
    shapes = dict(CM=(M, M), SM=(M, M), WCT=(nh, N), WST=(nh, N), CN=(N, nh), SN=(N, nh))
    for k in names:
        m = rdft_mats[k]
        if m.device != like.device or m.dtype != torch.float32 or tuple(m.shape) != shapes[k] \
                or not m.is_contiguous():
            raise ValueError(f"{what}: rdft_mats[{k!r}] must be a contiguous float32 "
                             f"{shapes[k]} tensor on {like.device}")


def _check_ghat(ghat, B, M, N, like, what):
    nh = N // 2 + 1
    if ghat.dtype != torch.complex64 or tuple(ghat.shape) != (B, M, nh) \
            or not ghat.is_contiguous() or ghat.device != like.device:
        raise ValueError(f"{what}: ghat must be a contiguous complex64 ({B}, {M}, {nh}) "
                         f"tensor on {like.device}, got {ghat.dtype} {tuple(ghat.shape)}")


@functools.lru_cache(maxsize=64)
def _host_plan(B, M, N):
    """(geometry, the plan as a host int array, workspace floats).  The
    array is gemm_plan's eight ints, then the geometry's Nhp, ld1 and ldN:
    the kernel indexes the buffers this module sizes with these widths."""
    plan, ws_floats = gemm_plan(B, M, N)
    g = dft_geometry(B, M, N)
    plan += (g["Nhp"], g["ld1"], g["ldN"])
    return g, (ctypes.c_int * len(plan))(*plan), ws_floats


def _gemm_buffers(B, M, N, forward, dev):
    """Scratch of the products (dft_geometry) and the split-K workspace in
    one allocation, each buffer 256-byte aligned: (allocation, {name:
    (offset, shape)}, host plan, workspace floats)."""
    g, plan, ws_floats = _host_plan(B, M, N)
    nhp = g["Nhp"]
    shapes = dict(gbuf=(2, B * nhp, g["ld1"]), ybuf=(2, B * M, 2 * nhp), ws=(max(ws_floats, 1),))
    if forward:
        shapes.update(xbuf=(2, B * M, g["ldN"]), fbuf=(2, B * nhp, g["ld1"]))
    layout, at = {}, 0
    for k, v in shapes.items():
        layout[k] = (at, v)
        at += -(-math.prod(v) // 64) * 64
    return torch.empty((at,), dtype=torch.float32, device=dev), layout, plan, ws_floats


def _ptrs(flat, layout):
    """Device pointers of the scratch buffers (None for those not made)."""
    base = flat.data_ptr()
    return {k: (base + 4 * layout[k][0] if k in layout else None)
            for k in ("gbuf", "ybuf", "xbuf", "fbuf", "ws")}


def _launch(ghat, x, prox_cache, z, rdft_mats, gamma, lam, lam_theta, sigma2, n_sweeps, tau,
            tol, positivity, forward: bool, return_iters: bool):
    """Check, allocate and launch D (forward=True) or E on the card."""
    from semiblind_tv_tpu_torch._build import load_library

    what = "myula_prox_tv_dft" if forward else "myula_prox_tv_irdft"
    squeeze = x.ndim == 2
    if squeeze:
        ghat, x, prox_cache, z = ghat[None], x[None], prox_cache[None], z[None]
    if x.ndim != 3:
        raise ValueError(f"x must be (M, N) or (B, M, N), got {tuple(x.shape)}")
    check_fields(["x", "prox_cache", "z"], [x, prox_cache, z], x)
    B, M, N = x.shape
    _check_ghat(ghat, B, M, N, x, what)
    _check_mats(rdft_mats, _INVERSE + (_FORWARD if forward else ()), M, N, x, what)
    lib = load_library()
    with torch.cuda.device(x.device):
        packed = packed_factors(rdft_mats)
        scal, strides = chain_scalars(((gamma, "gamma"), (lam, "lam"), (lam_theta, "lam_theta"),
                                       (sigma2, "sigma2")), x)
        dev = x.device
        f32 = dict(dtype=torch.float32, device=dev)
        flat, layout, plan, ws_floats = _gemm_buffers(B, M, N, forward, dev)
        ptr = _ptrs(flat, layout)
        xn = torch.empty_like(x)
        proxn = torch.empty_like(x)
        tv = torch.empty((B,), **f32)
        grad = torch.empty((B, M, N), **f32)
        iters = torch.empty((B,), dtype=torch.int32, device=dev)
        err = torch.empty((B,), **f32)
        geo, ws_int, ws_f, stream = resident_launch(x)
        tail = (iters.data_ptr(), err.data_ptr(), ws_int.data_ptr(), ws_f.data_ptr(),
                ctypes.addressof(plan), ws_floats, B, M, N, geo.chains, geo.grid, geo.stack,
                int(n_sweeps), float(tau), float(tol), int(bool(positivity)), strides, stream)
        head = (torch.view_as_real(ghat).data_ptr(), x.data_ptr(), prox_cache.data_ptr(),
                z.data_ptr(), packed["fac_inv"].data_ptr(), packed["w_t"].data_ptr())
        mid = (*(s.data_ptr() for s in scal), xn.data_ptr(), proxn.data_ptr(), tv.data_ptr())
        if forward:
            xhat = torch.empty((B, M, N // 2 + 1), dtype=torch.complex64, device=dev)
            code = lib.sb_myula_prox_tv_dft(
                *head, packed["fac_fwd"].data_ptr(), packed["cns_t"].data_ptr(), *mid,
                torch.view_as_real(xhat).data_ptr(), ptr["gbuf"], ptr["ybuf"], grad.data_ptr(),
                ptr["xbuf"], ptr["fbuf"], ptr["ws"], *tail)
            out = (xn, proxn, tv, xhat)
        else:
            code = lib.sb_myula_prox_tv_irdft(
                *head, *mid, ptr["gbuf"], ptr["ybuf"], grad.data_ptr(), ptr["ws"], *tail)
            out = (xn, proxn, tv)
    check_status(code, what)
    kernel = "D" if forward else "E"
    profiling.counters.add("launches." + kernel)
    profiling.counters.add("groups." + kernel, geo.groups)
    profiling.count_sweeps(kernel, iters)
    if return_iters:
        out = out + (iters,)
    return tuple(o[0] for o in out) if squeeze else out


def dft_products(ghat: torch.Tensor, x: torch.Tensor, rdft_mats, forward: bool = True,
                 return_scratch: bool = False):
    """Kernel D's products alone, for the card's timing and tests: (grad,
    x̂) with grad = irfft2(Ĝ) (E's products) and, when forward, x̂ = rfft2(x)
    (None otherwise), x (B, M, N) taking xn's place; with return_scratch
    also the scratch dict (gbuf, ybuf and, forward, xbuf, fbuf).  A CPU
    tensor runs `dft_products_emulated`."""
    what = "dft_products"
    if x.ndim != 3:
        raise ValueError(f"{what}: x must be (B, M, N), got {tuple(x.shape)}")
    B, M, N = x.shape
    _check_ghat(ghat, B, M, N, x, what)
    _check_mats(rdft_mats, _INVERSE + (_FORWARD if forward else ()), M, N, x, what)
    if x.device.type == "cpu":
        return dft_products_emulated(ghat, x, packed_factors(rdft_mats), forward=forward,
                                     return_scratch=return_scratch)
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    check_fields(["x"], [x], x)
    from semiblind_tv_tpu_torch._build import load_library

    lib = load_library()
    with torch.cuda.device(x.device):
        packed = packed_factors(rdft_mats)
        flat, layout, plan, ws_floats = _gemm_buffers(B, M, N, forward, x.device)
        ptr = _ptrs(flat, layout)
        grad = torch.empty((B, M, N), dtype=torch.float32, device=x.device)
        xhat = torch.empty((B, M, N // 2 + 1), dtype=torch.complex64, device=x.device) \
            if forward else None
        code = lib.sb_dft_products(
            torch.view_as_real(ghat).data_ptr(), x.data_ptr(), packed["fac_inv"].data_ptr(),
            packed["w_t"].data_ptr(), packed["fac_fwd"].data_ptr() if forward else None,
            packed["cns_t"].data_ptr() if forward else None, grad.data_ptr(),
            torch.view_as_real(xhat).data_ptr() if forward else None, ptr["gbuf"], ptr["ybuf"],
            ptr["xbuf"], ptr["fbuf"], ptr["ws"], ctypes.addressof(plan), ws_floats, B, M, N,
            torch.cuda.current_stream(x.device).cuda_stream)
    check_status(code, what)
    profiling.counters.add("launches.dft_products")
    if not return_scratch:
        return grad, xhat
    scratch = {k: flat[o:o + math.prod(v)].view(v) for k, (o, v) in layout.items() if k != "ws"}
    return grad, xhat, scratch


def myula_prox_tv_dft(
    ghat: torch.Tensor,
    x: torch.Tensor,
    prox_cache: torch.Tensor,
    z: torch.Tensor,
    rdft_mats,
    gamma,
    lam,
    lam_theta,
    sigma2,
    n_sweeps: int = 25,
    tau: float = 0.249,
    tol: float = 1e-3,
    positivity: bool = True,
    return_iters: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Kernel D: (x_new, prox_new, tv, xhat_new) of one SAPG iteration from
    Ĝ = conj(H)·(H·X̂ − ŷ) (before the σ² division); rdft_mats is
    fourier.rdft_matrices(shape).  Signature of
    fused_step_pallas.myula_prox_tv_dft without `interpret` and
    `precision` (the port's products keep fp32 accuracy)."""
    if x.device.type == "cpu":
        return myula_prox_tv_dft_plain(ghat, x, prox_cache, z, rdft_mats, gamma, lam,
                                       lam_theta, sigma2, n_sweeps, tau, tol, positivity,
                                       return_iters)
    if x.device.type != "cuda":
        raise ValueError(f"myula_prox_tv_dft: unsupported device {x.device}")
    return _launch(ghat, x, prox_cache, z, rdft_mats, gamma, lam, lam_theta, sigma2, n_sweeps,
                   tau, tol, positivity, True, return_iters)


def myula_prox_tv_irdft(
    ghat: torch.Tensor,
    x: torch.Tensor,
    prox_cache: torch.Tensor,
    z: torch.Tensor,
    rdft_mats,
    gamma,
    lam,
    lam_theta,
    sigma2,
    n_sweeps: int = 25,
    tau: float = 0.249,
    tol: float = 1e-3,
    positivity: bool = True,
    return_iters: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Kernel E: kernel D without the forward transform; returns (x_new,
    prox_new, tv).  Signature of fused_step_pallas.myula_prox_tv_irdft
    without `interpret` and `precision`."""
    if x.device.type == "cpu":
        return myula_prox_tv_irdft_plain(ghat, x, prox_cache, z, rdft_mats, gamma, lam,
                                         lam_theta, sigma2, n_sweeps, tau, tol, positivity,
                                         return_iters)
    if x.device.type != "cuda":
        raise ValueError(f"myula_prox_tv_irdft: unsupported device {x.device}")
    return _launch(ghat, x, prox_cache, z, rdft_mats, gamma, lam, lam_theta, sigma2, n_sweeps,
                   tau, tol, positivity, False, return_iters)
