"""Counter-based standard normals for the in-kernel-noise step: the plain
version of the device Philox of `csrc/rng.cuh` (counterpart of
`semiblind_tv_tpu/ops/tv_pallas.py::box_muller_normals`, which draws from
the TPU's per-core hardware generator).

Layout.  Chain b is keyed by its seed pair (seeds[b, 0], seeds[b, 1]) read
as two uint32 words.  Pixel p (row-major in the (M, N) plane) uses the
Philox4x32-10 block of counter (p // 4, 0, 0, 0): its words 0 and 1 give
the (u1, u2) pair of pixels 4g and 4g+1, words 2 and 3 that of pixels 4g+2
and 4g+3.  From the top 24 bits `top` of a word, u1 = (top + 1)·2⁻²⁴ in
(0, 1] and u2 = top·2⁻²⁴ in [0, 1), as in the JAX version; then
r = √(−2 log u1), and z = r·cos(2πu2) at the even pixel, r·sin(2πu2) at
the odd one.  Every pixel's z is a pure function of (seed, pixel index),
so a kernel can recompute a neighbour's noise and a tiled kernel's window
needs no pairing of rows.

PyTorch on the CPU has no right shift for uint32, so the integer part runs
in int64 with every 32×32-bit product split into 16-bit limbs (no product
overflows) and masked to 32 bits; it is exact, on the CPU and on the card.
"""
from __future__ import annotations

import torch

__all__ = ["philox4x32_10", "philox_normals", "PHILOX_M", "PHILOX_W"]

PHILOX_M = (0xD2511F53, 0xCD9E8D57)   # round multipliers
PHILOX_W = (0x9E3779B9, 0xBB67AE85)   # Weyl key increments
_MASK = 0xFFFFFFFF
_TWO_PI = 6.283185307179586


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product m·c, c uint32 in int64."""
    mh, ml = m >> 16, m & 0xFFFF
    ch, cl = c >> 16, c & 0xFFFF
    mid = mh * cl + ml * ch                       # < 2^33
    lo_full = ml * cl + ((mid & 0xFFFF) << 16)    # < 2^33
    lo = lo_full & _MASK
    hi = mh * ch + (mid >> 16) + (lo_full >> 32)
    return hi & _MASK, lo


def philox4x32_10(counter, key):
    """Philox4x32 with 10 rounds (Salmon et al., SC'11; Random123's
    philox4x32_R).  counter: four int64 tensors of uint32 values, key: two
    (broadcastable); returns the four output words as int64 tensors."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W[0]) & _MASK
            k1 = (k1 + PHILOX_W[1]) & _MASK
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_normals(seeds: torch.Tensor, shape, dtype=torch.float32) -> torch.Tensor:
    """Standard normals of `shape` (M, N) for each chain's seed pair:
    seeds (B, 2) int32 gives (B, M, N), seeds (2,) gives (M, N).  Computed
    in `dtype` on the seeds' device, in the operation order of the device
    version (csrc/rng.cuh::philox_normal)."""
    squeeze = seeds.ndim == 1
    s = seeds.reshape(-1, 2).to(torch.int64) & _MASK
    M, N = (int(v) for v in shape)
    n_px = M * N
    groups = torch.arange((n_px + 3) // 4, dtype=torch.int64, device=seeds.device)[None]
    zero = torch.zeros_like(groups)
    w = philox4x32_10((groups, zero, zero, zero), (s[:, :1], s[:, 1:]))
    scale = 2.0 ** -24

    def pair(a, b):
        u1 = ((a >> 8) + 1).to(dtype) * scale
        u2 = (b >> 8).to(dtype) * scale
        r = torch.sqrt(-2.0 * torch.log(u1))
        t = torch.tensor(_TWO_PI, dtype=dtype) * u2
        return r * torch.cos(t), r * torch.sin(t)

    z = torch.stack(pair(w[0], w[1]) + pair(w[2], w[3]), dim=-1)   # (B, G, 4)
    # contiguous: cutting the last group's spare normals leaves a strided view
    z = z.reshape(s.shape[0], -1)[:, :n_px].reshape(-1, M, N).contiguous()
    return z[0] if squeeze else z
