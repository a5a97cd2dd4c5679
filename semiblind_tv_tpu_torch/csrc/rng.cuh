// Counter-based standard normals on the device: Philox4x32-10 and
// Box–Muller, the device version of ops/rng.py::philox_normals (its
// docstring has the layout).  Replaces the TPU's per-core hardware
// generator (pltpu.prng_seed / prng_random_bits in
// semiblind_tv_tpu/ops/tv_pallas.py::box_muller_normals).
//
// Pixel p of a chain keyed by (k0, k1) takes the Philox block of counter
// (p / 4, 0, 0, 0); its noise depends on nothing else, so a kernel may
// evaluate it at any pixel, a neighbour's included.  One evaluation costs
// 10 rounds of two 32x32-bit multiplies, a logf, a sqrtf and a sinf or a
// cosf.  The float part runs in the operation order of the plain version,
// with IEEE logf/sqrtf/sinf/cosf (no fast math, --fmad=false).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Philox4x32-10 of counter (c0, 0, 0, 0) under key (k0, k1): out[0..3].
__device__ __forceinline__ void philox4x32_10(uint32_t c0, uint32_t k0, uint32_t k1,
                                              uint32_t out[4]) {
  uint32_t c1 = 0u, c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  out[0] = c0;
  out[1] = c1;
  out[2] = c2;
  out[3] = c3;
}

// The standard normal of pixel p under key (k0, k1).
__device__ __forceinline__ float philox_normal(size_t p, uint32_t k0, uint32_t k1) {
  uint32_t w[4];
  philox4x32_10((uint32_t)(p >> 2), k0, k1, w);
  const uint32_t a = (p & 2) ? w[2] : w[0];
  const uint32_t b = (p & 2) ? w[3] : w[1];
  const float u1 = (float)((a >> 8) + 1u) * 5.9604644775390625e-08f;   // 2^-24
  const float u2 = (float)(b >> 8) * 5.9604644775390625e-08f;
  const float r = sqrtf(-2.0f * logf(u1));
  const float t = 6.283185307179586f * u2;
  return r * ((p & 1) ? sinf(t) : cosf(t));
}

}  // namespace
