// Chambolle-sweep variant probe for Hopper (sm_90a): eleven forms of the
// fresh-dual prox f = g − λ·div p, each changing one class of operation.
//
// Replaces the Pallas TPU kernel of the JAX package's
//   benchmarks/probe_prox_variants.py::build (its pallas_call; make_kernel)
// which runs each variant with the image and both duals resident in VMEM.
// Here every mode runs kernel A's schedule (tv_kernels.cu): one launch per
// sweep over 32x8 tiles (one thread a pixel, the divergence read from
// device memory, most of it served by L2 at 512²), the duals ping-ponging
// between two buffers, a device-side per-chain `active` flag, fixed-order
// per-tile residual partials and a per-chain reduce (no float atomics, no
// host sync), then one assembly launch.  Bound: at 512² B=16 a sweep moves
// ~5 fields through L2 and executes ~30 float operations a pixel; at B=1 the
// launches themselves.  The probe measures how each mode moves that time.
//
// How each mode realises J's loop (Traits below):
//   base     masked: an inactive chain's blocks still compute and write
//            active ? new : old (JAX's where-frozen fori_loop); 2 divides
//   recip    base with rden = 1/(1 + τ·tmp) and 2 multiplies
//   noresid  recip, no residual: no partials, no reduce launch; every chain
//            runs max_iter sweeps, meta = (max_iter, 0)
//   nosqrt   noresid with tmp = upx² + upy² (wrong by design)
//   while    recip with a true early exit: an inactive chain's blocks
//            return at once, no select
//   roll     while with the image-boundary terms of div and ∇ formed by
//   rollmul  select masks / 0/1 multiplicative masks (clamped neighbour
//            indices) in place of the i < M−1, j < N−1 branches; the values
//            are the concatenate form's, so both equal `while` bit for bit.
//            The TPU's rolls have no CUDA counterpart: the boundary form is
//            what carries over.
//   every5   while with partials and the reduce only on sweeps 5, 10, ...:
//            the exit can fire only there
//   bf16mix  duals stored as bfloat16 (half the dual bytes) and the stencil
//            adds/subs rounded to bfloat16; sqrt, reciprocal, update and
//            residual in float32, the new duals rounded when stored
//   bf16     every sweep operation rounded to bfloat16, residual in float32
//   bf16all  bf16 with the residual terms rounded to bfloat16 too (float32
//            partial sums)
// A bfloat16 operation is the float32 operation on bfloat16 values rounded
// once to bfloat16 (__float2bfloat16_rn), which is how PyTorch computes it;
// this includes sqrt and the reciprocal (hsqrt/hrcp, approximate, are not
// used).  Products and sums of two bfloat16 values are exact in float32, so
// those equal native bfloat16 arithmetic.  The final f = g − λ·div p is
// float32 from the (widened) duals, as in J.
//
// Built with --fmad=false so the float32 modes round like PyTorch's separate
// operations; '/' and sqrtf are IEEE.
//
// Entry point sb_prox_variant: the caller allocates px_buf/py_buf as
// (2, B, M, N) of the mode's dual type (float32, or bfloat16 for the bf16
// modes), iters/err/active (B,), partials (B, sb_num_tiles(M, N)), f
// (B, M, N) and meta (B, 2) = (sweeps run, last residual).  scal = (λ, τ,
// tol) stays in device memory.  Returns the first CUDA error.

#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"

namespace {

enum Mode { BASE, RECIP, NORESID, NOSQRT, WHILE, ROLL, ROLLMUL, EVERY5, BF16MIX, BF16, BF16ALL };
enum Form { CONCAT, SELECT, MULMASK };

template <int MODE>
struct Traits {
  static constexpr bool kBf16Dual = MODE == BF16MIX || MODE == BF16 || MODE == BF16ALL;
  static constexpr bool kBf16Arith = MODE == BF16 || MODE == BF16ALL;
  static constexpr bool kResid = MODE != NORESID && MODE != NOSQRT;
  static constexpr bool kMasked = MODE == BASE || MODE == RECIP;
  static constexpr bool kSqrt = MODE != NOSQRT;
  static constexpr bool kDivide = MODE == BASE;
  static constexpr int kForm = MODE == ROLL ? SELECT : (MODE == ROLLMUL ? MULMASK : CONCAT);
  // every sweep writes every chain's duals: they end in buffer max_iter % 2
  static constexpr bool kAllSweeps = kMasked || !kResid;
  using Dual = typename std::conditional<kBf16Dual, __nv_bfloat16, float>::type;
};

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// v rounded to bfloat16 when BF (and returned as float), else v.
template <bool BF>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (BF) return __bfloat162float(__float2bfloat16_rn(v));
  else return v;
}

// u = div p − g/λ at (i, j) of one (M, N) plane (ops/tv.py::divergence: row
// 0 -> p1[0], rows 1..M-2 -> p1[i] − p1[i−1], row M−1 -> −p1[M−1]; the same
// for the columns with p2), in the mode's boundary form, each operation
// rounded to bfloat16 when BF.
template <int FORM, bool BF, class D>
__device__ __forceinline__ float u_at(const D* __restrict__ p1, const D* __restrict__ p2,
                                      const float* __restrict__ g, float lam, int i, int j,
                                      int M, int N) {
  const size_t idx = (size_t)i * N + j;
  const float c1 = ld(p1, idx);
  const float c2 = ld(p2, idx);
  float a, b;
  if constexpr (FORM == CONCAT) {
    if (i == 0) a = c1;
    else if (i == M - 1) a = -c1;
    else a = rnd<BF>(c1 - ld(p1, idx - N));
    if (j == 0) b = c2;
    else if (j == N - 1) b = -c2;
    else b = rnd<BF>(c2 - ld(p2, idx - 1));
  } else {
    // x − 0 = x, so the masked forms give the branches' values exactly
    const float d1 = ld(p1, i > 0 ? idx - N : idx);
    const float d2 = ld(p2, j > 0 ? idx - 1 : idx);
    const bool mid_i = i > 0 && i < M - 1;
    const bool mid_j = j > 0 && j < N - 1;
    if constexpr (FORM == SELECT) {
      a = (i < M - 1 ? c1 : -c1) - (mid_i ? d1 : 0.f);
      b = (j < N - 1 ? c2 : -c2) - (mid_j ? d2 : 0.f);
    } else {
      a = c1 * ((float)(i < M - 1) - (float)(i == M - 1)) - d1 * (float)mid_i;
      b = c2 * ((float)(j < N - 1) - (float)(j == N - 1)) - d2 * (float)mid_j;
    }
  }
  return rnd<BF>(rnd<BF>(a + b) - rnd<BF>(g[idx] / lam));
}

__global__ void variant_init(int* __restrict__ iters, float* __restrict__ err,
                             int* __restrict__ active, int B, float err0) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) {
    iters[b] = 0;
    err[b] = err0;
    active[b] = 1;
  }
}

// One sweep of mode MODE on g/λ; `resid` (uniform) asks for the tile's
// partial sum of rx² + ry².  Grid (⌈N/TX⌉, ⌈M/TY⌉, B), block (TX, TY).
template <int MODE>
__global__ void __launch_bounds__(NT)
variant_sweep(const float* __restrict__ g, const float* __restrict__ scal,
              const typename Traits<MODE>::Dual* __restrict__ px,
              const typename Traits<MODE>::Dual* __restrict__ py,
              typename Traits<MODE>::Dual* __restrict__ qx,
              typename Traits<MODE>::Dual* __restrict__ qy,
              const int* __restrict__ active, float* __restrict__ partials, int M, int N,
              int resid) {
  using T = Traits<MODE>;
  constexpr bool BS = T::kBf16Dual;   // bfloat16 stencil
  constexpr bool BA = T::kBf16Arith;  // bfloat16 sqrt, reciprocal and update
  __shared__ float sh[NT];
  const int b = blockIdx.z;
  const bool act = active[b] != 0;
  if (!T::kMasked && !act) return;  // uniform over the block
  const size_t off = (size_t)b * M * N;
  const auto* pxb = px + off;
  const auto* pyb = py + off;
  const float* gb = g + off;
  const float lam = scal[0];
  const float tau = scal[1];
  const int j = blockIdx.x * TX + threadIdx.x;
  const int i = blockIdx.y * TY + threadIdx.y;
  float r2 = 0.f;
  if (i < M && j < N) {
    const size_t idx = (size_t)i * N + j;
    constexpr int F = T::kForm;
    const float u = u_at<F, BS>(pxb, pyb, gb, lam, i, j, M, N);
    float upx = 0.f, upy = 0.f;
    if constexpr (F == CONCAT) {
      if (i < M - 1) upx = rnd<BS>(u_at<F, BS>(pxb, pyb, gb, lam, i + 1, j, M, N) - u);
      if (j < N - 1) upy = rnd<BS>(u_at<F, BS>(pxb, pyb, gb, lam, i, j + 1, M, N) - u);
    } else {
      const float ud = u_at<F, BS>(pxb, pyb, gb, lam, min(i + 1, M - 1), j, M, N);
      const float ur = u_at<F, BS>(pxb, pyb, gb, lam, i, min(j + 1, N - 1), M, N);
      if constexpr (F == SELECT) {
        upx = i < M - 1 ? ud - u : 0.f;
        upy = j < N - 1 ? ur - u : 0.f;
      } else {
        upx = (ud - u) * (float)(i < M - 1);
        upy = (ur - u) * (float)(j < N - 1);
      }
    }
    const float p1 = ld(pxb, idx);
    const float p2 = ld(pyb, idx);
    float q1, q2;
    if constexpr (BA) {
      const float tb = rnd<true>(tau);
      const float tmp = rnd<true>(sqrtf(rnd<true>(rnd<true>(upx * upx) + rnd<true>(upy * upy))));
      if (resid) {
        if constexpr (MODE == BF16) {
          const float rx = -upx + tmp * p1;
          const float ry = -upy + tmp * p2;
          r2 = rx * rx + ry * ry;
        } else {
          const float rx = rnd<true>(-upx + rnd<true>(tmp * p1));
          const float ry = rnd<true>(-upy + rnd<true>(tmp * p2));
          r2 = rnd<true>(rnd<true>(rx * rx) + rnd<true>(ry * ry));
        }
      }
      const float rden = rnd<true>(1.0f / rnd<true>(1.0f + rnd<true>(tb * tmp)));
      q1 = rnd<true>(rnd<true>(p1 + rnd<true>(tb * upx)) * rden);
      q2 = rnd<true>(rnd<true>(p2 + rnd<true>(tb * upy)) * rden);
    } else {
      const float s = upx * upx + upy * upy;
      const float tmp = T::kSqrt ? sqrtf(s) : s;
      if (T::kResid && resid) {
        const float rx = -upx + tmp * p1;
        const float ry = -upy + tmp * p2;
        r2 = rx * rx + ry * ry;
      }
      if constexpr (T::kDivide) {
        const float denom = 1.0f + tau * tmp;
        q1 = (p1 + tau * upx) / denom;
        q2 = (p2 + tau * upy) / denom;
      } else {
        const float rden = 1.0f / (1.0f + tau * tmp);
        q1 = (p1 + tau * upx) * rden;
        q2 = (p2 + tau * upy) * rden;
      }
    }
    if (T::kMasked && !act) {
      q1 = p1;
      q2 = p2;
    }
    st(qx + off, idx, q1);
    st(qy + off, idx, q2);
  }
  if (T::kResid && resid) {
    const float s = tile_sum(r2, sh);
    if (threadIdx.x == 0 && threadIdx.y == 0)
      partials[(size_t)b * gridDim.x * gridDim.y + blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// err = sqrt(fixed-order sum of the chain's partials), iters = sweeps run
// so far, active = err > tol; an inactive chain is left as it is.
__global__ void __launch_bounds__(RT)
variant_reduce(const float* __restrict__ partials, int nblk, const float* __restrict__ scal,
               int* __restrict__ active, int* __restrict__ iters, float* __restrict__ err,
               int sweeps) {
  __shared__ float sh[RT];
  const int b = blockIdx.x;
  if (!active[b]) return;
  const float s = chain_sum(partials + (size_t)b * nblk, nblk, sh);
  if (threadIdx.x == 0) {
    const float e = sqrtf(s);
    err[b] = e;
    iters[b] = sweeps;
    active[b] = (e > scal[2]) ? 1 : 0;
  }
}

// f = g − λ·div p in float32 from the chain's last duals, and meta.  A chain
// still active ran max_iter sweeps; its duals are in buffer k % 2, or
// max_iter % 2 when every sweep wrote every chain (all_sweeps).
template <class D>
__global__ void __launch_bounds__(NT)
variant_assemble(const float* __restrict__ g, const float* __restrict__ scal,
                 const D* __restrict__ px_buf, const D* __restrict__ py_buf,
                 const int* __restrict__ iters, const int* __restrict__ active,
                 const float* __restrict__ err, float* __restrict__ f, float* __restrict__ meta,
                 int B, int M, int N, int max_iter, int all_sweeps) {
  const int b = blockIdx.z;
  const int k = active[b] ? max_iter : iters[b];
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0 && threadIdx.y == 0) {
    meta[2 * b] = (float)k;
    meta[2 * b + 1] = err[b];
  }
  const int j = blockIdx.x * TX + threadIdx.x;
  const int i = blockIdx.y * TY + threadIdx.y;
  if (i >= M || j >= N) return;
  const size_t plane = (size_t)M * N;
  const size_t off = (size_t)b * plane;
  const size_t sel = (size_t)((all_sweeps ? max_iter : k) & 1) * B * plane + off;
  const D* p1 = px_buf + sel;
  const D* p2 = py_buf + sel;
  const size_t idx = (size_t)i * N + j;
  float a, c;
  if (i == 0) a = ld(p1, idx);
  else if (i == M - 1) a = -ld(p1, idx);
  else a = ld(p1, idx) - ld(p1, idx - N);
  if (j == 0) c = ld(p2, idx);
  else if (j == N - 1) c = -ld(p2, idx);
  else c = ld(p2, idx) - ld(p2, idx - 1);
  f[off + idx] = g[off + idx] - scal[0] * (a + c);
}

template <int MODE>
cudaError_t run_mode(const float* g, const float* scal, void* px_buf, void* py_buf, int* iters,
                     float* err, int* active, float* partials, float* f, float* meta, int B,
                     int M, int N, int max_iter, cudaStream_t st) {
  using T = Traits<MODE>;
  using D = typename T::Dual;
  D* px = static_cast<D*>(px_buf);
  D* py = static_cast<D*>(py_buf);
  const dim3 block(TX, TY);
  const dim3 grid((N + TX - 1) / TX, (M + TY - 1) / TY, B);
  const int nblk = (int)(grid.x * grid.y);
  const size_t n = (size_t)B * M * N;
  cudaError_t e;
  // fresh duals: buffer 0 only (buffer 1 is written before it is read)
  if ((e = cudaMemsetAsync(px, 0, n * sizeof(D), st)) != cudaSuccess) return e;
  if ((e = cudaMemsetAsync(py, 0, n * sizeof(D), st)) != cudaSuccess) return e;
  variant_init<<<(B + 255) / 256, 256, 0, st>>>(iters, err, active, B,
                                                 T::kResid ? INFINITY : 0.f);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  for (int s = 0; s < max_iter; ++s) {
    const bool resid = T::kResid && (MODE != EVERY5 || (s + 1) % 5 == 0);
    const size_t rd = (size_t)(s & 1) * n;
    const size_t wr = (size_t)((s + 1) & 1) * n;
    variant_sweep<MODE><<<grid, block, 0, st>>>(g, scal, px + rd, py + rd, px + wr, py + wr,
                                                active, partials, M, N, resid ? 1 : 0);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    if (resid) {
      variant_reduce<<<B, RT, 0, st>>>(partials, nblk, scal, active, iters, err, s + 1);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
  }
  variant_assemble<D><<<grid, block, 0, st>>>(g, scal, px, py, iters, active, err, f, meta, B,
                                              M, N, max_iter, T::kAllSweeps ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel J: mode is the index in semiblind_tv_tpu_torch/benchmarks/
// probe_prox_variants.py::MODES (the order of enum Mode).
int sb_prox_variant(int mode, const float* g, const float* scal, void* px_buf, void* py_buf,
                    int* iters, float* err, int* active, float* partials, float* f,
                    float* meta, int B, int M, int N, int max_iter, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SB_MODE(m)                                                                         \
  case m:                                                                                  \
    return run_mode<m>(g, scal, px_buf, py_buf, iters, err, active, partials, f, meta, B, \
                       M, N, max_iter, st)
  switch (mode) {
    SB_MODE(BASE);
    SB_MODE(RECIP);
    SB_MODE(NORESID);
    SB_MODE(NOSQRT);
    SB_MODE(WHILE);
    SB_MODE(ROLL);
    SB_MODE(ROLLMUL);
    SB_MODE(EVERY5);
    SB_MODE(BF16MIX);
    SB_MODE(BF16);
    SB_MODE(BF16ALL);
    default:
      return cudaErrorInvalidValue;
  }
#undef SB_MODE
}

}  // extern "C"
