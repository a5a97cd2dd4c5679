// The whole-iteration DFT steps for Hopper (sm_90a): an fp32 GEMM for the
// dense-DFT factor products, and the glue entry points of kernels D and E.
//
// Replaces the Pallas TPU kernels
//   D  semiblind_tv_tpu/ops/fused_step_pallas.py::myula_prox_tv_dft
//      (_kernel_dft: irfft2(Ĝ)/σ² by six DFT matmuls, kernel B's MYULA +
//      prox + TV, then rfft2(xn) by six more, all in one VMEM-resident
//      launch per chain)
//   E  semiblind_tv_tpu/ops/fused_step_pallas.py::myula_prox_tv_irdft
//      (_kernel_irdft: D without the forward rfft2)
// The TPU keeps the six factor matrices and the fields in VMEM; on Hopper
// CM and SM alone are 1 MB each at 512², far above one SM's 227 KB of
// shared memory.  So D becomes a short launch sequence on one stream, with
// no host sync:
//   1. GEMM, inverse columns:  Y  = (1/M)·[CM −SM; SM CM]·[Ĝre; Ĝim]   (2M×Nh)
//   2. GEMM, inverse rows:     grad = [Yre Yim]·[WCT; −WST]            (M×N)
//   3. kernel B's sequence with σ² (tv_kernels.cu::sb_myula_step)
//   4. GEMM, forward rows:     F  = xn·[CN −SN]                         (M×2Nh)
//   5. GEMM, forward columns:  X̂ = [CM SM; −SM CM]·[Fre; Fim]          (2M×Nh)
// E stops after 3.  Stacking the complex products into real ones does the
// TPU kernel's 12 products and no more: 1.6 GFLOP a chain-step at 512²
// (0.81 for E).  The block structure and signs of the stacked operands are
// applied by the operand loaders, so no stacked copy of a matrix is made;
// Ĝ is read and X̂ written interleaved (re, im) in place, as
// torch.view_as_real lays out a complex64 tensor.
//
// Bound.  A simple shared-memory-tiled SIMT GEMM: 64×64 block tiles, a
// depth of 16 a step, 256 threads with a 4×4 register micro-tile each, two
// 16-byte shared-memory loads per 16 FMAs, and a Kahan-compensated sum of
// the 16-deep partial products (4 adds per output per step).  It runs far
// below the card's 67 TFLOP/s fp32 peak, and at B=1 its grids fill only
// 24–80 of the 132 SMs; the products are in full fp32 with explicit
// __fmaf_rn (the library is built with --fmad=false), no TF32 and no tensor
// cores, as the TPU kernel runs at Precision.HIGHEST.  wgmma with 3×TF32
// splitting and TMA are a later design.
//
// The C interface takes raw pointers and a cudaStream_t and returns the
// first CUDA error (cudaSuccess == 0); the caller allocates everything.

#include "common.cuh"

namespace {

constexpr int GB = 64;     // block tile: GB rows x GB columns of C
constexpr int GK = 16;     // depth of one k-step
constexpr int GT = 256;    // threads: 16 x 16, each a 4 x 4 micro-tile
constexpr int GPAD = 4;    // shared row padding (keeps 16-byte alignment)

// C_b(i, j) = alpha · Σ_k A_b(i, k)·B_b(k, j) for i < R, j < C, k < K; the
// operands are read through the loaders la(b, i, k), lb(b, k, j) and the
// result written by sc(b, i, j, v).  Grid (⌈C/GB⌉, ⌈R/GB⌉, B).  The sum
// over k runs in blocks of GK terms, each by fused multiply-adds in order;
// the block sums are added with Kahan compensation, so the rounding error
// stays near that of a GK-term sum whatever K (a plain running sum over
// K = 2M = 512 terms deviated from float64 2.2 times as much as
// torch.matmul did at 256² on an H100).
template <class LA, class LB, class SC>
__global__ void __launch_bounds__(GT)
gemm(LA la, LB lb, SC sc, int R, int C, int K, float alpha) {
  __shared__ __align__(16) float As[GK][GB + GPAD];
  __shared__ __align__(16) float Bs[GK][GB + GPAD];
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * GB, j0 = blockIdx.x * GB;
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  float acc[4][4], cmp[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = cmp[p][q] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GK) {
#pragma unroll
    for (int r = 0; r < GB * GK / GT; ++r) {
      const int e = t + r * GT;
      const int ai = e / GK, ak = e % GK;     // A tile: k fastest
      const int gi = i0 + ai, gka = k0 + ak;
      As[ak][ai] = (gi < R && gka < K) ? la(b, gi, gka) : 0.f;
      const int bk = e / GB, bj = e % GB;     // B tile: j fastest
      const int gkb = k0 + bk, gj = j0 + bj;
      Bs[bk][bj] = (gkb < K && gj < C) ? lb(b, gkb, gj) : 0.f;
    }
    __syncthreads();
    float part[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[p][q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 v = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[p][q] = __fmaf_rn(av[p], bv[q], part[p][q]);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) {   // Kahan: acc += part
        const float y = part[p][q] - cmp[p][q];
        const float s = acc[p][q] + y;
        cmp[p][q] = (s - acc[p][q]) - y;
        acc[p][q] = s;
      }
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + ty * 4 + p, j = j0 + tx * 4 + q;
      if (i < R && j < C) sc(b, i, j, acc[p][q] * alpha);
    }
}

// An (M, M) pair of symmetric factors stacked as [CM sA·SM; sB·SM CM]
// (2M × 2M): inverse columns sA = −1, sB = +1; forward columns sA = +1,
// sB = −1.  Negation is exact.
struct ColFactor {
  const float* cm;
  const float* sm;
  int M;
  float s_upper;   // sign of the upper-right SM block
  __device__ float operator()(int, int i, int k) const {
    const bool ui = i < M, uk = k < M;
    const size_t o = (size_t)(ui ? i : i - M) * M + (uk ? k : k - M);
    if (ui == uk) return cm[o];
    return ui ? s_upper * sm[o] : -s_upper * sm[o];
  }
};

// [Ĝre; Ĝim] (2M × Nh) from the interleaved complex (B, M, Nh).
struct HalfSpectrumStack {
  const float* g;
  int M, Nh;
  __device__ float operator()(int b, int k, int n) const {
    const int re_im = k < M ? 0 : 1;
    const int row = k < M ? k : k - M;
    return g[(((size_t)b * M + row) * Nh + n) * 2 + re_im];
  }
};

// Row-major (B, rows, cols) field.
struct Field {
  float* p;
  int rows, cols;
  __device__ float operator()(int b, int i, int j) const {
    return p[((size_t)b * rows + i) * cols + j];
  }
  __device__ void operator()(int b, int i, int j, float v) const {
    p[((size_t)b * rows + i) * cols + j] = v;
  }
};

// [Yre Yim] (M × 2Nh) from Y stored as (B, 2M, Nh): rows M.. hold Yim.
struct StackedRowsAsCols {
  const float* y;
  int M, Nh;
  __device__ float operator()(int b, int i, int k) const {
    const size_t row = k < Nh ? (size_t)i : (size_t)(M + i);
    return y[((size_t)b * 2 * M + row) * Nh + (k < Nh ? k : k - Nh)];
  }
};

// [Fre; Fim] (2M × Nh) from F stored as (B, M, 2Nh): columns Nh.. hold Fim.
struct StackedColsAsRows {
  const float* f;
  int M, Nh;
  __device__ float operator()(int b, int k, int n) const {
    const int row = k < M ? k : k - M;
    return f[((size_t)b * M + row) * 2 * Nh + (k < M ? n : Nh + n)];
  }
};

// [P; s·Q] (2Nh × N) from two (Nh, N) matrices: the inverse rows' [WCT; −WST].
struct RowPair {
  const float* p;
  const float* q;
  int Nh, N;
  float s;
  __device__ float operator()(int, int k, int n) const {
    return k < Nh ? p[(size_t)k * N + n] : s * q[(size_t)(k - Nh) * N + n];
  }
};

// [P s·Q] (N × 2Nh) from two (N, Nh) matrices: the forward rows' [CN −SN].
struct ColPair {
  const float* p;
  const float* q;
  int Nh;
  float s;
  __device__ float operator()(int, int n, int k) const {
    return k < Nh ? p[(size_t)n * Nh + k] : s * q[(size_t)n * Nh + (k - Nh)];
  }
};

// X̂ (2M × Nh, rows M.. the imaginary parts) into the interleaved complex
// (B, M, Nh).
struct HalfSpectrumOut {
  float* g;
  int M, Nh;
  __device__ void operator()(int b, int i, int n, float v) const {
    const int re_im = i < M ? 0 : 1;
    const int row = i < M ? i : i - M;
    g[(((size_t)b * M + row) * Nh + n) * 2 + re_im] = v;
  }
};

template <class LA, class LB, class SC>
cudaError_t launch_gemm(LA la, LB lb, SC sc, int B, int R, int C, int K, float alpha,
                        cudaStream_t st) {
  const dim3 grid((C + GB - 1) / GB, (R + GB - 1) / GB, B);
  gemm<<<grid, GT, 0, st>>>(la, lb, sc, R, C, K, alpha);
  return cudaGetLastError();
}

// D when cn, sn, xhat and fbuf are given, E when they are null.
int dft_step(const float* ghat, const float* x, const float* prox, const float* z,
             const float* cm, const float* sm, const float* wct, const float* wst,
             const float* cn, const float* sn, const float* gamma, const float* lam,
             const float* lam_theta, const float* sigma2, float* xn, float* proxn, float* tv,
             float* xhat, float* ybuf, float* grad, float* fbuf, float* px_buf,
             float* py_buf, int* iters, float* err, int* active, float* partials, int B,
             int M, int N, int n_sweeps, float tau, float tol, int positivity, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Nh = N / 2 + 1;
  cudaError_t e;
  // 1. Y = (1/M)·[CM −SM; SM CM]·[Ĝre; Ĝim]; the TPU kernel scales by the
  // f32 value of 1.0/M
  e = launch_gemm(ColFactor{cm, sm, M, -1.f}, HalfSpectrumStack{ghat, M, Nh},
                  Field{ybuf, 2 * M, Nh}, B, 2 * M, Nh, 2 * M, (float)(1.0 / M), st);
  if (e != cudaSuccess) return e;
  // 2. grad = [Yre Yim]·[WCT; −WST]
  e = launch_gemm(StackedRowsAsCols{ybuf, M, Nh}, RowPair{wct, wst, Nh, N, -1.f},
                  Field{grad, M, N}, B, M, N, 2 * Nh, 1.f, st);
  if (e != cudaSuccess) return e;
  // 3. MYULA with gradF = grad/σ², the prox and the TV: kernel B
  const int code = sb_myula_step(x, prox, grad, z, nullptr, gamma, lam, lam_theta, sigma2,
                                 xn, proxn, tv, px_buf, py_buf, iters, err, active, partials,
                                 B, M, N, n_sweeps, tau, tol, positivity, stream);
  if (code != 0 || xhat == nullptr) return code;
  // 4. F = xn·[CN −SN]
  e = launch_gemm(Field{xn, M, N}, ColPair{cn, sn, Nh, -1.f}, Field{fbuf, M, 2 * Nh}, B, M,
                  2 * Nh, N, 1.f, st);
  if (e != cudaSuccess) return e;
  // 5. X̂ = [CM SM; −SM CM]·[Fre; Fim]
  return launch_gemm(ColFactor{cm, sm, M, 1.f}, StackedColsAsRows{fbuf, M, Nh},
                     HalfSpectrumOut{xhat, M, Nh}, B, 2 * M, Nh, 2 * M, 1.f, st);
}

}  // namespace

extern "C" {

// Kernel D.  ghat, xhat: interleaved complex (B, M, N/2+1); cm, sm (M, M),
// wct, wst (N/2+1, N), cn, sn (N, N/2+1): fourier.rdft_matrices; scratch
// ybuf (B, 2M, N/2+1), grad (B, M, N), fbuf (B, M, 2(N/2+1)), and kernel
// B's px_buf/py_buf (2, B, M, N), iters/err/active (B), partials
// (B, ⌈M/8⌉·⌈N/32⌉).
int sb_myula_prox_tv_dft(const float* ghat, const float* x, const float* prox, const float* z,
                         const float* cm, const float* sm, const float* wct, const float* wst,
                         const float* cn, const float* sn, const float* gamma,
                         const float* lam, const float* lam_theta, const float* sigma2,
                         float* xn, float* proxn, float* tv, float* xhat, float* ybuf,
                         float* grad, float* fbuf, float* px_buf, float* py_buf, int* iters,
                         float* err, int* active, float* partials, int B, int M, int N,
                         int n_sweeps, float tau, float tol, int positivity, void* stream) {
  if (cn == nullptr || sn == nullptr || xhat == nullptr || fbuf == nullptr)
    return cudaErrorInvalidValue;
  return dft_step(ghat, x, prox, z, cm, sm, wct, wst, cn, sn, gamma, lam, lam_theta, sigma2,
                  xn, proxn, tv, xhat, ybuf, grad, fbuf, px_buf, py_buf, iters, err, active,
                  partials, B, M, N, n_sweeps, tau, tol, positivity, stream);
}

// Kernel E: D's steps 1–3 (the caller takes the forward transform).
int sb_myula_prox_tv_irdft(const float* ghat, const float* x, const float* prox,
                           const float* z, const float* cm, const float* sm, const float* wct,
                           const float* wst, const float* gamma, const float* lam,
                           const float* lam_theta, const float* sigma2, float* xn,
                           float* proxn, float* tv, float* ybuf, float* grad, float* px_buf,
                           float* py_buf, int* iters, float* err, int* active,
                           float* partials, int B, int M, int N, int n_sweeps, float tau,
                           float tol, int positivity, void* stream) {
  return dft_step(ghat, x, prox, z, cm, sm, wct, wst, nullptr, nullptr, gamma, lam,
                  lam_theta, sigma2, xn, proxn, tv, nullptr, ybuf, grad, nullptr, px_buf,
                  py_buf, iters, err, active, partials, B, M, N, n_sweeps, tau, tol,
                  positivity, stream);
}

}  // extern "C"
