// The SAPG step's Fourier-domain work around the spatial segment: the
// residual, the Parseval statistics and the clamped SA updates
// (ops/sapg_stats.py; sapg/estimator.py::make_general_sapg_step).
//
// They replace no TPU kernel: the JAX package leaves this work to XLA,
// which fuses it into a few loops.  In PyTorch it was some forty small
// elementwise and reduce launches an iteration, each a pass over the
// (B, M, N/2+1) complex half-spectrum or a launch of a few scalars.
//
//   sapg_residual  Ĝ = conj(H)·(H·X̂ − ŷ): reads X̂ once, writes Ĝ once.  H
//                  (one (M, Nh) OTF for every chain, or one a problem) and
//                  ŷ (one a problem) are read by every chain of a problem
//                  and come from L2.  Bound by bytes: 16 B a value.
//   sapg_stats     one pass over X̂ₙ: Rₙ = H·X̂ₙ − ŷ in registers, never
//                  written; each chain's Σ w·|Rₙ|² and, for each free PSF
//                  parameter, Σ w·Re(dH·X̂ₙ·conj(Rₙ)) (w the rfft columns'
//                  Parseval weights).  Block (k, b) sums spans k·S … k·S +
//                  S − 1 of SPAN values of chain b (S larger for a problem
//                  of more chains: fewer, longer blocks) in a fixed tree
//                  (shuffles in each warp, then over the warps); a chain's
//                  last block to arrive (an integer ticket a chain, no float
//                  atomics) sums its partials in a fixed order and forms the
//                  chain's statistics from its sums and its TV, and the last
//                  chain's block writes each problem's means over its chains
//                  (a warp a problem: its lanes over the chains in turn,
//                  then a shuffle tree) into `packed` (statistic-major,
//                  (K, D)).  The divides are select-only (common.cuh's
//                  div_rn_exact: no called slow path, no spill).  A chain's
//                  sums depend only on its own values, the image's shape
//                  and C, and a problem's means only on its own chains, so
//                  each of D problems gets the bits of its own run.  Bound
//                  by bytes: 8 B a value (+8 B a value a free parameter's
//                  dH·X̂ₙ reads dH from L2).
//   sapg_update    one block: θ, σ² and the free PSF parameters' clamped
//                  updates from `packed` (divided by the chains group's size
//                  after its all_reduce) and column ii of the step
//                  coefficient table, read at a device index, so a CUDA
//                  graph replays it; writes the iteration's trace row.
//                  Bound by launch latency.
//
// Complex products are written as PyTorch's (a·c − b·d, a·d + b·c); with
// --fmad=false each product and sum rounds on its own.  The sums are taken
// in another order than torch.sum's, which is the only numerical
// difference from the plain versions.

#include "common.cuh"

namespace {

constexpr int ST = 256;             // threads of a block
constexpr int PER = 4;              // values of a chain a thread of sapg_stats sums
constexpr int SPAN = ST * PER;      // values of a chain a block of sapg_stats sums
constexpr int MAX_PSF = 2;          // PSF parameters sapg_stats and sapg_update take
constexpr int MAX_Q = 1 + MAX_PSF;  // sums a chain: Σw|R|², then one a free parameter
constexpr int MAX_K = 4 + MAX_PSF;  // statistics a problem: G_t, G_s, G_p…, logπ, gX

// update flags (ops/sapg_stats.py::UPDATE_FLAGS)
constexpr int THETA_LOG = 1;
constexpr int SIGMA_LOG = 2;
constexpr int PSF_LOG = 4;
constexpr int SIGMA_FIX = 8;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// conj(a)·b as PyTorch's conj(a) * b: (a.x·b.x − (−a.y)·b.y, a.x·b.y + (−a.y)·b.x)
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.x * b.y - a.y * b.x);
}

// torch.clamp(v, lo, hi): max then min, a NaN v stays NaN
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

__global__ void __launch_bounds__(ST) sapg_residual_kernel(
    const float2* __restrict__ xhat, const float2* __restrict__ h,
    const float2* __restrict__ yhat, float2* __restrict__ ghat, int mnh, int chains,
    long long h_stride) {
  const int k = blockIdx.x * ST + threadIdx.x;
  if (k >= mnh) return;
  const int b = blockIdx.y;
  const long long d = b / chains;
  const size_t i = (size_t)b * mnh + k;
  const float2 hv = h[d * h_stride + k];
  const float2 y = yhat[d * mnh + k];
  const float2 hx = cmul(hv, xhat[i]);
  ghat[i] = cmul_conj(hv, make_float2(hx.x - y.x, hx.y - y.y));
}

struct StatsArgs {
  const float2* xhat;   // (B, M, Nh), B = D·C problem-major
  const float2* h;      // (M, Nh), or (D, M, Nh) with h_stride = M·Nh
  const float2* yhat;   // (D, M, Nh)
  const float2* dh[MAX_PSF];  // (D, M, Nh) each, the free parameters' OTF gradients
  const float* w;       // (Nh,) the rfft columns' Parseval weights
  const float* tv;      // (B,)
  const float* theta;   // θ of each problem, at theta_stride (0: one value)
  const float* sigma2;  // (D,)
  float* packed;        // (K, D)
  float* partials;      // (n_q, B, gridDim.x)
  float* chain_stats;   // (K, B): each chain's statistics
  unsigned int* ticket; // B + 1 zeros (one a chain, one for the chains), left zero
  long long h_stride;
  int chains, mnh, nh, spans, theta_stride, n_free, logpi_only;
  float dim;
};

// Fixed-order sum over a warp: lane 0 gets it.
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The arrival of a block at `counter` of `n` arrivals, after thread 0's
// global writes (the block's only ones): true for the last, which then sees
// every earlier arrival's writes (read them with __ldcg).
__device__ __forceinline__ bool last_to_arrive(unsigned int* counter, unsigned int n,
                                               bool* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    *flag = atomicAdd(counter, 1u) == n - 1u;
  }
  __syncthreads();
  if (*flag) __threadfence();
  return *flag;
}

__global__ void __launch_bounds__(ST) sapg_stats_kernel(StatsArgs a) {
  __shared__ float sh[MAX_Q][ST / 32];
  __shared__ bool last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int blk = blockIdx.x, b = blockIdx.y;
  const int B = gridDim.y, nblk = gridDim.x, nq = 1 + a.n_free;
  const long long d = b / a.chains;
  const float2* x = a.xhat + (size_t)b * a.mnh;
  const float2* hp = a.h + d * a.h_stride;
  const float2* yp = a.yhat + d * a.mnh;
  // the chain's scalars, read now: only its last block uses them
  float th = 0.f, s2 = 0.f, tvb = 0.f;
  if (t == 0) {
    th = a.theta[d * a.theta_stride];
    s2 = a.sigma2[d];
    tvb = a.tv[b];
  }

  float s[MAX_Q];
#pragma unroll
  for (int q = 0; q < MAX_Q; ++q) s[q] = 0.f;
  for (int sp = 0; sp < a.spans; ++sp) {
    const int base = (blk * a.spans + sp) * SPAN + t;
    int col = base % a.nh;   // the value's column, carried from value to value
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int k = base + j * ST;
      if (k < a.mnh) {
        const float w = a.w[col];
        const float2 xv = x[k];
        const float2 hx = cmul(hp[k], xv);
        const float2 y = yp[k];
        const float2 r = make_float2(hx.x - y.x, hx.y - y.y);
        s[0] += w * (r.x * r.x + r.y * r.y);
#pragma unroll
        for (int p = 0; p < MAX_PSF; ++p) {
          if (p < a.n_free) {
            const float2 av = cmul(a.dh[p][d * a.mnh + k], xv);
            s[1 + p] += w * (av.x * r.x + av.y * r.y);
          }
        }
      }
      for (col += ST; col >= a.nh;) col -= a.nh;
    }
  }
  // the block's sums: a shuffle tree in each warp, then over the warps
#pragma unroll
  for (int q = 0; q < MAX_Q; ++q) {
    if (q < nq) {
      const float v = warp_sum(s[q]);
      if (lane == 0) sh[q][warp] = v;
    }
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < MAX_Q; ++q) {
      if (q < nq) {
        float v = lane < ST / 32 ? sh[q][lane] : 0.f;
        for (int off = ST / 64; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) sh[q][0] = v;
      }
    }
  }
  if (t == 0) {
    for (int q = 0; q < nq; ++q) a.partials[((size_t)q * B + b) * nblk + blk] = sh[q][0];
  }

  // the chain's last block sums its partials (warp q the q-th sum) and
  // forms the chain's statistics
  if (!last_to_arrive(a.ticket + b, nblk, &last)) return;
  if (warp < nq) {
    // lane l sums partials l, l + 32, … in turn, its loads issued four at once
    const float* part = a.partials + ((size_t)warp * B + b) * nblk;
    float v = 0.f;
    for (int k0 = 0; k0 < nblk; k0 += 4 * 32) {
      float r[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = k0 + u * 32 + lane;
        r[u] = k < nblk ? __ldcg(part + k) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) v += r[u];
    }
    v = warp_sum(v);
    if (lane == 0) sh[warp][0] = v;
  }
  __syncthreads();
  if (t == 0) {
    a.ticket[b] = 0u;
    const float dd = a.dim;
    const float res2 = div_rn_exact(sh[0][0], dd);
    // the θ lag: logπ at the pre-update θ and σ²
    const float logpi = -div_rn_exact(res2, 2.f * s2) - th * tvb;
    float* out = a.chain_stats + b;
    if (a.logpi_only) {
      out[0] = logpi;
    } else {
      out[0] = div_rn_exact(dd, th) - tvb;
      out[B] = div_rn_exact(res2, 2.f * (s2 * s2)) - div_rn_exact(dd, 2.f * s2);
#pragma unroll
      for (int p = 0; p < MAX_PSF; ++p)
        if (p < a.n_free)
          out[(size_t)(2 + p) * B] = div_rn_exact(div_rn_exact(sh[1 + p][0], dd), s2);
      out[(size_t)(2 + a.n_free) * B] = logpi;
      out[(size_t)(3 + a.n_free) * B] = tvb;
    }
  }

  // the last chain's block: each problem's means over its chains, a warp a
  // problem, its lanes over the chains in turn, then a shuffle tree (one
  // chain: its block is the last)
  if (B > 1 && !last_to_arrive(a.ticket + B, B, &last)) return;
  if (B == 1) {
    if (t == 0) __threadfence();
    __syncthreads();
  }
  const int D = B / a.chains;
  const int K = a.logpi_only ? 1 : 4 + a.n_free;
  const float C = (float)a.chains;
  for (int pd = warp; pd < D; pd += ST / 32) {
    float acc[MAX_K];
#pragma unroll
    for (int k = 0; k < MAX_K; ++k) acc[k] = 0.f;
    for (int c = lane; c < a.chains; c += 32) {
      const float* in = a.chain_stats + pd * a.chains + c;
#pragma unroll
      for (int k = 0; k < MAX_K; ++k)
        if (k < K) acc[k] += __ldcg(in + (size_t)k * B);
    }
#pragma unroll
    for (int k = 0; k < MAX_K; ++k) {
      if (k < K) {
        const float v = warp_sum(acc[k]);
        if (lane == 0) a.packed[(size_t)k * D + pd] = div_rn_exact(v, C);
      }
    }
  }
  if (t == 0) a.ticket[B] = 0u;
}

struct UpdateArgs {
  const float* packed;      // (4 + P, D): G_t, G_s, G_p…, logπ, gX
  const float* coef;        // (2 + P, n_cols) step coefficients
  const long long* index;   // the column ii on the device, or null: column coef_col
  const float* theta;       // (D,)
  const float* sigma2;      // (D,)
  const float* param[MAX_PSF];  // (D,) each, null for a pinned parameter
  const float* sigma2_lo;   // (D,)
  const float* sigma2_hi;   // (D,)
  const float* sigma2_init; // (D,)
  const float* box;         // θ lo, hi, log lo, log hi; per PSF parameter lo, hi, log lo, log hi, pinned value
  float* rows;              // (6 + 2·n_psf, D): θ, σ², logπ, gX, G_t, G_s, G_<each>, <each>
  long long coef_col;
  int n_cols, D, n_psf, pinned, flags;
  float n_group;
};

__global__ void __launch_bounds__(ST) sapg_update_kernel(UpdateArgs a) {
  const long long col = a.index != nullptr ? *a.index : a.coef_col;
  const int D = a.D;
  int n_free = 0;
  for (int i = 0; i < a.n_psf; ++i) n_free += ((a.pinned >> i) & 1) ? 0 : 1;
  const float ng = a.n_group;
  for (int d = threadIdx.x; d < D; d += ST) {
    const float G_t = a.packed[d] / ng;
    const float G_s = a.packed[(size_t)D + d] / ng;
    const float logpi = a.packed[(size_t)(2 + n_free) * D + d] / ng;
    const float gX = a.packed[(size_t)(3 + n_free) * D + d] / ng;

    const float th = a.theta[d];
    const float c0 = a.coef[col];
    float th_n;
    if (a.flags & THETA_LOG)
      th_n = expf(clampf(logf(th) + c0 * G_t * th, a.box[2], a.box[3]));
    else
      th_n = clampf(th + c0 * G_t, a.box[0], a.box[1]);

    int j = 0;
    for (int i = 0; i < a.n_psf; ++i) {
      const float* bx = a.box + 4 + 5 * i;
      float g = 0.f, v = bx[4];
      if (!((a.pinned >> i) & 1)) {
        const float c = a.coef[(size_t)(2 + j) * a.n_cols + col];
        g = a.packed[(size_t)(2 + j) * D + d] / ng;
        const float p = a.param[i][d];
        if (a.flags & PSF_LOG)
          v = expf(clampf(logf(p) + c * g * p, bx[2], bx[3]));
        else
          v = clampf(p + c * g, bx[0], bx[1]);
        ++j;
      }
      a.rows[(size_t)(6 + i) * D + d] = g;
      a.rows[(size_t)(6 + a.n_psf + i) * D + d] = v;
    }

    const float s2 = a.sigma2[d];
    float s2_n;
    if (a.flags & SIGMA_FIX) {
      s2_n = a.sigma2_init[d];
    } else {
      const float c1 = a.coef[(size_t)a.n_cols + col];
      if (a.flags & SIGMA_LOG)
        s2_n = expf(clampf(logf(s2) + c1 * G_s * s2, logf(a.sigma2_lo[d]),
                           logf(a.sigma2_hi[d])));
      else
        s2_n = clampf(s2 + c1 * G_s, a.sigma2_lo[d], a.sigma2_hi[d]);
    }
    a.rows[d] = th_n;
    a.rows[(size_t)D + d] = s2_n;
    a.rows[(size_t)2 * D + d] = logpi;
    a.rows[(size_t)3 * D + d] = gX;
    a.rows[(size_t)4 * D + d] = G_t;
    a.rows[(size_t)5 * D + d] = G_s;
  }
}

}  // namespace

extern "C" {

// The values of a chain one block of sapg_stats sums (ops/sapg_stats.py
// sizes the partials from it).
int sb_sapg_stats_span() { return SPAN; }

// Ĝ = conj(H)·(H·X̂ − ŷ) of B = D·C chains of M·Nh half-spectrum values;
// h_stride: 0 (one H) or M·Nh (one a problem).
int sb_sapg_residual(const void* xhat, const void* h, const void* yhat, void* ghat, int B,
                     int mnh, int chains, long long h_stride, void* stream) {
  if (B < 1 || B > 65535 || mnh < 1 || chains < 1 || B % chains != 0) return -1;
  const dim3 grid((mnh + ST - 1) / ST, B);
  sapg_residual_kernel<<<grid, ST, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(xhat), static_cast<const float2*>(h),
      static_cast<const float2*>(yhat), static_cast<float2*>(ghat), mnh, chains, h_stride);
  return (int)cudaGetLastError();
}

// Each problem's means of the chains' Parseval statistics into packed (K, D)
// (K = 4 + n_free, or 1 with logpi_only: logπ alone).  dh0, dh1: the first
// n_free are the free parameters' dH, the others unused (null).
// partials: at least (1 + n_free)·B·⌈M·Nh/SPAN⌉ floats; chain_stats K·B;
// ticket: B + 1 zero ints, left zero.
int sb_sapg_stats(const void* xhat, const void* h, const void* yhat, const void* dh0,
                  const void* dh1, const void* w, const void* tv,
                  const void* theta, const void* sigma2, void* packed, void* partials,
                  void* chain_stats, void* ticket, long long partial_floats, int B, int chains,
                  int M, int nh, long long h_stride, int theta_stride, int n_free,
                  int logpi_only, float dim, void* stream) {
  const int mnh = M * nh;
  // spans of SPAN values a block sums in turn: more where a problem has more
  // chains, so a many-chain launch runs fewer, longer blocks; it depends on
  // a problem's chains and the image alone, so each problem keeps its bits
  const int spans = chains < 8 ? 1 : (chains < 32 ? chains / 4 : 8);
  const int nblk = (mnh + SPAN * spans - 1) / (SPAN * spans);
  if (B < 1 || B > 65535 || mnh < 1 || chains < 1 || B % chains != 0 || n_free < 0 ||
      n_free > MAX_PSF || (logpi_only && n_free != 0))
    return -1;
  if ((long long)(1 + n_free) * B * nblk > partial_floats) return -2;
  StatsArgs a;
  a.xhat = static_cast<const float2*>(xhat);
  a.h = static_cast<const float2*>(h);
  a.yhat = static_cast<const float2*>(yhat);
  a.dh[0] = static_cast<const float2*>(dh0);
  a.dh[1] = static_cast<const float2*>(dh1);
  a.w = static_cast<const float*>(w);
  a.tv = static_cast<const float*>(tv);
  a.theta = static_cast<const float*>(theta);
  a.sigma2 = static_cast<const float*>(sigma2);
  a.packed = static_cast<float*>(packed);
  a.partials = static_cast<float*>(partials);
  a.chain_stats = static_cast<float*>(chain_stats);
  a.ticket = static_cast<unsigned int*>(ticket);
  a.h_stride = h_stride;
  a.chains = chains;
  a.mnh = mnh;
  a.nh = nh;
  a.spans = spans;
  a.theta_stride = theta_stride;
  a.n_free = n_free;
  a.logpi_only = logpi_only;
  a.dim = dim;
  sapg_stats_kernel<<<dim3(nblk, B), ST, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The SA updates of D problems and their trace rows (flags: THETA_LOG,
// SIGMA_LOG, PSF_LOG, SIGMA_FIX; pinned: bit i set, PSF parameter i is
// pinned and param[i] may be null).  index: the device column, or null for
// coef_col.
int sb_sapg_update(const void* packed, const void* coef, const void* index, const void* theta,
                   const void* sigma2, const void* p0, const void* p1,
                   const void* sigma2_lo, const void* sigma2_hi,
                   const void* sigma2_init, const void* box, void* rows, long long coef_col,
                   int n_cols, int D, int n_psf, int pinned, int flags, float n_group,
                   void* stream) {
  if (D < 1 || n_psf < 0 || n_psf > MAX_PSF || n_cols < 1) return -1;
  UpdateArgs a;
  a.packed = static_cast<const float*>(packed);
  a.coef = static_cast<const float*>(coef);
  a.index = static_cast<const long long*>(index);
  a.theta = static_cast<const float*>(theta);
  a.sigma2 = static_cast<const float*>(sigma2);
  a.param[0] = static_cast<const float*>(p0);
  a.param[1] = static_cast<const float*>(p1);
  a.sigma2_lo = static_cast<const float*>(sigma2_lo);
  a.sigma2_hi = static_cast<const float*>(sigma2_hi);
  a.sigma2_init = static_cast<const float*>(sigma2_init);
  a.box = static_cast<const float*>(box);
  a.rows = static_cast<float*>(rows);
  a.coef_col = coef_col;
  a.n_cols = n_cols;
  a.D = D;
  a.n_psf = n_psf;
  a.pinned = pinned;
  a.flags = flags;
  a.n_group = n_group;
  const int threads = D < ST ? ((D + 31) / 32) * 32 : ST;
  sapg_update_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
