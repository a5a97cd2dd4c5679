// The whole-iteration DFT steps for Hopper (sm_90a): a 3×TF32 tensor-core
// GEMM for the dense-DFT factor products, and the glue entry points of
// kernels D and E.
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
// shared memory.  So D is a short launch sequence on one stream, with no
// host sync.  Every product is C = A·Bᵀ with A (rows × K) and B (cols × K)
// both K-major, and the chains stacked into one product (batch folded into
// the rows or the columns, so each factor tile is loaded once for all
// chains):
//   0. repack Ĝ (interleaved complex (B, M, Nh)) to gbuf: row b·Nhp + j
//      holds [Ĝre[b, :, j], Ĝim[b, :, j]] (2M), split into tf32 hi and lo
//   1. inverse columns:  Y = (1/M)·[CM −SM; SM CM]·gbufᵀ  (2M × B·Nhp),
//      stored to ybuf: row b·M + i holds [Yre[b, i, :], Yim[b, i, :]]
//   2. inverse rows:     grad = ybuf·[WCT; −WST]            (B·M × N)
//   3. kernel B's persistent launch with σ² (tv_kernels.cu::sb_myula_step)
//   4. split xn to xbuf, then forward rows: F = xbuf·[CN −SN]  (B·M × 2Nhp),
//      stored to fbuf: row b·Nhp + j holds [Fre[b, :, j], Fim[b, :, j]]
//   5. forward columns:  X̂ = [CM SM; −SM CM]·fbufᵀ           (2M × B·Nhp),
//      stored interleaved into the complex x̂ (B, M, Nh)
// E stops after 3.  The stacked, signed, transposed factor operands are
// packed once per problem by the wrapper (ops/fused_dft_cuda.py::
// pack_factors), already split into hi and lo; Nhp = Nh rounded up to even,
// and the pads of gbuf, ybuf and the packed factors are zeros.
//
// Arithmetic: 3×TF32.  Each operand value a is held as hi = tf32(a) and
// lo = tf32(a − hi) (round to nearest, cvt.rna), and the tensor cores sum
// hi·hi + lo·hi + hi·lo with fp32 accumulation (lo·lo, ~2⁻²² relative, is
// dropped).  The JAX kernel runs these products at Precision.HIGHEST and
// TF32 alone would put ~1e-3 into H, so this keeps fp32 accuracy.  The
// tensor cores round each step's sum toward zero, which biases sums of one
// sign (the DC column of a positive image: accumulated across k-blocks it
// put 2 ulp into x̂'s DC term, 2.3× the deviation of torch.matmul).  So each
// k-block of 32 sums hi·hi in a fresh accumulator ("big": for the DC
// column a sum of 11-bit values, exact) and the small terms in a second
// one ("small") that starts from the negated Kahan compensation of the
// running sum; big + small is then added to the running sum in fp32 with
// Kahan's step, and its lost part goes back into small.
//
// Bound.  The products are 3 tensor-core passes of 2·M·N·K each: at 512²
// B=16 D's 12 products are 25.9 GFLOP, 77.7 in TF32, 157 µs at the H100's
// 495 TFLOP/s; the repack and the split move 24 bytes per value.  The
// design: wgmma.m64nNk8.f32.tf32.tf32 with both operands in shared memory,
// 128-byte swizzled K-major tiles loaded by TMA (one thread issues them)
// into a 3-stage ring of mbarriers; tiles of 128×128 (two consumer
// warpgroups) for large grids, 64×64 with split-K for small ones, whose
// partials a second launch sums in fixed order (no float atomics).  Each
// stage's loads overlap the two stages before it; the warpgroups
// synchronise once a k-block to release it.  The split operands double
// the bytes each tile reads from L2.
//
// The C interface takes raw pointers and a cudaStream_t and returns the
// first CUDA error (cudaSuccess == 0); the caller allocates everything and
// owns the layout: the padded widths come in with the tile plan, and are
// checked against the shape.  A call encodes no tensor map it has encoded
// before and sets each GEMM's shared-memory allowance once a device.

#include <cuda.h>
#include <stdint.h>

#include <atomic>
#include <chrono>
#include <mutex>

#include "common.cuh"

namespace {

constexpr int BK = 32;       // k-block: one 128-byte swizzle row of fp32
constexpr int STAGES = 3;    // shared-memory ring depth

// ---- 3×TF32 operands ------------------------------------------------------

__device__ __forceinline__ float tf32_rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return __uint_as_float(r);
}

// v into its hi plane at p[o] and its lo plane at p[o + plane]; v − hi is
// exact in fp32.
__device__ __forceinline__ void store_split(float* p, size_t o, size_t plane, float v) {
  const float hi = tf32_rna(v);
  p[o] = hi;
  p[o + plane] = tf32_rna(v - hi);
}

// ---- epilogues: where element (r, c) of a product's C goes ----------------

// 1. Y (2M × B·Nhp) into ybuf (2, B·M, 2·Nhp).
struct StoreY {
  float* y;
  size_t plane;
  int M, Nhp;
  __device__ void operator()(int r, int c, float v) const {
    const int b = c / Nhp, j = c - b * Nhp;
    const int half = r >= M, i = r - half * M;
    store_split(y, ((size_t)b * M + i) * (2 * Nhp) + half * Nhp + j, plane, v);
  }
};

// 2. grad (B·M × N), row-major.
struct StoreGrad {
  float* g;
  int N;
  __device__ void operator()(int r, int c, float v) const { g[(size_t)r * N + c] = v; }
};

// 4. F (B·M × 2Nhp) into fbuf (2, B·Nhp, ld).
struct StoreF {
  float* f;
  size_t plane;
  int M, Nhp, ld;
  __device__ void operator()(int r, int c, float v) const {
    const int b = r / M, i = r - b * M;
    const int half = c >= Nhp, j = c - half * Nhp;
    store_split(f, ((size_t)b * Nhp + j) * ld + half * M + i, plane, v);
  }
};

// 5. X̂ (2M × B·Nhp) into the interleaved complex (B, M, Nh); the pad
// columns j ≥ Nh are dropped.
struct StoreXhat {
  float* x;
  int M, Nh, Nhp;
  __device__ void operator()(int r, int c, float v) const {
    const int b = c / Nhp, j = c - b * Nhp;
    if (j >= Nh) return;
    const int half = r >= M, i = r - half * M;
    x[(((size_t)b * M + i) * Nh + j) * 2 + half] = v;
  }
};

// ---- Hopper primitives (inline PTX) ---------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// A (32 × rows × 2 planes) box of a 3-D tensor map into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int k0, int row0) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k0), "r"(row0), "r"(0)
      : "memory");
}

// wgmma descriptor of a K-major tile with 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart (SBO), LBO unused.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

#define D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define D16(i) D4(i), D4(i + 4), D4(i + 8), D4(i + 12)

// d (64 × BN, fp32) = [d +] A·Bᵀ over k = 8, A and B tf32 from shared memory.
template <int BN>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float* d, uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1;\n"
        "}\n"
        : D16(0), D16(16)
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float* d, uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1;\n"
        "}\n"
        : D16(0), D16(16), D16(32), D16(48)
        : "l"(a), "l"(b), "r"(acc));
  }
};

#undef D16
#undef D4

// ---- the GEMM ---------------------------------------------------------------

// WGS consumer warpgroups of 64 rows each; a BN-column tile.
template <int WGS, int BN>
struct Tile {
  static constexpr int BM = 64 * WGS;
  static constexpr int THREADS = 128 * WGS;
  static constexpr int A_BYTES = BM * BK * 4;   // one plane
  static constexpr int B_BYTES = BN * BK * 4;
  static constexpr int STAGE_BYTES = 2 * (A_BYTES + B_BYTES);
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 8 * STAGES;
};

// C(r, c) = alpha · Σ_k A(r, k)·B(c, k) for r < Mg, c < Ng over the
// k-blocks of split blockIdx.z; A and B come through the tensor maps
// (K, rows, hi/lo plane).  With one split the result goes to `epi`; with
// several, split z's raw sum goes to ws[z] (Mg × Ng) for splitk_reduce.
// Grid (⌈Ng/BN⌉, ⌈Mg/BM⌉, splits).
template <int WGS, int BN, class Epi>
__global__ void __launch_bounds__(128 * WGS)
gemm_tf32x3(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
            Epi epi, float* __restrict__ ws, int Mg, int Ng, int nk, float alpha) {
  using T = Tile<WGS, BN>;
  constexpr int R = BN / 2;   // accumulator registers a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + STAGES * T::STAGE_BYTES;
  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * BN;
  const int z = blockIdx.z, splits = gridDim.z;
  const int kb0 = (int)((long long)nk * z / splits);
  const int n = (int)((long long)nk * (z + 1) / splits) - kb0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int i) {
    const int s = i % STAGES;
    const uint32_t st = base + s * T::STAGE_BYTES, bar = bars + 8 * s;
    mbar_expect_tx(bar, T::STAGE_BYTES);
    tma_load(st, &map_a, bar, (kb0 + i) * BK, m0);
    tma_load(st + 2 * T::A_BYTES, &map_b, bar, (kb0 + i) * BK, n0);
  };
  if (tid == 0)
    for (int i = 0; i < STAGES && i < n; ++i) issue(i);

  // big: this k-block's hi·hi; small: −(the running compensation) plus its
  // lo·hi + hi·lo; sum: the running sum
  float big[R], small[R], sum[R];
#pragma unroll
  for (int r = 0; r < R; ++r) big[r] = small[r] = sum[r] = 0.f;

  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    mbar_wait(bars + 8 * s, (i / STAGES) & 1);
    const uint32_t st = base + s * T::STAGE_BYTES;
    const uint32_t a_hi = st + wg * 64 * 128, a_lo = a_hi + T::A_BYTES;
    const uint32_t b_hi = st + 2 * T::A_BYTES, b_lo = b_hi + T::B_BYTES;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      fence_operand(big[r]);
      fence_operand(small[r]);
    }
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
      Wgmma<BN>::mma(big, sw128_desc(a_hi + 32 * kk), sw128_desc(b_hi + 32 * kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      Wgmma<BN>::mma(small, sw128_desc(a_lo + 32 * kk), sw128_desc(b_hi + 32 * kk), 1);
      Wgmma<BN>::mma(small, sw128_desc(a_hi + 32 * kk), sw128_desc(b_lo + 32 * kk), 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
    for (int r = 0; r < R; ++r) {   // Kahan: sum += big + small, its lost part into small
      fence_operand(big[r]);
      fence_operand(small[r]);
      const float y = big[r] + small[r];
      const float t = sum[r] + y;
      small[r] = y - (t - sum[r]);
      sum[r] = t;
    }
    __syncthreads();   // every warpgroup is done with stage s
    if (tid == 0 && i + STAGES < n) issue(i + STAGES);
  }

  // accumulator layout: warp w of the warpgroup holds rows 16w + lane/4
  // (+8), register 4j + 2h + e column 8j + 2·(lane%4) + e
  const int t = tid % 128, lane = t % 32;
  const int row0 = m0 + wg * 64 + (t / 32) * 16 + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = row0 + 8 * h, c = col0 + 8 * j + e;
        // Kahan's estimate: the sum with its outstanding compensation
        const float v = sum[4 * j + 2 * h + e] + small[4 * j + 2 * h + e];
        if (r < Mg && c < Ng) {
          if (splits > 1) ws[((size_t)z * Mg + r) * Ng + c] = v;
          else epi(r, c, v * alpha);
        }
      }
}

// The split-K second stage: C = alpha · (ws[0] + ws[1] + …), in that order.
template <class Epi>
__global__ void __launch_bounds__(256)
splitk_reduce(const float* __restrict__ ws, Epi epi, int Mg, int Ng, int splits, float alpha) {
  const size_t total = (size_t)Mg * Ng;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float v = 0.f;
  for (int z = 0; z < splits; ++z) v += ws[z * total + e];
  epi((int)(e / Ng), (int)(e % Ng), v * alpha);
}

// 0. gbuf (2, B·Nhp, ld) from the interleaved complex Ĝ (B, M, Nh): a 32×32
// (i, j) tile through shared memory; rows Nh ≤ j < Nhp get zeros.
// Grid (⌈Nhp/32⌉, ⌈M/32⌉, B), block (32, 8).
__global__ void __launch_bounds__(256)
repack_spectrum(const float2* __restrict__ g, float* __restrict__ out, size_t plane, int M,
                int Nh, int Nhp, int ld) {
  __shared__ float2 tile[32][33];
  const int b = blockIdx.z, j0 = blockIdx.x * 32, i0 = blockIdx.y * 32;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int i = i0 + r, j = j0 + threadIdx.x;
    tile[r][threadIdx.x] =
        (i < M && j < Nh) ? g[((size_t)b * M + i) * Nh + j] : make_float2(0.f, 0.f);
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int j = j0 + r, i = i0 + threadIdx.x;
    if (j < Nhp && i < M) {
      const float2 v = tile[threadIdx.x][r];
      const size_t o = ((size_t)b * Nhp + j) * ld + i;
      store_split(out, o, plane, v.x);
      store_split(out, o + M, plane, v.y);
    }
  }
}

// 4. xbuf (2, R, ld) from the row-major (R, N) field.
__global__ void __launch_bounds__(256)
split_rows(const float* __restrict__ x, float* __restrict__ out, size_t plane, int R, int N,
           int ld) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)R * N) return;
  const size_t r = e / N, c = e % N;
  store_split(out, r * ld + c, plane, x[e]);
}

// ---- host side ----------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once through the runtime
// (no link against libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                                  &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A product operand: `rows` rows of K fp32 values, row stride ld (a
// multiple of 4), its hi plane at p and its lo plane `plane` floats on.
struct Operand {
  const float* p;
  int rows, K, ld;
  size_t plane;
};

// The TMA map of an operand, boxes of (32, box_rows, 2), 128-byte swizzle;
// reads past K or the rows are zeros.
bool encode_map(CUtensorMap* map, const Operand& o, int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)o.K, (cuuint64_t)o.rows, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)o.ld * 4, (cuuint64_t)o.plane * 4};
  const cuuint32_t box[3] = {BK, (cuuint32_t)box_rows, 2};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(o.p), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// encode_map, memoised.  A map is a pure function of its operand and box,
// and a problem's calls repeat the same eight: the packed factors stay put
// and PyTorch's caching allocator hands the scratch back at the same
// addresses.  A round-robin table of 64 under a mutex (ctypes calls run
// without the GIL).
bool make_map(CUtensorMap* map, const Operand& o, int box_rows) {
  struct Entry {
    CUtensorMap map;
    Operand o;
    int box_rows;
  };
  constexpr int SIZE = 64;
  static Entry table[SIZE];
  static int filled = 0, next = 0;
  static std::mutex mu;
  const std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < filled; ++i) {
    const Entry& t = table[i];
    if (t.o.p == o.p && t.o.rows == o.rows && t.o.K == o.K && t.o.ld == o.ld &&
        t.o.plane == o.plane && t.box_rows == box_rows) {
      *map = t.map;
      return true;
    }
  }
  if (!encode_map(map, o, box_rows)) return false;
  table[next] = Entry{*map, o, box_rows};
  next = (next + 1) % SIZE;
  if (filled < SIZE) ++filled;
  return true;
}

// How one product runs (from the wrapper's plan): tile config 0 (64×64) or
// 1 (128×128), its split-K factor, and the workspace for the partials.
struct Launch {
  int cfg, splits;
  float* ws;
  size_t ws_floats;
};

template <int WGS, int BN, class Epi>
cudaError_t run_gemm(const Operand& a, const Operand& b, Epi epi, int nk, float alpha,
                     const Launch& l, cudaStream_t st) {
  using T = Tile<WGS, BN>;
  // the shared-memory allowance, set once a device for this instantiation
  static std::atomic<uint64_t> allowed{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = 1ull << (dev & 63);
  if (!(allowed.load() & bit)) {
    e = cudaFuncSetAttribute(gemm_tf32x3<WGS, BN, Epi>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return e;
    allowed.fetch_or(bit);
  }
  CUtensorMap ma, mb;
  if (!make_map(&ma, a, T::BM) || !make_map(&mb, b, BN)) return cudaErrorInvalidValue;
  const dim3 grid((b.rows + BN - 1) / BN, (a.rows + T::BM - 1) / T::BM, l.splits);
  gemm_tf32x3<WGS, BN, Epi><<<grid, T::THREADS, T::SMEM, st>>>(ma, mb, epi, l.ws, a.rows,
                                                               b.rows, nk, alpha);
  e = cudaGetLastError();
  if (e != cudaSuccess || l.splits == 1) return e;
  const size_t total = (size_t)a.rows * b.rows;
  splitk_reduce<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(l.ws, epi, a.rows, b.rows,
                                                                 l.splits, alpha);
  return cudaGetLastError();
}

// C = alpha · A·Bᵀ (a.rows × b.rows) into epi.
template <class Epi>
cudaError_t gemm(const Operand& a, const Operand& b, Epi epi, float alpha, const Launch& l,
                 cudaStream_t st) {
  const int nk = (a.K + BK - 1) / BK;
  if (a.K != b.K || a.ld % 4 || b.ld % 4 || l.splits < 1 || l.splits > nk ||
      (l.splits > 1 && (size_t)l.splits * a.rows * b.rows > l.ws_floats))
    return cudaErrorInvalidValue;
  if (l.cfg == 1) return run_gemm<2, 128>(a, b, epi, nk, alpha, l, st);
  if (l.cfg == 0) return run_gemm<1, 64>(a, b, epi, nk, alpha, l, st);
  return cudaErrorInvalidValue;
}

// Shapes of the packed operands and scratch buffers, as the wrapper laid
// them out (ops/fused_dft_cuda.py::dft_geometry) and passed them in the
// plan: the half-spectrum's Nhp ≥ Nh columns, the row strides ld1 ≥ 2M and
// ldN ≥ N.  ok(): they hold the problem and keep TMA's 16-byte strides.
struct Geo {
  int B, M, N, Nh, Nhp, ld1, ldN;
  Geo(int b, int m, int n, const int* plan)
      : B(b), M(m), N(n), Nh(n / 2 + 1), Nhp(plan[8]), ld1(plan[9]), ldN(plan[10]) {}
  bool ok() const {
    return B > 0 && M > 0 && N > 0 && Nhp >= Nh && Nhp % 2 == 0 && ld1 >= 2 * M &&
           ld1 % 4 == 0 && ldN >= N && ldN % 4 == 0;
  }
};

// The plan (11 ints, ops/fused_dft_cuda.py::_host_plan): (cfg, splits) of
// products 1, 2, 4 and 5, then Nhp, ld1 and ldN.
Launch launch_of(const int* plan, int product, float* ws, size_t ws_floats) {
  return Launch{plan[2 * product], plan[2 * product + 1], ws, ws_floats};
}

// Steps 0–2: grad = irfft2(Ĝ) (before the σ² division).
cudaError_t inverse_products(const float* ghat, const float* fac_inv, const float* w_t,
                             float* gbuf, float* ybuf, float* grad, float* ws, size_t ws_floats,
                             const int* plan, const Geo& g, cudaStream_t st) {
  const int M = g.M, BM = g.B * M, BNh = g.B * g.Nhp;
  const size_t gplane = (size_t)BNh * g.ld1, yplane = (size_t)BM * 2 * g.Nhp;
  repack_spectrum<<<dim3((g.Nhp + 31) / 32, (M + 31) / 32, g.B), dim3(32, 8), 0, st>>>(
      reinterpret_cast<const float2*>(ghat), gbuf, gplane, M, g.Nh, g.Nhp, g.ld1);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // 1. Y = (1/M)·[CM −SM; SM CM]·gbufᵀ; the TPU kernel scales by the f32
  // value of 1.0/M
  e = gemm(Operand{fac_inv, 2 * M, 2 * M, g.ld1, (size_t)2 * M * g.ld1},
           Operand{gbuf, BNh, 2 * M, g.ld1, gplane}, StoreY{ybuf, yplane, M, g.Nhp},
           (float)(1.0 / M), launch_of(plan, 0, ws, ws_floats), st);
  if (e != cudaSuccess) return e;
  // 2. grad = [Yre Yim]·[WCT; −WST]
  return gemm(Operand{ybuf, BM, 2 * g.Nhp, 2 * g.Nhp, yplane},
              Operand{w_t, g.N, 2 * g.Nhp, 2 * g.Nhp, (size_t)g.N * 2 * g.Nhp},
              StoreGrad{grad, g.N}, 1.f, launch_of(plan, 1, ws, ws_floats), st);
}

// Step 4–5: x̂ = rfft2(xn).
cudaError_t forward_products(const float* xn, const float* fac_fwd, const float* cns_t,
                             float* xbuf, float* fbuf, float* xhat, float* ws, size_t ws_floats,
                             const int* plan, const Geo& g, cudaStream_t st) {
  const int M = g.M, BM = g.B * M, BNh = g.B * g.Nhp;
  const size_t xplane = (size_t)BM * g.ldN, fplane = (size_t)BNh * g.ld1;
  const size_t total = (size_t)BM * g.N;
  split_rows<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(xn, xbuf, xplane, BM, g.N, g.ldN);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // 4. F = xn·[CN −SN]
  e = gemm(Operand{xbuf, BM, g.N, g.ldN, xplane},
           Operand{cns_t, 2 * g.Nhp, g.N, g.ldN, (size_t)2 * g.Nhp * g.ldN},
           StoreF{fbuf, fplane, M, g.Nhp, g.ld1}, 1.f, launch_of(plan, 2, ws, ws_floats), st);
  if (e != cudaSuccess) return e;
  // 5. X̂ = [CM SM; −SM CM]·[Fre; Fim]
  return gemm(Operand{fac_fwd, 2 * M, 2 * M, g.ld1, (size_t)2 * M * g.ld1},
              Operand{fbuf, BNh, 2 * M, g.ld1, fplane}, StoreXhat{xhat, M, g.Nh, g.Nhp}, 1.f,
              launch_of(plan, 3, ws, ws_floats), st);
}

// D when fac_fwd, cns_t, xhat, xbuf and fbuf are given, E when they are null.
int dft_step(const float* ghat, const float* x, const float* prox, const float* z,
             const float* fac_inv, const float* w_t, const float* fac_fwd, const float* cns_t,
             const float* gamma, const float* lam, const float* lam_theta, const float* sigma2,
             float* xn, float* proxn, float* tv, float* xhat, float* gbuf, float* ybuf,
             float* grad, float* xbuf, float* fbuf, float* ws, int* iters, float* err,
             int* ws_int, float* ws_f, const int* plan, long long ws_floats, int B, int M, int N,
             int chains, int grid, int stack, int n_sweeps, float tau, float tol,
             int positivity, int strides, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geo g(B, M, N, plan);
  if (!g.ok()) return cudaErrorInvalidValue;
  cudaError_t e = inverse_products(ghat, fac_inv, w_t, gbuf, ybuf, grad, ws, (size_t)ws_floats,
                                   plan, g, st);
  if (e != cudaSuccess) return e;
  // 3. MYULA with gradF = grad/σ², the prox and the TV: kernel B
  const int code = sb_myula_step(x, prox, grad, z, nullptr, gamma, lam, lam_theta, sigma2,
                                 xn, proxn, tv, iters, err, ws_int, ws_f, B, M, N, chains, grid,
                                 stack, n_sweeps, tau, tol, positivity, strides, stream);
  if (code != 0 || xhat == nullptr) return code;
  return forward_products(xn, fac_fwd, cns_t, xbuf, fbuf, xhat, ws, (size_t)ws_floats, plan, g,
                          st);
}

}  // namespace

extern "C" {

// Kernel D.  ghat, xhat: interleaved complex (B, M, N/2+1); the packed
// factors fac_inv, fac_fwd (2, 2M, ld1), w_t (2, N, 2Nhp), cns_t (2, 2Nhp,
// ldN) (ops/fused_dft_cuda.py::pack_factors); scratch gbuf, fbuf (2, B·Nhp,
// ld1), ybuf (2, B·M, 2Nhp), xbuf (2, B·M, ldN), grad (B, M, N), ws
// (ws_floats), and kernel B's iters/err (B), workspace ws_int/ws_f and
// geometry chains/grid/stack (tv_kernels.cu::sb_myula_step); plan: host
// int[11] (the tile plans and the geometry, ops/fused_dft_cuda.py::_host_plan);
// strides: the scalars' chain strides, as sb_myula_step.
int sb_myula_prox_tv_dft(const float* ghat, const float* x, const float* prox, const float* z,
                         const float* fac_inv, const float* w_t, const float* fac_fwd,
                         const float* cns_t, const float* gamma, const float* lam,
                         const float* lam_theta, const float* sigma2, float* xn, float* proxn,
                         float* tv, float* xhat, float* gbuf, float* ybuf, float* grad,
                         float* xbuf, float* fbuf, float* ws, int* iters, float* err,
                         int* ws_int, float* ws_f, const int* plan, long long ws_floats, int B,
                         int M, int N, int chains, int grid, int stack, int n_sweeps,
                         float tau, float tol, int positivity, int strides, void* stream) {
  if (fac_fwd == nullptr || cns_t == nullptr || xhat == nullptr || xbuf == nullptr ||
      fbuf == nullptr)
    return cudaErrorInvalidValue;
  return dft_step(ghat, x, prox, z, fac_inv, w_t, fac_fwd, cns_t, gamma, lam, lam_theta, sigma2,
                  xn, proxn, tv, xhat, gbuf, ybuf, grad, xbuf, fbuf, ws, iters, err, ws_int, ws_f,
                  plan, ws_floats, B, M, N, chains, grid, stack, n_sweeps, tau, tol,
                  positivity, strides, stream);
}

// Kernel E: D's steps 0–3 (the caller takes the forward transform).
int sb_myula_prox_tv_irdft(const float* ghat, const float* x, const float* prox,
                           const float* z, const float* fac_inv, const float* w_t,
                           const float* gamma, const float* lam, const float* lam_theta,
                           const float* sigma2, float* xn, float* proxn, float* tv, float* gbuf,
                           float* ybuf, float* grad, float* ws, int* iters, float* err,
                           int* ws_int, float* ws_f, const int* plan, long long ws_floats, int B,
                           int M, int N, int chains, int grid, int stack, int n_sweeps, float tau,
                           float tol, int positivity, int strides, void* stream) {
  return dft_step(ghat, x, prox, z, fac_inv, w_t, nullptr, nullptr, gamma, lam, lam_theta,
                  sigma2, xn, proxn, tv, nullptr, gbuf, ybuf, grad, nullptr, nullptr, ws, iters,
                  err, ws_int, ws_f, plan, ws_floats, B, M, N, chains, grid, stack, n_sweeps,
                  tau, tol, positivity, strides, stream);
}

// D's and E's products alone (timing and the card tests): grad = irfft2(Ĝ)
// into grad, and, when xhat is given, x̂ = rfft2(x) into xhat (x takes xn's
// place); the scratch as for kernel D.
int sb_dft_products(const float* ghat, const float* x, const float* fac_inv, const float* w_t,
                    const float* fac_fwd, const float* cns_t, float* grad, float* xhat,
                    float* gbuf, float* ybuf, float* xbuf, float* fbuf, float* ws,
                    const int* plan, long long ws_floats, int B, int M, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geo g(B, M, N, plan);
  if (!g.ok()) return cudaErrorInvalidValue;
  cudaError_t e = inverse_products(ghat, fac_inv, w_t, gbuf, ybuf, grad, ws, (size_t)ws_floats,
                                   plan, g, st);
  if (e != cudaSuccess || xhat == nullptr) return e;
  return forward_products(x, fac_fwd, cns_t, xbuf, fbuf, xhat, ws, (size_t)ws_floats, plan, g,
                          st);
}

// Host µs of the work a call no longer repeats (chip_smoke.py phase 6a),
// each the mean of `reps`: us[0] one tensor-map encoding (of a 64 × 64
// operand at buf, which must hold 2·64·64 floats), us[1] one setting of a
// GEMM's shared-memory allowance.
int sb_dft_host_costs(const float* buf, int reps, double* us) {
  using clock = std::chrono::steady_clock;
  if (reps < 1) return cudaErrorInvalidValue;
  CUtensorMap map;
  auto t0 = clock::now();
  for (int i = 0; i < reps; ++i)
    if (!encode_map(&map, Operand{buf, 64, 64, 64, 64 * 64}, 64)) return cudaErrorInvalidValue;
  auto t1 = clock::now();
  us[0] = std::chrono::duration<double, std::micro>(t1 - t0).count() / reps;
  using T = Tile<1, 64>;
  t0 = clock::now();
  for (int i = 0; i < reps; ++i) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_tf32x3<1, 64, StoreGrad>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return e;
  }
  t1 = clock::now();
  us[1] = std::chrono::duration<double, std::micro>(t1 - t0).count() / reps;
  return cudaSuccess;
}

}  // extern "C"
