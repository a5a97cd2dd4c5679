// The resident Chambolle machinery shared by tv_kernels.cu (kernels A1, A2,
// B, C and the step inside D/E) and prox_variants.cu (kernel J): the
// 32 x 64 tile of 256 threads with p1/p2 strips in registers, the border
// records exchanged through L2, the per-chain arrival barrier that carries
// the residual partials in a fixed order, the early exit, the chain groups,
// the stacked form (several chains a block between two barriers) and the
// walk form.  The design and its reasons are in tv_kernels.cu's header.
// The sweep and the chain loop take a policy (SweepPolicy below): kernels
// A-C instantiate SweepPolicy itself, J one policy a mode.

#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

// The kernel's arguments (one struct, for the cooperative launch; outside
// the unnamed namespace, as the extern "C" kernels take it).  The
// prox forms read g, lam and, warm, px_in/py_in, and write f and, when
// given, px_out/py_out.  The step forms read x, prox, grad, z or seeds,
// gamma, lam_step (λ of the update), sigma2 (null: 1), take lam = λθ, write
// xn (which is then g) and tv, and f is proxn.  Each scalar is read for
// chain b at scalar[b · stride]: stride 0 shares one value, 1 reads a (B,)
// vector (the problems of a sharded run, each with its own γ, λ, θ, σ²).
struct ResidentParams {
  const float* g;
  const float* lam;
  const float* px_in;
  const float* py_in;
  float* f;
  float* px_out;
  float* py_out;
  const float* x;
  const float* prox;
  const float* grad;
  const float* z;
  const int* seeds;
  const float* gamma;
  const float* lam_step;
  const float* sigma2;
  float* xn;
  float* tv;
  int* iters;
  float* err;
  int* ws_int;
  float* ws_f;
  int B, M, N, TX, T, C, max_iter, positivity;
  int K;   // blocks of a chain: T (resident form) or the grid (walk form)
  int S;   // tiles of the chains of a group, C·T: border records and partials a parity
  int lam_s, gamma_s, lam_step_s, sigma2_s;   // the scalars' chain strides (0 or 1)
  float tau, tol;
  int stack;   // chains a block sweeps between two barriers (stacked form), else 1
};

namespace {

constexpr int WX = 2;               // warps across a tile
constexpr int WY = 4;               // warps down a tile
constexpr int R = 8;                // rows of a thread's strip
constexpr int TW = 32 * WX;         // tile columns (64)
constexpr int TH = R * WY;          // tile rows (32)
constexpr int NW = WX * WY;         // warps of a block
constexpr int BT = 32 * NW;         // threads of a block (256)
constexpr int MIN_BLOCKS = 2;       // blocks an SM, the design's count
constexpr unsigned FULL = 0xffffffffu;
constexpr long long SPIN_LIMIT = 1LL << 25;
constexpr int ERR_TIMEOUT = 1;      // workspace error code: a barrier gave up
constexpr int PART_PER = 8;         // partials a thread loads at once
constexpr int KMAX = 3;             // chains a block of the stacked form holds, at most

static_assert(R % 4 == 0 && R <= 32, "a strip is float4 rows of at most 32 pixels");
static_assert(TW + TH <= BT, "one thread a halo u of the row below and column right");

// A tile's border record: offsets of its first row's p1 and p2, last row's
// p1, first column's p1 and p2 and last column's p2.
enum { B_R0P1 = 0, B_R0P2 = TW, B_RLP1 = 2 * TW, B_C0P1 = 3 * TW, B_C0P2 = 3 * TW + TH,
       B_CLP2 = 3 * TW + 2 * TH, BORDER = 3 * TW + 3 * TH };

// Halo elements a tile gathers a sweep: p1 above, p2 left, p1 below, p2
// below (and below-left), p1 right (and above-right), p2 right.
constexpr int HALO = TW + TH + TW + (TW + 1) + (TH + 1) + TH;
constexpr int HALO_PER = (HALO + BT - 1) / BT;   // halo elements a thread

// Workspace ints: the error code, the exit counter, then one arrival
// counter per chain slot (a slot: the T blocks of one chain, or of the
// stacked form's chains of a tile).  Workspace floats: border records
// [2][S], then residual partials [2][S], then TV partials [2][S], then (walk
// form) the duals p1 and p2 of one chain, M·N floats each.  The stacked
// form's chain k of block i takes record and partial k·grid + i.
enum { W_ERROR, W_EXIT, W_SLOTS };

// The image-boundary form of div p and ∇u: the branches' selects on the
// last row and column with a zero halo before the first (CONCAT, the
// reference's concatenate form), explicit select masks on both ends
// (SELECT), or 0/1 multiplicative masks (MULMASK).  All three give the
// same values.
enum { FORM_CONCAT, FORM_SELECT, FORM_MULMASK };

// v rounded to bfloat16 when BF (and returned as float), else v.
template <bool BF>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (BF) return __bfloat162float(__float2bfloat16_rn(v));
  else return v;
}

// What a sweep and the chain loop do.  Kernels A1, A2, B, C and the step
// inside D/E take SweepPolicy itself; kernel J (prox_variants.cu) one
// policy a mode, which overrides some of these:
//   Rec        a border record's element: float, or unsigned short holding
//              a bfloat16 (J's bf16 modes)
//   kBf16Dual  the duals, g/λ and the stencil's adds rounded to bfloat16
//   kBf16Arith the root, reciprocal and update rounded to bfloat16 too
//   kResidual  0: none (no partials, no exit), 1: float32 terms, 2: the
//              terms rounded to bfloat16 (float32 partial sums)
//   kDivide    2 divides, else 1 reciprocal and 2 multiplies
//   kSqrt      |∇u| a root, else its square (J's nosqrt, wrong by design)
//   kForm      the boundary form above
//   kMasked    a stopped chain's blocks go on sweeping to max_iter, meeting
//              the barrier (borders only), and keep their old duals
//   kEvery     the residual and the exit test only on sweeps kEvery, 2kEvery
//   tau, tol   from the parameters, or read on the device (J's scal)
//   finish     writes the chain's sweeps and last residual
struct SweepPolicy {
  using Rec = float;
  static constexpr bool kBf16Dual = false;
  static constexpr bool kBf16Arith = false;
  static constexpr int kResidual = 1;
  static constexpr bool kDivide = true;
  static constexpr bool kSqrt = true;
  static constexpr int kForm = FORM_CONCAT;
  static constexpr bool kMasked = false;
  static constexpr int kEvery = 1;
  __device__ static float tau(const ResidentParams& P) { return P.tau; }
  __device__ static float tol(const ResidentParams& P) { return P.tol; }
  __device__ static void finish(const ResidentParams& P, int b, int n, float e) {
    P.iters[b] = n;
    P.err[b] = e;
  }
};

// Whether sweep s (from 0) takes the residual and may exit.
template <class Pol>
__device__ __forceinline__ bool checks(int s) {
  if constexpr (Pol::kResidual == 0) return false;
  else if constexpr (Pol::kEvery == 1) return true;
  else return (s + 1) % Pol::kEvery == 0;
}

// A border record's element: loaded from L2, stored from a float (a
// bfloat16 value, which the upper half of its bits holds exactly).
__device__ __forceinline__ float rec_ld(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float rec_ld(const unsigned short* p) {
  return __uint_as_float((uint32_t)__ldcg(p) << 16);
}
__device__ __forceinline__ void rec_st(float* p, float v) { *p = v; }
__device__ __forceinline__ void rec_st(unsigned short* p, float v) {
  *p = (unsigned short)(__float_as_uint(v) >> 16);
}

__device__ __forceinline__ bool bit(uint32_t m, int i) { return (m >> i) & 1u; }

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// An arrival: the block's writes (ordered before by __syncthreads) made
// visible at the GPU's scope, then the counter raised, in one release add.
__device__ __forceinline__ void red_release(int* p) {
  asm volatile("red.release.gpu.global.add.s32 [%0], 1;" : : "l"(p) : "memory");
}

// Shared exchange: xrow[0] the p1 of the row above the tile, xrow[y + 1] of
// warp row y's last row; urow[y] the u of warp row y's first row, urow[WY]
// of the row below the tile; yedge[0] the p2 of the column left of the tile,
// yedge[x + 1] of warp column x's lane 31; uedge[x] the u of warp column x's
// lane 0, uedge[WX] of the column right of the tile.  bot_* and rgt_* hold
// the neighbours' p and g/λ for the u below and to the right: bot_p2[c + 1]
// at tile column c, bot_p2[0] below-left; rgt_p1[r + 1] at tile row r,
// rgt_p1[0] above-right.
struct Xch {
  float xrow[WY + 1][TW];
  float urow[WY + 1][TW];
  __align__(16) float yedge[WX + 1][TH];
  __align__(16) float uedge[WX + 1][TH];
  float bot_p1[TW], bot_p2[TW + 1], bot_gl[TW];
  float rgt_p1[TH + 1], rgt_p2[TH], rgt_gl[TH];
  float wpart[NW], wtv[NW];
  float wsum[2][NW];
  float gl[R][BT];      // g/λ of each thread's strip: gl[i][thread]
  float ex[3][R][BT];   // numerators and denominator of a warp's exact quotients
  // the halo elements thread t gathers (halo_table): hrec[j][t] the offset in
  // a parity's border records (-1: the pixel lies outside the image), hpix
  // the pixel's 2·(row·N + col) + (0: p1, 1: p2), hdst the float offset of
  // its slot in this struct (-1: none)
  int hrec[HALO_PER][BT], hpix[HALO_PER][BT], hdst[HALO_PER][BT];
};

// The walk form's exchange: Xch and the chain's g (or xn), the first duals
// (null: zero) and the duals between sweeps, read back through `fresh` at
// each use.
struct XchWalk : Xch {
  const float* wg;
  const float* wp1f;
  const float* wp2f;
  float* w1;
  float* w2;
  // and its loop state, one copy a thread: the sweep, the tile, the
  // barriers so far, the sweeps run and the last residual
  int wsw[BT], wtile[BT], warr[BT], wn[BT];
  float we[BT];
};

// The stacked form's chains of a block, in dynamic shared memory beside Xch
// (chain k = 0 .. stack−1): the duals of each strip, p[k][0] p1 and p[k][1]
// p2, loaded into the sweep's registers and stored back around each sweep;
// g/λ of the strip (chain 0's is Xch::gl); the halo elements gathered after
// each barrier (element e of halo_table's order) and the g/λ halo below and
// to the right (thread t < TW + TH, in bot_gl/rgt_gl's order); the warp sums
// of the residual and TV partials and of the chain's totals; thread 0's
// sweeps run and last residual; and the loop's state, thread 0's to write:
// the group's chains of the block (−1: none), the block's chain slot and
// the slots of the launch, its slot's barriers so far and before the group,
// and the next group's first chain, read back where used (`fresh`), so that
// no register holds them across a sweep.  The halo and g/λ halo go into
// Xch's slots before the chain's sweep, so the sweep is the one-chain
// form's.
constexpr int GLH = TW + TH;
struct Stack {
  float p[KMAX][2][R][BT];
  float gl[KMAX - 1][R][BT];
  float halo[KMAX][HALO];
  float glh[KMAX][GLH];
  float wpart[KMAX][NW], wtv[KMAX][NW];
  float wsum[KMAX][2][NW];
  int n[KMAX];
  float e[KMAX];
  int chain[KMAX], slot, slots, arr, arr0, next;
};

// v read from shared memory at this point: a volatile load, so that the
// value holds no register across the sweep between two uses.
template <typename T>
__device__ __forceinline__ T fresh(const T& v) {
  return *const_cast<const volatile T*>(&v);
}

// A thread's place, fixed for the launch: lane, warp, warp column and row,
// tile column, first strip row; the tile's origin and grid place; whether
// the thread's column is the image's last; bit i: strip row i is the
// image's last row / lies in the image (with the column).
struct Pos {
  int lane, w, wx, wy, c, r0, ty0, tx0, ty, tx;
  bool c_last;
  uint32_t m_last, m_valid;
};

// xn at (row, col) of chain b: common.cuh::myula_at's update, with the noise
// of z or of the chain's Philox stream (rng.cuh::philox_normal's), in their
// operation order with div_rn_exact and sqrt_rn_exact for '/' and sqrtf, so
// that the kernel makes no call.  A pure function of the inputs, so a halo
// pixel computed by two tiles has one value.
struct StepIn {
  const float* x;
  const float* prox;
  const float* grad;
  const float* z;
  uint32_t k0, k1;
  float gamma, lam, sigma2, s2g;
  int N, positivity;
  __device__ float noise(size_t p) const {
    if (z != nullptr) return z[p];
    uint32_t w[4];
    philox4x32_10((uint32_t)(p >> 2), k0, k1, w);
    const uint32_t a = (p & 2) ? w[2] : w[0];
    const uint32_t b = (p & 2) ? w[3] : w[1];
    const float u1 = (float)((a >> 8) + 1u) * 5.9604644775390625e-08f;   // 2^-24
    const float u2 = (float)(b >> 8) * 5.9604644775390625e-08f;
    const float r = sqrt_rn_exact(-2.0f * logf(u1));
    const float t = 6.283185307179586f * u2;
    return r * ((p & 1) ? sinf(t) : cosf(t));
  }
  __device__ float at(int row, int col) const {
    const size_t q = (size_t)row * N + col;
    return at_of(q, x[q], prox[q], grad[q], z != nullptr ? z[q] : 0.f);
  }
  // at() from the pixel's inputs, loaded beforehand (zv: z's, when given)
  __device__ float at_of(size_t q, float xv, float pv, float gv, float zv) const {
    const float v = xv + div_rn_exact(gamma * (pv - xv), lam) - gamma * div_rn_exact(gv, sigma2) +
                    s2g * (z != nullptr ? zv : noise(q));
    return positivity ? fabsf(v) : v;
  }
};

// One halo element of the sweep: the image pixel, its dual (0: p1, 1: p2),
// the neighbour tile's place and the offset in its border record, and the
// shared slot it goes to.
__device__ __forceinline__ float* halo_elem(Xch& x, const Pos& ps, int e, int& row, int& col,
                                            int& comp, int& dty, int& dtx, int& off) {
  if (e < TW) {                   // p1 of the row above
    row = ps.ty0 - 1; col = ps.tx0 + e; comp = 0; dty = -1; dtx = 0; off = B_RLP1 + e;
    return &x.xrow[0][e];
  }
  e -= TW;
  if (e < TH) {                   // p2 of the column left
    row = ps.ty0 + e; col = ps.tx0 - 1; comp = 1; dty = 0; dtx = -1; off = B_CLP2 + e;
    return &x.yedge[0][e];
  }
  e -= TH;
  if (e < TW) {                   // p1 of the row below
    row = ps.ty0 + TH; col = ps.tx0 + e; comp = 0; dty = 1; dtx = 0; off = B_R0P1 + e;
    return &x.bot_p1[e];
  }
  e -= TW;
  if (e < TW + 1) {               // p2 of the row below, from its left neighbour on
    row = ps.ty0 + TH; col = ps.tx0 + e - 1; comp = 1; dty = 1;
    dtx = e == 0 ? -1 : 0; off = B_R0P2 + (e == 0 ? TW - 1 : e - 1);
    return &x.bot_p2[e];
  }
  e -= TW + 1;
  if (e < TH + 1) {               // p1 of the column right, from its upper neighbour on
    row = ps.ty0 + e - 1; col = ps.tx0 + TW; comp = 0; dtx = 1;
    dty = e == 0 ? -1 : 0; off = e == 0 ? B_RLP1 : B_C0P1 + e - 1;
    return &x.rgt_p1[e];
  }
  e -= TH + 1;                    // p2 of the column right
  row = ps.ty0 + e; col = ps.tx0 + TW; comp = 1; dty = 0; dtx = 1; off = B_C0P2 + e;
  return &x.rgt_p2[e];
}

// The border records of parity par, one a tile of a group's chains, of
// element type T (a bfloat16 record fills the first half of its floats).
template <class T = float>
__device__ __forceinline__ T* records(const ResidentParams& P, int par) {
  return reinterpret_cast<T*>(P.ws_f + (size_t)par * P.S * BORDER);
}

// The residual (kind 0) or TV (kind 1) partials of parity par, one a tile.
__device__ __forceinline__ float* partials(const ResidentParams& P, int kind, int par) {
  return P.ws_f + (size_t)2 * P.S * BORDER + (size_t)(2 * kind + par) * P.S;
}

// The walk form's duals in the workspace: p1, then p2 at + M·N.
__device__ __forceinline__ float* walk_duals(const ResidentParams& P) {
  return P.ws_f + (size_t)2 * P.S * BORDER + (size_t)4 * P.S;
}

// A thread's place on tile `tile` of a chain.
__device__ __forceinline__ Pos place(const ResidentParams& P, int tile) {
  const int t = threadIdx.x;
  Pos ps;
  ps.lane = t & 31;
  ps.w = t >> 5;
  ps.wx = ps.w % WX;
  ps.wy = ps.w / WX;
  ps.c = 32 * ps.wx + ps.lane;
  ps.r0 = R * ps.wy;
  ps.ty = tile / P.TX;
  ps.tx = tile % P.TX;
  ps.ty0 = ps.ty * TH;
  ps.tx0 = ps.tx * TW;
  const int col = ps.tx0 + ps.c;
  ps.c_last = col == P.N - 1;
  ps.m_last = ps.m_valid = 0u;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = ps.ty0 + ps.r0 + i;
    ps.m_last |= (uint32_t)(row == P.M - 1) << i;
    ps.m_valid |= (uint32_t)(row < P.M && col < P.N) << i;
  }
  return ps;
}

// This thread's halo elements (t, t + BT, ...) into the table of Xch, once a
// launch: the tile is the same for every chain.
__device__ __forceinline__ void halo_table(Xch& x, const Pos& ps, const ResidentParams& P, int base) {
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < HALO_PER; ++j) {
    const int e = t + j * BT;
    int rec = -1, pix = 0, dst = -1;
    if (e < HALO) {
      int row, col, comp, dty, dtx, off;
      dst = (int)(halo_elem(x, ps, e, row, col, comp, dty, dtx, off) -
                  reinterpret_cast<float*>(&x));
      if (row >= 0 && row < P.M && col >= 0 && col < P.N) {
        rec = (base + (ps.ty + dty) * P.TX + ps.tx + dtx) * BORDER + off;
        pix = 2 * (row * P.N + col) + comp;
      }
    }
    x.hrec[j][t] = rec;
    x.hpix[j][t] = pix;
    x.hdst[j][t] = dst;
  }
}

// The strip ends of (v1, v2) to the shared exchange: v1's last row to
// xrow, lane 31's v2 to yedge.
__device__ __forceinline__ void publish_ends(Xch& x, const Pos& ps, const float (&v1)[R],
                                             const float (&v2)[R]) {
  x.xrow[ps.wy + 1][ps.c] = v1[R - 1];
  if (ps.lane == 31) {
#pragma unroll
    for (int i = 0; i < R; i += 4)
      *reinterpret_cast<float4*>(&x.yedge[ps.wx + 1][ps.r0 + i]) =
          make_float4(v2[i], v2[i + 1], v2[i + 2], v2[i + 3]);
  }
}

// The tile's border record of (p1, p2) at parity q.
template <class T>
__device__ __forceinline__ void publish_border(const Pos& ps, T* rec, const float (&p1)[R],
                                               const float (&p2)[R]) {
  if (ps.wy == 0) {
    rec_st(rec + B_R0P1 + ps.c, p1[0]);
    rec_st(rec + B_R0P2 + ps.c, p2[0]);
  }
  if (ps.wy == WY - 1) rec_st(rec + B_RLP1 + ps.c, p1[R - 1]);
  if (ps.wx == 0 && ps.lane == 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      rec_st(rec + B_C0P1 + ps.r0 + i, p1[i]);
      rec_st(rec + B_C0P2 + ps.r0 + i, p2[i]);
    }
  }
  if (ps.wx == WX - 1 && ps.lane == 31) {
#pragma unroll
    for (int i = 0; i < R; ++i) rec_st(rec + B_CLP2 + ps.r0 + i, p2[i]);
  }
}

// The sum of v over the block's valid pixels in the kernel's order: each
// thread's strip in row order (done by the caller), a shuffle-down tree
// across each warp into wp[w], then (after the barrier's __syncthreads)
// thread 0 adds the warps in order.
__device__ __forceinline__ void warp_part(float v, float* wp, const Pos& ps) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  if (ps.lane == 0) wp[ps.w] = v;
}

__device__ __forceinline__ float block_part(const float* wp) {
  float s = wp[0];
#pragma unroll
  for (int v = 1; v < NW; ++v) s += wp[v];
  return s;
}

// The chain slot's barrier.  Thread 0 writes the block's residual (and, with
// tv_slot, TV) partial from the warp sums when given, arrives on the slot's
// counter with release semantics and spins until `target` arrivals.  A spin
// that gives up writes the error code and traps: the launch fails, and the
// caller's next synchronisation raises.
__device__ __forceinline__ void arrive_and_wait(const ResidentParams& P, int* ctr, int target) {
  red_release(ctr);
  long long polls = 0;
  while (ld_acquire(ctr) < target) {
    if ((++polls & 1023) == 0 && polls > SPIN_LIMIT) {
      atomicExch(P.ws_int + W_ERROR, ERR_TIMEOUT);
      __threadfence_system();
      __trap();
    }
  }
}

__device__ __forceinline__ void slot_barrier(Xch& x, const ResidentParams& P, int* ctr,
                                             int target, float* part_slot, float* tv_slot) {
  __syncthreads();
  if (threadIdx.x == 0) {
    if (part_slot != nullptr) *part_slot = block_part(x.wpart);
    if (tv_slot != nullptr) *tv_slot = block_part(x.wtv);
    arrive_and_wait(P, ctr, target);
  }
  __syncthreads();
}

// The fixed-order sum of one thread's partials (thread t: t, t + BT, ...
// of T, in order; PART_PER loaded at once), then a shuffle-down tree across
// the warp.
__device__ __forceinline__ float thread_total(const float* part, int T) {
  float s = 0.f;
  for (int k0 = 0; k0 < T; k0 += PART_PER * BT) {
    float v[PART_PER];
#pragma unroll
    for (int j = 0; j < PART_PER; ++j) {
      const int k = k0 + threadIdx.x + j * BT;
      v[j] = k < T ? __ldcg(part + k) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < PART_PER; ++j) s = s + v[j];
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(FULL, s, o);
  return s;
}

// The chain's total of its T partials at `part`, the same in every block
// (thread_total, then the warps in order).
__device__ __forceinline__ float slot_total(Xch& x, const float* part, int T) {
  const float s = thread_total(part, T);
  if ((threadIdx.x & 31) == 0) x.wsum[0][threadIdx.x >> 5] = s;
  __syncthreads();
  return block_part(x.wsum[0]);
}

// After a barrier: the neighbours' duals at the tile's edges into the
// exchange, and the chain's totals of the T partials at `part` and, when
// not null, `tvp` (every block of the slot gets the same values: each
// thread's partials in order, a shuffle tree down each warp, the warps in
// order).  The duals come from the fields p1f/p2f (the call's first duals;
// null: zero) when q < 0, else from the border records of parity q.  A
// pixel outside the image reads zero; one inside lies in an existing
// neighbour tile, whose record holds it.  All loads are issued together.
// Ends with a barrier.  Rec: the records' element type.
template <class Rec = float>
__device__ __forceinline__ float2 gather(Xch& x, const Pos& ps, const ResidentParams& P,
                                         const float* p1f, const float* p2f, int q,
                                         const float* part, const float* tvp) {
  const int t = threadIdx.x;
  const Rec* rec = records<Rec>(P, q < 0 ? 0 : q);
  float hv[HALO_PER];
#pragma unroll
  for (int j = 0; j < HALO_PER; ++j) {
    const int r = x.hrec[j][t], hp = x.hpix[j][t];
    float v = 0.f;
    if (r >= 0) {
      if (q >= 0) {
        v = rec_ld(rec + r);
      } else {
        const float* src = (hp & 1) ? p2f : p1f;
        if (src != nullptr) v = src[hp >> 1];
      }
    }
    hv[j] = v;
  }
  float2 tot = make_float2(0.f, 0.f);
  if (part != nullptr) {
    const float a = thread_total(part, P.T);
    const float b = tvp != nullptr ? thread_total(tvp, P.T) : 0.f;
    if (ps.lane == 0) {
      x.wsum[0][ps.w] = a;
      x.wsum[1][ps.w] = b;
    }
  }
#pragma unroll
  for (int j = 0; j < HALO_PER; ++j) {
    const int d = x.hdst[j][t];
    if (d >= 0) reinterpret_cast<float*>(&x)[d] = hv[j];
  }
  __syncthreads();
  if (part != nullptr) {
    tot.x = block_part(x.wsum[0]);
    tot.y = block_part(x.wsum[1]);
  }
  return tot;
}

// u = div p − g/λ at one pixel from its duals (c1, c2), the p1 above and
// the p2 to its left (zero outside the image), whether its row and column
// are the image's first and last, and gl = g/λ there, in the policy's
// boundary form and rounding.
template <class Pol>
__device__ __forceinline__ float u_of(float c1, float up, float c2, float lf, bool fr, bool lr,
                                      bool fc, bool lc, float gl) {
  constexpr bool BS = Pol::kBf16Dual;
  float a, b;
  if constexpr (Pol::kForm == FORM_SELECT) {
    a = (lr ? -c1 : c1) - ((!fr && !lr) ? up : 0.f);
    b = (lc ? -c2 : c2) - ((!fc && !lc) ? lf : 0.f);
  } else if constexpr (Pol::kForm == FORM_MULMASK) {
    a = c1 * ((float)!lr - (float)lr) - up * (float)(!fr && !lr);
    b = c2 * ((float)!lc - (float)lc) - lf * (float)(!fc && !lc);
  } else {
    a = lr ? -c1 : rnd<BS>(c1 - up);
    b = lc ? -c2 : rnd<BS>(c2 - lf);
  }
  static_assert(!BS || Pol::kForm == FORM_CONCAT, "bfloat16 stencils take the concatenate form");
  return rnd<BS>(rnd<BS>(a + b) - gl);
}

// A forward difference of u, nb − u, zero at the image's last row/column.
template <class Pol>
__device__ __forceinline__ float grad_of(float nb, float u, bool last) {
  if constexpr (Pol::kForm == FORM_MULMASK) return (nb - u) * (float)!last;
  else return last ? 0.f : rnd<Pol::kBf16Dual>(nb - u);
}

// One sweep on the strip: u = div p − g/λ (and the halo u below and to the
// right by threads 0 .. TW+TH−1), then the update; returns the thread's
// residual sum over its valid pixels when `check` (else 0).  The
// neighbours' duals are in the exchange (gather); the strip ends of p are
// published again at the end.  `keep` (a masked policy's stopped chain)
// computes the sweep and keeps the old duals.  g/λ is x.gl, or `gl` when
// given (a stacked chain's).
template <class Pol>
__device__ __forceinline__ float sweep(Xch& x, const Pos& ps, const ResidentParams& P, float (&p1)[R],
                                       float (&p2)[R], bool check = true, bool keep = false,
                                       const float (*gl)[BT] = nullptr) {
  constexpr bool BS = Pol::kBf16Dual;
  const float(*glam)[BT] = gl != nullptr ? gl : x.gl;
  constexpr bool BA = Pol::kBf16Arith;
  const int col0 = ps.tx0 + ps.c;
  float u[R];
#pragma unroll
  for (int i4 = 0; i4 < R; i4 += 4) {
    float4 e = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ps.lane == 0) e = *reinterpret_cast<const float4*>(&x.yedge[ps.wx][ps.r0 + i4]);
    const float ev[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i4 + q;
      const float above = i == 0 ? x.xrow[ps.wy][ps.c] : p1[i > 0 ? i - 1 : 0];
      const float sh = __shfl_up_sync(FULL, p2[i], 1);
      const float left = ps.lane == 0 ? ev[q] : sh;
      u[i] = u_of<Pol>(p1[i], above, p2[i], left, ps.ty0 + ps.r0 + i == 0, bit(ps.m_last, i),
                       col0 == 0, ps.c_last, glam[i][threadIdx.x]);
    }
  }
  x.urow[ps.wy][ps.c] = u[0];
  if (ps.lane == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 4)
      *reinterpret_cast<float4*>(&x.uedge[ps.wx][ps.r0 + i]) =
          make_float4(u[i], u[i + 1], u[i + 2], u[i + 3]);
  }
  // the u of the row below and of the column right of the tile
  const int t = threadIdx.x;
  if (t < TW) {
    const int row = ps.ty0 + TH, col = ps.tx0 + t;
    float v = 0.f;
    if (row < P.M && col < P.N)
      v = u_of<Pol>(x.bot_p1[t], x.xrow[WY][t], x.bot_p2[t + 1], x.bot_p2[t], false,
                    row == P.M - 1, col == 0, col == P.N - 1, x.bot_gl[t]);
    x.urow[WY][t] = v;
  } else if (t < TW + TH) {
    const int r = t - TW, row = ps.ty0 + r, col = ps.tx0 + TW;
    float v = 0.f;
    if (row < P.M && col < P.N)
      v = u_of<Pol>(x.rgt_p1[r + 1], x.rgt_p1[r], x.rgt_p2[r], x.yedge[WX][r], row == 0,
                    row == P.M - 1, false, col == P.N - 1, x.rgt_gl[r]);
    x.uedge[WX][r] = v;
  }
  __syncthreads();
  // the residual and the update, a row at a time: the row's numerators and
  // denominator go to shared memory and its quotients are taken at once by
  // div_rn_fast, so that u[i] is dead after row i; a warp with an operand
  // outside that quotient's range takes them all again by div_rn_exact
  const float below_last = x.urow[ps.wy + 1][ps.c];
  const float tau = rnd<BA>(Pol::tau(P));
  float acc = 0.f;
  bool ok = true;
#pragma unroll
  for (int i4 = 0; i4 < R; i4 += 4) {
    float4 e = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ps.lane == 31) e = *reinterpret_cast<const float4*>(&x.uedge[ps.wx + 1][ps.r0 + i4]);
    const float ev[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i4 + q;
      const float below = i == R - 1 ? below_last : u[i < R - 1 ? i + 1 : i];
      const float sh = __shfl_down_sync(FULL, u[i], 1);
      const float right = ps.lane == 31 ? ev[q] : sh;
      const float upx = grad_of<Pol>(below, u[i], bit(ps.m_last, i));
      const float upy = grad_of<Pol>(right, u[i], ps.c_last);
      float tmp;
      if constexpr (BA) {
        tmp = rnd<true>(sqrt_rn_exact(rnd<true>(rnd<true>(upx * upx) + rnd<true>(upy * upy))));
      } else {
        const float s2 = upx * upx + upy * upy;
        tmp = Pol::kSqrt ? sqrt_rn_exact(s2) : s2;
      }
      if (check) {
        if constexpr (Pol::kResidual == 2) {
          const float rx = rnd<true>(-upx + rnd<true>(tmp * p1[i]));
          const float ry = rnd<true>(-upy + rnd<true>(tmp * p2[i]));
          const bool valid = bit(ps.m_valid, i);
          acc = acc + (valid ? rnd<true>(rnd<true>(rx * rx) + rnd<true>(ry * ry)) : 0.f);
        } else {
          const float rx = -upx + tmp * p1[i];
          const float ry = -upy + tmp * p2[i];
          const bool valid = bit(ps.m_valid, i);
          acc = acc + (valid ? rx * rx + ry * ry : 0.f);
        }
      }
      const bool valid = bit(ps.m_valid, i);
      const float denom = rnd<BA>(1.0f + rnd<BA>(tau * tmp));
      const float a1 = rnd<BA>(p1[i] + rnd<BA>(tau * upx));
      const float a2 = rnd<BA>(p2[i] + rnd<BA>(tau * upy));
      if constexpr (Pol::kDivide)
        ok = ok & (!valid | (fast_div_ok(a1, denom) & fast_div_ok(a2, denom)));
      else
        ok = ok & (!valid | fast_div_ok(1.0f, denom));
      x.ex[0][i][t] = a1;
      x.ex[1][i][t] = a2;
      x.ex[2][i][t] = denom;
      if constexpr (Pol::kDivide) {
        // a zero numerator keeps its sign, as under '/' (denom ≥ 1)
        p1[i] = keep ? p1[i] : (a1 == 0.f ? a1 : div_rn_fast(a1, denom));
        p2[i] = keep ? p2[i] : (a2 == 0.f ? a2 : div_rn_fast(a2, denom));
      } else {
        const float rden = rnd<BA>(div_rn_fast(1.0f, denom));
        p1[i] = keep ? p1[i] : rnd<BA || BS>(a1 * rden);
        p2[i] = keep ? p2[i] : rnd<BA || BS>(a2 * rden);
      }
    }
  }
  if (!__all_sync(FULL, ok)) {
    // one pixel at a time, so that the exact quotient costs the sweep no
    // registers
#pragma unroll 1
    for (int i = 0; i < R; ++i) {
      const float d = x.ex[2][i][t];
      if constexpr (Pol::kDivide) {
        x.ex[0][i][t] = div_rn_exact(x.ex[0][i][t], d);
        x.ex[1][i][t] = div_rn_exact(x.ex[1][i][t], d);
      } else {
        const float rden = rnd<BA>(div_rn_exact(1.0f, d));
        x.ex[0][i][t] = rnd<BA || BS>(x.ex[0][i][t] * rden);
        x.ex[1][i][t] = rnd<BA || BS>(x.ex[1][i][t] * rden);
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      p1[i] = keep ? p1[i] : x.ex[0][i][t];
      p2[i] = keep ? p2[i] : x.ex[1][i][t];
    }
  }
  publish_ends(x, ps, p1, p2);
  return acc;
}

// The step forms' prologue: xn of the strip to P.xn (staged in x.gl); the
// circular TV partial of the strip into the warp sums wtv; g/λθ of the strip
// into x.gl; the halo xn below and to the right of the tile, divided by λθ,
// into bot_gl/rgt_gl.  The TV's up and left neighbours across the tile's
// edge (wrapping at the image's) are computed again from the inputs, so no
// barrier is needed.  The strip's inputs are loaded half a strip at once, so
// that the loads wait on memory twice, not once a row (the stores to xn may
// alias them); the TV's strip loops are not unrolled, as the sweeps need the
// registers.
__device__ __forceinline__ void step_prologue(Xch& x, const Pos& ps, const ResidentParams& P, int b,
                                              float lam) {
  const size_t off = (size_t)b * P.M * P.N;
  StepIn in;
  in.x = P.x + off;
  in.prox = P.prox + off;
  in.grad = P.grad + off;
  in.z = P.z != nullptr ? P.z + off : nullptr;
  in.k0 = P.z == nullptr ? (uint32_t)P.seeds[2 * b] : 0u;
  in.k1 = P.z == nullptr ? (uint32_t)P.seeds[2 * b + 1] : 0u;
  in.gamma = P.gamma[b * P.gamma_s];
  in.lam = P.lam_step[b * P.lam_step_s];
  in.sigma2 = P.sigma2 != nullptr ? P.sigma2[b * P.sigma2_s] : 1.0f;
  in.s2g = sqrt_rn_exact(2.0f * in.gamma);
  in.N = P.N;
  in.positivity = P.positivity;
  const int t = threadIdx.x, col = ps.tx0 + ps.c;
  // the strip in two halves, each half's inputs loaded at once
#pragma unroll
  for (int i0 = 0; i0 < R; i0 += R / 2) {
    float xv[R / 2], pv[R / 2], gv[R / 2], zv[R / 2];
#pragma unroll
    for (int j = 0; j < R / 2; ++j) {
      const bool ok = bit(ps.m_valid, i0 + j);
      const size_t q = (size_t)(ps.ty0 + ps.r0 + i0 + j) * P.N + col;
      xv[j] = ok ? in.x[q] : 0.f;
      pv[j] = ok ? in.prox[q] : 0.f;
      gv[j] = ok ? in.grad[q] : 0.f;
      zv[j] = (ok && in.z != nullptr) ? in.z[q] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < R / 2; ++j) {
      const size_t q = (size_t)(ps.ty0 + ps.r0 + i0 + j) * P.N + col;
      float v = 0.f;
      if (bit(ps.m_valid, i0 + j)) {
        v = in.at_of(q, xv[j], pv[j], gv[j], zv[j]);
        P.xn[off + q] = v;
      }
      x.gl[i0 + j][t] = v;
    }
  }
  // the halo: up (wrapping), left (wrapping), below, right
  for (int e = t; e < 2 * (TW + TH); e += BT) {
    int k = e, row, cl;
    float* dst;
    bool div = false;
    if (k < TW) {
      row = ps.ty0 == 0 ? P.M - 1 : ps.ty0 - 1; cl = ps.tx0 + k; dst = &x.xrow[0][k];
    } else if ((k -= TW) < TH) {
      row = ps.ty0 + k; cl = ps.tx0 == 0 ? P.N - 1 : ps.tx0 - 1; dst = &x.yedge[0][k];
    } else if ((k -= TH) < TW) {
      row = ps.ty0 + TH; cl = ps.tx0 + k; dst = &x.bot_gl[k]; div = true;
    } else {
      k -= TW;
      row = ps.ty0 + k; cl = ps.tx0 + TW; dst = &x.rgt_gl[k]; div = true;
    }
    float v = 0.f;
    if (row < P.M && cl < P.N) {
      v = in.at(row, cl);
      if (div) v = div_rn_exact(v, lam);
    }
    *dst = v;
  }
  x.xrow[ps.wy + 1][ps.c] = x.gl[R - 1][t];
  if (ps.lane == 31) {
#pragma unroll 1
    for (int i = 0; i < R; ++i) x.yedge[ps.wx + 1][ps.r0 + i] = x.gl[i][t];
  }
  __syncthreads();
  float tacc = 0.f;
#pragma unroll 1
  for (int i = 0; i < R; ++i) {
    const float v = x.gl[i][t];
    const float up = i == 0 ? x.xrow[ps.wy][ps.c] : x.gl[i > 0 ? i - 1 : 0][t];
    const float sh = __shfl_up_sync(FULL, v, 1);
    const float left = ps.lane == 0 ? x.yedge[ps.wx][ps.r0 + i] : sh;
    const float dh = v - left;
    const float dv = v - up;
    tacc = tacc + (bit(ps.m_valid, i) ? sqrt_rn_exact(dh * dh + dv * dv) : 0.f);
  }
  warp_part(tacc, x.wtv, ps);
#pragma unroll 1
  for (int i = 0; i < R; ++i) x.gl[i][t] = bit(ps.m_valid, i) ? div_rn_exact(x.gl[i][t], lam) : 0.f;
  __syncthreads();
}

// g/λ of the strip into x.gl, and of the row below and the column right of
// the tile into bot_gl/rgt_gl (zero outside the image).  g is read from L2:
// the step forms' xn is written earlier in the launch.  BF: rounded to
// bfloat16 (kernel J's bf16 modes).
template <bool BF = false>
__device__ __forceinline__ void load_glam(Xch& x, const Pos& ps, const ResidentParams& P,
                                          const float* gsrc, float lam) {
  const int t = threadIdx.x, col = ps.tx0 + ps.c;
#pragma unroll 1
  for (int i = 0; i < R; ++i) {
    const size_t idx = (size_t)(ps.ty0 + ps.r0 + i) * P.N + col;
    x.gl[i][t] = bit(ps.m_valid, i) ? rnd<BF>(div_rn_exact(__ldcg(gsrc + idx), lam)) : 0.f;
  }
  if (t < TW) {
    const int row = ps.ty0 + TH, cl = ps.tx0 + t;
    x.bot_gl[t] = (row < P.M && cl < P.N)
                      ? rnd<BF>(div_rn_exact(__ldcg(gsrc + (size_t)row * P.N + cl), lam))
                      : 0.f;
  } else if (t < TW + TH) {
    const int row = ps.ty0 + t - TW, cl = ps.tx0 + TW;
    x.rgt_gl[t - TW] = (row < P.M && cl < P.N)
                           ? rnd<BF>(div_rn_exact(__ldcg(gsrc + (size_t)row * P.N + cl), lam))
                           : 0.f;
  }
}

// The strip's duals from the fields (d1, d2) (null: zero), read from L2.
__device__ __forceinline__ void load_duals(const Pos& ps, const ResidentParams& P,
                                           const float* d1, const float* d2, float (&p1)[R],
                                           float (&p2)[R]) {
  const int col = ps.tx0 + ps.c;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const size_t idx = (size_t)(ps.ty0 + ps.r0 + i) * P.N + col;
    const bool v = bit(ps.m_valid, i);
    p1[i] = (v && d1 != nullptr) ? __ldcg(d1 + idx) : 0.f;
    p2[i] = (v && d2 != nullptr) ? __ldcg(d2 + idx) : 0.f;
  }
}

// f = g − λ·div p on the strip (proxn = xn − λθ·div p), and the duals to
// px_out/py_out when given; the exchange holds the final duals' halo
// (gather).  The strip's g is loaded before the first store (the stores to f
// may alias it, so the loads would otherwise wait one a row).
__device__ __forceinline__ void assemble(Xch& x, const Pos& ps, const ResidentParams& P,
                                         size_t off, const float* gsrc, float lam,
                                         const float (&p1)[R], const float (&p2)[R]) {
  const int col = ps.tx0 + ps.c;
  float gv[R];
#pragma unroll
  for (int i = 0; i < R; ++i)
    gv[i] = bit(ps.m_valid, i) ? __ldcg(gsrc + (size_t)(ps.ty0 + ps.r0 + i) * P.N + col) : 0.f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float above = i == 0 ? x.xrow[ps.wy][ps.c] : p1[i > 0 ? i - 1 : 0];
    const float sh = __shfl_up_sync(FULL, p2[i], 1);
    const float left = ps.lane == 0 ? x.yedge[ps.wx][ps.r0 + i] : sh;
    if (bit(ps.m_valid, i)) {
      const float a = bit(ps.m_last, i) ? -p1[i] : p1[i] - above;
      const float bb = ps.c_last ? -p2[i] : p2[i] - left;
      const size_t pix = (size_t)(ps.ty0 + ps.r0 + i) * P.N + col;
      P.f[off + pix] = gv[i] - lam * (a + bb);
      if (P.px_out != nullptr) {
        P.px_out[off + pix] = p1[i];
        P.py_out[off + pix] = p2[i];
      }
    }
  }
}

// Resident form: one chain of the call on this block's tile, the duals in
// registers.  `arrivals` counts the slot's barriers so far.
template <bool STEP, class Pol>
__device__ __forceinline__ void run_chain(Xch& x, const Pos& ps, const ResidentParams& P, int b,
                                          int slot, int tile, int& arrivals) {
  using Rec = typename Pol::Rec;
  const size_t off = (size_t)b * P.M * P.N;
  const float lam = P.lam[b * P.lam_s];
  const float* gsrc = STEP ? P.xn + off : P.g + off;
  const float* p1f = (!STEP && P.px_in != nullptr) ? P.px_in + off : nullptr;
  const float* p2f = (!STEP && P.py_in != nullptr) ? P.py_in + off : nullptr;
  const int base = slot * P.T;
  int* ctr = P.ws_int + W_SLOTS + slot;

  float p1[R], p2[R];
  if (STEP) {
    step_prologue(x, ps, P, b, lam);
#pragma unroll
    for (int i = 0; i < R; ++i) p1[i] = p2[i] = 0.f;
  } else {
    load_glam<Pol::kBf16Dual>(x, ps, P, gsrc, lam);
    load_duals(ps, P, p1f, p2f, p1, p2);
  }
  publish_ends(x, ps, p1, p2);
  gather<Rec>(x, ps, P, p1f, p2f, -1, nullptr, nullptr);

  const float tol = Pol::tol(P);
  int n = 0;
  float e = Pol::kResidual ? INFINITY : 0.f;
  for (int s = 0; s < P.max_iter; ++s) {
    // a sweep without the residual carries only the borders over the barrier
    const bool keep = Pol::kMasked && !(e > tol);
    const bool check = checks<Pol>(s) && !keep;
    const float acc = sweep<Pol>(x, ps, P, p1, p2, check, keep);
    const int par = arrivals & 1;
    publish_border(ps, records<Rec>(P, par) + (size_t)blockIdx.x * BORDER, p1, p2);
    if (check) warp_part(acc, x.wpart, ps);
    float* part = partials(P, 0, par);
    float* tv_slot = STEP && s == 0 ? partials(P, 1, par) : nullptr;
    slot_barrier(x, P, ctr, (arrivals + 1) * P.K, check ? part + blockIdx.x : nullptr,
                 tv_slot != nullptr ? tv_slot + blockIdx.x : nullptr);
    ++arrivals;
    // the next sweep's (or the assembly's) halo and the chain's sums, at once
    const float2 tot = gather<Rec>(x, ps, P, p1f, p2f, par, check ? part + base : nullptr,
                                   tv_slot != nullptr ? tv_slot + base : nullptr);
    if (tv_slot != nullptr && tile == 0 && threadIdx.x == 0) P.tv[b] = tot.y;
    if (!keep) {
      n = s + 1;
      if (check) e = sqrt_rn_exact(tot.x);
    }
    if (!Pol::kMasked && check && !(e > tol)) break;
  }
  if (STEP && P.max_iter == 0) {   // the TV's barrier alone
    float* tv_slot = partials(P, 1, arrivals & 1);
    slot_barrier(x, P, ctr, (arrivals + 1) * P.K, nullptr, tv_slot + blockIdx.x);
    ++arrivals;
    const float tv = slot_total(x, tv_slot + base, P.T);
    if (tile == 0 && threadIdx.x == 0) P.tv[b] = tv;
  }

  assemble(x, ps, P, off, gsrc, lam, p1, p2);
  if (tile == 0 && threadIdx.x == 0) Pol::finish(P, b, n, e);
  __syncthreads();   // the exchange is rewritten by the next chain
}

// Walk form: one chain of the call on the K blocks of the grid, block k
// sweeping tiles k, k + K, ... in turn, the duals in device memory between
// sweeps.  The step forms' TV takes a barrier of its own before the first
// sweep, which then reads the neighbours' xn.  The chain's pointers live in
// the exchange (`fresh`): with them in registers the sweep spilled.
template <bool STEP, class Pol>
__device__ __forceinline__ void run_chain_walk(XchWalk& x, const ResidentParams& P, int b,
                                               int& arrivals) {
  using Rec = typename Pol::Rec;
  const int t = threadIdx.x;
  if (t == 0) {
    const size_t off = (size_t)b * P.M * P.N;
    x.wg = STEP ? P.xn + off : P.g + off;
    x.wp1f = (!STEP && P.px_in != nullptr) ? P.px_in + off : nullptr;
    x.wp2f = (!STEP && P.py_in != nullptr) ? P.py_in + off : nullptr;
    x.w1 = P.px_out != nullptr ? P.px_out + off : walk_duals(P);
    x.w2 = P.py_out != nullptr ? P.py_out + off : walk_duals(P) + (size_t)P.M * P.N;
  }
  __syncthreads();
  int* ctr = P.ws_int + W_SLOTS;
  float p1[R], p2[R];

  if (STEP) {
    x.warr[t] = arrivals;
    for (x.wtile[t] = blockIdx.x; fresh(x.wtile[t]) < P.T; x.wtile[t] = fresh(x.wtile[t]) + P.K) {
      step_prologue(x, place(P, fresh(x.wtile[t])), P, b, P.lam[b * P.lam_s]);
      if (t == 0) partials(P, 1, fresh(x.warr[t]) & 1)[fresh(x.wtile[t])] = block_part(x.wtv);
    }
    arrivals = fresh(x.warr[t]);
    slot_barrier(x, P, ctr, (arrivals + 1) * P.K, nullptr, nullptr);
    ++arrivals;
    const float tv = slot_total(x, partials(P, 1, (arrivals - 1) & 1), P.T);
    if (blockIdx.x == 0 && t == 0) P.tv[b] = tv;
  }

  // the loop's state lives in the exchange (`fresh`) while a tile sweeps;
  // the tile's place is worked out again after its sweep
  // a masked policy's stopped chain: its sweeps so far negated in wn
  x.wn[t] = 0;
  x.we[t] = Pol::kResidual ? INFINITY : 0.f;
  x.warr[t] = arrivals;
  for (x.wsw[t] = 0; fresh(x.wsw[t]) < P.max_iter; x.wsw[t] = fresh(x.wsw[t]) + 1) {
    for (x.wtile[t] = blockIdx.x; fresh(x.wtile[t]) < P.T; x.wtile[t] = fresh(x.wtile[t]) + P.K) {
      const int s = fresh(x.wsw[t]);
      {
        const Pos ps = place(P, fresh(x.wtile[t]));
        halo_table(x, ps, P, 0);
        load_glam<Pol::kBf16Dual>(x, ps, P, fresh(x.wg), P.lam[b * P.lam_s]);
        load_duals(ps, P, s == 0 ? fresh(x.wp1f) : fresh(x.w1),
                   s == 0 ? fresh(x.wp2f) : fresh(x.w2), p1, p2);
        publish_ends(x, ps, p1, p2);
        // the records of the previous sweep, the other parity
        gather<Rec>(x, ps, P, fresh(x.wp1f), fresh(x.wp2f),
                    s == 0 ? -1 : (fresh(x.warr[t]) & 1) ^ 1, nullptr, nullptr);
        // the tile's residual sum, for now (we holds the last residual
        // across a sweep that does not check)
        const bool keep = Pol::kMasked && fresh(x.wn[t]) < 0;
        const bool check = checks<Pol>(s) && !keep;
        const float acc = sweep<Pol>(x, place(P, fresh(x.wtile[t])), P, p1, p2, check, keep);
        if (check) x.we[t] = acc;
      }
      const int tile = fresh(x.wtile[t]), par = fresh(x.warr[t]) & 1;
      const Pos ps = place(P, tile);
      float* w1 = fresh(x.w1);
      float* w2 = fresh(x.w2);
      const int col = ps.tx0 + ps.c;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (bit(ps.m_valid, i)) {
          const size_t idx = (size_t)(ps.ty0 + ps.r0 + i) * P.N + col;
          w1[idx] = p1[i];
          w2[idx] = p2[i];
        }
      }
      publish_border(ps, records<Rec>(P, par) + (size_t)tile * BORDER, p1, p2);
      const bool check = checks<Pol>(fresh(x.wsw[t])) && !(Pol::kMasked && fresh(x.wn[t]) < 0);
      if (check) warp_part(fresh(x.we[t]), x.wpart, ps);
      __syncthreads();
      if (check && t == 0) partials(P, 0, par)[tile] = block_part(x.wpart);
    }
    const int par = fresh(x.warr[t]) & 1;
    slot_barrier(x, P, ctr, (fresh(x.warr[t]) + 1) * P.K, nullptr, nullptr);
    x.warr[t] = fresh(x.warr[t]) + 1;
    const bool keep = Pol::kMasked && fresh(x.wn[t]) < 0;
    const bool check = checks<Pol>(fresh(x.wsw[t])) && !keep;
    if (!keep) x.wn[t] = fresh(x.wsw[t]) + 1;
    if (check) x.we[t] = sqrt_rn_exact(slot_total(x, partials(P, 0, par), P.T));
    if (check && !(fresh(x.we[t]) > Pol::tol(P))) {
      if (!Pol::kMasked) break;
      x.wn[t] = -fresh(x.wn[t]);
    }
  }
  arrivals = fresh(x.warr[t]);
  const int n = Pol::kMasked ? abs(fresh(x.wn[t])) : fresh(x.wn[t]);
  const float e = fresh(x.we[t]);

  const size_t off = (size_t)b * P.M * P.N;
  for (int tile = blockIdx.x; tile < P.T; tile += P.K) {
    const Pos ps = place(P, tile);
    halo_table(x, ps, P, 0);
    load_duals(ps, P, n == 0 ? fresh(x.wp1f) : fresh(x.w1),
               n == 0 ? fresh(x.wp2f) : fresh(x.w2), p1, p2);
    publish_ends(x, ps, p1, p2);
    gather<Rec>(x, ps, P, fresh(x.wp1f), fresh(x.wp2f), n == 0 ? -1 : (arrivals - 1) & 1,
                nullptr, nullptr);
    assemble(x, ps, P, off, fresh(x.wg), P.lam[b * P.lam_s], p1, p2);
    __syncthreads();   // the exchange is rewritten by the next tile
  }
  if (blockIdx.x == 0 && t == 0) Pol::finish(P, b, n, e);
}

// The stacked form's chain k: its strip's duals out of st into (p1, p2) and
// its strip ends published, its halo and g/λ halo into the exchange's slots:
// the exchange as the one-chain form has it before a sweep or the assembly.
// Ends with a barrier.
__device__ __forceinline__ void stacked_exchange(Xch& x, Stack& st, const Pos& ps, int k,
                                                 float (&p1)[R], float (&p2)[R]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    p1[i] = st.p[k][0][i][t];
    p2[i] = st.p[k][1][i][t];
  }
  publish_ends(x, ps, p1, p2);
#pragma unroll
  for (int j = 0; j < HALO_PER; ++j) {
    const int e = t + j * BT;
    if (e < HALO) reinterpret_cast<float*>(&x)[x.hdst[j][t]] = st.halo[k][e];
  }
  if (t < TW) x.bot_gl[t] = st.glh[k][t];
  else if (t < GLH) x.rgt_gl[t - TW] = st.glh[k][t];
  __syncthreads();
}

// After a stacked barrier of parity q, for each chain k of the block in
// `live`: its halo from the border records into st.halo[k] (halos), and its
// totals of the T residual partials (resid) and TV partials (tv) into
// tot[k], each in gather's order; the loads of all chains issued together.
// Ends with a barrier.
template <class Rec>
__device__ __forceinline__ void gather_stacked(Xch& x, Stack& st, const Pos& ps,
                                               const ResidentParams& P, int q, uint32_t live,
                                               bool halos, bool resid, bool tv,
                                               float2 (&tot)[KMAX]) {
  const int t = threadIdx.x;
  const int cs = gridDim.x;   // from chain k of a block to chain k + 1
  const Rec* rec = records<Rec>(P, q);
  float hv[KMAX][HALO_PER];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
#pragma unroll
    for (int j = 0; j < HALO_PER; ++j) {
      const int r = x.hrec[j][t];
      hv[k][j] = (halos && bit(live, k) && r >= 0) ? rec_ld(rec + k * cs * BORDER + r) : 0.f;
    }
  }
  const int first = blockIdx.x - blockIdx.x % P.T;   // chain 0's first tile
  const float* rp = partials(P, 0, q) + first;
  const float* tp = partials(P, 1, q) + first;
  float a[KMAX], c[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) a[k] = c[k] = 0.f;
  for (int i0 = 0; i0 < P.T; i0 += BT) {
    const int i = i0 + t;
    float va[KMAX], vc[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const bool on = bit(live, k) && i < P.T;
      va[k] = (resid && on) ? __ldcg(rp + k * cs + i) : 0.f;
      vc[k] = (tv && on) ? __ldcg(tp + k * cs + i) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      a[k] = a[k] + va[k];
      c[k] = c[k] + vc[k];
    }
  }
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (!bit(live, k)) continue;
    for (int o = 16; o > 0; o >>= 1) {
      if (resid) a[k] += __shfl_down_sync(FULL, a[k], o);
      if (tv) c[k] += __shfl_down_sync(FULL, c[k], o);
    }
    if (ps.lane == 0) {
      st.wsum[k][0][ps.w] = a[k];
      st.wsum[k][1][ps.w] = c[k];
    }
#pragma unroll
    for (int j = 0; j < HALO_PER; ++j) {
      const int e = t + j * BT;
      if (halos && e < HALO) st.halo[k][e] = hv[k][j];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
    tot[k] = make_float2(block_part(st.wsum[k][0]), block_part(st.wsum[k][1]));
}

// Stacked form: the chains k = 0 .. stack−1 of the block's slot in the group
// from b0 (chain b0 + k·slots + slot, those below B) on its tile, each
// chain's duals in st between its sweeps.  A sweep round sweeps each running
// chain in turn, then one barrier carries the partials of them all (and, on
// the first, the step forms' TV partials; with no sweep, those alone), and
// one gather takes their halos and totals.  Each chain leaves on its own
// residual; a chain that has left takes no further sweep and keeps its
// duals, and the block sweeps while any of its chains runs.  Every chain's
// operations and sums are the resident form's (run_chain), in its order.
template <bool STEP, class Pol>
__device__ __forceinline__ void run_stack(Xch& x, Stack& st, const Pos& ps,
                                          const ResidentParams& P) {
  using Rec = typename Pol::Rec;
  static_assert(Pol::kResidual == 1 && Pol::kEvery == 1 && !Pol::kMasked,
                "the stacked form checks every sweep and leaves on it");
  const int t = threadIdx.x;
  __syncthreads();   // the last group's chains are read no more
  if (t == 0) {
    const int b0 = st.next;
    for (int k = 0; k < KMAX; ++k) {
      const int b = b0 + k * st.slots + st.slot;
      st.chain[k] = (k < P.stack && b < P.B) ? b : -1;
      st.n[k] = 0;
      st.e[k] = INFINITY;
    }
    st.arr0 = st.arr;
    st.next = b0 + P.C;
  }
  __syncthreads();

  // each chain's g/λ, duals and first halo into st, the last chain first:
  // chain 0's g/λ stays in x.gl
  uint32_t live = 0u;
  for (int k = KMAX - 1; k >= 0; --k) {
    const int b = fresh(st.chain[k]);
    if (b < 0) continue;
    live |= 1u << k;
    const size_t off = (size_t)b * P.M * P.N;
    const float lam = P.lam[b * P.lam_s];
    float p1[R], p2[R];
    if (STEP) {
      step_prologue(x, ps, P, b, lam);
#pragma unroll
      for (int i = 0; i < R; ++i) p1[i] = p2[i] = 0.f;
      if (t < NW) st.wtv[k][t] = x.wtv[t];
    } else {
      load_glam<Pol::kBf16Dual>(x, ps, P, P.g + off, lam);
      load_duals(ps, P, P.px_in != nullptr ? P.px_in + off : nullptr,
                 P.py_in != nullptr ? P.py_in + off : nullptr, p1, p2);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      st.p[k][0][i][t] = p1[i];
      st.p[k][1][i][t] = p2[i];
      if (k > 0) st.gl[k - 1][i][t] = x.gl[i][t];
    }
    if (t < TW) st.glh[k][t] = x.bot_gl[t];
    else if (t < GLH) st.glh[k][t] = x.rgt_gl[t - TW];
    // the first halo, from the call's first duals (null: zero)
#pragma unroll
    for (int j = 0; j < HALO_PER; ++j) {
      const int e = t + j * BT, r = x.hrec[j][t], hp = x.hpix[j][t];
      if (e < HALO) {
        const float* src = STEP ? nullptr : ((hp & 1) ? P.py_in : P.px_in);
        st.halo[k][e] = (r >= 0 && src != nullptr) ? src[off + (hp >> 1)] : 0.f;
      }
    }
    __syncthreads();   // the next chain's set-up rewrites the exchange
  }

  // the rounds, one a barrier since the group's first; the step forms with
  // no sweep take one for the TV's barrier
  const int rounds = (STEP && P.max_iter == 0) ? 1 : P.max_iter;
  while (live != 0u && fresh(st.arr) - fresh(st.arr0) < rounds) {
    if (fresh(st.arr) - fresh(st.arr0) < P.max_iter) {
      for (int k = 0; k < KMAX; ++k) {
        if (!bit(live, k)) continue;
        float p1[R], p2[R];
        stacked_exchange(x, st, ps, k, p1, p2);
        const float acc = sweep<Pol>(x, ps, P, p1, p2, true, false, k == 0 ? x.gl : st.gl[k - 1]);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          st.p[k][0][i][t] = p1[i];
          st.p[k][1][i][t] = p2[i];
        }
        const int i = k * gridDim.x + blockIdx.x;   // the chain's record and partial
        publish_border(ps, records<Rec>(P, fresh(st.arr) & 1) + i * BORDER, p1, p2);
        warp_part(acc, st.wpart[k], ps);
      }
    }
    // one barrier for the block's chains, carrying their partials; the
    // round's number n from 1 read again after the sweeps
    const int par = fresh(st.arr) & 1, n = fresh(st.arr) + 1 - fresh(st.arr0);
    const bool sweeps = n <= P.max_iter, first_tv = STEP && n == 1;
    __syncthreads();
    if (t == 0) {
      for (int k = 0; k < KMAX; ++k) {
        if (!bit(live, k)) continue;
        const int i = k * gridDim.x + blockIdx.x;
        if (sweeps) partials(P, 0, par)[i] = block_part(st.wpart[k]);
        if (first_tv) partials(P, 1, par)[i] = block_part(st.wtv[k]);
      }
      arrive_and_wait(P, P.ws_int + W_SLOTS + st.slot, (st.arr + 1) * P.K);
      ++st.arr;
    }
    __syncthreads();
    float2 tot[KMAX];
    gather_stacked<Rec>(x, st, ps, P, par, live, sweeps, sweeps, first_tv, tot);
    if (first_tv && t == 0 && blockIdx.x % P.T == 0) {
#pragma unroll
      for (int k = 0; k < KMAX; ++k)
        if (bit(live, k)) P.tv[st.chain[k]] = tot[k].y;
    }
    if (sweeps) {
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (!bit(live, k)) continue;
        const float e = sqrt_rn_exact(tot[k].x);
        if (t == 0) {
          st.n[k] = n;
          st.e[k] = e;
        }
        if (!(e > Pol::tol(P))) live &= ~(1u << k);
      }
    }
  }

  // the thread's place again, from the exchange: worked out from the
  // sweeps' ps, its rows would stay in registers across them
  const Pos pa = place(P, blockIdx.x - fresh(st.slot) * P.T);
  for (int k = 0; k < KMAX; ++k) {
    const int b = fresh(st.chain[k]);
    if (b < 0) continue;
    const size_t off = (size_t)b * P.M * P.N;
    float p1[R], p2[R];
    stacked_exchange(x, st, pa, k, p1, p2);
    assemble(x, pa, P, off, (STEP ? P.xn : P.g) + off, P.lam[b * P.lam_s], p1, p2);
    if (t == 0 && blockIdx.x % P.T == 0) Pol::finish(P, b, st.n[k], st.e[k]);
    __syncthreads();   // the exchange is rewritten by the next chain
  }
}

// The last block out resets the arrival counters of the call's `slots`
// chain slots and the exit counter for the next call.
__device__ __forceinline__ void leave(const ResidentParams& P, int slots) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(P.ws_int + W_EXIT, 1) == (int)gridDim.x - 1) {
      for (int s = 0; s < slots; ++s) P.ws_int[W_SLOTS + s] = 0;
      P.ws_int[W_EXIT] = 0;
      __threadfence();
    }
  }
}

template <bool STEP, bool WALK, class Pol = SweepPolicy, class X>
__device__ __forceinline__ void resident_body(X& x, const ResidentParams& P) {
  int arrivals = 0;
  if constexpr (WALK) {
    for (int b = 0; b < P.B; ++b) run_chain_walk<STEP, Pol>(x, P, b, arrivals);
  } else {
    const int slot = blockIdx.x / P.T, tile = blockIdx.x % P.T;
    const Pos ps = place(P, tile);
    halo_table(x, ps, P, slot * P.T);
    for (int b0 = 0; b0 < P.B; b0 += P.C) {
      const int b = b0 + slot;
      if (b < P.B) run_chain<STEP, Pol>(x, ps, P, b, slot, tile, arrivals);
    }
  }
  leave(P, P.C);
}

// The stacked form's launch: groups of C chains, C/stack slots of T blocks,
// block i (slot i / T) sweeping tile i mod T of its slot's `stack` chains.
template <bool STEP, class Pol = SweepPolicy>
__device__ __forceinline__ void stacked_body(Xch& x, Stack& st, const ResidentParams& P) {
  const int slot = blockIdx.x / P.T;
  const Pos ps = place(P, blockIdx.x % P.T);
  halo_table(x, ps, P, slot * P.T);
  if (threadIdx.x == 0) {
    st.slot = slot;
    st.slots = P.C / P.stack;
    st.arr = 0;
    st.next = 0;
  }
  __syncthreads();
  while (fresh(st.next) + fresh(st.slot) < P.B) run_stack<STEP, Pol>(x, st, ps, P);
  leave(P, P.C / P.stack);
}

// Checks the geometry (chains a group, grid, stack) against the image and
// launches the call cooperatively: the resident form when the grid is C·T
// (stack 1), the stacked form when it is C/stack slots of T blocks with
// stack > 1 (`stacked`, with sizeof(Stack) bytes of dynamic shared memory,
// which the caller has allowed), the walk form when it is one chain's K < T
// blocks.  A launch that CUDA refuses returns its error; nothing falls back.
inline cudaError_t launch_resident(const void* resident, const void* walk, ResidentParams& P,
                                   int grid, cudaStream_t st, const void* stacked = nullptr) {
  if (P.B < 1 || P.M < 2 || P.N < 2 || P.max_iter < 0) return cudaErrorInvalidValue;
  P.TX = (P.N + TW - 1) / TW;
  P.T = P.TX * ((P.M + TH - 1) / TH);
  const bool is_walk = P.C == 1 && grid >= 1 && grid < P.T;
  if (P.stack < 1 || P.stack > (stacked != nullptr ? KMAX : 1) || P.C % P.stack != 0)
    return cudaErrorInvalidValue;
  const int slots = P.C / P.stack;
  if (slots < 1 || slots > P.B || (!is_walk && grid != slots * P.T)) return cudaErrorInvalidValue;
  P.K = is_walk ? grid : P.T;
  P.S = P.C * P.T;
  const bool stacks = P.stack > 1;
  void* args[] = {&P};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      is_walk ? walk : (stacks ? stacked : resident), dim3(grid), dim3(BT), args,
      stacks ? sizeof(Stack) : 0, st);
  if (e != cudaSuccess) cudaGetLastError();   // a refused launch leaves no error behind
  return e;
}

// The occupancy of kernels fns[0..n) with `dyn` bytes of dynamic shared
// memory: out = {active blocks per SM (the smallest), registers a thread
// (the largest), local (spill) bytes a thread (the largest)}.
inline cudaError_t occupancy_of(const void* const* fns, int n, int* out, size_t dyn = 0) {
  int blocks = 1 << 30, regs = 0, local = 0;
  for (int k = 0; k < n; ++k) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, fns[k]);
    if (e != cudaSuccess) return e;
    int nb = 0;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, fns[k], BT, dyn)) != cudaSuccess)
      return e;
    blocks = nb < blocks ? nb : blocks;
    regs = a.numRegs > regs ? a.numRegs : regs;
    local = (int)a.localSizeBytes > local ? (int)a.localSizeBytes : local;
  }
  out[0] = blocks;
  out[1] = regs;
  out[2] = local;
  return cudaSuccess;
}

}  // namespace
