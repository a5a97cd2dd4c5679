// Chambolle TV-prox and fused MYULA-step kernels for Hopper (sm_90a): one
// persistent launch a call, designed for images up to 512².
//
// Replaces the Pallas TPU kernels
//   semiblind_tv_tpu/ops/tv_pallas.py::chambolle_prox_pallas
//       (pallas_call :262 with _kernel: warm duals in and out, A1; :232 with
//       _kernel_fresh: zero duals, f only, A2)
//   semiblind_tv_tpu/ops/fused_step_pallas.py::myula_prox_tv (:375, _kernel,
//       B)
//   semiblind_tv_tpu/ops/fused_step_pallas.py::myula_prox_tv_rng (:166,
//       _kernel_rng, C: the same step with the noise drawn in the kernel)
// and the step in the middle of the DFT steps of dft_kernels.cu (D, E),
// which divides the gradient by σ².  The TPU kernels keep the whole image
// and both dual fields in VMEM for all sweeps.  A 512² f32 field is 1 MB and
// one SM has 227 KB of shared memory, so here the image is cut into tiles
// and the tiles of a chain run on as many SMs at once.
//
// What bounds it.  A sweep is about 26 float operations a pixel, two of
// them divides and one a square root; at 512² B=16 that is 109 MFLOP, 1.6 µs
// at the card's float32 peak, and nothing of it needs device memory, since
// the duals can stay on the chip from the first sweep to the last.  What
// costs is what ties the tiles of a chain together: each sweep needs the
// neighbours' duals across a tile's edge and the chain's residual before
// the next one may start.  The design:
//  1. One launch a call.  One kernel runs the whole call (resident_prox,
//     resident_step and their walk forms, below): A1/A2 from
//     g (and warm duals), the step forms from x, prox, grad and z (or the
//     seeds) through the MYULA update and the circular TV of xn, then the
//     sweeps, the early exit and f = g − λ·div p (proxn), with no memset,
//     copy or reduce launch around it.  It is launched cooperatively
//     (cudaLaunchCooperativeKernel), so that every block of the grid is
//     resident at once, which the barriers below need.
//  2. The duals in registers, in tv_blocked.cu's strip layout: warp (wx,
//     wy) of a 2 (across) x 4 (down) block, lane l owns column 32·wx + l of
//     the tile and the R = 8 rows from 8·wy, and keeps p1 and p2 of its
//     strip in registers (g/λ in shared memory) for the whole call.
//     Vertical neighbours are the thread's own registers, horizontal ones
//     come by __shfl_up_sync / __shfl_down_sync; a strip's end rows and a
//     warp's edge columns go through shared memory (Xch).  A tile is 32 x
//     64, so a 512² chain is 128 tiles and spreads over 128 SMs at B=1;
//     256 threads, at most 128 registers (__launch_bounds__(256, 2)): two
//     blocks an SM.  The same tile as 2 x 2 warps of 16-row strips (four
//     blocks of 128 threads an SM) spilled, at 128 registers and at 168,
//     and a 16 x 64 tile of 128 threads was slower at B=16; this one
//     spills nothing.
//  3. Tiles exchange only their borders.  A sweep at (i, j) reads p1 of the
//     row above, p1 and p2 of the row below (through u below), p2 of the
//     column to the left, p1 and p2 of the column to the right (through u to
//     the right), and p2 below-left and p1 above-right for those u.  After
//     each sweep a block writes its tile's first row (p1, p2), last row
//     (p1), first column (p1, p2) and last column (p2) to a border record in
//     device memory, and before the next it reads its neighbours' records
//     and computes the u of the row below and the column to the right of
//     its tile itself.  The records are double-buffered by the parity of
//     the chain's barrier count.  g/λ's border is read once a call.  No halo
//     is swept twice.
//  4. A per-chain barrier that carries the residual and the exit.  After
//     sweep s each block writes its tile's residual partial (thread strip
//     sums in row order, a shuffle tree down each warp, the warps in order)
//     to a slot of the barrier's parity and its border, then __threadfence
//     and an integer atomicAdd on its chain slot's arrival counter, which
//     never goes back within a launch; it spins on an acquire load until
//     the counter reaches (barriers so far) x (tiles a chain).  Then every
//     block sums the chain's partials in one fixed order (thread t the
//     tiles t, t + 256, ... in order, a shuffle tree down each warp, the
//     warps in order), loaded together with the neighbours' borders for the
//     next sweep, so every block finds the same residual and takes the same
//     exit: the
//     sweep whose pre-update residual is <= tol still applies its update,
//     and the next does not run (tv_pallas.dual_ascent_loop).  The TV
//     partials of the step forms ride on the first barrier.  Border and
//     partial data are read with ld.global.cg (L2), never through the
//     non-coherent read-only path.  A spin gives up after 2^25 polls: it
//     writes an error code to the workspace and traps, so the launch fails
//     and the caller's next synchronisation raises.  The last block to leave
//     resets the counters, so the next call on the stream finds them zero
//     without a memset.
//  5. Co-residency by construction.  The grid is (chains a group) x (tiles
//     a chain), at most the resident blocks of the card
//     (sb_resident_occupancy), and the Python side
//     (ops/tv_cuda.py::resident_geometry) picks it; block k handles tile
//     k mod T of chain g·C + k / T in group g = 0, 1, ..., so a chain slot's
//     blocks are the same in every group.  A launch that CUDA refuses
//     returns its error; nothing falls back.
//     The walk form takes a chain whose tiles are more than the card holds
//     at once (above about 512 x 1056 at 264 blocks): one chain at a time,
//     K blocks, block k sweeping tiles k, k + K, ... in turn each sweep,
//     with the duals in device memory between sweeps (px_out/py_out or the
//     workspace) instead of registers, g/λ read again each sweep, and one
//     barrier of its own for the step forms' TV.  Partials and border
//     records are kept a tile, so the sums and the fields are those of the
//     resident form.
//  6. No per-pixel edge branches: which of a thread's rows is the image's
//     last or inside the image is a bit mask worked out once a call, and the
//     stencil is straight-line code with selects.  The divides take
//     div_rn_fast when a warp's every quotient is in its exact range
//     (fast_div_ok, tested before the warp divides; otherwise the warp
//     takes div_rn_exact one pixel at a time through shared memory), the
//     roots sqrt_rn_exact: bit-equal to IEEE.  No '/' or sqrtf is left in
//     the kernel: their slow paths are called subroutines, and a call makes
//     ptxas spill the registers live across it.
// Built with --fmad=false: at a fixed sweep count the fields equal the
// plain PyTorch versions' to the bit.
//
// The C interface takes raw pointers and a cudaStream_t and returns the
// first CUDA error (cudaSuccess == 0).  Outputs and the workspace are
// allocated by the caller; nothing here allocates or synchronises.

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
// counter per chain slot.  Workspace floats: border records [2][S], then
// residual partials [2][S], then TV partials [2][S], then (walk form) the
// duals p1 and p2 of one chain, M·N floats each.
enum { W_ERROR, W_EXIT, W_SLOTS };

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
  // the walk form's chain: g (or xn), the first duals (null: zero) and the
  // duals between sweeps, read back through `fresh` at each use
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
    const float xv = x[q];
    const float v = xv + div_rn_exact(gamma * (prox[q] - xv), lam) -
                    gamma * div_rn_exact(grad[q], sigma2) + s2g * noise(q);
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

// The border records of parity par, one a tile of a group's chains.
__device__ __forceinline__ float* records(const ResidentParams& P, int par) {
  return P.ws_f + (size_t)par * P.S * BORDER;
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
__device__ __forceinline__ void publish_border(const Pos& ps, float* rec, const float (&p1)[R],
                                               const float (&p2)[R]) {
  if (ps.wy == 0) {
    rec[B_R0P1 + ps.c] = p1[0];
    rec[B_R0P2 + ps.c] = p2[0];
  }
  if (ps.wy == WY - 1) rec[B_RLP1 + ps.c] = p1[R - 1];
  if (ps.wx == 0 && ps.lane == 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      rec[B_C0P1 + ps.r0 + i] = p1[i];
      rec[B_C0P2 + ps.r0 + i] = p2[i];
    }
  }
  if (ps.wx == WX - 1 && ps.lane == 31) {
#pragma unroll
    for (int i = 0; i < R; ++i) rec[B_CLP2 + ps.r0 + i] = p2[i];
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
__device__ __forceinline__ void slot_barrier(Xch& x, const ResidentParams& P, int* ctr,
                                             int target, float* part_slot, float* tv_slot) {
  __syncthreads();
  if (threadIdx.x == 0) {
    if (part_slot != nullptr) *part_slot = block_part(x.wpart);
    if (tv_slot != nullptr) *tv_slot = block_part(x.wtv);
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
// Ends with a barrier.
__device__ __forceinline__ float2 gather(Xch& x, const Pos& ps, const ResidentParams& P,
                                         const float* p1f, const float* p2f, int q,
                                         const float* part, const float* tvp) {
  const int t = threadIdx.x;
  const float* rec = records(P, q < 0 ? 0 : q);
  float hv[HALO_PER];
#pragma unroll
  for (int j = 0; j < HALO_PER; ++j) {
    const int r = x.hrec[j][t], hp = x.hpix[j][t];
    float v = 0.f;
    if (r >= 0) {
      if (q >= 0) {
        v = __ldcg(rec + r);
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

// One sweep on the strip: u = div p − g/λ (and the halo u below and to the
// right by threads 0 .. TW+TH−1), then the update; returns the thread's
// residual sum over its valid pixels.  The neighbours' duals are in the
// exchange (gather); the strip ends of p are published again at the end.
__device__ __forceinline__ float sweep(Xch& x, const Pos& ps, const ResidentParams& P, float (&p1)[R],
                                       float (&p2)[R]) {
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
      const float a = bit(ps.m_last, i) ? -p1[i] : p1[i] - above;
      const float b = ps.c_last ? -p2[i] : p2[i] - left;
      u[i] = (a + b) - x.gl[i][threadIdx.x];
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
    if (row < P.M && col < P.N) {
      const float a = row == P.M - 1 ? -x.bot_p1[t] : x.bot_p1[t] - x.xrow[WY][t];
      const float b = col == P.N - 1 ? -x.bot_p2[t + 1] : x.bot_p2[t + 1] - x.bot_p2[t];
      v = (a + b) - x.bot_gl[t];
    }
    x.urow[WY][t] = v;
  } else if (t < TW + TH) {
    const int r = t - TW, row = ps.ty0 + r, col = ps.tx0 + TW;
    float v = 0.f;
    if (row < P.M && col < P.N) {
      const float a = row == P.M - 1 ? -x.rgt_p1[r + 1] : x.rgt_p1[r + 1] - x.rgt_p1[r];
      const float b = col == P.N - 1 ? -x.rgt_p2[r] : x.rgt_p2[r] - x.yedge[WX][r];
      v = (a + b) - x.rgt_gl[r];
    }
    x.uedge[WX][r] = v;
  }
  __syncthreads();
  // the residual and the update, a row at a time: the row's numerators and
  // denominator go to shared memory and its quotients are taken at once by
  // div_rn_fast, so that u[i] is dead after row i; a warp with an operand
  // outside that quotient's range takes them all again by div_rn_exact
  const float below_last = x.urow[ps.wy + 1][ps.c];
  const float tau = P.tau;
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
      const float upx = bit(ps.m_last, i) ? 0.f : below - u[i];
      const float upy = ps.c_last ? 0.f : right - u[i];
      const float tmp = sqrt_rn_exact(upx * upx + upy * upy);
      const float rx = -upx + tmp * p1[i];
      const float ry = -upy + tmp * p2[i];
      const bool valid = bit(ps.m_valid, i);
      acc = acc + (valid ? rx * rx + ry * ry : 0.f);
      const float denom = 1.0f + tau * tmp;
      const float a1 = p1[i] + tau * upx;
      const float a2 = p2[i] + tau * upy;
      ok = ok & (!valid | (fast_div_ok(a1, denom) & fast_div_ok(a2, denom)));
      x.ex[0][i][t] = a1;
      x.ex[1][i][t] = a2;
      x.ex[2][i][t] = denom;
      // a zero numerator keeps its sign, as under '/' (denom ≥ 1)
      p1[i] = a1 == 0.f ? a1 : div_rn_fast(a1, denom);
      p2[i] = a2 == 0.f ? a2 : div_rn_fast(a2, denom);
    }
  }
  if (!__all_sync(FULL, ok)) {
    // one pixel at a time, so that the exact quotient costs the sweep no
    // registers
#pragma unroll 1
    for (int i = 0; i < R; ++i) {
      const float d = x.ex[2][i][t];
      x.ex[0][i][t] = div_rn_exact(x.ex[0][i][t], d);
      x.ex[1][i][t] = div_rn_exact(x.ex[1][i][t], d);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      p1[i] = x.ex[0][i][t];
      p2[i] = x.ex[1][i][t];
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
// barrier is needed.  The strip loops are not unrolled: the update and its
// noise are long, and the sweeps need the registers.
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
#pragma unroll 1
  for (int i = 0; i < R; ++i) {
    const int row = ps.ty0 + ps.r0 + i;
    float v = 0.f;
    if (bit(ps.m_valid, i)) {
      v = in.at(row, col);
      P.xn[off + (size_t)row * P.N + col] = v;
    }
    x.gl[i][t] = v;
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
// the step forms' xn is written earlier in the launch.
__device__ __forceinline__ void load_glam(Xch& x, const Pos& ps, const ResidentParams& P,
                                          const float* gsrc, float lam) {
  const int t = threadIdx.x, col = ps.tx0 + ps.c;
#pragma unroll 1
  for (int i = 0; i < R; ++i) {
    const size_t idx = (size_t)(ps.ty0 + ps.r0 + i) * P.N + col;
    x.gl[i][t] = bit(ps.m_valid, i) ? div_rn_exact(__ldcg(gsrc + idx), lam) : 0.f;
  }
  if (t < TW) {
    const int row = ps.ty0 + TH, cl = ps.tx0 + t;
    x.bot_gl[t] =
        (row < P.M && cl < P.N) ? div_rn_exact(__ldcg(gsrc + (size_t)row * P.N + cl), lam) : 0.f;
  } else if (t < TW + TH) {
    const int row = ps.ty0 + t - TW, cl = ps.tx0 + TW;
    x.rgt_gl[t - TW] =
        (row < P.M && cl < P.N) ? div_rn_exact(__ldcg(gsrc + (size_t)row * P.N + cl), lam) : 0.f;
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
// (gather).
__device__ __forceinline__ void assemble(Xch& x, const Pos& ps, const ResidentParams& P,
                                         size_t off, const float* gsrc, float lam,
                                         const float (&p1)[R], const float (&p2)[R]) {
  const int col = ps.tx0 + ps.c;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float above = i == 0 ? x.xrow[ps.wy][ps.c] : p1[i > 0 ? i - 1 : 0];
    const float sh = __shfl_up_sync(FULL, p2[i], 1);
    const float left = ps.lane == 0 ? x.yedge[ps.wx][ps.r0 + i] : sh;
    if (bit(ps.m_valid, i)) {
      const float a = bit(ps.m_last, i) ? -p1[i] : p1[i] - above;
      const float bb = ps.c_last ? -p2[i] : p2[i] - left;
      const size_t pix = (size_t)(ps.ty0 + ps.r0 + i) * P.N + col;
      P.f[off + pix] = __ldcg(gsrc + pix) - lam * (a + bb);
      if (P.px_out != nullptr) {
        P.px_out[off + pix] = p1[i];
        P.py_out[off + pix] = p2[i];
      }
    }
  }
}

// Resident form: one chain of the call on this block's tile, the duals in
// registers.  `arrivals` counts the slot's barriers so far.
template <bool STEP>
__device__ __forceinline__ void run_chain(Xch& x, const Pos& ps, const ResidentParams& P, int b,
                                          int slot, int tile, int& arrivals) {
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
    load_glam(x, ps, P, gsrc, lam);
    load_duals(ps, P, p1f, p2f, p1, p2);
  }
  publish_ends(x, ps, p1, p2);
  gather(x, ps, P, p1f, p2f, -1, nullptr, nullptr);

  int n = 0;
  float e = INFINITY;
  for (int s = 0; s < P.max_iter; ++s) {
    const float acc = sweep(x, ps, P, p1, p2);
    const int par = arrivals & 1;
    publish_border(ps, records(P, par) + (size_t)blockIdx.x * BORDER, p1, p2);
    warp_part(acc, x.wpart, ps);
    float* part = partials(P, 0, par);
    float* tv_slot = STEP && s == 0 ? partials(P, 1, par) : nullptr;
    slot_barrier(x, P, ctr, (arrivals + 1) * P.K, part + blockIdx.x,
                 tv_slot != nullptr ? tv_slot + blockIdx.x : nullptr);
    ++arrivals;
    // the next sweep's (or the assembly's) halo and the chain's sums, at once
    const float2 tot = gather(x, ps, P, p1f, p2f, par, part + base,
                              tv_slot != nullptr ? tv_slot + base : nullptr);
    if (tv_slot != nullptr && tile == 0 && threadIdx.x == 0) P.tv[b] = tot.y;
    n = s + 1;
    e = sqrt_rn_exact(tot.x);
    if (!(e > P.tol)) break;
  }
  if (STEP && P.max_iter == 0) {   // the TV's barrier alone
    float* tv_slot = partials(P, 1, arrivals & 1);
    slot_barrier(x, P, ctr, (arrivals + 1) * P.K, nullptr, tv_slot + blockIdx.x);
    ++arrivals;
    const float tv = slot_total(x, tv_slot + base, P.T);
    if (tile == 0 && threadIdx.x == 0) P.tv[b] = tv;
  }

  assemble(x, ps, P, off, gsrc, lam, p1, p2);
  if (tile == 0 && threadIdx.x == 0) {
    P.iters[b] = n;
    P.err[b] = e;
  }
  __syncthreads();   // the exchange is rewritten by the next chain
}

// Walk form: one chain of the call on the K blocks of the grid, block k
// sweeping tiles k, k + K, ... in turn, the duals in device memory between
// sweeps.  The step forms' TV takes a barrier of its own before the first
// sweep, which then reads the neighbours' xn.  The chain's pointers live in
// the exchange (`fresh`): with them in registers the sweep spilled.
template <bool STEP>
__device__ __forceinline__ void run_chain_walk(Xch& x, const ResidentParams& P, int b,
                                               int& arrivals) {
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
  x.wn[t] = 0;
  x.we[t] = INFINITY;
  x.warr[t] = arrivals;
  for (x.wsw[t] = 0; fresh(x.wsw[t]) < P.max_iter; x.wsw[t] = fresh(x.wsw[t]) + 1) {
    for (x.wtile[t] = blockIdx.x; fresh(x.wtile[t]) < P.T; x.wtile[t] = fresh(x.wtile[t]) + P.K) {
      const int s = fresh(x.wsw[t]);
      {
        const Pos ps = place(P, fresh(x.wtile[t]));
        halo_table(x, ps, P, 0);
        load_glam(x, ps, P, fresh(x.wg), P.lam[b * P.lam_s]);
        load_duals(ps, P, s == 0 ? fresh(x.wp1f) : fresh(x.w1),
                   s == 0 ? fresh(x.wp2f) : fresh(x.w2), p1, p2);
        publish_ends(x, ps, p1, p2);
        // the records of the previous sweep, the other parity
        gather(x, ps, P, fresh(x.wp1f), fresh(x.wp2f), s == 0 ? -1 : (fresh(x.warr[t]) & 1) ^ 1,
               nullptr, nullptr);
        x.we[t] = sweep(x, place(P, fresh(x.wtile[t])), P, p1, p2);   // the residual sum, for now
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
      publish_border(ps, records(P, par) + (size_t)tile * BORDER, p1, p2);
      warp_part(fresh(x.we[t]), x.wpart, ps);
      __syncthreads();
      if (t == 0) partials(P, 0, par)[tile] = block_part(x.wpart);
    }
    const int par = fresh(x.warr[t]) & 1;
    slot_barrier(x, P, ctr, (fresh(x.warr[t]) + 1) * P.K, nullptr, nullptr);
    x.warr[t] = fresh(x.warr[t]) + 1;
    x.wn[t] = fresh(x.wsw[t]) + 1;
    x.we[t] = sqrt_rn_exact(slot_total(x, partials(P, 0, par), P.T));
    if (!(fresh(x.we[t]) > P.tol)) break;
  }
  arrivals = fresh(x.warr[t]);
  const int n = fresh(x.wn[t]);
  const float e = fresh(x.we[t]);

  const size_t off = (size_t)b * P.M * P.N;
  for (int tile = blockIdx.x; tile < P.T; tile += P.K) {
    const Pos ps = place(P, tile);
    halo_table(x, ps, P, 0);
    load_duals(ps, P, n == 0 ? fresh(x.wp1f) : fresh(x.w1),
               n == 0 ? fresh(x.wp2f) : fresh(x.w2), p1, p2);
    publish_ends(x, ps, p1, p2);
    gather(x, ps, P, fresh(x.wp1f), fresh(x.wp2f), n == 0 ? -1 : (arrivals - 1) & 1, nullptr,
           nullptr);
    assemble(x, ps, P, off, fresh(x.wg), P.lam[b * P.lam_s], p1, p2);
    __syncthreads();   // the exchange is rewritten by the next tile
  }
  if (blockIdx.x == 0 && t == 0) {
    P.iters[b] = n;
    P.err[b] = e;
  }
}

template <bool STEP, bool WALK>
__device__ __forceinline__ void resident_body(Xch& x, const ResidentParams& P) {
  int arrivals = 0;
  if (WALK) {
    for (int b = 0; b < P.B; ++b) run_chain_walk<STEP>(x, P, b, arrivals);
  } else {
    const int slot = blockIdx.x / P.T, tile = blockIdx.x % P.T;
    const Pos ps = place(P, tile);
    halo_table(x, ps, P, slot * P.T);
    for (int b0 = 0; b0 < P.B; b0 += P.C) {
      const int b = b0 + slot;
      if (b < P.B) run_chain<STEP>(x, ps, P, b, slot, tile, arrivals);
    }
  }
  // the last block out resets the arrival and exit counters for the next call
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(P.ws_int + W_EXIT, 1) == (int)gridDim.x - 1) {
      for (int s = 0; s < P.C; ++s) P.ws_int[W_SLOTS + s] = 0;
      P.ws_int[W_EXIT] = 0;
      __threadfence();
    }
  }
}

}  // namespace

// The four forms, with C names so that ptxas's report and the profiler name
// them plainly: the prox (A1/A2) and the step (B, C, the σ² step of D/E),
// each resident or walking.
extern "C" {
__global__ void __launch_bounds__(BT, MIN_BLOCKS) resident_prox(const __grid_constant__ ResidentParams P) {
  __shared__ Xch x;
  resident_body<false, false>(x, P);
}
__global__ void __launch_bounds__(BT, MIN_BLOCKS) resident_step(const __grid_constant__ ResidentParams P) {
  __shared__ Xch x;
  resident_body<true, false>(x, P);
}
__global__ void __launch_bounds__(BT, MIN_BLOCKS)
    resident_prox_walk(const __grid_constant__ ResidentParams P) {
  __shared__ Xch x;
  resident_body<false, true>(x, P);
}
__global__ void __launch_bounds__(BT, MIN_BLOCKS)
    resident_step_walk(const __grid_constant__ ResidentParams P) {
  __shared__ Xch x;
  resident_body<true, true>(x, P);
}
}  // extern "C"

namespace {

const void* const FORMS[4] = {(const void*)resident_prox, (const void*)resident_step,
                              (const void*)resident_prox_walk, (const void*)resident_step_walk};

// Checks the geometry (chains a group, grid) against the image and
// launches the call cooperatively: the resident form when the grid is C·T,
// the walk form when it is one chain's K < T blocks.
template <bool STEP>
cudaError_t launch(ResidentParams& P, int grid, cudaStream_t st) {
  if (P.B < 1 || P.M < 2 || P.N < 2 || P.max_iter < 0) return cudaErrorInvalidValue;
  P.TX = (P.N + TW - 1) / TW;
  P.T = P.TX * ((P.M + TH - 1) / TH);
  const bool walk = P.C == 1 && grid >= 1 && grid < P.T;
  if (P.C < 1 || P.C > P.B || (!walk && grid != P.C * P.T)) return cudaErrorInvalidValue;
  P.K = walk ? grid : P.T;
  P.S = P.C * P.T;
  void* args[] = {&P};
  const cudaError_t e = cudaLaunchCooperativeKernel(FORMS[(walk ? 2 : 0) + (STEP ? 1 : 0)],
                                                    dim3(grid), dim3(BT), args, 0, st);
  if (e != cudaSuccess) cudaGetLastError();   // a refused launch leaves no error behind
  return e;
}

// The kernel's exact quotient and root elementwise: q = div_rn_exact(a, b),
// r = sqrt_rn_exact(a) (chip_smoke.py and the card tests hold them to '/'
// and sqrtf).
__global__ void exact_ops(const float* __restrict__ a, const float* __restrict__ b,
                          float* __restrict__ q, float* __restrict__ r, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) {
    if (q != nullptr) q[i] = div_rn_exact(a[i], b[i]);
    r[i] = sqrt_rn_exact(a[i]);
  }
}

}  // namespace

extern "C" {

// Number of 32x8 tiles of an (M, N) image (the partial sums of the
// one-thread-per-pixel kernels of tv_blocked.cu and prox_variants.cu).
int sb_num_tiles(int M, int N) { return ((N + TX - 1) / TX) * ((M + TY - 1) / TY); }

// Kernel A: the warm form (A1) when px_in/py_in are given, the fresh form
// (A2) when they are null; px_out/py_out may be null.  iters (int32) and err
// (B,) get each chain's sweeps and last residual.  ws_int: 2 + chains ints
// and ws_f: 2·S·(BORDER + 2) floats of workspace with S = chains × tiles a
// chain, and 2·M·N more for the walk form; the ints zero before the first
// call (the kernel leaves them zero).  chains: chains a group; grid: chains
// × tiles a chain (resident form), or fewer blocks than one chain's tiles
// with chains = 1 (walk form) (ops/tv_cuda.py::resident_geometry).
// strides: bit 0 set, lam is a (B,) vector, one λ a chain; clear, one value.
int sb_chambolle_prox(const float* g, const float* lam, const float* px_in, const float* py_in,
                      float* f, float* px_out, float* py_out, int* iters, float* err,
                      int* ws_int, float* ws_f, int B, int M, int N, int chains, int grid,
                      int max_iter, float tau, float tol, int strides, void* stream) {
  ResidentParams P{};
  P.g = g;
  P.lam = lam;
  P.lam_s = strides & 1;
  P.px_in = px_in;
  P.py_in = py_in;
  P.f = f;
  P.px_out = px_out;
  P.py_out = py_out;
  P.iters = iters;
  P.err = err;
  P.ws_int = ws_int;
  P.ws_f = ws_f;
  P.B = B;
  P.M = M;
  P.N = N;
  P.C = chains;
  P.max_iter = max_iter;
  P.tau = tau;
  P.tol = tol;
  if ((px_in == nullptr) != (py_in == nullptr) || (px_out == nullptr) != (py_out == nullptr))
    return cudaErrorInvalidValue;
  return launch<false>(P, grid, static_cast<cudaStream_t>(stream));
}

// Kernels B and C (and the σ² step of D and E): xn = [abs](x + γ(prox−x)/λ −
// γ·(grad/σ²) + √(2γ)·Z) with Z = z, or, z null, drawn from seeds ((B, 2)
// int32); tv = its circular TV; proxn = xn − λθ·div p after n_sweeps fresh
// sweeps on xn/(λθ).  sigma2 may be null (σ² = 1).  strides: bits 0–3 set
// make gamma, lam, lam_theta and sigma2 (B,) vectors, one value a chain.
// Workspace and geometry as sb_chambolle_prox.
int sb_myula_step(const float* x, const float* prox, const float* grad, const float* z,
                  const int* seeds, const float* gamma, const float* lam,
                  const float* lam_theta, const float* sigma2, float* xn, float* proxn,
                  float* tv, int* iters, float* err, int* ws_int, float* ws_f, int B, int M,
                  int N, int chains, int grid, int n_sweeps, float tau, float tol,
                  int positivity, int strides, void* stream) {
  if ((z == nullptr) == (seeds == nullptr)) return cudaErrorInvalidValue;
  ResidentParams P{};
  P.lam = lam_theta;
  P.f = proxn;
  P.x = x;
  P.prox = prox;
  P.grad = grad;
  P.z = z;
  P.seeds = seeds;
  P.gamma = gamma;
  P.lam_step = lam;
  P.sigma2 = sigma2;
  P.gamma_s = strides & 1;
  P.lam_step_s = (strides >> 1) & 1;
  P.lam_s = (strides >> 2) & 1;
  P.sigma2_s = (strides >> 3) & 1;
  P.xn = xn;
  P.tv = tv;
  P.iters = iters;
  P.err = err;
  P.ws_int = ws_int;
  P.ws_f = ws_f;
  P.B = B;
  P.M = M;
  P.N = N;
  P.C = chains;
  P.max_iter = n_sweeps;
  P.positivity = positivity;
  P.tau = tau;
  P.tol = tol;
  return launch<true>(P, grid, static_cast<cudaStream_t>(stream));
}

// The resident kernel's occupancy on the current device: out = {active
// blocks per SM (the smallest of the four forms), registers a thread (the
// largest), local (spill) bytes a thread (the largest), threads a block,
// the blocks per SM of __launch_bounds__, SMs of the device, tile rows,
// tile columns, floats of a border record}.
int sb_resident_occupancy(int* out) {
  int blocks = 1 << 30, regs = 0, local = 0;
  for (const void* fn : FORMS) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, fn);
    if (e != cudaSuccess) return e;
    int n = 0;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, BT, 0)) != cudaSuccess)
      return e;
    blocks = n < blocks ? n : blocks;
    regs = a.numRegs > regs ? a.numRegs : regs;
    local = (int)a.localSizeBytes > local ? (int)a.localSizeBytes : local;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  out[0] = blocks;
  out[1] = regs;
  out[2] = local;
  out[3] = BT;
  out[4] = MIN_BLOCKS;
  out[5] = sms;
  out[6] = TH;
  out[7] = TW;
  out[8] = BORDER;
  return cudaSuccess;
}

// exact_ops on n elements; b and q may be null (roots only).
int sb_resident_exact_ops(const float* a, const float* b, float* q, float* r, long long n,
                          void* stream) {
  if ((b == nullptr) != (q == nullptr)) return cudaErrorInvalidValue;
  if (n > 0)
    exact_ops<<<(unsigned)((n + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
        a, b, q, r, n);
  return cudaGetLastError();
}

}  // extern "C"
