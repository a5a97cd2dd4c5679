// Kernel J for Hopper (sm_90a): eleven forms of the fresh-dual Chambolle
// prox f = g − λ·div p, each changing one class of operation, to show where
// a sweep's time goes.
//
// Replaces the Pallas TPU kernel of the JAX package's
//   benchmarks/probe_prox_variants.py:362 (build's pallas_call; make_kernel
//   :42)
// which runs each variant with the image and both duals resident in VMEM.
// Here every mode runs on the resident design of kernels A1/A2/B/C
// (resident.cuh, whose reasons tv_kernels.cu's header gives): one
// cooperative launch a call; 32 x 64 tiles of 256 threads with the p1/p2
// strips in registers for the whole call; border records exchanged through
// L2; a per-chain arrival barrier that carries the residual partials in a
// fixed order, so every block takes the same exit; resident_geometry's
// chain groups (8 groups of 2 chains at 512² B=16); the walk form for a
// chain of more tiles than the card holds at once.  Each mode is a policy
// (Variant below) of the sweep and of what the barrier carries.
//
// What bounds it.  At 512² B=16, 25 sweeps of ~26 float operations a pixel
// and the prologue and assembly take 41.07 µs at the card's float32 peak;
// the bytes (g in, f out) take 20 µs.  So operations bound it, and none of
// them needs device memory between sweeps: the duals stay on chip.  What
// costs is a group-sweep's latency: the sweep's dependent chain of
// shuffles, divides and roots on one tile per SM, and the barrier's round
// trip through L2.  The modes take those apart: base against while is the
// masked loop, recip against base the divides, noresid against recip the
// residual and the exit inside the barrier, nosqrt the root, every5 four
// of five residual sums, roll and rollmul the boundary form, and the bf16
// modes the rounding and half the border bytes.
//
// The modes (the order of MODES in semiblind_tv_tpu_torch/benchmarks/
// probe_prox_variants.py):
//   base     2 divides; masked: a stopped chain's blocks keep sweeping and
//            meeting the barrier up to max_iter, and keep their old duals
//            (JAX's where-frozen fori_loop)
//   recip    base with rden = 1/(1 + τ·tmp) and 2 multiplies
//   noresid  recip without the residual: the barrier carries borders only,
//            every chain runs max_iter sweeps, meta = (max_iter, 0)
//   nosqrt   noresid with tmp = upx² + upy² (wrong by design)
//   while    recip with the resident kernel's own exit: a stopped chain's
//            blocks leave
//   roll     while with the image-boundary terms of div and ∇ formed by
//   rollmul  select masks / 0/1 multiplicative masks on unconditional
//            loads; the values are the concatenate form's, so both equal
//            `while` bit for bit
//   every5   while with the partials and the exit test only on sweeps 5,
//            10, ...
//   bf16mix  the duals, g/λ and the stencil's adds rounded to bfloat16,
//            the border records bfloat16; root, reciprocal, update and
//            residual in float32, the new duals rounded
//   bf16     every sweep operation rounded to bfloat16, residual in float32
//   bf16all  bf16 with the residual terms rounded to bfloat16 too (float32
//            partial sums)
// A bfloat16 operation is the float32 operation on bfloat16 values rounded
// once to bfloat16 (__float2bfloat16_rn), which is how PyTorch computes it,
// also for the root and the reciprocal.  A bfloat16 dual is held in a
// float register (its value exact).  f = g − λ·div p is float32 from the
// widened duals, in the concatenate form, as in J.  λ, τ and tol are read
// on the device from scal: no host read.  Built with --fmad=false: f
// equals the plain PyTorch version's to the bit at equal sweep counts.
//
// Entry point sb_prox_variant: g (B, M, N) and scal (3,) float32 on the
// card; f (B, M, N) and meta (B, 2) = (sweeps run, last residual) float32
// out; ws_int/ws_f the resident workspace (ops/tv_cuda.py::
// resident_workspace) and chains/grid its geometry (resident_geometry).
// Returns the first CUDA error.

#include <type_traits>

#include "resident.cuh"

namespace {

enum Mode { BASE, RECIP, NORESID, NOSQRT, WHILE, ROLL, ROLLMUL, EVERY5, BF16MIX, BF16, BF16ALL,
            N_MODES };

// The policy of one mode (resident.cuh::SweepPolicy lists the knobs).
template <int MODE>
struct Variant : SweepPolicy {
  static constexpr bool kBf16Dual = MODE == BF16MIX || MODE == BF16 || MODE == BF16ALL;
  static constexpr bool kBf16Arith = MODE == BF16 || MODE == BF16ALL;
  using Rec = typename std::conditional<kBf16Dual, unsigned short, float>::type;
  static constexpr int kResidual =
      (MODE == NORESID || MODE == NOSQRT) ? 0 : (MODE == BF16ALL ? 2 : 1);
  static constexpr bool kDivide = MODE == BASE;
  static constexpr bool kSqrt = MODE != NOSQRT;
  static constexpr int kForm =
      MODE == ROLL ? FORM_SELECT : (MODE == ROLLMUL ? FORM_MULMASK : FORM_CONCAT);
  static constexpr bool kMasked = MODE == BASE || MODE == RECIP;
  static constexpr int kEvery = MODE == EVERY5 ? 5 : 1;
  // scal = (λ, τ, tol) is P.lam; meta (B, 2) is P.err
  __device__ static float tau(const ResidentParams& P) { return __ldg(P.lam + 1); }
  __device__ static float tol(const ResidentParams& P) { return __ldg(P.lam + 2); }
  __device__ static void finish(const ResidentParams& P, int b, int n, float e) {
    P.err[2 * b] = (float)n;
    P.err[2 * b + 1] = e;
  }
};

template <int MODE>
__global__ void __launch_bounds__(BT, MIN_BLOCKS)
    variant_prox(const __grid_constant__ ResidentParams P) {
  __shared__ Xch x;
  resident_body<false, false, Variant<MODE>>(x, P);
}

template <int MODE>
__global__ void __launch_bounds__(BT, MIN_BLOCKS)
    variant_prox_walk(const __grid_constant__ ResidentParams P) {
  __shared__ XchWalk x;
  resident_body<false, true, Variant<MODE>>(x, P);
}

#define SB_FORMS(m) {(const void*)variant_prox<m>, (const void*)variant_prox_walk<m>}
const void* const FORMS[N_MODES][2] = {
    SB_FORMS(BASE),   SB_FORMS(RECIP),   SB_FORMS(NORESID), SB_FORMS(NOSQRT),
    SB_FORMS(WHILE),  SB_FORMS(ROLL),    SB_FORMS(ROLLMUL), SB_FORMS(EVERY5),
    SB_FORMS(BF16MIX), SB_FORMS(BF16),   SB_FORMS(BF16ALL)};
#undef SB_FORMS

}  // namespace

extern "C" {

// Kernel J in mode `mode` (the index in MODES): one cooperative launch.
// ws_int: the resident workspace's ints (zero, left zero); ws_f: its
// floats (ops/tv_cuda.py::resident_floats); chains, grid: the resident
// geometry (chains a group and C·T blocks, or fewer blocks than one chain's
// tiles with chains = 1: the walk form).
int sb_prox_variant(int mode, const float* g, const float* scal, float* f, float* meta,
                    int* ws_int, float* ws_f, int B, int M, int N, int chains, int grid,
                    int max_iter, void* stream) {
  if (mode < 0 || mode >= N_MODES) return cudaErrorInvalidValue;
  ResidentParams P{};
  P.g = g;
  P.lam = scal;
  P.f = f;
  P.err = meta;
  P.ws_int = ws_int;
  P.ws_f = ws_f;
  P.B = B;
  P.M = M;
  P.N = N;
  P.C = chains;
  P.stack = 1;
  P.max_iter = max_iter;
  return launch_resident(FORMS[mode][0], FORMS[mode][1], P, grid,
                         static_cast<cudaStream_t>(stream));
}

// out = {active blocks per SM (the smaller of the mode's two forms),
// registers a thread and local (spill) bytes a thread (the larger)}.
int sb_prox_variant_occupancy(int mode, int* out) {
  if (mode < 0 || mode >= N_MODES) return cudaErrorInvalidValue;
  return occupancy_of(FORMS[mode], 2, out);
}

}  // extern "C"
