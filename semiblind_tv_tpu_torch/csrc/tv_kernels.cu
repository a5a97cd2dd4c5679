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
//     The stacked form takes the chains beyond those the card holds at one
//     a block: block k holds tile k mod T of up to KMAX = 3 chains
//     (resident_prox_stacked, resident_step_stacked), so that 16 chains at
//     512² run in 3 groups instead of 8.  Only one chain's strip fits the
//     registers, so each chain's duals and g/λ live in dynamic shared
//     memory (resident.cuh's Stack, 70.6 KB beside Xch's 43.5 KB, still two
//     blocks an SM) and a sweep round loads each running chain's strip,
//     sweeps it and stores it back, then one barrier carries the partials
//     of all of them and one gather takes all their halos and sums.  Each
//     chain keeps its own records, partials, sums and exit; a chain that
//     has left is not swept again.  The set-up loads each chain's inputs
//     half a strip at once (its registers are free there).  A chain's
//     operations and sums are the one-chain form's, so every output is the
//     same to the bit.  Why it is not more: a sweep of a chain's tile is
//     ~3 µs of instructions (the exact divides and roots), of which the
//     barrier and gather it no longer waits on are under a third.
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
// allocated by the caller; nothing here allocates or synchronises.  The
// machinery of points 1-6 lives in resident.cuh, which kernel J
// (prox_variants.cu) shares; the four forms below take its SweepPolicy.

#include <atomic>

#include "resident.cuh"

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
  __shared__ XchWalk x;
  resident_body<false, true>(x, P);
}
__global__ void __launch_bounds__(BT, MIN_BLOCKS)
    resident_step_walk(const __grid_constant__ ResidentParams P) {
  __shared__ XchWalk x;
  resident_body<true, true>(x, P);
}
// The stacked forms: up to KMAX chains a block between two barriers, their
// duals and g/λ in dynamic shared memory (resident.cuh's Stack).
__global__ void __launch_bounds__(BT, MIN_BLOCKS)
    resident_prox_stacked(const __grid_constant__ ResidentParams P) {
  __shared__ Xch x;
  extern __shared__ __align__(16) unsigned char dyn[];
  stacked_body<false>(x, *reinterpret_cast<Stack*>(dyn), P);
}
__global__ void __launch_bounds__(BT, MIN_BLOCKS)
    resident_step_stacked(const __grid_constant__ ResidentParams P) {
  __shared__ Xch x;
  extern __shared__ __align__(16) unsigned char dyn[];
  stacked_body<true>(x, *reinterpret_cast<Stack*>(dyn), P);
}
}  // extern "C"

namespace {

const void* const FORMS[4] = {(const void*)resident_prox, (const void*)resident_step,
                              (const void*)resident_prox_walk, (const void*)resident_step_walk};
const void* const STACKED[2] = {(const void*)resident_prox_stacked,
                                (const void*)resident_step_stacked};

// Allows the stacked forms their dynamic shared memory (above the 48 KB
// default) and the largest shared-memory carveout on the current device,
// once a device: at the first occupancy query or launch, so that no launch
// captured in a CUDA graph sets it.
cudaError_t allow_stacked() {
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (ready.load() & bit) return cudaSuccess;
  for (const void* fn : STACKED) {
    if ((e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)sizeof(Stack))) != cudaSuccess ||
        (e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                                  cudaSharedmemCarveoutMaxShared)) != cudaSuccess)
      return e;
  }
  ready.fetch_or(bit);
  return cudaSuccess;
}

// The prox (STEP false) or the step forms' launch (resident.cuh).
template <bool STEP>
cudaError_t launch(ResidentParams& P, int grid, cudaStream_t st) {
  if (P.stack > 1) {
    const cudaError_t e = allow_stacked();
    if (e != cudaSuccess) return e;
  }
  return launch_resident(FORMS[STEP ? 1 : 0], FORMS[STEP ? 3 : 2], P, grid, st, STACKED[STEP]);
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
// one-thread-per-pixel kernels of tv_blocked.cu).
int sb_num_tiles(int M, int N) { return ((N + TX - 1) / TX) * ((M + TY - 1) / TY); }

// Kernel A: the warm form (A1) when px_in/py_in are given, the fresh form
// (A2) when they are null; px_out/py_out may be null.  iters (int32) and err
// (B,) get each chain's sweeps and last residual.  ws_int: 2 + chains ints
// and ws_f: 2·S·(BORDER + 2) floats of workspace with S = chains × tiles a
// chain, and 2·M·N more for the walk form; the ints zero before the first
// call (the kernel leaves them zero).  chains: chains a group; stack: the
// chains a block sweeps between two barriers (1, or up to KMAX in the
// stacked form); grid: chains / stack × tiles a chain (resident and stacked
// forms), or fewer blocks than one chain's tiles with chains = 1 (walk form)
// (ops/tv_cuda.py::resident_geometry).  strides: bit 0 set, lam is a (B,)
// vector, one λ a chain; clear, one value.
int sb_chambolle_prox(const float* g, const float* lam, const float* px_in, const float* py_in,
                      float* f, float* px_out, float* py_out, int* iters, float* err,
                      int* ws_int, float* ws_f, int B, int M, int N, int chains, int grid,
                      int stack, int max_iter, float tau, float tol, int strides, void* stream) {
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
  P.stack = stack;
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
                  int N, int chains, int grid, int stack, int n_sweeps, float tau, float tol,
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
  P.stack = stack;
  P.max_iter = n_sweeps;
  P.positivity = positivity;
  P.tau = tau;
  P.tol = tol;
  return launch<true>(P, grid, static_cast<cudaStream_t>(stream));
}

// The resident kernel's occupancy on the current device: out = {active
// blocks per SM (the smallest of the four one-chain forms), registers a
// thread (the largest of all six forms), local (spill) bytes a thread (the
// largest), threads a block, the blocks per SM of __launch_bounds__, SMs of
// the device, tile rows, tile columns, floats of a border record, the
// chains a block may stack (KMAX when the stacked forms keep the one-chain
// forms' blocks an SM with their shared memory, else 1)}.
int sb_resident_occupancy(int* out) {
  cudaError_t e = occupancy_of(FORMS, 4, out);
  if (e != cudaSuccess) return e;
  int so[3];
  if ((e = allow_stacked()) != cudaSuccess ||
      (e = occupancy_of(STACKED, 2, so, sizeof(Stack))) != cudaSuccess)
    return e;
  out[1] = so[1] > out[1] ? so[1] : out[1];
  out[2] = so[2] > out[2] ? so[2] : out[2];
  out[9] = so[0] >= out[0] ? KMAX : 1;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
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
