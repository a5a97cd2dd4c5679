// Chambolle TV-prox and fused MYULA-step kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   semiblind_tv_tpu/ops/tv_pallas.py::chambolle_prox_pallas
//       (_kernel: warm duals in and out; _kernel_fresh: zero duals, f only)
//   semiblind_tv_tpu/ops/fused_step_pallas.py::myula_prox_tv (_kernel)
//   semiblind_tv_tpu/ops/fused_step_pallas.py::myula_prox_tv_rng (_kernel_rng:
//       the same step with the noise drawn in the kernel)
// which keep the whole image and both dual fields resident in VMEM for all
// sweeps.  A 512x512 f32 field is 1 MB, far above the 227 KB of shared
// memory of one SM, so that design does not carry over.  This first port
// runs ONE LAUNCH PER SWEEP with the sweep-to-sweep dependency carried
// through device memory (about 5 fields of traffic a sweep, most of it
// served from the 50 MB L2 at 512²); at 512² a sweep is bound by launch
// latency and L2 bandwidth, not by arithmetic.
//
// Per sweep s (the host issues all max_iter sweeps, no host sync):
//   chambolle_sweep   one thread per pixel, tiles of TX x TY, grid z = chain.
//                     A chain whose device flag active[b] is 0 returns at
//                     once.  Reads duals from buffer s % 2, writes buffer
//                     (s+1) % 2 (Jacobi: in place would be wrong), and
//                     writes the tile's partial sum of rx²+ry² to
//                     partials[b, tile] (fixed-order tree, no atomics).
//   residual_reduce   one block per chain: sums the partials in a fixed
//                     order, err = sqrt(sum), iters += 1, active = err > tol.
//                     An inactive chain's partials are stale: it is skipped.
// This reproduces tv_pallas.dual_ascent_loop exactly: the sweep whose
// pre-update residual is <= tol still applies its update, and the next one
// does not run.  Chain b's duals therefore end in buffer iters[b] % 2,
// which `assemble` reads to form f = g − λ·div p.
//
// Built with --fmad=false so that the elementwise arithmetic rounds like
// PyTorch's separate operations; '/' and sqrtf are IEEE (no fast math).
//
// Entry points: sb_chambolle_prox (A1/A2) and sb_myula_step, the fused
// step: kernel B with a z field, kernel C with z null and per-chain seeds
// (the prologue evaluates the Philox normals of rng.cuh at each pixel, and
// at the tile's up and left halo that it recomputes for the TV, instead of
// reading a z field: one field read and the torch.randn launch less per
// chain-iteration for 1.16 Philox evaluations a pixel, ten rounds of two
// 32x32-bit multiplies each), and with σ² the middle of the DFT steps of
// dft_kernels.cu.
//
// The C interface takes raw pointers and a cudaStream_t and returns the
// first CUDA error (cudaSuccess == 0).  Outputs and scratch are allocated by
// the caller; nothing here allocates or synchronises.

#include "common.cuh"

namespace {

__global__ void init_state(int* __restrict__ iters, float* __restrict__ err,
                           int* __restrict__ active, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) {
    iters[b] = 0;
    err[b] = INFINITY;
    active[b] = 1;
  }
}

// One Chambolle sweep on g/λ for every active chain.
__global__ void __launch_bounds__(NT)
chambolle_sweep(const float* __restrict__ g, const float* __restrict__ lam_ptr,
                const float* __restrict__ px, const float* __restrict__ py,
                float* __restrict__ qx, float* __restrict__ qy,
                const int* __restrict__ active, float* __restrict__ partials,
                int M, int N, float tau) {
  __shared__ float sh[NT];
  const int b = blockIdx.z;
  if (!active[b]) return;  // uniform over the block
  const size_t off = (size_t)b * M * N;
  const float* gb = g + off;
  const float* pxb = px + off;
  const float* pyb = py + off;
  const float lam = *lam_ptr;
  const int j = blockIdx.x * TX + threadIdx.x;
  const int i = blockIdx.y * TY + threadIdx.y;
  float r2 = 0.f;
  if (i < M && j < N) {
    const size_t idx = (size_t)i * N + j;
    const float u = div_at(pxb, pyb, i, j, M, N) - gb[idx] / lam;
    float upx = 0.f, upy = 0.f;
    if (i < M - 1) upx = (div_at(pxb, pyb, i + 1, j, M, N) - gb[idx + N] / lam) - u;
    if (j < N - 1) upy = (div_at(pxb, pyb, i, j + 1, M, N) - gb[idx + 1] / lam) - u;
    const float tmp = sqrtf(upx * upx + upy * upy);
    const float p1 = pxb[idx];
    const float p2 = pyb[idx];
    const float rx = -upx + tmp * p1;
    const float ry = -upy + tmp * p2;
    r2 = rx * rx + ry * ry;
    const float denom = 1.0f + tau * tmp;
    qx[off + idx] = (p1 + tau * upx) / denom;
    qy[off + idx] = (p2 + tau * upy) / denom;
  }
  const float s = tile_sum(r2, sh);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    partials[(size_t)b * gridDim.x * gridDim.y + blockIdx.y * gridDim.x + blockIdx.x] = s;
}

__global__ void __launch_bounds__(RT)
residual_reduce(const float* __restrict__ partials, int nblk,
                int* __restrict__ active, int* __restrict__ iters,
                float* __restrict__ err, float tol) {
  __shared__ float sh[RT];
  const int b = blockIdx.x;
  if (!active[b]) return;  // stale partials: leave the chain as it is
  const float s = chain_sum(partials + (size_t)b * nblk, nblk, sh);
  if (threadIdx.x == 0) {
    const float e = sqrtf(s);
    err[b] = e;
    iters[b] += 1;
    active[b] = (e > tol) ? 1 : 0;
  }
}

// f = g − λ·div p from buffer iters[b] % 2; optionally also the final duals.
__global__ void __launch_bounds__(NT)
assemble(const float* __restrict__ g, const float* __restrict__ lam_ptr,
         const float* __restrict__ px_buf, const float* __restrict__ py_buf,
         const int* __restrict__ iters, float* __restrict__ f,
         float* __restrict__ px_out, float* __restrict__ py_out,
         int B, int M, int N) {
  const int b = blockIdx.z;
  const int j = blockIdx.x * TX + threadIdx.x;
  const int i = blockIdx.y * TY + threadIdx.y;
  if (i >= M || j >= N) return;
  const size_t plane = (size_t)M * N;
  const size_t off = (size_t)b * plane;
  const size_t sel = (size_t)(iters[b] & 1) * B * plane + off;
  const float* pxb = px_buf + sel;
  const float* pyb = py_buf + sel;
  const size_t idx = (size_t)i * N + j;
  f[off + idx] = g[off + idx] - *lam_ptr * div_at(pxb, pyb, i, j, M, N);
  if (px_out != nullptr) {
    px_out[off + idx] = pxb[idx];
    py_out[off + idx] = pyb[idx];
  }
}

// The sweep/reduce loop from the state in buffer 0, then assembly.
cudaError_t prox_from_buffer0(const float* g, const float* lam, float* px_buf,
                              float* py_buf, int* iters, float* err, int* active,
                              float* partials, float* f, float* px_out,
                              float* py_out, int B, int M, int N, int max_iter,
                              float tau, float tol, cudaStream_t st) {
  const dim3 block(TX, TY);
  const dim3 grid((N + TX - 1) / TX, (M + TY - 1) / TY, B);
  const int nblk = (int)(grid.x * grid.y);
  const size_t n = (size_t)B * M * N;
  cudaError_t e;
  init_state<<<(B + 255) / 256, 256, 0, st>>>(iters, err, active, B);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  for (int s = 0; s < max_iter; ++s) {
    const size_t rd = (size_t)(s & 1) * n;
    const size_t wr = (size_t)((s + 1) & 1) * n;
    chambolle_sweep<<<grid, block, 0, st>>>(g, lam, px_buf + rd, py_buf + rd,
                                            px_buf + wr, py_buf + wr, active,
                                            partials, M, N, tau);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    residual_reduce<<<B, RT, 0, st>>>(partials, nblk, active, iters, err, tol);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  assemble<<<grid, block, 0, st>>>(g, lam, px_buf, py_buf, iters, f, px_out,
                                   py_out, B, M, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of per-tile partials of one chain for an (M, N) image: the caller
// sizes `partials` as B times this.
int sb_num_tiles(int M, int N) { return ((N + TX - 1) / TX) * ((M + TY - 1) / TY); }

// Kernel A (A1 warm form when px_in/py_in are given, A2 fresh form when they
// are null).  px_buf/py_buf: (2, B, M, N) scratch; px_out/py_out may be null.
int sb_chambolle_prox(const float* g, const float* lam, const float* px_in,
                      const float* py_in, float* px_buf, float* py_buf, int* iters,
                      float* err, int* active, float* partials, float* f,
                      float* px_out, float* py_out, int B, int M, int N,
                      int max_iter, float tau, float tol, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = (size_t)B * M * N * sizeof(float);
  cudaError_t e;
  if (px_in != nullptr) {
    if ((e = cudaMemcpyAsync(px_buf, px_in, bytes, cudaMemcpyDeviceToDevice, st)) != cudaSuccess) return e;
    if ((e = cudaMemcpyAsync(py_buf, py_in, bytes, cudaMemcpyDeviceToDevice, st)) != cudaSuccess) return e;
  } else {
    if ((e = cudaMemsetAsync(px_buf, 0, bytes, st)) != cudaSuccess) return e;
    if ((e = cudaMemsetAsync(py_buf, 0, bytes, st)) != cudaSuccess) return e;
  }
  return prox_from_buffer0(g, lam, px_buf, py_buf, iters, err, active, partials,
                           f, px_out, py_out, B, M, N, max_iter, tau, tol, st);
}

int sb_myula_step(const float* x, const float* prox, const float* grad, const float* z,
                  const int* seeds, const float* gamma, const float* lam,
                  const float* lam_theta, const float* sigma2, float* xn, float* proxn,
                  float* tv, float* px_buf, float* py_buf, int* iters, float* err,
                  int* active, float* partials, int B, int M, int N, int n_sweeps,
                  float tau, float tol, int positivity, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((z == nullptr) == (seeds == nullptr)) return cudaErrorInvalidValue;
  const dim3 block(TX, TY);
  const dim3 grid((N + TX - 1) / TX, (M + TY - 1) / TY, B);
  const int nblk = (int)(grid.x * grid.y);
  const size_t bytes = (size_t)B * M * N * sizeof(float);
  cudaError_t e;
  myula_prologue<<<grid, block, 0, st>>>(x, prox, grad, z, seeds, gamma, lam, sigma2, xn,
                                         partials, M, N, positivity);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  sum_reduce<<<B, RT, 0, st>>>(partials, nblk, tv);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = cudaMemsetAsync(px_buf, 0, bytes, st)) != cudaSuccess) return e;
  if ((e = cudaMemsetAsync(py_buf, 0, bytes, st)) != cudaSuccess) return e;
  return prox_from_buffer0(xn, lam_theta, px_buf, py_buf, iters, err, active,
                           partials, proxn, nullptr, nullptr, B, M, N, n_sweeps,
                           tau, tol, st);
}

}  // extern "C"
