// B4: the whole quadratic-tier Langevin training run in M space, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel projected_langevin_sampling_tpu/ops/pallas/
// quadratic_train.py:123 (quadratic_train_fused / _quadratic_train_kernel).
// For the Gaussian cost with the identity link, for t = 0 .. T-1:
//
//   U' = U - eta (A U - b) + sqrt(2 eta) S eps      (M, M) x (M, J)
//   energy_t = mean_j(0.5 U'_j^T E U'_j - e_bias . U'_j) + e_const
//
// Shared (the orthonormal basis): E == A and S == I, so V = A U is carried
// and one product per step serves this step's energy and the next drift.
// Non-shared (the inducing-point basis): A, E and S differ, three products
// per step. The reference's early stopping in simulation time: the stop
// step's update is applied, the particles freeze after it and later energies
// are NaN.
//
// What bounds it on this card: operations. At M = 512, J = 1000 a product is
// 2 M^2 J = 5.2e8 flops; the non-shared step has three (1.57e9), the shared
// step one, besides about 41 operations per element of U (Philox and
// Box-Muller, the update, the energy). A, E, S and the particle buffers
// (about 5 MB) stay in the 50 MB L2, so bytes do not bind.
//
// Design. The TPU kernel keeps everything in VMEM and runs the steps in one
// program. Blocks on the H100 cannot share a step's particles or energy, so
// each step is a few launches on one stream and the host never waits inside
// the run:
//   normals_kernel         (non-shared, with noise) Philox normals into an
//                          (M, J) buffer, counted on (column group of 4, row,
//                          step), so every block of the product sees the same
//                          eps;
//   update_product_kernel  (non-shared) grid (J tiles, M tiles): A U and S eps
//                          in two accumulators over K = M, then
//                          U' = U - eta (A U - b) + sqrt(2 eta) S eps into the
//                          other of two particle buffers;
//   update_shared_kernel   (shared) elementwise U' = U - eta (V - b) +
//                          sqrt(2 eta) eps with its own Philox normals;
//   energy_kernel          grid (J tiles, M tiles): V' = E U' (written when
//                          shared) and one partial of 0.5 U' V' - e_bias U'
//                          per block (fixed order, no atomics);
//   stop_kernel            one block: the energy of the step and the stopper
//                          (min loss, last improvement, stopped) in device
//                          memory.
// A frozen step copies U. So a shared run is 3 T + 2 launches, a non-shared
// run 4 T + 1 (3 T + 1 with zero noise), and a run with the same seed is
// bitwise reproducible.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "langevin_common.cuh"
#include "philox.cuh"

namespace {

using plst::BK;
using plst::BM;
using plst::BN;
using plst::StopState;
using plst::STOP_THREADS;
using plst::THREADS;
using plst::TM;
using plst::TN;
using plst::WARPS;

constexpr uint32_t STREAM_ID = 2u;  // the fourth Philox counter word of this kernel

// the four normals of (row, column group cg) at `step`
__device__ __forceinline__ void step_normals(int row, int cg, int step, uint2 key, float z[4]) {
  plst::normals4(make_uint4((uint32_t)cg, (uint32_t)row, (uint32_t)step, STREAM_ID), key, z);
}

__global__ void __launch_bounds__(THREADS)
normals_kernel(float* __restrict__ eps, int m, int j, int step, uint2 key,
               const StopState* __restrict__ state) {
  if (state->stopped) return;
  const int groups = (j + TN - 1) / TN;
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= m * groups) return;
  const int row = idx / groups, cg = idx % groups;
  float z[4];
  step_normals(row, cg, step, key, z);
#pragma unroll
  for (int jj = 0; jj < TN; ++jj) {
    const int c = cg * TN + jj;
    if (c < j) eps[(size_t)row * j + c] = z[jj];
  }
}

// copy of the (BM, BN) tile of a frozen particle buffer
__device__ __forceinline__ void copy_tile(const float* __restrict__ u, float* __restrict__ u_next,
                                          int m, int j, int row0, int col0) {
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) {
      const int c = col0 + tx * TN + jj;
      if (r < m && c < j) u_next[(size_t)r * j + c] = u[(size_t)r * j + c];
    }
  }
}

// Non-shared update: U' = U - eta (A U - b) + root2eta S eps on one tile.
__global__ void __launch_bounds__(THREADS)
update_product_kernel(const float* __restrict__ a, const float* __restrict__ s,
                      const float* __restrict__ b, const float* __restrict__ u,
                      const float* __restrict__ eps, float* __restrict__ u_next, int m, int j,
                      float eta, float root2eta, int zero_noise,
                      const StopState* __restrict__ state) {
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  if (state->stopped) {
    copy_tile(u, u_next, m, j, row0, col0);
    return;
  }
  __shared__ float a_tile[BK][BM + 1];
  __shared__ __align__(16) float b_tile[BK][BN];
  float drift[TM][TN] = {};
  float noise[TM][TN] = {};
  plst::tile_product<false>(a, m, m, u, j, j, m, row0, col0, a_tile, b_tile, drift);
  if (!zero_noise) {
    plst::tile_product<false>(s, m, m, eps, j, j, m, row0, col0, a_tile, b_tile, noise);
  }
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= m) continue;
    const float br = b[r];
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) {
      const int c = col0 + tx * TN + jj;
      if (c >= j) continue;
      float un = u[(size_t)r * j + c] - eta * (drift[i][jj] - br);
      if (!zero_noise) un = un + root2eta * noise[i][jj];
      u_next[(size_t)r * j + c] = un;
    }
  }
}

// Shared update: U' = U - eta (V - b) + root2eta eps, elementwise, four
// columns of one row to a thread.
__global__ void __launch_bounds__(THREADS)
update_shared_kernel(const float* __restrict__ v, const float* __restrict__ b,
                     const float* __restrict__ u, float* __restrict__ u_next, int m, int j,
                     float eta, float root2eta, int step, uint2 key, int zero_noise,
                     const StopState* __restrict__ state) {
  const int groups = (j + TN - 1) / TN;
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= m * groups) return;
  const int row = idx / groups, cg = idx % groups;
  const bool stopped = state->stopped != 0;
  float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (!stopped && !zero_noise) step_normals(row, cg, step, key, z);
  const float br = b[row];
#pragma unroll
  for (int jj = 0; jj < TN; ++jj) {
    const int c = cg * TN + jj;
    if (c >= j) continue;
    const size_t k = (size_t)row * j + c;
    if (stopped) {
      u_next[k] = u[k];
      continue;
    }
    float un = u[k] - eta * (v[k] - br);
    if (!zero_noise) un = un + root2eta * z[jj];
    u_next[k] = un;
  }
}

// V' = E U' on one tile (written when write_v), and one partial of
// sum(0.5 U' V' - e_bias U') per block.
__global__ void __launch_bounds__(THREADS)
energy_kernel(const float* __restrict__ e, const float* __restrict__ u,
              const float* __restrict__ e_bias, float* __restrict__ v,
              double* __restrict__ partials, int m, int j, int write_v,
              const StopState* __restrict__ state) {
  if (state->stopped) return;  // frozen: the stopper writes NaN
  __shared__ float a_tile[BK][BM + 1];
  __shared__ __align__(16) float b_tile[BK][BN];
  __shared__ double red[WARPS];
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  float acc[TM][TN] = {};
  plst::tile_product<false>(e, m, m, u, j, j, m, row0, col0, a_tile, b_tile, acc);
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  float local = 0.0f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= m) continue;
    const float eb = e_bias[r];
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) {
      const int c = col0 + tx * TN + jj;
      if (c >= j) continue;
      const float uv = u[(size_t)r * j + c];
      if (write_v) v[(size_t)r * j + c] = acc[i][jj];
      local += 0.5f * (uv * acc[i][jj]) - eb * uv;
    }
  }
  const double total = plst::block_sum((double)local, red);
  if (threadIdx.x == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = total;
}

// The energy of update `index` and the early stopper (quadratic_train.py:102-109).
__global__ void __launch_bounds__(STOP_THREADS)
stop_kernel(const double* __restrict__ partials, int n, float* __restrict__ energies, int index,
            double inv_j, double e_const, float eta, float patience,
            StopState* __restrict__ state) {
  __shared__ double red[STOP_THREADS];
  const double total = plst::sum_partials(partials, n, red);
  if (threadIdx.x != 0) return;
  plst::record_energy_and_stop((float)(total * inv_j + e_const), index, eta, patience, energies,
                               state);
}

}  // namespace

// One whole run on `stream`, no synchronisation. u_a holds U0 on entry; the
// final particles are in u_a for even T and in u_b for odd T. energies (T)
// must be NaN-filled by the caller. v and eps are (M, J) scratch buffers,
// partials holds one double per (M, J) tile. Returns a CUDA error code, 0 on
// success.
extern "C" int plst_quadratic_train(const void* a, const void* e, const void* s, const void* b,
                                    const void* e_bias, void* u_a, void* u_b, void* v, void* eps,
                                    void* partials, void* energies, void* state, int m, int j,
                                    int num_steps, int shared, float eta, float patience,
                                    double e_const, unsigned long long seed, int zero_noise,
                                    void* stream_ptr) {
  if (m <= 0 || j <= 0 || num_steps < 0) return (int)cudaErrorInvalidValue;
  if (num_steps == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid_tiles((j + BN - 1) / BN, (m + BM - 1) / BM);
  const int n_partials = (int)(grid_tiles.x * grid_tiles.y);
  const int elementwise_blocks = (m * ((j + TN - 1) / TN) + THREADS - 1) / THREADS;
  const float* ap = static_cast<const float*>(a);
  const float* ep = static_cast<const float*>(e);
  const float* sp = static_cast<const float*>(s);
  const float* bp = static_cast<const float*>(b);
  const float* ebp = static_cast<const float*>(e_bias);
  float* vp = static_cast<float*>(v);
  float* epsp = static_cast<float*>(eps);
  double* part = static_cast<double*>(partials);
  float* en = static_cast<float*>(energies);
  StopState* st = static_cast<StopState*>(state);
  const uint2 key = plst::philox_key(seed);
  const float root2eta = sqrtf(2.0f * eta);
  const double inv_j = 1.0 / (double)j;

  plst::init_state_kernel<<<1, 1, 0, stream>>>(st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  float* u_cur = static_cast<float*>(u_a);
  float* u_nxt = static_cast<float*>(u_b);
  if (shared) {  // V0 = A U0 (its partials are not used)
    energy_kernel<<<grid_tiles, THREADS, 0, stream>>>(ap, u_cur, ebp, vp, part, m, j, 1, st);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  for (int t = 0; t < num_steps; ++t) {
    if (shared) {
      update_shared_kernel<<<elementwise_blocks, THREADS, 0, stream>>>(
          vp, bp, u_cur, u_nxt, m, j, eta, root2eta, t, key, zero_noise, st);
    } else {
      if (!zero_noise) {
        normals_kernel<<<elementwise_blocks, THREADS, 0, stream>>>(epsp, m, j, t, key, st);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      }
      update_product_kernel<<<grid_tiles, THREADS, 0, stream>>>(ap, sp, bp, u_cur, epsp, u_nxt,
                                                                 m, j, eta, root2eta, zero_noise,
                                                                 st);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    energy_kernel<<<grid_tiles, THREADS, 0, stream>>>(shared ? ap : ep, u_nxt, ebp, vp, part, m,
                                                      j, shared, st);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    stop_kernel<<<1, STOP_THREADS, 0, stream>>>(part, n_partials, en, t, inv_j, e_const, eta,
                                                 patience, st);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    float* tmp = u_cur;
    u_cur = u_nxt;
    u_nxt = tmp;
  }
  return 0;
}
