// Building blocks shared by the trainer kernels: a SIMT fp32 tile product
// through shared memory (quadratic_train.cu; general_train.cu and
// fused_update.cu multiply on the tensor cores through tc_product.cuh), a
// fixed-order block sum and the reference's early stopper kept in device
// memory (general_train.cu, quadratic_train.cu).
//
// A product kernel runs THREADS = 256 threads on a BM x BN = 64 x 64 output
// tile, 4 x 4 elements to a thread, with the depth in shared-memory stages
// of BK = 16. Operands and sums are fp32 with FFMA (no tensor cores, no
// TF32). Partial sums go through block_sum in a fixed order, never through
// atomics, so a rerun is bitwise equal.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace plst {

constexpr int BM = 64;  // rows of an output tile
constexpr int BN = 64;  // columns of an output tile
constexpr int BK = 16;  // depth of a shared-memory stage
constexpr int TM = 4;   // rows per thread
constexpr int TN = 4;   // columns per thread: one Philox call
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int WARPS = THREADS / 32;
constexpr int STOP_THREADS = 256;

// acc[i][j] += sum_k A(row0 + ty TM + i, k) B(k, col0 + tx TN + j), k < depth,
// in shared-memory stages of depth BK. A_KMAJOR: A(r, k) = a[k lda + r] (an
// (K, rows) matrix read as its transpose); else A(r, k) = a[r lda + k].
// B(k, c) = b[k ldb + c]. Out-of-range rows, columns and depths load as 0.
template <bool A_KMAJOR>
__device__ __forceinline__ void tile_product(const float* __restrict__ a, int lda, int rows,
                                             const float* __restrict__ b, int ldb, int cols,
                                             int depth, int row0, int col0,
                                             float (&a_tile)[BK][BM + 1],
                                             float (&b_tile)[BK][BN], float (&acc)[TM][TN]) {
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  for (int k0 = 0; k0 < depth; k0 += BK) {
#pragma unroll
    for (int l = 0; l < (BM * BK) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      // neighbouring threads on neighbouring addresses
      const int r = A_KMAJOR ? idx % BM : idx / BK;
      const int kk = A_KMAJOR ? idx / BM : idx % BK;
      const int gr = row0 + r, gk = k0 + kk;
      float v = 0.0f;
      if (gr < rows && gk < depth) {
        v = A_KMAJOR ? a[(size_t)gk * lda + gr] : a[(size_t)gr * lda + gk];
      }
      a_tile[kk][r] = v;
    }
#pragma unroll
    for (int l = 0; l < (BK * BN) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int kk = idx / BN, c = idx % BN;
      const int gk = k0 + kk, gc = col0 + c;
      b_tile[kk][c] = (gk < depth && gc < cols) ? b[(size_t)gk * ldb + gc] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = a_tile[kk][ty * TM + i];
      const float4 bv = *reinterpret_cast<const float4*>(&b_tile[kk][tx * TN]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        acc[i][0] = fmaf(av[i], bv.x, acc[i][0]);
        acc[i][1] = fmaf(av[i], bv.y, acc[i][1]);
        acc[i][2] = fmaf(av[i], bv.z, acc[i][2]);
        acc[i][3] = fmaf(av[i], bv.w, acc[i][3]);
      }
    }
    __syncthreads();
  }
}

// Sum of one value per thread in a fixed order; thread 0 gets the total.
__device__ __forceinline__ double block_sum(double v, double (&red)[WARPS]) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < WARPS; ++w) total += red[w];
  }
  return total;
}

// The early stopper's carry (reference early_stopper.py:15-24) in device
// memory, so that a run queues all its launches without a host sync.
struct StopState {
  float min_loss;
  int last_improved;
  int stopped;
  int unused;
};

__global__ void init_state_kernel(StopState* state) {
  state->min_loss = INFINITY;
  state->last_improved = -1;
  state->stopped = 0;
  state->unused = 0;
}

// Sum of n partials over STOP_THREADS threads in a fixed order; thread 0 gets
// the total.
__device__ __forceinline__ double sum_partials(const double* __restrict__ partials, int n,
                                               double (&red)[STOP_THREADS]) {
  double s = 0.0;
  for (int i = threadIdx.x; i < n; i += STOP_THREADS) s += partials[i];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int width = STOP_THREADS / 2; width > 0; width >>= 1) {
    if (threadIdx.x < width) red[threadIdx.x] += red[threadIdx.x + width];
    __syncthreads();
  }
  return red[0];
}

// One thread: write the energy of update `index` (NaN once stopped) and step
// the stopper. The simulation time is eta (index - last improvement), the
// formula of the wrapper's replay of the stopper.
__device__ __forceinline__ void record_energy_and_stop(float energy, int index, float eta,
                                                       float patience,
                                                       float* __restrict__ energies,
                                                       StopState* __restrict__ state) {
  const bool stopped = state->stopped != 0;
  if (stopped) energy = NAN;
  energies[index] = energy;
  const bool improved = energy < state->min_loss;
  const int last = improved ? index : state->last_improved;
  const float sim_time = eta * (float)(index - last);
  const bool should_stop = !isfinite(energy) || (!improved && sim_time >= patience);
  if (!stopped && improved) {
    state->min_loss = energy;
    state->last_improved = index;
  }
  if (should_stop) state->stopped = 1;
}

}  // namespace plst
