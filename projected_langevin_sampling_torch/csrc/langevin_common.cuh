// Building blocks shared by the trainer kernels general_train.cu (B3) and
// quadratic_train.cu (B4): a fixed-order block sum and the reference's early
// stopper kept in device memory. Both multiply on the tensor cores through
// tc_product.cuh. Partial sums go through block_sum and sum_partials in a
// fixed order, never through atomics, so a rerun is bitwise equal.
// smoothed_bernoulli.cu sums its column partials with sum_partials too.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace plst {

constexpr int THREADS = 256;  // a block of 8 warps (tc_product.cuh's)
constexpr int WARPS = THREADS / 32;
constexpr int STOP_THREADS = 256;

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

// Sum of n partials over STOP_THREADS threads in a fixed order; every thread
// gets the total. T is double for the trainers, T of the input for
// smoothed_bernoulli.cu.
template <typename T>
__device__ __forceinline__ T sum_partials(const T* __restrict__ partials, int n,
                                          T (&red)[STOP_THREADS]) {
  T s = 0;
  for (int i = threadIdx.x; i < n; i += STOP_THREADS) s += partials[i];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int width = STOP_THREADS / 2; width > 0; width >>= 1) {
    if (threadIdx.x < width) red[threadIdx.x] += red[threadIdx.x + width];
    __syncthreads();
  }
  return red[0];
}

// One thread: step the stopper with the energy of update `index` and return
// the energy to write (NaN once stopped). The simulation time is eta (index -
// last improvement), the formula of the wrapper's replay of the stopper.
__device__ __forceinline__ float step_stopper(float energy, int index, float eta, float patience,
                                              StopState* __restrict__ state) {
  const bool stopped = state->stopped != 0;
  if (stopped) energy = NAN;
  const bool improved = energy < state->min_loss;
  const int last = improved ? index : state->last_improved;
  const float sim_time = eta * (float)(index - last);
  const bool should_stop = !isfinite(energy) || (!improved && sim_time >= patience);
  if (!stopped && improved) {
    state->min_loss = energy;
    state->last_improved = index;
  }
  if (should_stop) state->stopped = 1;
  return energy;
}

// One thread: write the energy of update `index` (NaN once stopped) and step
// the stopper.
__device__ __forceinline__ void record_energy_and_stop(float energy, int index, float eta,
                                                       float patience,
                                                       float* __restrict__ energies,
                                                       StopState* __restrict__ state) {
  energies[index] = step_stopper(energy, index, eta, patience, state);
}

}  // namespace plst
