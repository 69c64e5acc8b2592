// B1: the whole spectral Langevin training run for Hopper (sm_90a).
//
// Replaces the TPU kernel projected_langevin_sampling_tpu/ops/pallas/
// spectral_train.py (spectral_train_fused / _spectral_train_kernel /
// _standard_normals). In the eigenbasis of the drift a training step is
// elementwise:
//
//   W' = decay * W + shift + noise_scale * eps,   eps ~ N(0, 1) iid
//   energy partial = sum over the block's elements of 0.5 sigma W'^2 - b W'
//
// What bounds it: operations. Each element-step draws one normal (a quarter of
// a Philox4x32-10 call plus half a Box-Muller pair) and does a handful of
// FMAs; W itself is read once and written once for the whole run. The design
// keeps every element in registers for all T steps: a thread owns four
// consecutive elements of the flattened (M, J) matrix, exactly the four
// normals one Philox call gives, so per step it touches no device memory
// except one partial-energy word per block. At M = 512, J = 1000 that is 500
// blocks of 256 threads, about four blocks on each of the 132 SMs.
//
// Noise: Philox4x32-10 (philox.cuh, shared with general_train.cu) keyed on
// the 64-bit seed and counted on (element group, step), so any rerun of steps
// 0..s reproduces the same draws. Uniforms are 24-bit and lie in (0, 1], so
// log never sees 0; both Box-Muller outputs are used; everything is fp32, as
// on the TPU.
//
// Energy and stopping: blocks cannot see each other's partial energies within
// a step without a grid-wide sync, so the kernel writes one partial per
// (step, block) and the wrapper sums them, adds the constant and replays the
// early stopper; if the stop falls before the last step it reruns steps
// 0..stop from W0 on the same counters (design (a): two passes, one with
// infinite patience). A grid sync per step would cost more than the step.
//
// The update mirrors the plain PyTorch order, ((decay * W) + shift) +
// (noise_scale * eps), with explicitly rounded operations, so with zero_noise
// the particles are bit-identical to the plain loop.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ELEMENTS_PER_THREAD = 4;

__global__ void __launch_bounds__(THREADS)
spectral_train_kernel(const float* __restrict__ w0, float* __restrict__ w_out,
                      const float* __restrict__ decay, const float* __restrict__ shift,
                      const float* __restrict__ sigma, const float* __restrict__ b,
                      float* __restrict__ partials,  // (num_steps, gridDim.x)
                      long long total, int j, int step0, int num_steps, float noise_scale,
                      uint2 key, int zero_noise) {
  __shared__ float red[2][WARPS];
  const long long group = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long e0 = group * ELEMENTS_PER_THREAD;

  float w[ELEMENTS_PER_THREAD], dk[ELEMENTS_PER_THREAD], sh[ELEMENTS_PER_THREAD];
  float sg[ELEMENTS_PER_THREAD], bk[ELEMENTS_PER_THREAD];
  bool valid[ELEMENTS_PER_THREAD];
#pragma unroll
  for (int k = 0; k < ELEMENTS_PER_THREAD; ++k) {
    const long long e = e0 + k;
    valid[k] = e < total;
    const long long row = valid[k] ? e / j : 0;
    w[k] = valid[k] ? w0[e] : 0.0f;
    dk[k] = valid[k] ? decay[row] : 0.0f;
    sh[k] = valid[k] ? shift[row] : 0.0f;
    sg[k] = valid[k] ? sigma[row] : 0.0f;
    bk[k] = valid[k] ? b[row] : 0.0f;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int s = 0; s < num_steps; ++s) {
    float z[ELEMENTS_PER_THREAD] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (!zero_noise) {
      plst::normals4(
          make_uint4((uint32_t)group, (uint32_t)(group >> 32), (uint32_t)(step0 + s), 0u), key, z);
    }
    float energy = 0.0f;
#pragma unroll
    for (int k = 0; k < ELEMENTS_PER_THREAD; ++k) {
      const float wn = __fadd_rn(__fadd_rn(__fmul_rn(dk[k], w[k]), sh[k]),
                                 __fmul_rn(noise_scale, z[k]));
      w[k] = valid[k] ? wn : 0.0f;
      energy += 0.5f * sg[k] * w[k] * w[k] - bk[k] * w[k];
    }
    for (int off = 16; off > 0; off >>= 1) energy += __shfl_down_sync(0xffffffffu, energy, off);
    // two buffers: a warp writing step s + 2 has passed step s + 1's barrier,
    // so warp 0 has finished reading step s
    if (lane == 0) red[s & 1][warp] = energy;
    __syncthreads();
    if (warp == 0) {
      float v = lane < WARPS ? red[s & 1][lane] : 0.0f;
      for (int off = WARPS / 2; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) partials[(size_t)s * gridDim.x + blockIdx.x] = v;
    }
  }

#pragma unroll
  for (int k = 0; k < ELEMENTS_PER_THREAD; ++k) {
    if (valid[k]) w_out[e0 + k] = w[k];
  }
}

}  // namespace

extern "C" int plst_spectral_train(const void* w0, void* w_out, const void* decay,
                                   const void* shift, const void* sigma, const void* b,
                                   void* partials, long long total, int j, int num_blocks,
                                   int step0, int num_steps, float noise_scale,
                                   unsigned long long seed, int zero_noise, void* stream) {
  if (total <= 0 || num_steps <= 0) return 0;
  const long long per_block = (long long)THREADS * ELEMENTS_PER_THREAD;
  if (j <= 0 || num_blocks != (int)((total + per_block - 1) / per_block)) {
    return (int)cudaErrorInvalidValue;
  }
  const uint2 key = plst::philox_key(seed);
  spectral_train_kernel<<<num_blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w0), static_cast<float*>(w_out),
      static_cast<const float*>(decay), static_cast<const float*>(shift),
      static_cast<const float*>(sigma), static_cast<const float*>(b),
      static_cast<float*>(partials), total, j, step0, num_steps, noise_scale, key, zero_noise);
  return (int)cudaGetLastError();
}
