// Counter-based normals shared by the trainer kernels (spectral_train.cu,
// general_train.cu): Philox4x32-10 and Box-Muller, all fp32.
//
// They take the place of the TPU's hardware PRNG (pltpu.prng_random_bits in
// projected_langevin_sampling_tpu/ops/pallas/spectral_train.py,
// _standard_normals). A draw depends only on (key, counter), so a rerun of
// the same steps reproduces the same normals whatever the launch layout.
// Uniforms are 24-bit and lie in (0, 1], so log never sees 0; one Philox call
// gives four normals through two Box-Muller pairs.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace plst {

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  const uint32_t m0 = 0xD2511F53u, m1 = 0xCD9E8D57u;
  const uint32_t w0 = 0x9E3779B9u, w1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(m0, ctr.x), lo0 = m0 * ctr.x;
    const uint32_t hi1 = __umulhi(m1, ctr.z), lo1 = m1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += w0;
    key.y += w1;
  }
  return ctr;
}

// uniform in (0, 1] from the top 24 bits
__device__ __forceinline__ float uniform_open0(uint32_t bits) {
  return __uint2float_rn((bits >> 8) + 1u) * 5.9604644775390625e-08f;  // 2^-24
}

__device__ __forceinline__ void box_muller(uint32_t a, uint32_t b, float& z0, float& z1) {
  const float r = sqrtf(-2.0f * logf(uniform_open0(a)));
  float s, c;
  sincospif(2.0f * uniform_open0(b), &s, &c);
  z0 = r * c;
  z1 = r * s;
}

// the four standard normals of one counter
__device__ __forceinline__ void normals4(uint4 ctr, uint2 key, float z[4]) {
  const uint4 bits = philox4x32_10(ctr, key);
  box_muller(bits.x, bits.y, z[0], z[1]);
  box_muller(bits.z, bits.w, z[2], z[3]);
}

__host__ __device__ inline uint2 philox_key(unsigned long long seed) {
  return make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
}

}  // namespace plst
