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
// FMAs; W itself is read once and written once for the whole run. Every
// element stays in a register for all T steps, and the step is cut to the
// fewest instructions and the shortest dependency chains:
//
// - Eight elements a thread, two Philox counters: two independent dependency
//   chains through Philox's ten rounds, and the per-step warp reduction
//   shared by eight elements.
// - No block barrier on most steps: each warp's lane 0 keeps the warp's
//   per-step energy in shared memory for INTERVAL steps, and the block meets
//   once every INTERVAL steps, when warp 0 sums the block's partials of those
//   steps and stores them in one coalesced line of the (blocks, steps)
//   partial buffer. A step's warp sum is taken in the next step, where its
//   shuffles overlap the draws.
// - Philox's round keys, and the parts of its first two rounds that depend on
//   the group alone, computed once a run (the keys on the host), not once a
//   step.
// - Normals from the MUFU unit (lg2, sqrt, sin and cos approximations, noise
//   scale folded into the radius) in place of philox.cuh's IEEE-accurate
//   logf / sqrtf / sincospif sequences; see fast_pair for their error and how
//   the two hazards (the range of __sinf / __cosf, and a log that may come
//   out positive near u = 1) are met.
//
// Noise: Philox4x32-10 (philox.cuh's bits) keyed on the 64-bit seed and
// counted on (group of four elements, step), so any rerun of steps 0..s
// reproduces the same draws whatever the launch layout. The group is the
// whole run's: a launch on a shard of columns j0 .. j0 + j of a j_total-column
// run (a particle shard of parallel/auto.py) draws exactly the normals of
// those columns in the unsharded run (run_group). Uniforms are 24-bit
// and lie in (0, 1]; both Box-Muller outputs are used; everything is fp32, as
// on the TPU. ops/cuda/spectral_train.py holds a CPU mirror of the draws.
//
// Energy and stopping: blocks cannot see each other's partial energies within
// a step without a grid-wide sync, so the kernel writes one partial per
// (block, step) and the wrapper sums them, adds the constant and replays the
// early stopper; if the stop falls before the last step it reruns steps
// 0..stop from W0 on the same counters (two passes, one with infinite
// patience). A grid sync per step would cost more than the step.
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
constexpr int GROUPS_PER_THREAD = 2;  // groups of four elements, one Philox call each
constexpr int ELEMENTS_PER_THREAD = 4 * GROUPS_PER_THREAD;
constexpr int INTERVAL = 32;  // steps between block barriers: one per lane of warp 0

// Philox4x32-10 of plst::philox4x32_10 on the counter (group lo, group hi,
// step, 0), split so that a thread computes once what does not change from
// step to step: the round keys, and the parts of rounds 1 and 2 that depend on
// the group alone. The output bits are philox.cuh's.
constexpr uint32_t PHILOX_M0 = 0xD2511F53u, PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u, PHILOX_W1 = 0xBB67AE85u;
constexpr int PHILOX_ROUNDS = 10;

// the round keys, a kernel argument: the rounds' xors read them from the
// constant bank and no step recomputes them
struct RoundKeys {
  uint32_t k0[PHILOX_ROUNDS], k1[PHILOX_ROUNDS];
};

RoundKeys round_keys(uint2 key) {
  RoundKeys rk;
  for (int i = 0; i < PHILOX_ROUNDS; ++i) {
    rk.k0[i] = key.x + (uint32_t)i * PHILOX_W0;
    rk.k1[i] = key.y + (uint32_t)i * PHILOX_W1;
  }
  return rk;
}

// A round maps (x, y, z, w) to (hi(M1 z) ^ y ^ k0, lo(M1 z), hi(M0 x) ^ w ^ k1,
// lo(M0 x)). From (glo, ghi, step, 0), with (sh, sl) = M1 step:
//   round 1: x1 = sh ^ (ghi ^ k0[0]), y1 = sl, z1 = hi(M0 glo) ^ k1[0], w1 = lo(M0 glo)
//   round 2: x2 = (hi(M1 z1) ^ k0[1]) ^ sl, y2 = lo(M1 z1), z2 = hi(M0 x1) ^ (w1 ^ k1[1]),
//            w2 = lo(M0 x1)
// so a group keeps a = ghi ^ k0[0], b = hi(M1 z1) ^ k0[1], c = lo(M1 z1) and
// d = w1 ^ k1[1].
struct GroupConstants {
  uint32_t a, b, c, d;
};

__device__ __forceinline__ GroupConstants group_constants(long long group, const RoundKeys& rk) {
  const uint32_t glo = (uint32_t)group, ghi = (uint32_t)(group >> 32);
  const uint32_t z1 = __umulhi(PHILOX_M0, glo) ^ rk.k1[0];
  return {ghi ^ rk.k0[0], __umulhi(PHILOX_M1, z1) ^ rk.k0[1], PHILOX_M1 * z1,
          (PHILOX_M0 * glo) ^ rk.k1[1]};
}

// The whole run's group of a local group of four elements: local element
// e = 4 group lies at (row e / j, column e % j) of a shard whose columns start
// at j0 of a j_total-column run, and the run's flat index of that element is
// row j_total + j0 + column. Unsharded (j0 = 0, j_total = j) this is the local
// group itself. A shard needs j, j0 and j_total to be multiples of 4 (the
// entry point checks), so that a group's four elements stay in one row.
__device__ __forceinline__ long long run_group(long long group, int j, long long j0,
                                               long long j_total) {
  const long long e = 4 * group;
  return ((e / j) * j_total + j0 + e % j) / 4;
}

__device__ __forceinline__ uint4 philox_bits(const GroupConstants& g, uint32_t sh, uint32_t sl,
                                             const RoundKeys& rk) {
  const uint32_t x1 = sh ^ g.a;
  uint4 ctr = make_uint4(g.b ^ sl, g.c, __umulhi(PHILOX_M0, x1) ^ g.d, PHILOX_M0 * x1);
#pragma unroll
  for (int i = 2; i < PHILOX_ROUNDS; ++i) {
    const uint32_t hi0 = __umulhi(PHILOX_M0, ctr.x), lo0 = PHILOX_M0 * ctr.x;
    const uint32_t hi1 = __umulhi(PHILOX_M1, ctr.z), lo1 = PHILOX_M1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ rk.k0[i], lo1, hi0 ^ ctr.w ^ rk.k1[i], lo0);
  }
  return ctr;
}

// uniform in (0, 1] from the top 24 bits, the value of plst::uniform_open0:
// float(bits >> 8) is exact, and so is the fma (a multiple of 2^-24 up to 1)
__device__ __forceinline__ float uniform24(uint32_t bits) {
  return fmaf(__uint2float_rn(bits >> 8), 5.9604644775390625e-08f, 5.9604644775390625e-08f);
}

// One Box-Muller pair on the MUFU unit, times the noise scale s. With u1, u2
// the uniforms of a and b:
//   r^2 = -2 ln u1 = (-2 ln 2) log2 u1,   theta = 2 pi u2 - pi,
//   z0 = s r cos(theta), z1 = s r sin(theta),
// s folded into r^2 through r2_scale = -2 ln 2 s^2. theta lies in
// (-pi, pi], where __sinf and __cosf keep their stated error; it is the
// angle 2 pi u2 of philox.cuh's box_muller shifted by pi, which flips the
// sign of both outputs and leaves the law unchanged. lg2 and sqrt flush
// subnormals (u1 >= 2^-24 is normal; a subnormal r^2 gives r = 0 in place of
// r < 1.1e-19). Near
// u1 = 1, lg2's absolute error (at most 2^-22 on [0.5, 2]) can make log2 u1
// slightly positive, so r^2 is clamped at 0 before the root. Error against the
// exact pair at s = 1 (CUDA Programming Guide, intrinsic functions, for
// __log2f, __sinf and __cosf; Math API for sqrt.approx, the code of sqrtf
// under -prec-sqrt=false, at most 1 ulp): r^2 within 2^-21 + 2^-18 r^2, theta
// within 2^-19 (chip_smoke.py phase 3 holds the draws to these).
__device__ __forceinline__ void fast_pair(uint32_t a, uint32_t b, float r2_scale, float& z0,
                                          float& z1) {
  float lg, r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(lg) : "f"(uniform24(a)));
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(fmaxf(r2_scale * lg, 0.0f)));
  float s, c;
  __sincosf(fmaf(uniform24(b), 6.2831853071795865f, -3.1415926535897932f), &s, &c);
  z0 = r * c;
  z1 = r * s;
}

// the noise a kernel draws: none (zero_noise) or the MUFU normals of
// fast_pair; a template argument, so that a step is one basic block the
// compiler can schedule as a whole
enum class Noise { kNone = 0, kFast = 1 };

template <Noise kNoise>
__global__ void __launch_bounds__(THREADS)
spectral_train_kernel(const float* __restrict__ w0, float* __restrict__ w_out,
                      const float* __restrict__ decay, const float* __restrict__ shift,
                      const float* __restrict__ sigma, const float* __restrict__ b,
                      float* __restrict__ partials,  // (gridDim.x, ld): block-major
                      long long ld, long long total, int j, long long j0, long long j_total,
                      int step0, int num_steps, float noise_scale, RoundKeys rk) {
  // per-warp energies of an interval of steps, row s + 1 for step s (row 0
  // takes the empty sum a step 0 writes), two intervals deep: a warp writing
  // interval c + 2 has passed interval c + 1's barrier, so warp 0 has finished
  // reading interval c; rows padded against bank conflicts
  __shared__ float red[2][INTERVAL + 1][WARPS + 1];
  const long long group0 = ((long long)blockIdx.x * THREADS + threadIdx.x) * GROUPS_PER_THREAD;
  const long long e0 = group0 * 4;

  // invalid elements (past the end) get zero coefficients: they never reach
  // the output and add 0 to the energy (their W stays finite)
  float w[ELEMENTS_PER_THREAD], dk[ELEMENTS_PER_THREAD], sk[ELEMENTS_PER_THREAD];
  float hs[ELEMENTS_PER_THREAD], bk[ELEMENTS_PER_THREAD];
#pragma unroll
  for (int k = 0; k < ELEMENTS_PER_THREAD; ++k) {
    const long long e = e0 + k;
    const bool valid = e < total;
    const long long row = valid ? e / j : 0;
    w[k] = valid ? w0[e] : 0.0f;
    dk[k] = valid ? decay[row] : 0.0f;
    sk[k] = valid ? shift[row] : 0.0f;
    hs[k] = valid ? 0.5f * sigma[row] : 0.0f;
    bk[k] = valid ? b[row] : 0.0f;
  }

  GroupConstants gc[GROUPS_PER_THREAD];
#pragma unroll
  for (int q = 0; q < GROUPS_PER_THREAD; ++q) {
    gc[q] = group_constants(run_group(group0 + q, j, j0, j_total), rk);
  }
  const float r2_scale = -1.3862943611198906f * noise_scale * noise_scale;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < num_steps; c0 += INTERVAL) {
    const int n = min(INTERVAL, num_steps - c0);
    float(*buf)[WARPS + 1] = red[(c0 / INTERVAL) & 1];
    float prev = 0.0f;  // this thread's energy of the step before
    for (int s = 0; s < n; ++s) {
      // the warp's sum of the step before, its shuffles free to overlap this
      // step's draws
      float v = prev;
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) buf[s][warp] = v;

      const uint32_t step = (uint32_t)(step0 + c0 + s);
      const uint32_t sh = __umulhi(PHILOX_M1, step), sl = PHILOX_M1 * step;
      float energy[GROUPS_PER_THREAD];
#pragma unroll
      for (int q = 0; q < GROUPS_PER_THREAD; ++q) {
        // the group's four draws times noise_scale
        float nz[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if constexpr (kNoise != Noise::kNone) {
          const uint4 bits = philox_bits(gc[q], sh, sl, rk);
          fast_pair(bits.x, bits.y, r2_scale, nz[0], nz[1]);
          fast_pair(bits.z, bits.w, r2_scale, nz[2], nz[3]);
        }
        energy[q] = 0.0f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = 4 * q + k;
          w[i] = __fadd_rn(__fadd_rn(__fmul_rn(dk[i], w[i]), sk[i]), nz[k]);
          energy[q] = fmaf(w[i], fmaf(hs[i], w[i], -bk[i]), energy[q]);
        }
      }
      prev = energy[0];
#pragma unroll
      for (int q = 1; q < GROUPS_PER_THREAD; ++q) prev += energy[q];
    }
    float v = prev;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) buf[n][warp] = v;
    __syncthreads();
    if (warp == 0 && lane < n) {
      v = 0.0f;
#pragma unroll
      for (int k = 0; k < WARPS; ++k) v += buf[lane + 1][k];
      partials[blockIdx.x * ld + c0 + lane] = v;
    }
  }

#pragma unroll
  for (int k = 0; k < ELEMENTS_PER_THREAD; ++k) {
    if (e0 + k < total) w_out[e0 + k] = w[k];
  }
}

}  // namespace

extern "C" int plst_spectral_train(const void* w0, void* w_out, const void* decay,
                                   const void* shift, const void* sigma, const void* b,
                                   void* partials, long long ld, long long total, int j,
                                   long long j0, long long j_total, int num_blocks, int step0,
                                   int num_steps, float noise_scale, unsigned long long seed,
                                   int zero_noise, void* stream) {
  if (total <= 0 || num_steps <= 0) return 0;
  const long long per_block = (long long)THREADS * ELEMENTS_PER_THREAD;
  if (j <= 0 || ld < num_steps || num_blocks != (int)((total + per_block - 1) / per_block)) {
    return (int)cudaErrorInvalidValue;
  }
  // a shard of columns: whole groups of four in every row (run_group)
  const bool sharded = j0 != 0 || j_total != j;
  if (j0 < 0 || j_total < j0 + j || (sharded && (j % 4 || j0 % 4 || j_total % 4))) {
    return (int)cudaErrorInvalidValue;
  }
  const RoundKeys rk = round_keys(plst::philox_key(seed));
  auto kernel =
      zero_noise ? spectral_train_kernel<Noise::kNone> : spectral_train_kernel<Noise::kFast>;
  kernel<<<num_blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w0), static_cast<float*>(w_out),
      static_cast<const float*>(decay), static_cast<const float*>(shift),
      static_cast<const float*>(sigma), static_cast<const float*>(b),
      static_cast<float*>(partials), ld, total, j, j0, j_total, step0, num_steps, noise_scale,
      rk);
  return (int)cudaGetLastError();
}
