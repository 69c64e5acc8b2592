// B5: one fused Langevin update of the general tier for a closed-form cost,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel projected_langevin_sampling_tpu/ops/pallas/
// fused_update.py:134 (fused_langevin_update / _fused_update_kernel, with the
// dc closed forms of fused_update.py:46-75):
//
//   F  = P U + m0                        (N, M) x (M, J)
//   dc = d cost / d F, per element: Gaussian-identity, Bernoulli-sigmoid
//        (jitter clip), Poisson-square, Student-T-identity (cost_forms.cuh's
//        forms, the cost dropped)
//   U' = U - eta (D^T dc + prior(U)) + sqrt(2 eta) noise
//
// with prior(U) = prior * U for a diagonal prior (the orthonormal basis,
// 1 / lambda) or Prior U for a matrix (the inducing-point basis, M K^{-1}), D
// = P for the orthonormal basis and k(X, Z) for the inducing-point basis. The
// noise (S z for the inducing-point basis) comes in precomputed, as in the
// JAX package. The mean shift m0 is 0 in the TPU kernel; the port's
// langevin_steps passes the basis's mean constant.
//
// What bounds it on this card: operations. The two N products are 4 N M J
// flops (1.02e10 at N = 5000, M = 512, J = 1000) and a matrix prior adds
// 2 M^2 J (5.2e8), each run as three TF32 products on the tensor cores
// (0.065 ms at 495 TFLOP/s); dc is about 15-25 operations per element of F
// (about 1e8, 0.002 ms on the CUDA cores). The bytes (P, D, U, the noise, U'
// and y) are about 27 MB, 0.008 ms at 3.35 TB/s.
//
// Design. The TPU kernel accumulates the N axis of its grid in order into one
// output block. Blocks on the H100 run in no order, so the update is two
// launches on one stream, both products on the tensor cores in 3xTF32
// (tc_product.cuh: fp32 operands split into two TF32 halves, three products,
// error at the level of an fp32 product):
//   dc_kernel      grid (J tiles, N tiles): F tile = P tile U tile over K = M,
//                  then dc in the epilogue into an (N, J) scratch buffer (20
//                  MB at the shape above, which stays in the 50 MB L2); rows
//                  and columns past the edge are not written. Its first block
//                  also zeroes the update's split-K arrival counters;
//   update_kernel  grid (J tiles, M tiles, S slices): split-K over the depth
//                  of D^T dc (K = N) followed, for a matrix prior, by Prior U
//                  (K = M) in the same accumulator, the two laid end to end
//                  with N rounded up to a stage; the last block of a tile to
//                  arrive sums the S partial tiles in a fixed order and runs
//                  the update with the prior, the noise and eta.
// No atomic touches a value: a rerun is bitwise equal. At the headline the dc
// grid is 8 x 79 = 632 tiles of 64 x 128 and the update's 64 tiles take S = 4
// slices, 256 blocks (ops/cuda/tc_product.py picks S from the shape alone).
// D is read in either layout, (N, M) (P) or its transpose stored (M, N)
// (k(Z, X)), so neither is copied.
//
// Partial mode (the sharded step of parallel/sharded.py on a mesh whose data
// axis is more than 1): the same two launches over a data rank's rows,
// with the update kernel's depth N only, and its epilogue writing the
// split-K-reduced tile of D^T dc into u_out (M, J). The caller sums these
// over the data ranks and applies the prior, the noise and eta; the fused
// mode's code is unchanged.

#include <cuda_runtime.h>
#include <math.h>

#include "cost_forms.cuh"
#include "tc_product.cuh"

namespace {

using namespace plst::costs;
namespace tc = plst::tc;
using tc::BK;
using tc::BM;
using tc::BN;
using tc::THREADS;

// F = P U + m0 on one (N, J) tile, then dc (p0 is the Bernoulli kind's
// jitter); block (0, 0) also zeroes the update's arrival counters.
template <int KIND>
__global__ void __launch_bounds__(THREADS, tc::MIN_BLOCKS)
dc_kernel(const float* __restrict__ p, const float* __restrict__ u, const float* __restrict__ y,
          float* __restrict__ dc, int* __restrict__ counters, int n_counters, int n, int m, int j,
          CostParams cp) {
  if (blockIdx.x == 0 && blockIdx.y == 0) {
    for (int i = threadIdx.x; i < n_counters; i += THREADS) counters[i] = 0;
  }
  extern __shared__ __align__(16) float smem[];
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  tc::Acc acc;
  tc::zero(acc);
  tc::product<false>(p, m, n, u, j, j, 0, m, row0, col0, smem, acc);
  tc::stage(acc, smem);
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {  // a warp on 32 columns of a row
    const int r = row0 + e / BN, c = col0 + e % BN;
    if (r < n && c < j) {
      float cost, d;
      cost_and_dc<KIND>(smem[(e / BN) * tc::TILE_STRIDE + e % BN] + cp.m0, y[r], 0.0f, true,
                        cp.p0, cp, cost, d);
      dc[(size_t)r * j + c] = d;
    }
  }
}

// U' = U - eta (D^T dc + prior(U)) + root2eta noise on one (M, J) tile:
// slice blockIdx.z of the depth N (+ M for a matrix prior), then the update
// in the tile's last block to arrive. D_KMAJOR: d is D (N, M); else d is D^T
// stored (M, N). PARTIAL (with PRIOR_DIAG, so the depth is N): the tile of
// D^T dc itself goes to u_out, and u, prior and noise are not read.
template <bool D_KMAJOR, bool PRIOR_DIAG, bool PARTIAL>
__global__ void __launch_bounds__(THREADS, tc::MIN_BLOCKS)
update_kernel(const float* __restrict__ d, const float* __restrict__ dc,
              const float* __restrict__ u, const float* __restrict__ prior,
              const float* __restrict__ noise, float* __restrict__ u_out,
              float* __restrict__ slabs, int* __restrict__ counters, int n, int m, int j,
              int slices, float eta, float root2eta) {
  extern __shared__ __align__(16) float smem[];
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x, tiles = gridDim.x * gridDim.y;
  // depth [0, N) is D^T dc; [n_pad, n_pad + M) is Prior U
  const int n_pad = (n + BK - 1) / BK * BK;
  const int depth = PRIOR_DIAG ? n : n_pad + m;
  const int k_slice = tc::slice_depth(depth, slices);
  const int k_begin = blockIdx.z * k_slice, k_end = min(depth, k_begin + k_slice);
  tc::Acc acc;
  tc::zero(acc);
  if (k_begin < n) {
    tc::product<D_KMAJOR>(d, D_KMAJOR ? m : n, m, dc, j, j, k_begin, min(k_end, n), row0, col0,
                          smem, acc);
  }
  if (!PRIOR_DIAG && k_end > n_pad) {
    tc::product<false>(prior, m, m, u, j, j, max(k_begin, n_pad) - n_pad, k_end - n_pad, row0,
                       col0, smem, acc);
  }
  if (!tc::reduce_slices(acc, slabs, counters, tile, tiles, blockIdx.z, slices)) return;
  tc::stage(acc, smem);
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {  // a warp on 32 columns of a row
    const int r = row0 + e / BN, c = col0 + e % BN;
    if (r >= m || c >= j) continue;
    const size_t k = (size_t)r * j + c;
    const float g = smem[(e / BN) * tc::TILE_STRIDE + e % BN];
    if (PARTIAL) {
      u_out[k] = g;
      continue;
    }
    const float uv = u[k];
    const float drift = PRIOR_DIAG ? g + prior[r] * uv : g;
    u_out[k] = uv - eta * drift + root2eta * noise[k];
  }
}

template <typename Kernel>
cudaError_t allow_ring(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::SMEM_BYTES);
}

template <int KIND>
cudaError_t launch_dc(dim3 grid, cudaStream_t stream, const float* p, const float* u,
                      const float* y, float* dc, int* counters, int n_counters, int n, int m,
                      int j, const CostParams& cp) {
  cudaError_t err = allow_ring(dc_kernel<KIND>);
  if (err != cudaSuccess) return err;
  dc_kernel<KIND><<<grid, THREADS, tc::SMEM_BYTES, stream>>>(p, u, y, dc, counters, n_counters, n,
                                                             m, j, cp);
  return cudaGetLastError();
}

template <bool D_KMAJOR, bool PRIOR_DIAG, bool PARTIAL = false>
cudaError_t launch_update(dim3 grid, cudaStream_t stream, const float* d, const float* dc,
                          const float* u, const float* prior, const float* noise, float* u_out,
                          float* slabs, int* counters, int n, int m, int j, float eta,
                          float root2eta) {
  cudaError_t err = allow_ring(update_kernel<D_KMAJOR, PRIOR_DIAG, PARTIAL>);
  if (err != cudaSuccess) return err;
  update_kernel<D_KMAJOR, PRIOR_DIAG, PARTIAL><<<grid, THREADS, tc::SMEM_BYTES, stream>>>(
      d, dc, u, prior, noise, u_out, slabs, counters, n, m, j, (int)grid.z, eta, root2eta);
  return cudaGetLastError();
}

}  // namespace

// One update on `stream`, no synchronisation: 2 launches. d_kmajor: d is D
// (N, M) row-major, else D^T (M, N) row-major. prior_diag: prior is (M,),
// else (M, M). dc is an (N, J) scratch buffer; counters holds one int per
// update tile (M, J) and slabs `slices` partial tiles per update tile when
// slices > 1 (tc_product.cuh; ops/cuda/tc_product.py sizes them). partial:
// u_out gets D^T dc (M, J) over these N rows and prior, noise, prior_diag and
// eta are not used (slices then cut the depth N alone). kind is an index of
// cost_forms.cuh's CostKind; one this kernel has no instance of is refused.
// Returns a CUDA error code, 0 on success.
extern "C" int plst_fused_update(const void* p, const void* d, const void* y, const void* u,
                                 const void* prior, const void* noise, void* dc, void* u_out,
                                 void* slabs, void* counters, int n, int m, int j, int d_kmajor,
                                 int prior_diag, int partial, int kind, int slices, float p0,
                                 float p1, float m0, float eta, void* stream_ptr) {
  if (n <= 0 || m <= 0 || j <= 0 || slices < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  CostParams cp{};
  cp.p0 = p0;
  cp.p1 = p1;
  cp.m0 = m0;
  const float* pp = static_cast<const float*>(p);
  const float* up = static_cast<const float*>(u);
  const float* yp = static_cast<const float*>(y);
  float* dcp = static_cast<float*>(dc);
  float* slabp = static_cast<float*>(slabs);
  int* cnt = static_cast<int*>(counters);
  const dim3 grid_dc((j + BN - 1) / BN, (n + BM - 1) / BM);
  const dim3 grid_up((j + BN - 1) / BN, (m + BM - 1) / BM, slices);
  const int n_counters = (int)(grid_up.x * grid_up.y);
  cudaError_t err;
  switch (kind) {
    case GAUSSIAN:
      err = launch_dc<GAUSSIAN>(grid_dc, stream, pp, up, yp, dcp, cnt, n_counters, n, m, j, cp);
      break;
    case BERNOULLI_SIGMOID:
      err = launch_dc<BERNOULLI_SIGMOID>(grid_dc, stream, pp, up, yp, dcp, cnt, n_counters, n, m,
                                         j, cp);
      break;
    case POISSON_SQUARE:
      err = launch_dc<POISSON_SQUARE>(grid_dc, stream, pp, up, yp, dcp, cnt, n_counters, n, m, j,
                                      cp);
      break;
    case STUDENT_T:
      err = launch_dc<STUDENT_T>(grid_dc, stream, pp, up, yp, dcp, cnt, n_counters, n, m, j, cp);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const float* dp_ = static_cast<const float*>(d);
  const float* prp = static_cast<const float*>(prior);
  const float* np_ = static_cast<const float*>(noise);
  float* outp = static_cast<float*>(u_out);
  const float root2eta = sqrtf(2.0f * eta);
  if (partial) {
    err = d_kmajor ? launch_update<true, true, true>(grid_up, stream, dp_, dcp, up, prp, np_,
                                                     outp, slabp, cnt, n, m, j, eta, root2eta)
                   : launch_update<false, true, true>(grid_up, stream, dp_, dcp, up, prp, np_,
                                                      outp, slabp, cnt, n, m, j, eta, root2eta);
  } else if (d_kmajor) {
    err = prior_diag ? launch_update<true, true>(grid_up, stream, dp_, dcp, up, prp, np_, outp,
                                                 slabp, cnt, n, m, j, eta, root2eta)
                     : launch_update<true, false>(grid_up, stream, dp_, dcp, up, prp, np_, outp,
                                                  slabp, cnt, n, m, j, eta, root2eta);
  } else {
    err = prior_diag ? launch_update<false, true>(grid_up, stream, dp_, dcp, up, prp, np_, outp,
                                                  slabp, cnt, n, m, j, eta, root2eta)
                     : launch_update<false, false>(grid_up, stream, dp_, dcp, up, prp, np_, outp,
                                                   slabp, cnt, n, m, j, eta, root2eta);
  }
  return (int)err;
}
