// B4: the whole quadratic-tier Langevin training run in M space, for Hopper
// (sm_90a), in one persistent launch.
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
// 2 M^2 J = 5.2e8 flops, run as three TF32 products on the tensor cores
// (tc_product.cuh, 3xTF32: fp32-level error): a non-shared step is 4.72e9
// TF32 flops, 9.5 us at 495 TFLOP/s, a shared one 3.2 us. The 41 operations
// per element of U (Philox and Box-Muller, the update, the energy) are 0.31
// us at 67 TFLOP/s. A, E, S, U, the normals and the split-K slabs (about 30
// MB) stay in the 50 MB L2, so bytes do not bind.
//
// Design. The TPU kernel runs the steps in one program with everything in
// VMEM. Here the run is one cooperative launch of as many blocks as the card
// holds at once (two an SM: tc_product.cuh's 128-register cap and its
// 106.5 KB ring), and a step is one phase and one grid-wide barrier
// (cooperative_groups' grid.sync), so the host queues one launch a run. The
// products of a step all multiply what is known at its start, so phase t
// runs them together on U_t: A U_t, and when not shared E U_t and S eps_t,
// as work items (product, tile, slice) of 64 x 128 tiles over slices of the
// depth M (split-K). Block b owns items b, b + grid, ... of every phase and
// runs each through tc::product's cp.async ring. Every item writes its partial
// tile and bumps its tile's arrival counter; then each item with a share of
// its tile waits for the tile's other items (all blocks are resident, so the
// wait ends) and finishes that share, each sum over its slices in order:
// U_{t+1} = U_t - eta (A U_t - b) + sqrt(2 eta) eps, eps = S eps_t (eps_t
// when shared: S = I), and the energy terms of U_t, 0.5 U_t (E U_t) - e_bias
// U_t (E = A when shared), which the block sums into one partial. Before the
// waits it draws the next step's normals into the other of two buffers.
// After the barrier every block sums the blocks' partials in one fixed order
// and steps its own copy of the stopper with the energy of update t - 1, so
// all blocks take the same decision; block 0 writes the energy. A stop at
// update t - 1 leaves U_t final and drops U_{t+1}; phase T gives the last
// energy. The particles are copied into u_a if they ended in u_b. A, S and E
// are streamed from L2 each step: each block owns items of all three
// operators, whose slices do not fit beside the ring, and a block that kept
// its slice of E resident was no faster (PERF.md).
//
// A run with the same seed is bitwise reproducible: an item's sum depends
// only on the shape, the slices are summed in a fixed order, a block's items
// and the blocks' partials too (the grid is the card's), and no atomic
// touches a value. Noise: Philox4x32-10 (philox.cuh) counted on (column
// group of 4, row, step, STREAM_ID), so the draws do not depend on the
// tiling or the grid. The column group is the whole run's: a shard of
// columns j0 .. j0 + j of a j_total-column run (a particle shard of
// parallel/auto.py; j0 a multiple of 4) draws exactly the normals of those
// columns in the unsharded run, and its energies are its share, its sums
// over j_total.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "langevin_common.cuh"
#include "philox.cuh"
#include "tc_product.cuh"

namespace {

namespace cg = cooperative_groups;
namespace tc = plst::tc;
using plst::StopState;
using tc::BM;
using tc::BN;
using tc::MI;
using tc::NI;
using tc::THREADS;
static_assert(THREADS == plst::THREADS, "block_sum sums one value per thread of 8 warps");

constexpr uint32_t STREAM_ID = 2u;  // the fourth Philox counter word of this kernel
constexpr int GROUP = 4;            // columns of one Philox call

struct Run {
  const float* a;
  const float* e;
  const float* s;
  const float* b;
  const float* e_bias;
  float* u_a;
  float* u_b;
  float* eps;  // two (M, J) buffers: the normals of even steps, then of odd ones
  float* slabs;
  int* arrived;  // per tile: items published, only growing
  double* partials;  // one a block, two sets by the parity of the phase
  float* energies;
  int m, j, num_steps, shared, zero_noise;
  int j0;  // the run's column of local column 0 (a multiple of GROUP)
  int products;  // of a phase: A U, then E U (non-shared), then S eps (non-shared, noise)
  int slices;    // of the depth M of each product
  float eta, root2eta, patience;
  double inv_j, e_const;
  uint2 key;
};

// The (M, J) normals of `step`.
__device__ __forceinline__ float* step_eps(const Run& r, int step) {
  return r.eps + (size_t)(step & 1) * r.m * r.j;
}

// The normals of `step` into their buffer: one Philox call for each (row,
// column group of 4), grid-stride.
__device__ __forceinline__ void draw_normals(const Run& r, int step) {
  float* eps = step_eps(r, step);
  const int groups = (r.j + GROUP - 1) / GROUP;
  for (int idx = blockIdx.x * THREADS + threadIdx.x; idx < r.m * groups;
       idx += gridDim.x * THREADS) {
    const int row = idx / groups, cgroup = idx % groups;
    float z[4];
    plst::normals4(
        make_uint4((uint32_t)(cgroup + r.j0 / GROUP), (uint32_t)row, (uint32_t)step, STREAM_ID),
        r.key, z);
#pragma unroll
    for (int jj = 0; jj < GROUP; ++jj) {
      const int c = cgroup * GROUP + jj;
      if (c < r.j) eps[(size_t)row * r.j + c] = z[jj];
    }
  }
}

// (row, column) of element q = 2 h + e of the thread's float4 f = mi NI + ni of
// a tile at (row0, col0)
__device__ __forceinline__ int frag_r(int row0, int f, int q) {
  return row0 + tc::frag_row(f / NI, q >> 1);
}
__device__ __forceinline__ int frag_c(int col0, int f, int q) {
  return col0 + tc::frag_col(f % NI) + (q & 1);
}

__device__ __forceinline__ float at(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// Phase t: the products of U_t over items (product, tile, slice), product 0
// A U_t, 1 E U_t (non-shared), 2 S eps_t (non-shared, with noise). The
// block's items publish their partials (tc::product each); then `between`
// (work that needs no slab); then each of them with a share of its tile
// (float4s f = its index among the tile's items, plus multiples of their
// count) waits for the tile's other items, adds the energy terms 0.5 U_t (E
// U_t) - e_bias U_t into the block's partial, and unless `last` writes
// U_{t+1} = U_t - eta (A U_t - b) + sqrt(2 eta) eps with eps = S eps_t
// (non-shared) or eps_t (shared).
template <typename Between>
__device__ __forceinline__ void phase(const Run& r, const float* __restrict__ u,
                                      float* __restrict__ u_next, int t, bool last,
                                      double* partials, float* smem, double (&red)[plst::WARPS],
                                      int tiles, int tiles_x, int& arrived, Between between) {
  const int per_tile = r.products * r.slices;  // items of a tile
  const int items = tiles * per_tile;
  const int k_slice = tc::slice_depth(r.m, r.slices);
  const float* eps = step_eps(r, t);
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int tile = item % tiles, index = item / tiles, product = index / r.slices;
    const int k_begin = (index % r.slices) * k_slice;
    tc::Acc acc;
    tc::zero(acc);
    tc::product<false>(product == 0 ? r.a : product == 1 ? r.e : r.s, r.m, r.m,
                       product == 2 ? eps : u, r.j, r.j, k_begin, min(r.m, k_begin + k_slice),
                       (tile / tiles_x) * BM, (tile % tiles_x) * BN, smem, acc);
    tc::publish(acc, r.slabs, r.arrived, tile, tiles, index);
  }
  between();
  const bool noise = !r.zero_noise;
  double block_local = 0.0;  // the block's energy terms, over its items in order
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int tile = item % tiles, index = item / tiles;
    if (index >= MI * NI) continue;  // no share of the tile: nothing to wait for
    const int row0 = (tile / tiles_x) * BM, col0 = (tile % tiles_x) * BN;
    tc::wait_count(r.arrived, tile, arrived + per_tile);
    float local = 0.0f;
    for (int f = index; f < MI * NI; f += per_tile) {
      const int i = f * THREADS + threadIdx.x;
      const float4 au = tc::slab_sum(r.slabs, tile, tiles, 0, r.slices, i);
      const float4 eu =
          r.shared ? au : tc::slab_sum(r.slabs, tile, tiles, r.slices, 2 * r.slices, i);
      const float4 se = r.shared || !noise
                            ? au
                            : tc::slab_sum(r.slabs, tile, tiles, 2 * r.slices, 3 * r.slices, i);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = frag_r(row0, f, q), c = frag_c(col0, f, q);
        if (row >= r.m || c >= r.j) continue;
        const size_t k = (size_t)row * r.j + c;
        const float uv = __ldcg(u + k);
        local += 0.5f * (uv * at(eu, q)) - r.e_bias[row] * uv;
        if (last) continue;
        float un = uv - r.eta * (at(au, q) - r.b[row]);
        if (noise) un = un + r.root2eta * (r.shared ? __ldcg(eps + k) : at(se, q));
        u_next[k] = un;
      }
    }
    block_local += (double)local;
  }
  const double total = plst::block_sum(block_local, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
  arrived += per_tile;
}

// The card's own record of the run kernel, read by record(): the runs it
// started (a count that only grows) and the nanoseconds of the last one,
// from block 0's start to its end on the card's global timer.
__device__ unsigned long long g_runs = 0;
__device__ long long g_last_run_ns = 0;

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__global__ void __launch_bounds__(THREADS, tc::MIN_BLOCKS) quadratic_run_kernel(const Run r) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double red_warps[plst::WARPS];
  __shared__ StopState state;  // this block's copy of the stopper
  __shared__ int stopped;
  __shared__ long long started;  // block 0's, for the record
  cg::grid_group grid = cg::this_grid();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    started = global_ns();
    atomicAdd(&g_runs, 1ull);
  }
  const int tiles_x = (r.j + BN - 1) / BN;
  const int tiles = tiles_x * ((r.m + BM - 1) / BM);
  const int n_partials = gridDim.x;  // one energy partial a block
  if (threadIdx.x == 0) {
    state.min_loss = INFINITY;
    state.last_improved = -1;
    state.stopped = 0;
    state.unused = 0;
    stopped = 0;
  }
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < tiles; i += gridDim.x * THREADS) {
    r.arrived[i] = 0;
  }
  if (!r.zero_noise) draw_normals(r, 0);
  grid.sync();

  // Phase t multiplies U_t: its epilogue writes U_{t+1} and the energy of
  // U_t, the energy of update t - 1, which the stopper reads after the
  // barrier. Phase T only gives the last energy. Once stopped at update
  // t - 1, U_t is final; U_{t+1}, in the other buffer, is dropped.
  int arrived = 0;  // per tile so far, the same in every block
  float* u = r.u_a;
  float* u_next = r.u_b;
  for (int t = 0;; ++t) {
    const bool last = t == r.num_steps;
    // two sets of partials, by the parity of t: without a barrier between
    // the stopper and the next phase's epilogue, a block may write the next
    // partials while another still sums these
    double* partials = r.partials + (size_t)(t & 1) * n_partials;
    // the next step's normals (into the other buffer) fill the wait for the
    // tile's other items
    auto next_normals = [&] {
      if (!r.zero_noise && !last) draw_normals(r, t + 1);
    };
    phase(r, u, u_next, t, last, partials, smem, red_warps, tiles, tiles_x, arrived,
          next_normals);
    grid.sync();
    if (t > 0) {  // every block: the energy of update t - 1 and its own copy of the stopper
      double partial_sum = 0.0;
      for (int i = threadIdx.x; i < n_partials; i += THREADS) partial_sum += __ldcg(partials + i);
      const double total = plst::block_sum(partial_sum, red_warps);  // thread 0's
      if (threadIdx.x == 0) {
        const float e = plst::step_stopper((float)(total * r.inv_j + r.e_const), t - 1, r.eta,
                                           r.patience, &state);
        if (blockIdx.x == 0) r.energies[t - 1] = e;
        stopped = state.stopped;
      }
      __syncthreads();
    }
    if (last || stopped) break;
    float* tmp = u;
    u = u_next;
    u_next = tmp;
  }
  if (u != r.u_a) {  // the final particles go where the wrapper reads them
    const size_t n = (size_t)r.m * r.j;
    for (size_t k = (size_t)blockIdx.x * THREADS + threadIdx.x; k < n;
         k += (size_t)gridDim.x * THREADS) {
      r.u_a[k] = __ldcg(u + k);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) g_last_run_ns = global_ns() - started;
}

cudaError_t coresident(int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      quadratic_run_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  int per_sm = 0, device = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, quadratic_run_kernel, THREADS,
                                                      tc::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *blocks = per_sm * sms;
  return err;
}

}  // namespace

// The card's record of the run kernel: runs started so far, and the
// nanoseconds of the last (block 0's start to its end). Synchronises the
// device; returns a CUDA error code.
extern "C" int plst_quadratic_record(unsigned long long* runs, long long* last_run_ns) {
  cudaError_t err = cudaMemcpyFromSymbol(runs, g_runs, sizeof(*runs));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyFromSymbol(last_run_ns, g_last_run_ns, sizeof(*last_run_ns));
}

// The blocks of the run kernel that the current card holds at once: the
// largest grid a cooperative launch takes. Returns a CUDA error code.
extern "C" int plst_quadratic_coresident(int* blocks) { return (int)coresident(blocks); }

// One whole run on `stream`: one cooperative launch, no synchronisation. u_a
// holds U0 on entry and the final particles on exit; u_b is an (M, J)
// scratch buffer, eps two of them (unread without noise). energies (T) must
// be NaN-filled by the caller. arrived holds one int per 64 x 128 tile of
// (M, J), slabs one partial tile per item (products x slices x tiles),
// partials two doubles per block, at most two per item
// (ops/cuda/tc_product.py's persistent_phase sizes them). The particles are
// columns j0 .. j0 + j of a j_total-column run (j0 = 0, j_total = j
// unsharded): the noise is counted on the run's column and the energies are
// sums over j_total. Returns a CUDA error code, 0 on success: a launch the card
// refuses returns its error.
extern "C" int plst_quadratic_train(const void* a, const void* e, const void* s, const void* b,
                                    const void* e_bias, void* u_a, void* u_b, void* eps,
                                    void* slabs, void* arrived, void* partials, void* energies,
                                    int m, int j, int j0, int j_total, int num_steps, int shared,
                                    int slices, float eta, float patience, double e_const,
                                    unsigned long long seed, int zero_noise, void* stream_ptr) {
  if (m <= 0 || j <= 0 || num_steps < 0 || slices < 1) return (int)cudaErrorInvalidValue;
  if (j0 < 0 || j0 % GROUP || j_total < j0 + j) return (int)cudaErrorInvalidValue;
  if (num_steps == 0) return 0;
  int blocks = 0;
  cudaError_t err = coresident(&blocks);
  if (err != cudaSuccess) return (int)err;
  Run r;
  r.products = shared ? 1 : zero_noise ? 2 : 3;
  r.slices = slices;
  const int items = ((j + BN - 1) / BN) * ((m + BM - 1) / BM) * r.products * slices;
  const int grid = blocks < items ? blocks : items;  // 0 if the kernel does not fit: refused
  r.a = static_cast<const float*>(a);
  r.e = static_cast<const float*>(e);
  r.s = static_cast<const float*>(s);
  r.b = static_cast<const float*>(b);
  r.e_bias = static_cast<const float*>(e_bias);
  r.u_a = static_cast<float*>(u_a);
  r.u_b = static_cast<float*>(u_b);
  r.eps = static_cast<float*>(eps);
  r.slabs = static_cast<float*>(slabs);
  r.arrived = static_cast<int*>(arrived);
  r.partials = static_cast<double*>(partials);
  r.energies = static_cast<float*>(energies);
  r.m = m;
  r.j = j;
  r.j0 = j0;
  r.num_steps = num_steps;
  r.shared = shared;
  r.zero_noise = zero_noise;
  r.eta = eta;
  r.root2eta = sqrtf(2.0f * eta);
  r.patience = patience;
  r.inv_j = 1.0 / (double)j_total;
  r.e_const = e_const;
  r.key = plst::philox_key(seed);
  void* args[] = {&r};
  return (int)cudaLaunchCooperativeKernel((const void*)quadratic_run_kernel, dim3(grid),
                                          dim3(THREADS), args, tc::SMEM_BYTES,
                                          static_cast<cudaStream_t>(stream_ptr));
}
