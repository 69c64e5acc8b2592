// The block-level fp32 product of B3 (general_train.cu), B4
// (quadratic_train.cu) and B5 (fused_update.cu) on Hopper's tensor cores,
// with fp32 accuracy (3xTF32), an asynchronous-copy ring and a split-K
// reduction.
//
// Product. acc += A B on one BM x BN = 64 x 128 output tile, 8 warps of 32 x
// 32 each, with mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32. Every
// fp32 operand x is split in registers into hi = rna(x) and lo = rna(x - hi),
// both TF32 (to nearest, ties away from zero: cvt.rna.tf32.f32's rounding,
// done with an integer add and mask), and each 8-deep step accumulates
// a_lo b_hi, a_hi b_lo and a_hi b_hi into the same fp32 accumulator, small
// terms first. a_lo b_lo (about 2^-22 of a b) is dropped, so a product
// carries fp32-level error, not TF32's 2^-11 (ops/cuda/tc_product.py emulates
// the split on the CPU and its test holds it against fp32 and 1xTF32
// products). A step's fragments are loaded while the step before multiplies,
// and its 48 products go term by term over 16 independent accumulators.
//
// Ring. The depth goes through STAGES = 4 stages of BK = 32 in dynamic
// shared memory (106.5 KB, above the 48 KB default: every kernel that uses it
// needs cudaFuncSetAttribute first). cp.async copies 16 bytes a thread
// (4 bytes an element where a leading dimension or a base is not 16-byte
// aligned), zero-filling rows, columns and depths past the edge, and the
// loads of the next three stages are in flight while one computes. An (r, k)
// tile keeps rows of BK + 4 floats and a (k, r) or (k, c) tile rows of
// 64 + 8 or 128 + 8, so the fragment loads of a warp hit 32 different banks.
// Kernels bound their registers to 128 a thread (MIN_BLOCKS = 2), so two
// blocks share an SM and one's epilogue or split-K tail overlaps the other's
// products.
//
// Split-K. A product whose output has few tiles (B3's and B5's transposed
// products, B4's: 512 x 1000 outputs are 64 tiles against 132 SMs) runs S
// slices of its depth in separate blocks. Each writes its partial tile to a
// slab in fragment order (coalesced float4s), fences and bumps the tile's
// arrival counter; the block that arrives last sums slices 0 .. S-1 in that
// fixed order, so the result does not depend on which block came last and a
// rerun is bitwise equal, resets the counter to 0 for the next launch and
// runs the caller's epilogue (reduce_slices). B4's persistent kernel, whose
// blocks are all resident, has every block with a share of the tile wait for
// the others and sum that share instead (publish, wait_count).
//
// What bounds it: mma.sync's TF32 rate. The tensor cores' dense TF32 peak is
// 495 TFLOP/s, but mma.sync reaches only part of it on an H100, and three
// products per fp32 product divide that by three (scripts/mma_sync_ceiling.py
// measures the rate; PERF.md has the numbers). Inside B3 and B5 the products
// run below that ceiling: a block's loads, barriers and epilogue leave the
// tensor cores idle part of the time. Why not wgmma here: its .tf32 forms
// take both operands K-major from shared memory (the transpose flag exists
// only for 16-bit types), and the split would need hi and lo copies of every
// tile in shared memory. B3's forward sweep has moved to wgmma with TMA
// (general_train.cu, wgmma_tma.cuh): P and U^T are K-major there and are
// split once a run into TF32 halves in device memory. B3's update product
// (P^T dc, dc written each step), B4 and B5 still multiply here.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace plst {
namespace tc {

constexpr int BM = 64;          // rows of an output tile
constexpr int BN = 128;         // columns of an output tile
constexpr int BK = 32;          // depth of a shared-memory stage
constexpr int STAGES = 4;       // stages of the cp.async ring
constexpr int WARPS_M = 2;      // warps down a tile
constexpr int WARPS_N = 4;      // warps across a tile
constexpr int THREADS = 32 * WARPS_M * WARPS_N;  // 256
constexpr int WM = BM / WARPS_M;                 // 32 rows of a warp tile
constexpr int WN = BN / WARPS_N;                 // 32 columns of a warp tile
constexpr int MI = WM / 16;                      // m16n8k8 tiles down a warp tile
constexpr int NI = WN / 8;                       // ... and across it
constexpr int RK_STRIDE = BK + 4;                // a row of an (r, k) tile in shared memory
constexpr int AK_STRIDE = BM + 8;                // a row of a (k, r) tile
constexpr int BK_STRIDE = BN + 8;                // a row of a (k, c) tile
constexpr int A_STAGE = BM * RK_STRIDE > BK * AK_STRIDE ? BM * RK_STRIDE : BK * AK_STRIDE;
constexpr int B_STAGE = BK * BK_STRIDE;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) * (int)sizeof(float);  // 106.5 KB
// Kernels bound their registers to 128 a thread, so that two blocks share an
// SM and one's epilogue or split-K tail overlaps the other's products.
constexpr int MIN_BLOCKS = 2;
constexpr int TILE_FLOAT4 = BM * BN / 4;  // a partial tile in a split-K slab

// A thread's accumulators: acc[mi][ni][2 h + e] is element (frag_row(mi, h),
// frag_col(ni) + e) of the block's tile.
using Acc = float[MI][NI][4];

__device__ __forceinline__ int frag_row(int mi, int h) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp / WARPS_N) * WM + mi * 16 + (lane >> 2) + 8 * h;
}

__device__ __forceinline__ int frag_col(int ni) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp % WARPS_N) * WN + ni * 8 + 2 * (lane & 3);
}

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.0f;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// s[kk * STRIDE + xx] = m[(k0 + kk) ld + x0 + xx] for kk < BK, xx < WIDTH; 0
// where k >= k_end or x >= x_end. vec: 16-byte copies (ld and m 16-byte
// aligned, x0 a multiple of 4).
template <int WIDTH, int STRIDE>
__device__ __forceinline__ void load_kx(float* s, const float* __restrict__ m, int ld, int x0,
                                        int x_end, int k0, int k_end, bool vec) {
  constexpr int CHUNKS_PER_ROW = WIDTH / 4;
#pragma unroll
  for (int l = 0; l < BK * CHUNKS_PER_ROW / THREADS; ++l) {
    const int idx = threadIdx.x + l * THREADS;
    const int kk = idx / CHUNKS_PER_ROW, xx = (idx % CHUNKS_PER_ROW) * 4;
    const int k = k0 + kk, x = x0 + xx;
    float* dst = s + kk * STRIDE + xx;
    const bool k_ok = k < k_end;
    if (vec) {
      const int valid = k_ok ? max(0, min(4, x_end - x)) : 0;
      cp_async16(dst, valid > 0 ? m + (size_t)k * ld + x : m, 4 * valid);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = k_ok && x + e < x_end;
        cp_async4(dst + e, ok ? m + (size_t)k * ld + x + e : m, ok ? 4 : 0);
      }
    }
  }
}

// s[rr * RK_STRIDE + kk] = m[(r0 + rr) ld + k0 + kk] for rr < BM, kk < BK; 0
// where r >= r_end or k >= k_end. vec: 16-byte copies (ld, m and k0
// 16-byte aligned).
__device__ __forceinline__ void load_rk(float* s, const float* __restrict__ m, int ld, int r0,
                                        int r_end, int k0, int k_end, bool vec) {
  constexpr int CHUNKS_PER_ROW = BK / 4;
#pragma unroll
  for (int l = 0; l < BM * CHUNKS_PER_ROW / THREADS; ++l) {
    const int idx = threadIdx.x + l * THREADS;
    const int rr = idx / CHUNKS_PER_ROW, kk = (idx % CHUNKS_PER_ROW) * 4;
    const int r = r0 + rr, k = k0 + kk;
    float* dst = s + rr * RK_STRIDE + kk;
    const bool r_ok = r < r_end;
    if (vec) {
      const int valid = r_ok ? max(0, min(4, k_end - k)) : 0;
      cp_async16(dst, valid > 0 ? m + (size_t)r * ld + k : m, 4 * valid);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = r_ok && k + e < k_end;
        cp_async4(dst + e, ok ? m + (size_t)r * ld + k + e : m, ok ? 4 : 0);
      }
    }
  }
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero:
// half a TF32 unit added to the magnitude bits, the 13 low bits cleared. For
// finite x this is cvt.rna.tf32.f32 bit for bit (ops/cuda/tc_product.py's
// tf32_rna), in two integer instructions where ptxas lowers the cvt to a
// longer sequence with a compare and a select. The tensor cores read only
// the 19 high bits of the register.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo + O(2^-22 |x|), hi and lo TF32 bit patterns
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The fp32 fragments of the 8-deep step at kk of one stage. Fragments of
// m16n8k8: a[mi][q] is A(g + 8 (q & 1), t + 4 (q >> 1)) of m-tile mi, b[ni][h]
// is B(t + 4 h, g) of n-tile ni, g = lane / 4, t = lane % 4.
template <bool A_KMAJOR>
__device__ __forceinline__ void load_fragments(const float* as, const float* bs, int kk,
                                               float (&a)[MI][4], float (&b)[NI][2]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp / WARPS_N) * WM, wc = (warp % WARPS_N) * WN;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int h = 0; h < 2; ++h) b[ni][h] = bs[(kk + t + 4 * h) * BK_STRIDE + wc + ni * 8 + g];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = wr + mi * 16 + g + 8 * (q & 1), k = kk + t + 4 * (q >> 1);
      a[mi][q] = A_KMAJOR ? as[k * AK_STRIDE + r] : as[r * RK_STRIDE + k];
    }
}

// acc += the BK-deep product of one stage: the fragments of each 8-deep step
// are loaded while the step before multiplies, and the 3 x 16 products of a
// step go term by term, so that 16 independent accumulators separate two
// products into the same one.
template <bool A_KMAJOR>
__device__ __forceinline__ void mma_stage(const float* as, const float* bs, Acc& acc) {
  float a[2][MI][4], b[2][NI][2];
  load_fragments<A_KMAJOR>(as, bs, 0, a[0], b[0]);
#pragma unroll
  for (int step = 0; step < BK / 8; ++step) {
    const int cur = step & 1;
    if (step + 1 < BK / 8) load_fragments<A_KMAJOR>(as, bs, 8 * (step + 1), a[cur ^ 1], b[cur ^ 1]);
    uint32_t a_hi[MI][4], a_lo[MI][4], b_hi[NI][2], b_lo[NI][2];
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) split_tf32(b[cur][ni][h], b_hi[ni][h], b_lo[ni][h]);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int q = 0; q < 4; ++q) split_tf32(a[cur][mi][q], a_hi[mi][q], a_lo[mi][q]);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_tf32(acc[mi][ni], a_lo[mi], b_hi[ni]);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_tf32(acc[mi][ni], a_hi[mi], b_lo[ni]);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_tf32(acc[mi][ni], a_hi[mi], b_hi[ni]);
  }
}

__device__ __forceinline__ bool aligned16(const float* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// acc += sum_k A(row0 + r, k) B(k, col0 + c) over k in [k_begin, k_end) on
// the block's tile. A_KMAJOR: A(r, k) = a[k lda + r] (a (K, rows) matrix read
// as its transpose); else A(r, k) = a[r lda + k]. B(k, c) = b[k ldb + c].
// Rows >= rows, columns >= cols and depths >= k_end count as 0. smem holds
// SMEM_BYTES; every thread of the block calls this, and it returns with the
// ring drained and the block synchronised, so the caller may call it again.
template <bool A_KMAJOR>
__device__ __forceinline__ void product(const float* __restrict__ a, int lda, int rows,
                                        const float* __restrict__ b, int ldb, int cols,
                                        int k_begin, int k_end, int row0, int col0,
                                        float* smem, Acc& acc) {
  const int k_tiles = (k_end - k_begin + BK - 1) / BK;
  if (k_tiles <= 0) return;
  const bool vec_a = lda % 4 == 0 && aligned16(a) && (A_KMAJOR || k_begin % 4 == 0);
  const bool vec_b = ldb % 4 == 0 && aligned16(b);
  auto load = [&](int kt) {
    float* as = smem + (kt % STAGES) * (A_STAGE + B_STAGE);
    const int k0 = k_begin + kt * BK;
    if (A_KMAJOR) {
      load_kx<BM, AK_STRIDE>(as, a, lda, row0, rows, k0, k_end, vec_a);
    } else {
      load_rk(as, a, lda, row0, rows, k0, k_end, vec_a);
    }
    load_kx<BN, BK_STRIDE>(as + A_STAGE, b, ldb, col0, cols, k0, k_end, vec_b);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) load(s);
    cp_async_commit();  // empty groups keep the count uniform
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // stage kt has landed
    __syncthreads();              // ... for every thread, and stage kt - 1 is consumed
    if (kt + STAGES - 1 < k_tiles) load(kt + STAGES - 1);  // into stage kt - 1's slot
    cp_async_commit();
    const float* as = smem + (kt % STAGES) * (A_STAGE + B_STAGE);
    mma_stage<A_KMAJOR>(as, as + A_STAGE, acc);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The block's partial tile into slab `slice` of `tile`, in fragment order.
__device__ __forceinline__ void write_slab(const Acc& acc, float* __restrict__ slabs, int tile,
                                           int tiles, int slice) {
  float4* mine = reinterpret_cast<float4*>(slabs) + ((size_t)slice * tiles + tile) * TILE_FLOAT4;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
      mine[(mi * NI + ni) * THREADS + threadIdx.x] =
          make_float4(acc[mi][ni][0], acc[mi][ni][1], acc[mi][ni][2], acc[mi][ni][3]);
}

// Split-K: the block of slice `slice` of tile `tile` writes its partial to
// slabs (slices x tiles partial tiles); the last block of the tile to arrive
// gets the sum over slices 0 .. slices-1 in that order in acc, resets the
// tile's counter and returns true; the others return false. With one slice
// acc is already the total. Every thread of the block calls this.
__device__ __forceinline__ bool reduce_slices(Acc& acc, float* __restrict__ slabs,
                                              int* __restrict__ counters, int tile, int tiles,
                                              int slice, int slices) {
  if (slices == 1) return true;
  __shared__ int is_last;
  write_slab(acc, slabs, tile, tiles, slice);
  __threadfence();  // the partial is visible on the card before the count says so
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(&counters[tile], 1) == slices - 1;
  __syncthreads();
  if (!is_last) return false;
  __threadfence();
  const float4* first = reinterpret_cast<const float4*>(slabs) + (size_t)tile * TILE_FLOAT4;
  const size_t slice_step = (size_t)tiles * TILE_FLOAT4;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int i = (mi * NI + ni) * THREADS + threadIdx.x;
      float4 sum = __ldcg(first + i);  // L2, not a stale L1 line
      for (int s = 1; s < slices; ++s) {
        const float4 v = __ldcg(first + s * slice_step + i);
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      acc[mi][ni][0] = sum.x;
      acc[mi][ni][1] = sum.y;
      acc[mi][ni][2] = sum.z;
      acc[mi][ni][3] = sum.w;
    }
  if (threadIdx.x == 0) counters[tile] = 0;
  return true;
}

// Split-K in a persistent kernel whose blocks are all resident at once (a
// cooperative launch; B4): every block of a tile publishes its partial and
// bumps the tile's arrival counter; a block with a share of the tile then
// waits until the tile's other slices have arrived and sums that share of
// the tile's float4s (slab_sum), so the epilogue is spread over the tile's
// blocks instead of falling to the last. The counters only grow: a use
// waits for the count before it plus the tile's items, so no block resets
// them.

// Bump counters[tile] once every thread of the block has written what the
// count announces; the writes are visible on the card before the count is.
__device__ __forceinline__ void signal(int* __restrict__ counters, int tile) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(&counters[tile], 1);
  }
}

__device__ __forceinline__ void publish(const Acc& acc, float* __restrict__ slabs,
                                        int* __restrict__ counters, int tile, int tiles,
                                        int slice) {
  write_slab(acc, slabs, tile, tiles, slice);
  signal(counters, tile);
}

// Every thread of the block returns once counters[tile] has reached target;
// what was written before the counts is visible to its loads.
__device__ __forceinline__ void wait_count(const int* counters, int tile, int target) {
  if (threadIdx.x == 0) {
    int seen;
    do {
      asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(seen) : "l"(counters + tile)
                   : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

// The thread's float4 `i` of the fragments, i = (mi NI + ni) THREADS +
// threadIdx.x (elements 2 h + e of acc[mi][ni]), summed over slices
// [s_begin, s_end) of tile's partials in that order, read from L2, not from a
// stale L1 line. The loads of the first four slices are in flight together.
__device__ __forceinline__ float4 slab_sum(const float* __restrict__ slabs, int tile, int tiles,
                                           int s_begin, int s_end, int i) {
  const float4* first = reinterpret_cast<const float4*>(slabs) + (size_t)tile * TILE_FLOAT4 + i;
  const size_t slice_step = (size_t)tiles * TILE_FLOAT4;
  float4 v[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (s == 0 || s_begin + s < s_end) v[s] = __ldcg(first + (s_begin + s) * slice_step);
  }
  float4 sum = v[0];
  auto add = [&sum](const float4& w) {
    sum.x += w.x;
    sum.y += w.y;
    sum.z += w.z;
    sum.w += w.w;
  };
#pragma unroll
  for (int s = 1; s < 4; ++s) {
    if (s_begin + s < s_end) add(v[s]);
  }
  for (int s = s_begin + 4; s < s_end; ++s) add(__ldcg(first + s * slice_step));
  return sum;
}

constexpr int TILE_STRIDE = BN + 8;  // a row of a staged output tile: conflict-free float2 writes
static_assert(BM * TILE_STRIDE * (int)sizeof(float) <= SMEM_BYTES, "a staged tile fits the ring");

// Write the block's tile from the accumulators into smem, the drained ring,
// as a row-major BM x BN tile of row stride TILE_STRIDE, and synchronise, so
// that an epilogue can walk the tile in any order (rolled loops, coalesced
// stores).
__device__ __forceinline__ void stage(const Acc& acc, float* smem) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
        *reinterpret_cast<float2*>(smem + frag_row(mi, h) * TILE_STRIDE + frag_col(ni)) =
            make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
  __syncthreads();
}

// The depth of one slice of `depth` cut into `slices`: a multiple of BK, so
// every slice but the last starts and ends on a stage.
__device__ __forceinline__ int slice_depth(int depth, int slices) {
  const int per = (depth + slices - 1) / slices;
  return (per + BK - 1) / BK * BK;
}

}  // namespace tc
}  // namespace plst
