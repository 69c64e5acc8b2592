// The residual-smoothed Bernoulli cost and its derivative in one pass over F,
// for Hopper (sm_90a): the off tier's step on the card.
//
// Replaces no TPU kernel. The JAX package runs this quadrature as XLA
// elementwise code in its off tier, and the closed form inside B3
// (general_train.cu) runs in fp32 where the UCI mains state fp64. Done node by
// node in PyTorch it is about 250 elementwise kernels a step, 210 of them
// full (N, J) passes of 24 MB an operand at rice's shape. For F (N, J), labels
// y (N,), stds s (N,) and a Gauss-Hermite rule (x_q, w_q), q < Q:
//
//   dc[i, j] = (sum_q w_q sigmoid(F_ij + sqrt(2) s_i x_q)) / sqrt(pi) - y_i
//   cost[j]  = sum_i [(sum_q w_q softplus(F_ij + sqrt(2) s_i x_q)) / sqrt(pi)
//                     - y_i F_ij]
//
// with softplus(x) = max(x, 0) + log1p(e) and sigmoid(x) = 1 / (1 + e) for
// x >= 0, e / (1 + e) below, where e = exp(-|x|): one e a node serves both.
//
// What bounds it on this card: instruction issue, not bytes. F is read once
// and dc written once (49 MB at N = 3048, J = 1000: 0.015 ms at 3.35 TB/s);
// each element and node needs a log, a division and a few FMAs.
//
// Design.
//   - exp once an element, not once a node: with c_q = sqrt(2) s_i x_q,
//     exp(-|F + c_q|) is exp(-|F|) exp(-c_q) or exp(|F|) exp(-c_q) for
//     F + c_q >= 0, and exp(F) exp(c_q) below. A block computes exp(+-c_q) of
//     its rows once into shared memory, so a node costs a product where it
//     cost an exp. Where |F| + max_q |c_q| exceeds LIMIT (exp overflows near
//     709 in fp64, 88 in fp32) the element takes exp(-|F + c_q|) directly.
//   - quadrature_kernel, grid (J / COLS, N / rows_per_block): a block is COLS
//     columns by rows_per_block rows, a thread one column and every LANES-th
//     row, so a warp reads and writes 32 neighbouring elements of a row. The
//     rule's nodes are accumulated in the plain version's order (q = 0 .. Q-1,
//     then divided by sqrt(pi)). Each block writes one cost partial a column,
//     its rows summed in order, into partials[j * chunks + row block].
//   - a node's sigmoid and softplus (add_node): in fp64 one division gives
//     both 1 / (1 + e) and the log's argument, and the log is a polynomial
//     with no branch, where libdevice's log1p divides again and branches on
//     e; in fp32 the precise division and log1pf.
//   - column_sum_kernel, grid J: each column's partials summed in a fixed
//     order by plst::sum_partials. No atomics: a rerun is bitwise equal.
// fp64 inputs compute in fp64 throughout, fp32 inputs in fp32, with the
// precise exp and division (no fast-math intrinsics).

#include <cuda_runtime.h>
#include <math.h>

#include "langevin_common.cuh"

namespace {

constexpr int COLS = 128;  // columns a block, one a thread
constexpr int LANES = 2;   // threads a column in a block
constexpr int THREADS = COLS * LANES;

template <typename T>
struct Limits;
template <>
struct Limits<double> {
  static constexpr double LIMIT = 700.0;
  static constexpr double SQRT2 = 1.4142135623730951;
  static constexpr double SQRT_PI = 1.7724538509055159;
};
template <>
struct Limits<float> {
  static constexpr float LIMIT = 80.0f;
  static constexpr float SQRT2 = 1.41421356f;
  static constexpr float SQRT_PI = 1.77245385f;
};

__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float exp_(float x) { return expf(x); }

// fdlibm's minimax coefficients of log(1 + f) = f - (f^2/2 - s (f^2/2 + R(s^2)))
// with s = f / (2 + f), R(z) = z (LOG_POLY[0] + z (LOG_POLY[1] + ...)), for
// |s| <= 0.1716 (e_log.c: Lg1 .. Lg7), and ln 2 as a head with its low 21
// bits zero and a tail
__constant__ double LOG_POLY[7] = {
    6.666666666666735130e-01, 3.999999999940941908e-01, 2.857142874366239149e-01,
    2.222219843214978396e-01, 1.818357216161805012e-01, 1.531383769920937332e-01,
    1.479819860511658591e-01};
__constant__ double LN2_HI = 6.93147180369123816490e-01;
__constant__ double LN2_LO = 1.90821492927058770002e-10;

// One node: the sigmoid and softplus of x, given e = exp(-|x|), added with
// weight w to the two sums. fp32 takes the precise division and log1pf.
__device__ __forceinline__ void add_node(float x, float e, float w, float& acc_sigmoid,
                                         float& acc_softplus) {
  const float r = 1.0f / (1.0f + e);
  acc_sigmoid += w * (x >= 0.0f ? r : e * r);
  acc_softplus += w * ((x > 0.0f ? x : 0.0f) + log1pf(e));
}

// fp64: one division serves the sigmoid's 1 / (1 + e) and the log's s, and
// log1p(e) for e in [0, 1] is fdlibm's log of v = 1 + e, with no branch:
// v = 2^k m, m in [sqrt(1/2), sqrt(2)], k in {0, 1}, plus the rounding of
// 1 + e as (e - (v - 1)) / v. Within 2 ulp of log1p (held to it on the CPU by
// tests/test_torch_smoothed_quadrature.py), the sigmoid within 2 ulp.
__device__ __forceinline__ void add_node(double x, double e, double w, double& acc_sigmoid,
                                         double& acc_softplus) {
  const double v = 1.0 + e;                   // in [1, 2]
  const double k = v > 1.4142135623730951 ? 1.0 : 0.0;
  const double c = 1.0 + k;                   // 2^k
  const double f = v - c;                     // exact: c (m - 1)
  const double den = v + c;                   // c (2 + m - 1)
  const double d = 1.0 / (v * den);
  const double r = den * d;                   // 1 / (1 + e)
  const double s = (f * v) * d;               // (m - 1) / (m + 1)
  const double z = s * s;
  double p = LOG_POLY[6];
#pragma unroll
  for (int i = 5; i >= 0; --i) p = fma(z, p, LOG_POLY[i]);
  const double fm = k > 0.0 ? 0.5 * f : f;    // m - 1, exact
  const double hfsq = 0.5 * fm * fm;
  const double log_m = fm - (hfsq - s * (hfsq + z * p));
  const double log_v = fma(k, LN2_HI, log_m + k * LN2_LO);
  acc_sigmoid += w * (x >= 0.0 ? r : e * r);
  acc_softplus += w * ((x > 0.0 ? x : 0.0) + fma(e - (v - 1.0), r, log_v));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    quadrature_kernel(const T* __restrict__ f, const T* __restrict__ y, const T* __restrict__ s,
                      const T* __restrict__ nodes, const T* __restrict__ weights,
                      T* __restrict__ dc, T* __restrict__ partials, int n, int j, int q,
                      int rows_per_block) {
  // shared: w (q), then per row of the block c, exp(c), exp(-c) (q each),
  // then max |c| and y (one each)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w_s = reinterpret_cast<T*>(smem_raw);
  T* c_s = w_s + q;
  T* ep_s = c_s + rows_per_block * q;
  T* em_s = ep_s + rows_per_block * q;
  T* cmax_s = em_s + rows_per_block * q;
  T* y_s = cmax_s + rows_per_block;
  __shared__ T lane_sum[LANES][COLS];

  const int tid = threadIdx.y * COLS + threadIdx.x;
  const int row0 = blockIdx.y * rows_per_block;
  const int rows = min(rows_per_block, n - row0);
  for (int k = tid; k < q; k += THREADS) w_s[k] = weights[k];
  for (int k = tid; k < rows * q; k += THREADS) {
    const int r = k / q;
    const T c = (Limits<T>::SQRT2 * s[row0 + r]) * nodes[k - r * q];
    c_s[k] = c;
    ep_s[k] = exp_(c);
    em_s[k] = exp_(-c);
  }
  for (int r = tid; r < rows; r += THREADS) y_s[r] = y[row0 + r];
  __syncthreads();
  for (int r = tid; r < rows; r += THREADS) {
    T m = T(0);
    for (int k = 0; k < q; ++k) m = fmax(m, fabs(c_s[r * q + k]));
    cmax_s[r] = m;
  }
  __syncthreads();

  const int col = blockIdx.x * COLS + threadIdx.x;
  T part = T(0);
  if (col < j) {
    for (int r = threadIdx.y; r < rows; r += LANES) {
      const size_t idx = (size_t)(row0 + r) * (size_t)j + (size_t)col;
      const T fv = f[idx];
      const T af = fabs(fv);
      const T* c = c_s + r * q;
      T acc_sigmoid = T(0), acc_softplus = T(0);
      if (af + cmax_s[r] <= Limits<T>::LIMIT) {
        const T a = exp_(-af), b = exp_(af);
        const T lo = fv >= T(0) ? a : b;  // exp(-F): times exp(-c) where x >= 0
        const T hi = fv >= T(0) ? b : a;  // exp(F): times exp(c) where x < 0
        const T* ep = ep_s + r * q;
        const T* em = em_s + r * q;
#pragma unroll 4
        for (int k = 0; k < q; ++k) {
          const T x = fv + c[k];
          const T e = x >= T(0) ? lo * em[k] : hi * ep[k];
          add_node(x, e, w_s[k], acc_sigmoid, acc_softplus);
        }
      } else {
        for (int k = 0; k < q; ++k) {
          const T x = fv + c[k];
          add_node(x, exp_(-fabs(x)), w_s[k], acc_sigmoid, acc_softplus);
        }
      }
      dc[idx] = acc_sigmoid / Limits<T>::SQRT_PI - y_s[r];
      part += acc_softplus / Limits<T>::SQRT_PI - y_s[r] * fv;
    }
  }
  lane_sum[threadIdx.y][threadIdx.x] = part;
  __syncthreads();
  if (threadIdx.y == 0 && col < j) {
    T total = lane_sum[0][threadIdx.x];
    for (int l = 1; l < LANES; ++l) total += lane_sum[l][threadIdx.x];
    partials[(size_t)col * gridDim.y + blockIdx.y] = total;
  }
}

template <typename T>
__global__ void __launch_bounds__(plst::STOP_THREADS)
    column_sum_kernel(const T* __restrict__ partials, T* __restrict__ cost, int chunks) {
  __shared__ T red[plst::STOP_THREADS];
  const T total = plst::sum_partials(partials + (size_t)blockIdx.x * chunks, chunks, red);
  if (threadIdx.x == 0) cost[blockIdx.x] = total;
}

template <typename T>
size_t shared_bytes(int q, int rows_per_block) {
  return sizeof(T) * ((size_t)q + (size_t)rows_per_block * (3 * (size_t)q + 2));
}

template <typename T>
cudaError_t launch(const void* f, const void* y, const void* s, const void* nodes,
                   const void* weights, void* dc, void* cost, void* partials, int n, int j, int q,
                   int rows_per_block, cudaStream_t stream) {
  const size_t smem = shared_bytes<T>(q, rows_per_block);
  if (smem + sizeof(T) * THREADS > 48 * 1024) return cudaErrorInvalidValue;  // with lane_sum
  const int chunks = (n + rows_per_block - 1) / rows_per_block;
  if (chunks > 65535) return cudaErrorInvalidValue;
  const dim3 grid((j + COLS - 1) / COLS, chunks);
  quadrature_kernel<T><<<grid, dim3(COLS, LANES), smem, stream>>>(
      static_cast<const T*>(f), static_cast<const T*>(y), static_cast<const T*>(s),
      static_cast<const T*>(nodes), static_cast<const T*>(weights), static_cast<T*>(dc),
      static_cast<T*>(partials), n, j, q, rows_per_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  column_sum_kernel<T><<<j, plst::STOP_THREADS, 0, stream>>>(static_cast<const T*>(partials),
                                                             static_cast<T*>(cost), chunks);
  return cudaGetLastError();
}

}  // namespace

// Cost (J,) and dc (N, J) of F (N, J) on `stream`, no synchronisation: 2
// launches. All arrays are contiguous, of one type (is_double: fp64, else
// fp32); partials holds J * ceil(N / rows_per_block) values of scratch.
// Returns a CUDA error code, 0 on success.
extern "C" int plst_smoothed_bernoulli(const void* f, const void* y, const void* s,
                                       const void* nodes, const void* weights, void* dc,
                                       void* cost, void* partials, int n, int j, int q,
                                       int rows_per_block, int is_double, void* stream_ptr) {
  if (n <= 0 || j <= 0 || q <= 0 || rows_per_block <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return (int)(is_double ? launch<double>(f, y, s, nodes, weights, dc, cost, partials, n, j, q,
                                          rows_per_block, stream)
                         : launch<float>(f, y, s, nodes, weights, dc, cost, partials, n, j, q,
                                         rows_per_block, stream));
}
