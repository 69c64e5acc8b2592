// B2: ARD-RBF gram for Hopper (sm_90a).
//
// Replaces the TPU kernel projected_langevin_sampling_tpu/ops/pallas/gram.py
// (pallas_ard_gram / _gram_kernel) and computes what ops/kernels.py ard_gram
// computes, safeguards included:
//
//   out[i, j] = outputscale * exp(-0.5 * max(|x1_i|^2 + |x2_j|^2 - 2 x1_i.x2_j, 0))
//
// on inputs already divided by the lengthscales, with the squared distance of
// the diagonal set to exactly 0 when the caller says both inputs are the same.
//
// What bounds it: the output. D is small (1 to about 20), so the operations
// per output element are a few dozen while the kernel must write 4 or 8 bytes
// for each, far below the card's operations-per-byte line. So the design is
// about the stores:
//
// - D <= REGISTER_D (the main path has D = 1): no shared memory and no
//   barrier. A thread owns a strip of VEC consecutive columns (4 fp32 or 2
//   fp64, 16 bytes) in ROWS_PER_THREAD rows; it reads its columns' x2 rows
//   into registers once and sums their norms itself, reads each x1 row as a
//   broadcast load (the whole warp is on one row) and writes each row's strip
//   with one 16-byte store, a warp to 512 contiguous bytes. Where rows do not
//   start on 16 bytes (N2 not a multiple of VEC) the same strips go out as
//   scalar stores, masked at the ragged edge.
// - Larger D: 32 x 32 tiles of both inputs staged in shared memory, the D
//   loop in registers, one scalar store an element, a warp to a contiguous
//   line.
//
// launch() picks the path, the grid and the store width: 16-byte stores
// where every row starts on 16 bytes (an aligned output and N2 a multiple of
// VEC), else scalar stores. It refuses N1 beyond 65535 tiles of TILE_ROWS
// rows, the limit of gridDim.y.
//
// The outputscale is a host value, or, where `scale` is not null, the scalar
// at that device address: a GP's fitted outputscale is a tensor on the card,
// and a captured CUDA graph replays its launch with the value of each step.
//
// Precision: the cross term runs in true fp32 or fp64 on the CUDA cores (no
// tensor-core path, so no TF32). The distance is assembled with explicitly
// rounded adds and multiplies in the order the plain PyTorch expression uses,
// (|x1|^2 + |x2|^2) - 2 * cross, norms and cross summed over D in order, so
// the compiler cannot contract them into an FMA; for D = 1 (the main path)
// the distance is then bit-identical to the plain version and the 1-ulp
// cancellation error matches it instead of adding a second one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COL_THREADS = 32;  // blockDim.x: one warp across a row
constexpr int ROW_THREADS = 8;   // blockDim.y
constexpr int ROWS_PER_THREAD = 4;
constexpr int TILE_ROWS = ROW_THREADS * ROWS_PER_THREAD;  // x1 rows per block, both paths
constexpr int STAGED_COLS = 32;  // x2 rows per block on the staged path
constexpr int REGISTER_D = 8;    // largest D on the register path

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

// one 16-byte store of a row strip
__device__ __forceinline__ void store16(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(double* p, const double v[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// the kernel value of a squared norm pair and cross term, safeguards included
template <typename T>
__device__ __forceinline__ T gram_value(T n1, T n2, T cross, T outputscale, bool diagonal) {
  T d2 = sub_rn(add_rn(n1, n2), mul_rn(T(2), cross));
  d2 = d2 < T(0) ? T(0) : d2;  // NaN passes through, as in the plain version
  if (diagonal) d2 = T(0);
  return mul_rn(outputscale, exp_t(mul_rn(T(-0.5), d2)));
}

// D <= MAXD: the register path (MAXD = 1 for D = 1, else REGISTER_D)
template <typename T, int MAXD>
__global__ void __launch_bounds__(COL_THREADS * ROW_THREADS)
ard_gram_register_kernel(const T* __restrict__ x1, const T* __restrict__ x2, T* __restrict__ out,
                         int n1, int n2, int d, T outputscale, const T* __restrict__ scale,
                         int same, int vector_store) {
  if (scale != nullptr) outputscale = *scale;
  constexpr int VEC = 16 / sizeof(T);
  const int c0 = (blockIdx.x * COL_THREADS + threadIdx.x) * VEC;
  if (c0 >= n2) return;
  const int dd = MAXD == 1 ? 1 : d;

  // this strip's columns of x2 and their squared norms; columns past the
  // ragged edge read as 0 and are never stored
  T xc[VEC][MAXD], nc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const bool in = c0 + v < n2;
    nc[v] = T(0);
#pragma unroll
    for (int k = 0; k < MAXD; ++k) {
      if (k < dd) {
        xc[v][k] = in ? x2[(size_t)(c0 + v) * dd + k] : T(0);
        nc[v] = add_rn(nc[v], mul_rn(xc[v][k], xc[v][k]));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int r = blockIdx.y * TILE_ROWS + threadIdx.y + i * ROW_THREADS;
    if (r >= n1) break;
    T xr[MAXD], nr = T(0);
#pragma unroll
    for (int k = 0; k < MAXD; ++k) {
      if (k < dd) {
        xr[k] = x1[(size_t)r * dd + k];
        nr = add_rn(nr, mul_rn(xr[k], xr[k]));
      }
    }
    T o[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      T cross = T(0);
#pragma unroll
      for (int k = 0; k < MAXD; ++k) {
        if (k < dd) cross = add_rn(cross, mul_rn(xr[k], xc[v][k]));
      }
      o[v] = gram_value(nr, nc[v], cross, outputscale, same && r == c0 + v);
    }
    T* dst = out + (size_t)r * n2 + c0;
    if (vector_store) {
      store16(dst, o);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        if (c0 + v < n2) dst[v] = o[v];
      }
    }
  }
}

// D > REGISTER_D: both input tiles staged in shared memory
template <typename T>
__global__ void __launch_bounds__(STAGED_COLS * ROW_THREADS)
ard_gram_staged_kernel(const T* __restrict__ x1, const T* __restrict__ x2, T* __restrict__ out,
                       int n1, int n2, int d, T outputscale, const T* __restrict__ scale,
                       int same) {
  if (scale != nullptr) outputscale = *scale;
  extern __shared__ unsigned char smem_raw[];
  T* s1 = reinterpret_cast<T*>(smem_raw);  // (TILE_ROWS, d)
  T* s2 = s1 + TILE_ROWS * d;              // (STAGED_COLS, d)
  T* norm1 = s2 + STAGED_COLS * d;         // (TILE_ROWS,)
  T* norm2 = norm1 + TILE_ROWS;            // (STAGED_COLS,)

  const int row0 = blockIdx.y * TILE_ROWS;
  const int col0 = blockIdx.x * STAGED_COLS;
  const int tid = threadIdx.y * STAGED_COLS + threadIdx.x;
  const int nthreads = STAGED_COLS * ROW_THREADS;

  // stage both input tiles; rows past the ragged edge read as 0 and are
  // never stored
  for (int idx = tid; idx < TILE_ROWS * d; idx += nthreads) {
    const int r = row0 + idx / d;
    s1[idx] = r < n1 ? x1[(size_t)r * d + idx % d] : T(0);
  }
  for (int idx = tid; idx < STAGED_COLS * d; idx += nthreads) {
    const int c = col0 + idx / d;
    s2[idx] = c < n2 ? x2[(size_t)c * d + idx % d] : T(0);
  }
  __syncthreads();

  // squared norms, summed over D in order
  if (tid < TILE_ROWS) {
    T acc = T(0);
    for (int k = 0; k < d; ++k) acc = add_rn(acc, mul_rn(s1[tid * d + k], s1[tid * d + k]));
    norm1[tid] = acc;
  } else if (tid >= 32 && tid < 32 + STAGED_COLS) {
    const int c = tid - 32;
    T acc = T(0);
    for (int k = 0; k < d; ++k) acc = add_rn(acc, mul_rn(s2[c * d + k], s2[c * d + k]));
    norm2[c] = acc;
  }
  __syncthreads();

  const int c = threadIdx.x;
  const int gc = col0 + c;
  if (gc >= n2) return;
  const T nc = norm2[c];
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int r = threadIdx.y + i * ROW_THREADS;
    const int gr = row0 + r;
    if (gr >= n1) break;
    T cross = T(0);
    for (int k = 0; k < d; ++k) cross = add_rn(cross, mul_rn(s1[r * d + k], s2[c * d + k]));
    out[(size_t)gr * n2 + gc] = gram_value(norm1[r], nc, cross, outputscale, same && gr == gc);
  }
}

template <typename T>
int launch(const void* x1, const void* x2, void* out, int n1, int n2, int d, double outputscale,
           const void* scale_ptr, int same, void* stream) {
  if (n1 <= 0 || n2 <= 0) return 0;
  constexpr int VEC = 16 / sizeof(T);
  const bool registers = d <= REGISTER_D;
  const int cols = registers ? COL_THREADS * VEC : STAGED_COLS;
  const int grid_y = (n1 + TILE_ROWS - 1) / TILE_ROWS;
  if (d <= 0 || grid_y > 65535) return (int)cudaErrorInvalidValue;
  const int vector_store = reinterpret_cast<uintptr_t>(out) % 16 == 0 && n2 % VEC == 0;
  const dim3 grid((n2 + cols - 1) / cols, grid_y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* a = static_cast<const T*>(x1);
  const T* b = static_cast<const T*>(x2);
  T* o = static_cast<T*>(out);
  const T* scale = static_cast<const T*>(scale_ptr);
  if (registers) {
    const dim3 block(COL_THREADS, ROW_THREADS);
    if (d == 1) {
      ard_gram_register_kernel<T, 1><<<grid, block, 0, s>>>(
          a, b, o, n1, n2, d, static_cast<T>(outputscale), scale, same, vector_store);
    } else {
      ard_gram_register_kernel<T, REGISTER_D><<<grid, block, 0, s>>>(
          a, b, o, n1, n2, d, static_cast<T>(outputscale), scale, same, vector_store);
    }
  } else {
    const size_t smem =
        sizeof(T) * ((size_t)(TILE_ROWS + STAGED_COLS) * d + TILE_ROWS + STAGED_COLS);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          ard_gram_staged_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    ard_gram_staged_kernel<T><<<grid, dim3(STAGED_COLS, ROW_THREADS), smem, s>>>(
        a, b, o, n1, n2, d, static_cast<T>(outputscale), scale, same);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int plst_ard_gram_f32(const void* x1, const void* x2, void* out, int n1, int n2,
                                 int d, double outputscale, const void* scale, int same,
                                 void* stream) {
  return launch<float>(x1, x2, out, n1, n2, d, outputscale, scale, same, stream);
}

extern "C" int plst_ard_gram_f64(const void* x1, const void* x2, void* out, int n1, int n2,
                                 int d, double outputscale, const void* scale, int same,
                                 void* stream) {
  return launch<double>(x1, x2, out, n1, n2, d, outputscale, scale, same, stream);
}
