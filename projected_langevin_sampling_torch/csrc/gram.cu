// B2: tiled ARD-RBF gram for Hopper (sm_90a).
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
// for each, which is far below the card's operations-per-byte line. The design
// therefore reads each input row once per tile from shared memory, keeps the
// D loop in registers and writes every output element once, with neighbouring
// threads on neighbouring columns so each warp stores one contiguous line.
//
// Precision: the cross term runs in true fp32 or fp64 on the CUDA cores (no
// tensor-core path, so no TF32). The distance is assembled with explicitly
// rounded adds and multiplies in the order the plain PyTorch expression uses,
// (|x1|^2 + |x2|^2) - 2 * cross, so the compiler cannot contract them into an
// FMA; for D = 1 (the main path) the distance is then bit-identical to the
// plain version and the 1-ulp cancellation error matches it instead of adding
// a second one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_COLS = 32;  // x2 rows per block: one per lane
constexpr int TILE_ROWS = 32;  // x1 rows per block
constexpr int ROW_THREADS = 8;  // blockDim.y; each thread covers TILE_ROWS / 8 rows

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

template <typename T>
__global__ void __launch_bounds__(TILE_COLS * ROW_THREADS)
ard_gram_kernel(const T* __restrict__ x1, const T* __restrict__ x2, T* __restrict__ out,
                int n1, int n2, int d, T outputscale, int same) {
  extern __shared__ unsigned char smem_raw[];
  T* s1 = reinterpret_cast<T*>(smem_raw);  // (TILE_ROWS, d)
  T* s2 = s1 + TILE_ROWS * d;              // (TILE_COLS, d)
  T* norm1 = s2 + TILE_COLS * d;           // (TILE_ROWS,)
  T* norm2 = norm1 + TILE_ROWS;            // (TILE_COLS,)

  const int row0 = blockIdx.y * TILE_ROWS;
  const int col0 = blockIdx.x * TILE_COLS;
  const int tid = threadIdx.y * TILE_COLS + threadIdx.x;
  const int nthreads = TILE_COLS * ROW_THREADS;

  // stage both input tiles; rows past the ragged edge read as 0 and are
  // never stored
  for (int idx = tid; idx < TILE_ROWS * d; idx += nthreads) {
    const int r = row0 + idx / d;
    s1[idx] = r < n1 ? x1[(size_t)r * d + idx % d] : T(0);
  }
  for (int idx = tid; idx < TILE_COLS * d; idx += nthreads) {
    const int c = col0 + idx / d;
    s2[idx] = c < n2 ? x2[(size_t)c * d + idx % d] : T(0);
  }
  __syncthreads();

  // squared norms, summed over D in order
  if (tid < TILE_ROWS) {
    T acc = T(0);
    for (int k = 0; k < d; ++k) acc = add_rn(acc, mul_rn(s1[tid * d + k], s1[tid * d + k]));
    norm1[tid] = acc;
  } else if (tid >= 32 && tid < 32 + TILE_COLS) {
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
  for (int i = 0; i < TILE_ROWS / ROW_THREADS; ++i) {
    const int r = threadIdx.y + i * ROW_THREADS;
    const int gr = row0 + r;
    if (gr >= n1) break;
    T cross = T(0);
    for (int k = 0; k < d; ++k) cross = add_rn(cross, mul_rn(s1[r * d + k], s2[c * d + k]));
    T d2 = sub_rn(add_rn(norm1[r], nc), mul_rn(T(2), cross));
    d2 = d2 < T(0) ? T(0) : d2;  // NaN passes through, as in the plain version
    if (same && gr == gc) d2 = T(0);
    out[(size_t)gr * n2 + gc] = mul_rn(outputscale, exp_t(mul_rn(T(-0.5), d2)));
  }
}

template <typename T>
int launch(const void* x1, const void* x2, void* out, int n1, int n2, int d,
           double outputscale, int same, void* stream) {
  if (n1 <= 0 || n2 <= 0) return 0;
  if (d <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * ((size_t)(TILE_ROWS + TILE_COLS) * d + TILE_ROWS + TILE_COLS);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ard_gram_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 block(TILE_COLS, ROW_THREADS);
  const dim3 grid((n2 + TILE_COLS - 1) / TILE_COLS, (n1 + TILE_ROWS - 1) / TILE_ROWS);
  ard_gram_kernel<T><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x1), static_cast<const T*>(x2), static_cast<T*>(out), n1, n2, d,
      static_cast<T>(outputscale), same);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int plst_ard_gram_f32(const void* x1, const void* x2, void* out, int n1, int n2,
                                 int d, double outputscale, int same, void* stream) {
  return launch<float>(x1, x2, out, n1, n2, d, outputscale, same, stream);
}

extern "C" int plst_ard_gram_f64(const void* x1, const void* x2, void* out, int n1, int n2,
                                 int d, double outputscale, int same, void* stream) {
  return launch<double>(x1, x2, out, n1, n2, d, outputscale, same, stream);
}
