"""The rate of ``mma.sync`` on the card, the ceiling of the tensor-core
product of B3 and B5 (``projected_langevin_sampling_torch/csrc/tc_product.cuh``).

    python3 scripts/mma_sync_ceiling.py

Builds a small CUDA source with nvcc (``sm_90a``) into ``build/`` and times
loops of independent ``mma.sync`` products with no loads, one block of 256
threads on each SM, then two:

- ``tf32``: m16n8k8 TF32 products into 8 accumulators;
- ``tf32_3x``: the 3xTF32 pattern of ``tc_product.cuh``, 48 products over 16
  accumulators with distinct hi and lo fragments, term by term;
- ``bf16``: m16n8k16 bf16 products into 8 accumulators, for comparison.

Needs one CUDA card; prints one JSON line of TFLOP/s.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// MODE 0: tf32, 8 accumulators; 1: the 3xTF32 pattern; 2: bf16, 8 accumulators
template <int MODE>
__global__ void loop(float* out, int iters) {
  uint32_t ah[4][4], al[4][4], bh[4][2], bl[4][2];
  for (int i = 0; i < 4; ++i)
    for (int q = 0; q < 4; ++q) {
      ah[i][q] = 0x3f800000u + threadIdx.x + 7 * i + q;
      al[i][q] = 0x33800000u + threadIdx.x + i + q;
    }
  for (int i = 0; i < 4; ++i)
    for (int q = 0; q < 2; ++q) {
      bh[i][q] = 0x3f800000u + 3 * threadIdx.x + i + q;
      bl[i][q] = 0x33000000u + i + q;
    }
  float c[4][4][4] = {};
  for (int it = 0; it < iters; ++it) {
    if (MODE == 1) {
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_tf32(c[mi][ni], al[mi], bh[ni]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_tf32(c[mi][ni], ah[mi], bl[ni]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_tf32(c[mi][ni], ah[mi], bh[ni]);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (MODE == 0) mma_tf32(c[k >> 2][k & 3], ah[0], bh[0]);
        else mma_bf16(c[k >> 2][k & 3], ah[0], bh[0]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ah[i][0] ^= it;
      bh[i][0] ^= it;
    }
  }
  float s = 0.0f;
  for (int i = 0; i < 4; ++i)
    for (int k = 0; k < 4; ++k)
      for (int q = 0; q < 4; ++q) s += c[i][k][q];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" float run(int mode, int blocks, int iters, float* out) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  auto go = [&]() {
    if (mode == 0) loop<0><<<blocks, 256>>>(out, iters);
    else if (mode == 1) loop<1><<<blocks, 256>>>(out, iters);
    else loop<2><<<blocks, 256>>>(out, iters);
  };
  go();
  cudaEventRecord(e0);
  go();
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = -1.0f;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return cudaGetLastError() == cudaSuccess ? ms : -1.0f;
}
"""
# (products per iteration, flops per product) of each mode
MODES = {"tf32": (0, 8, 2 * 16 * 8 * 8), "tf32_3x": (1, 48, 2 * 16 * 8 * 8),
         "bf16": (2, 8, 2 * 16 * 8 * 16)}


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_sync_ceiling: no CUDA device", file=sys.stderr)
        return 1
    build = os.path.join(ROOT, "build", "mma_sync_ceiling")
    os.makedirs(build, exist_ok=True)
    src, lib_path = os.path.join(build, "loop.cu"), os.path.join(build, "libloop.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    subprocess.run([os.path.join(cuda_home, "bin", "nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    lib.run.restype = ctypes.c_float
    lib.run.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(2 * sms * 256, device="cuda")
    rates = {}
    for name, (mode, per_iter, flops) in MODES.items():
        for blocks in (sms, 2 * sms):
            iters = 2048
            ms = lib.run(mode, blocks, iters, out.data_ptr())
            if ms <= 0:
                raise RuntimeError(f"mma_sync_ceiling: {name} failed to run")
            total = blocks * 8 * iters * per_iter * flops  # 8 warps a block
            rates[f"{name}, {blocks} blocks"] = round(total / ms / 1e9, 1)
    print(json.dumps({"card": torch.cuda.get_device_name(0), "tflops": rates}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
