// Shared helpers for the port's CUDA kernels (built for sm_90a by
// repro_torch/kernels/_build.py into one shared library with a plain C
// interface, loaded through ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

// dtype codes; kernels/_build.py holds the same table (DTYPE_CODES)
enum DType : int { kF32 = 0, kBF16 = 1 };

// The tiling of the dense bodies of ternary_matmul and fused_transform and of
// easi_update's Gram kernel (the sparse bodies, ternary_encode.cuh, easi's
// other kernels and flash_attention define their own): a 32 x 32 output
// tile with 16 x 16 threads, each thread owning the 2 x 2 patch
// {ty, ty + 16} x {tx, tx + 16} (strided so a warp reads consecutive
// shared-memory words), walking the contraction in chunks of TK held in
// shared memory.  Shared arrays are padded by one column so that the
// transposed stores hit 32 distinct banks.
constexpr int TILE = 32;
constexpr int TK = 32;
constexpr int HALF = 16;
constexpr int NTHREADS = HALF * HALF;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__host__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The current device's SM count.
__host__ inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return rc;
}

}  // namespace repro_torch
