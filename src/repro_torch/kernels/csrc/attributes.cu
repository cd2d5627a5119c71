// What the compiler gave each kernel body: cudaFuncGetAttributes, beside the
// dynamic shared bytes a launch of the body requests.  The resource model
// (kernels/resource_model.py) predicts the same numbers from the sources;
// chip_smoke.py's [resources] phase holds the two against each other.
#include <cuda_runtime.h>

// Each kernel source's body lookup: (body, four variant arguments) -> the
// kernel and the dynamic shared bytes its launch requests.
extern "C" int repro_ternary_matmul_body(int, int, int, int, int, const void**, int*);
extern "C" int repro_fused_transform_body(int, int, int, int, int, const void**, int*);
extern "C" int repro_easi_apply_body(int, int, int, int, int, const void**, int*);
extern "C" int repro_flash_attention_body(int, int, int, int, int, const void**, int*);
extern "C" int repro_flash_attention_bwd_body(int, int, int, int, int, const void**, int*);

// source: 0 ternary_matmul, 1 fused_transform, 2 easi_update, 3 flash_attention,
// 4 flash_attention_bwd;
// body and a..d as that source's lookup takes them.  out[0..6]: numRegs,
// sharedSizeBytes (static), localSizeBytes (spills), maxThreadsPerBlock,
// the dynamic shared bytes the launch requests, the CTAs of blockDim threads
// an SM holds at once with those bytes (cudaOccupancyMaxActiveBlocksPerMultiprocessor;
// 0 when block_threads is 0), maxDynamicSharedSizeBytes.
extern "C" int repro_kernel_attributes(int source, int body, int a, int b, int c, int d,
                                       int block_threads, int* out) {
  const void* fn = nullptr;
  int dyn = 0, rc;
  switch (source) {
    case 0: rc = repro_ternary_matmul_body(body, a, b, c, d, &fn, &dyn); break;
    case 1: rc = repro_fused_transform_body(body, a, b, c, d, &fn, &dyn); break;
    case 2: rc = repro_easi_apply_body(body, a, b, c, d, &fn, &dyn); break;
    case 3: rc = repro_flash_attention_body(body, a, b, c, d, &fn, &dyn); break;
    case 4: rc = repro_flash_attention_bwd_body(body, a, b, c, d, &fn, &dyn); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  if (dyn > 0) {   // as every launch that requests dynamic bytes does: opt in
    const cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               dyn);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  int ctas = 0;
  if (block_threads > 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, block_threads, (size_t)dyn);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = attr.maxThreadsPerBlock;
  out[4] = dyn;
  out[5] = ctas;
  out[6] = attr.maxDynamicSharedSizeBytes;
  return 0;
}
