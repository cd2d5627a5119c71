// The tensor-core building blocks of the bf16 flash-attention kernels
// (flash_attention.cu's forward, flash_attention_bwd.cu's two backward
// passes): tiles of rows in shared memory padded by TC_PAD elements, filled
// by 16-byte cp.async, read by ldmatrix and multiplied on mma.sync m16n8k16
// (bf16 in, f32 out).
#pragma once

#include "common.cuh"

namespace repro_torch {

constexpr int TC_WARPS = 8;        // 16 rows each: a 128-row tile, one CTA an SM
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_BK = 64;          // keys per kv tile
constexpr int TC_PAD = 8;          // smem rows are D + 8 elements: ldmatrix without conflicts
constexpr float TC_LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// two 8 x 8 matrices, at the addresses of lanes 0-7 and 8-15
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the SFU (2 ulp; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// nrows rows into a [nrows][D + TC_PAD] tile; row_ptr(r) is the row's first
// element in device memory, or null for a row past the tensor.  Null rows
// and the columns from dh to D are zero-filled.
template <int D, bool VEC, int THREADS, typename RowPtr>
__device__ __forceinline__ void tc_load_rows(bf16* dst, int nrows, RowPtr row_ptr,
                                             const bf16* any, int dh, int tid) {
  constexpr int LD = D + TC_PAD;
  if constexpr (VEC) {
    constexpr int CH = D / 8;   // 16-byte chunks per row
    for (int e = tid; e < nrows * CH; e += THREADS) {
      const int r = e / CH, c = e % CH;
      const bf16* src = row_ptr(r);
      const bool in = src != nullptr && c * 8 < dh;
      cp_async16(dst + r * LD + c * 8, in ? src + c * 8 : any, in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < nrows * D; e += THREADS) {
      const int r = e / D, d = e % D;
      const bf16* src = row_ptr(r);
      dst[r * LD + d] = (src != nullptr && d < dh) ? src[d] : __float2bfloat16_rn(0.f);
    }
  }
}

}  // namespace repro_torch
