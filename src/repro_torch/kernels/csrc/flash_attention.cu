// flash_attention: out = softmax(q k^T / sqrt(dh) + mask) v, the forward pass
// of online-softmax attention with causal and sliding-window masks and GQA.
//
//   q (B, Sq, Hq, Dh), k and v (B, Skv, Hkv, Dh), out (B, Sq, Hq, Dh) in q's
//   dtype; query head h reads kv head h / (Hq / Hkv); query row r sits at
//   position q_offset + r; key c is visible when c < Skv, and, if causal,
//   q_pos >= c, and, with a window w >= 0, q_pos - c < w.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_fwd / _kernel).
//
// Bound on the H100: 4 * Dh operations per visible (query, key) pair and
// head (q k^T and p v), and q, k, v and out moved once.  At the prefill
// shapes of the LM path (thousands of positions, Dh = 120) the operations
// dominate by two orders of magnitude, so the bound is the tensor cores'
// rate; this kernel runs on the FP32 FMA units instead and is far from it.
//
// Design: the TPU grid walks kv blocks in order and carries acc / m / l in
// VMEM scratch from one grid step to the next.  CTAs carry nothing between
// them, so here one CTA owns one (batch, query head, 64-row query tile) and
// loops over all of that tile's kv tiles itself, keeping the running max m,
// sum l and the 64 x Dh accumulator in registers.  Per kv tile it stages 64
// keys and values in shared memory (widened to f32), computes the 64 x 64
// score tile with 16 x 16 threads owning 4 x 4 scores each, reduces each
// row's max and sum across its 16 threads with warp shuffles, writes p
// (rounded to v's dtype, as both JAX versions do) to shared memory and
// accumulates p v, each thread owning 4 rows x Dh/16 columns.  Everything
// sums in f32.
//   - Kv tiles that the causal or window mask hides from every row of the
//     query tile are never visited (the result is the same).
//   - Masked entries get p = 0 through an explicit predicate, and the
//     running max starts at a finite -1e30, so a fully masked tile never
//     computes inf - inf.  A row that sees some key gets the JAX value; a
//     row that sees none gets 0 (l stays 0, and out = 0 / max(l, 1e-30)).
//   - The ragged edges (rows past Sq, keys past Skv, and Dh below the tile
//     width: 120 of 128, for example) are masked here; nothing is padded in
//     device memory.  Dh tiles of 64 and 128 are compiled; Dh > 128 is
//     refused by the wrapper.
#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int FA_BQ = 64;          // query rows per CTA
constexpr int FA_BK = 64;          // keys per kv tile
constexpr int FA_SIDE = 16;        // the CTA is FA_SIDE x FA_SIDE threads
constexpr int FA_THREADS = FA_SIDE * FA_SIDE;
constexpr int FA_RI = FA_BQ / FA_SIDE;   // rows per thread
constexpr int FA_CJ = FA_BK / FA_SIDE;   // score columns per thread
constexpr int FA_LDP = FA_BK + 1;        // padded row of the p tile
constexpr float FA_NEG = -1e30f;

template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int DH>
constexpr size_t smem_bytes() {
  // q and k tiles padded by one column (conflict-free column reads), v
  // unpadded (read along rows), p tile padded
  return sizeof(float) * ((size_t)FA_BQ * (DH + 1) + (size_t)FA_BK * (DH + 1) +
                          (size_t)FA_BK * DH + (size_t)FA_BQ * FA_LDP);
}

template <typename T, int DH>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int sq, int skv,
                       int hq, int hkv, int dh, int causal, int window, int q_offset,
                       float scale) {
  constexpr int LD = DH + 1;
  constexpr int DJ = DH / FA_SIDE;   // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                  // [FA_BQ][LD]
  float* ks = qs + FA_BQ * LD;       // [FA_BK][LD]
  float* vs = ks + FA_BK * LD;       // [FA_BK][DH]
  float* ps = vs + FA_BK * DH;       // [FA_BQ][FA_LDP]

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * FA_SIDE + tx;
  const int bi = blockIdx.y / hq, h = blockIdx.y % hq;
  const int hk = h / (hq / hkv);
  const int q0 = blockIdx.x * FA_BQ;
  const size_t q_row = (size_t)hq * dh;     // stride between positions of q / out
  const size_t kv_row = (size_t)hkv * dh;   // and of k / v
  const T* qb = q + (size_t)bi * sq * q_row + (size_t)h * dh;
  const T* kb = k + (size_t)bi * skv * kv_row + (size_t)hk * dh;
  const T* vb = v + (size_t)bi * skv * kv_row + (size_t)hk * dh;
  T* ob = out + (size_t)bi * sq * q_row + (size_t)h * dh;

  for (int e = tid; e < FA_BQ * DH; e += FA_THREADS) {
    const int r = e / DH, d = e % DH;       // neighbouring threads: neighbouring d
    qs[r * LD + d] = (q0 + r < sq && d < dh) ? to_f32(qb[(size_t)(q0 + r) * q_row + d]) : 0.f;
  }

  // the kv range some row of this tile can see
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + FA_BQ, sq) - 1;
  int k_begin = 0, k_end = skv;
  if (causal) k_end = min(skv, q_last + 1);
  if (window >= 0) k_begin = max(0, q_first - window + 1);
  k_begin -= k_begin % FA_BK;

  float acc[FA_RI][DJ];
  float m_run[FA_RI], l_run[FA_RI];
#pragma unroll
  for (int i = 0; i < FA_RI; ++i) {
    m_run[i] = FA_NEG;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += FA_BK) {
    __syncthreads();   // the previous tile's ks / vs / ps are no longer read
    for (int e = tid; e < FA_BK * DH; e += FA_THREADS) {
      const int c = e / DH, d = e % DH;
      const bool in = k0 + c < skv && d < dh;
      const size_t off = (size_t)(k0 + c) * kv_row + d;
      ks[c * LD + d] = in ? to_f32(kb[off]) : 0.f;
      vs[c * DH + d] = in ? to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j
    float s[FA_RI][FA_CJ];
#pragma unroll
    for (int i = 0; i < FA_RI; ++i)
#pragma unroll
      for (int j = 0; j < FA_CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float a[FA_RI], b[FA_CJ];
#pragma unroll
      for (int i = 0; i < FA_RI; ++i) a[i] = qs[(ty + FA_SIDE * i) * LD + d];
#pragma unroll
      for (int j = 0; j < FA_CJ; ++j) b[j] = ks[(tx + FA_SIDE * j) * LD + d];
#pragma unroll
      for (int i = 0; i < FA_RI; ++i)
#pragma unroll
        for (int j = 0; j < FA_CJ; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

    // online softmax; each row's 16 threads are one half-warp, so xor
    // shuffles with offsets below 16 reduce within the row
#pragma unroll
    for (int i = 0; i < FA_RI; ++i) {
      const int r = ty + FA_SIDE * i;
      const int qp = q_offset + q0 + r;
      const bool row_in = q0 + r < sq;
      bool vis[FA_CJ];
      float mx = FA_NEG;
#pragma unroll
      for (int j = 0; j < FA_CJ; ++j) {
        const int kp = k0 + tx + FA_SIDE * j;
        vis[j] = row_in && kp < skv && (!causal || qp >= kp) && (window < 0 || qp - kp < window);
        s[i][j] *= scale;
        if (vis[j]) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = FA_SIDE / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < FA_CJ; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        ps[r * FA_LDP + tx + FA_SIDE * j] = round_to<T>(p);
      }
#pragma unroll
      for (int off = FA_SIDE / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * corr + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();   // the p tile is complete

#pragma unroll 4
    for (int c = 0; c < FA_BK; ++c) {
      float pr[FA_RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < FA_RI; ++i) pr[i] = ps[(ty + FA_SIDE * i) * FA_LDP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[c * DH + tx + FA_SIDE * j];
#pragma unroll
      for (int i = 0; i < FA_RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pr[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < FA_RI; ++i) {
    const int r = q0 + ty + FA_SIDE * i;
    if (r >= sq) continue;
    const float l = fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + FA_SIDE * j;
      if (d < dh) ob[(size_t)r * q_row + d] = from_f32<T>(acc[i][j] / l);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int b, int sq,
                   int skv, int hq, int hkv, int dh, int causal, int window, int q_offset,
                   float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DH>();
  // above 48 KB a kernel must opt in to dynamic shared memory
  const cudaError_t rc = cudaFuncSetAttribute(flash_attention_kernel<T, DH>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              (int)bytes);
  if (rc != cudaSuccess) return rc;
  const dim3 grid(ceil_div(sq, FA_BQ), b * hq);
  const dim3 block(FA_SIDE, FA_SIDE);
  flash_attention_kernel<T, DH><<<grid, block, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, skv, hq, hkv, dh, causal, window, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const void* q, const void* k, const void* v, void* out, int b, int sq,
                      int skv, int hq, int hkv, int dh, int causal, int window, int q_offset,
                      float scale, cudaStream_t stream) {
  if (dh <= 64)
    return launch<T, 64>(q, k, v, out, b, sq, skv, hq, hkv, dh, causal, window, q_offset,
                         scale, stream);
  return launch<T, 128>(q, k, v, out, b, sq, skv, hq, hkv, dh, causal, window, q_offset,
                        scale, stream);
}

}  // namespace

// window < 0 means no sliding window.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int b, int sq, int skv, int hq, int hkv, int dh,
                                     int causal, int window, int q_offset, float scale,
                                     int dtype, void* stream) {
  if (dh < 1 || dh > 128 || hkv < 1 || hq % hkv != 0 || b * hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (dtype == kF32) {
    rc = launch_dh<float>(q, k, v, out, b, sq, skv, hq, hkv, dh, causal, window, q_offset,
                          scale, s);
  } else if (dtype == kBF16) {
    rc = launch_dh<__nv_bfloat16>(q, k, v, out, b, sq, skv, hq, hkv, dh, causal, window,
                                  q_offset, scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(rc);
}
