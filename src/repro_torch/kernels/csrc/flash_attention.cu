// flash_attention: out = softmax(q k^T / sqrt(dh) + mask) v, the forward pass
// of online-softmax attention with causal and sliding-window masks and GQA.
//
//   q (B, Sq, Hq, Dh), k and v (B, Skv, Hkv, Dh), out (B, Sq, Hq, Dh) in q's
//   dtype; query head h reads kv head h / (Hq / Hkv); query row r sits at
//   position q_offset + r; key c is visible when c < Skv, and, if causal,
//   q_pos >= c, and, with a window w >= 0, q_pos - c < w.
//   lse (B, Hq, Sq) f32, written when its pointer is not null: each row's
//   log-sum-exp of the scaled scores, m + log(max(l, 1e-30)), which the
//   attention backward reads to recompute p (the residual of the JAX
//   package's custom VJP, models/blocks.py _flash_forward).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_fwd / _kernel).
//
// Bound on the H100: 4 * Dh operations per visible (query, key) pair and
// head (q k^T and p v), and q, k, v and out moved once.  At the prefill
// shapes of the LM path (thousands of positions, Dh = 120) the operations
// dominate by two orders of magnitude, so the bound is the bf16 tensor
// cores' rate.
//
// Two kernels, chosen by dtype (each is the port's own; neither stands in
// for the other):
//   - bf16 (every LM prefill): flash_tc_kernel, FA2-style on the tensor
//     cores.  One CTA of 8 warps owns a 128-row query tile; each warp owns
//     16 rows and keeps its Q fragment in registers for the whole kv loop.
//     Under GQA the tile's rows are hg query heads of one kv head (hg the
//     largest power of two <= 8 that divides Hq / Hkv) at 128 / hg
//     positions, so the heads of a group share every K/V tile.  K and V
//     tiles of 64 keys stay bf16 in shared memory (rows padded by 16 bytes,
//     so ldmatrix is free of bank conflicts), double-buffered with 16-byte
//     cp.async, so the next tile loads while this one computes; Q is staged
//     in the second buffer before the loop.  S = Q K^T is mma.sync
//     m16n8k16 (bf16 in, f32 out) and is multiplied by `scale` in f32
//     after the product, as the reference does.  The online softmax
//     reduces each row over its quad with shuffles and takes exp on the
//     SFU (ex2.approx); p is rounded to bf16 in registers and fed straight
//     back as the A operand of P V (ldmatrix.trans reads V); l sums the
//     unrounded p in f32.  Only tiles cut by the causal diagonal, the
//     window edge or Skv evaluate the mask; interior tiles skip it, and
//     tiles the mask hides from every row are never visited.  The grid is
//     flat (no 65535 limit) and starts with the last query tiles, which
//     have the most causal work.  Rows past Sq or Skv and the columns from
//     Dh to the tile width (120 of 128) are zero-filled in shared memory,
//     never left to the mask.  A Dh that is not a multiple of 8 (or an
//     unaligned pointer) loads element by element, synchronously.
//   - f32: flash_attention_kernel on the FP32 FMA units (the tensor cores'
//     TF32 would not hold the f32 tolerance).  One CTA of 16 x 16 threads
//     per (batch, query head, 64-row query tile) stages 64 keys and values
//     in shared memory, computes the 64 x 64 score tile with 4 x 4 scores a
//     thread, reduces each row's max and sum across its half-warp with
//     shuffles, and accumulates p v with 4 rows x Dh/16 columns a thread.
// Common to both:
//   - Masked entries get p = 0, and the running max starts at a finite
//     -1e30, so no inf - inf arises.  A row that sees some key gets the
//     JAX value; a row that sees none gets 0 (l stays 0, and out = acc /
//     max(l, 1e-30)), and an lse of about -1e30.
//   - m is kept in natural units of the scaled score in both kernels (the
//     bf16 kernel exponentiates in base 2 from m * log2 e), so the row's
//     lse is m + logf(l) in f32, written by one thread of the row after the
//     row's l is complete: with a null lse pointer nothing else changes.
//   - Everything sums in f32; p is rounded to v's dtype before p v, as both
//     JAX versions do.  Tiles of Dh 64 and 128 are compiled for both, and
//     of Dh 224 for bf16 (Zamba2's shared block: 32 heads on a 7168-wide
//     concat, scaled by (224 / 2)^-1/2, so `scale` is the caller's); a
//     wider head is refused.
//   - At D 224 the bf16 kernel keeps Q in shared memory, not in registers:
//     its output fragment alone is 112 registers a thread, and Q's 56 more
//     would spill past the 255 a thread may hold.  Q's 128 rows sit beside
//     the two K / V buffers (178 176 bytes in all, one CTA an SM), and each
//     kv tile reads them back by ldmatrix, one pair of k-steps at a time,
//     summing every score in the same order as the register-resident
//     form.
#include "flash_tc.cuh"

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
                       const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
                       int sq, int skv, int hq, int hkv, int dh, int causal, int window,
                       int q_offset, float scale) {
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
    // the row's 16 threads hold the same m and l
    if (lse != nullptr && tx == 0) lse[((size_t)bi * hq + h) * sq + r] = m_run[i] + logf(l);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int b,
                   int sq, int skv, int hq, int hkv, int dh, int causal, int window,
                   int q_offset, float scale, cudaStream_t stream) {
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
      static_cast<T*>(out), lse, sq, skv, hq, hkv, dh, causal, window, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const void* q, const void* k, const void* v, void* out, float* lse, int b,
                      int sq, int skv, int hq, int hkv, int dh, int causal, int window,
                      int q_offset, float scale, cudaStream_t stream) {
  if (dh <= 64)
    return launch<T, 64>(q, k, v, out, lse, b, sq, skv, hq, hkv, dh, causal, window, q_offset,
                         scale, stream);
  return launch<T, 128>(q, k, v, out, lse, b, sq, skv, hq, hkv, dh, causal, window, q_offset,
                        scale, stream);
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

// Up to D 128, Q is held in registers through the kv loop; above it, in
// shared memory (see the header).
template <int D>
constexpr bool TC_Q_IN_SMEM = D > 128;

// Two buffers, each a K tile and a V tile of TC_BK rows.  The Q tile (16
// rows a warp, at most 128) is staged in buffer 1 before the kv loop, read
// into registers, and then overwritten by the second kv tile; where Q stays
// in shared memory it has its own 128 rows after the buffers.
template <int D>
constexpr size_t tc_smem_bytes() {
  return sizeof(bf16) * (size_t)(4 * TC_BK + (TC_Q_IN_SMEM<D> ? 16 * TC_WARPS : 0)) *
         (D + TC_PAD);
}

// One CTA: TC_WARPS warps, 16 query rows each, all reading the K/V of kv
// head hk.  The CTA serves hg query heads of that kv head (hg divides
// Hq / Hkv) at 16 TC_WARPS / hg positions, so the heads of a GQA group
// share each K/V tile.
template <int D, bool VEC>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
                int b, int sq, int skv, int hq, int hkv, int dh, int causal, int window,
                int q_offset, float scale, int hg) {
  constexpr int NW = TC_WARPS, THREADS = TC_THREADS;
  constexpr int LD = D + TC_PAD;
  constexpr int KS = D / 16;        // k-steps of Q K^T
  constexpr int NT = D / 8;         // n-tiles of the output
  constexpr int ST = TC_BK / 8;     // n-tiles of the score tile
  constexpr bool QS = TC_Q_IN_SMEM<D>;
  static_assert(QS || 16 * NW <= 2 * TC_BK, "the Q tile must fit in one kv buffer");
  static_assert(KS % 2 == 0 && NT % 2 == 0, "k-steps and output n-tiles come in pairs");
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* kvs = reinterpret_cast<bf16*>(tc_smem);   // [buffer][K, V][TC_BK][LD]
  // buffer 1 before the loop, or Q's own rows after both buffers
  bf16* qs = kvs + (QS ? 4 : 2) * TC_BK * LD;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int grp = hq / hkv;                 // query heads per kv head
  const int wph = NW / hg;                  // warps per query head
  const int qpos = 16 * wph;                // query positions per CTA
  // flat grid, last query tiles (the most causal work) first
  const int units = b * hkv * (grp / hg);
  const int n_qt = (sq + qpos - 1) / qpos;
  const int qt = n_qt - 1 - (int)(blockIdx.x / units);
  int u = (int)(blockIdx.x % units);
  const int hb = u % (grp / hg);
  u /= grp / hg;
  const int hk = u % hkv, bi = u / hkv;
  const int h0 = hk * grp + hb * hg;        // the CTA's first query head
  const int q0 = qt * qpos;
  const size_t q_row = (size_t)hq * dh;
  const size_t kv_row = (size_t)hkv * dh;
  const bf16* qb = q + (size_t)bi * sq * q_row;
  const bf16* kb = k + (size_t)bi * skv * kv_row + (size_t)hk * dh;
  const bf16* vb = v + (size_t)bi * skv * kv_row + (size_t)hk * dh;
  // this warp: head h0 + warp / wph, positions wq .. wq + 15
  const int wq = q0 + 16 * (warp % wph);
  const int wh = h0 + warp / wph;
  bf16* ob = out + (size_t)bi * sq * q_row + (size_t)wh * dh;

  // the kv range some row of this tile can see
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + qpos, sq) - 1;
  int k_begin = 0, k_end = skv;
  if (causal) k_end = min(skv, q_last + 1);
  if (window >= 0) k_begin = max(0, q_first - window + 1);
  k_begin -= k_begin % TC_BK;

  auto q_rows = [&](int r) -> const bf16* {   // Q tile row r: head h0 + r / qpos
    const int pos = q0 + r % qpos;
    return pos < sq ? qb + (size_t)pos * q_row + (size_t)(h0 + r / qpos) * dh : nullptr;
  };
  auto load_kv = [&](int buf, int pos0) {
    auto k_rows = [&](int r) -> const bf16* {
      return pos0 + r < skv ? kb + (size_t)(pos0 + r) * kv_row : nullptr;
    };
    auto v_rows = [&](int r) -> const bf16* {
      return pos0 + r < skv ? vb + (size_t)(pos0 + r) * kv_row : nullptr;
    };
    tc_load_rows<D, VEC, THREADS>(kvs + (2 * buf) * TC_BK * LD, TC_BK, k_rows, k, dh, tid);
    tc_load_rows<D, VEC, THREADS>(kvs + (2 * buf + 1) * TC_BK * LD, TC_BK, v_rows, v, dh, tid);
  };

  tc_load_rows<D, VEC, THREADS>(qs, 16 * NW, q_rows, q, dh, tid);
  if (k_begin < k_end) load_kv(0, k_begin);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // this warp's 16 rows of Q as ldmatrix reads them, k-step kk at + kk * 16
  const bf16* q_frag = qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                       (lane >> 4) * 8;
  [[maybe_unused]] uint32_t qf[QS ? 1 : KS][4];   // Q in registers for the whole kv loop (D <= 128)
  if constexpr (!QS) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) ldsm_x4(qf[kk], q_frag + kk * 16);
    __syncthreads();    // buffer 1 is free for the second kv tile
  }

  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_run[2] = {FA_NEG, FA_NEG}, l_run[2] = {0.f, 0.f};
  const int p_lo = q_offset + wq + g;   // this thread's rows sit at p_lo and p_lo + 8

  int buf = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += TC_BK, buf ^= 1) {
    if (k0 + TC_BK < k_end) load_kv(buf ^ 1, k0 + TC_BK);   // loads while this tile computes
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = kvs + (2 * buf) * TC_BK * LD;
    const bf16* vt = kt + TC_BK * LD;

    // S = Q K^T: n-tile j holds keys k0 + 8 j .. + 7
    float s[ST][4];
#pragma unroll
    for (int j = 0; j < ST; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (QS) {
      // each pair of Q's k-steps read once a tile; every s[j] still sums
      // its k-steps in ascending order
#pragma unroll
      for (int kk = 0; kk < KS; kk += 2) {
        uint32_t qlo[4], qhi[4];
        ldsm_x4(qlo, q_frag + kk * 16);
        ldsm_x4(qhi, q_frag + (kk + 1) * 16);
#pragma unroll
        for (int j = 0; j < ST; ++j) {
          uint32_t kf[4];
          ldsm_x4(kf, kt + (j * 8 + (lane & 7)) * LD + kk * 16 + (lane >> 3) * 8);
          mma_bf16(s[j], qlo, kf[0], kf[1]);
          mma_bf16(s[j], qhi, kf[2], kf[3]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < ST; ++j) {
#pragma unroll
        for (int kk = 0; kk < KS; kk += 2) {
          uint32_t kf[4];
          ldsm_x4(kf, kt + (j * 8 + (lane & 7)) * LD + kk * 16 + (lane >> 3) * 8);
          mma_bf16(s[j], qf[kk], kf[0], kf[1]);
          mma_bf16(s[j], qf[kk + 1], kf[2], kf[3]);
        }
      }
    }

    // scale in f32; mask only the tiles cut by Skv, the diagonal or the window
    const bool interior = k0 + TC_BK <= skv && (!causal || k0 + TC_BK - 1 <= q_first) &&
                          (window < 0 || q_last - k0 < window);
#pragma unroll
    for (int j = 0; j < ST; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale;
    if (!interior) {
#pragma unroll
      for (int j = 0; j < ST; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + j * 8 + 2 * t4 + (e & 1);
          const int qp = p_lo + (e >> 1) * 8;
          const bool vis = kp < skv && (!causal || qp >= kp) && (window < 0 || qp - kp < window);
          if (!vis) s[j][e] = __uint_as_float(0xff800000u);   // -inf: p = 0, m stays finite
        }
    }

    // online softmax over the rows p_lo (e = 0, 1) and p_lo + 8 (e = 2, 3)
    float corr[2], mscaled[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = FA_NEG;
#pragma unroll
      for (int j = 0; j < ST; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[i], mx);
      corr[i] = fast_exp2((m_run[i] - m_new) * TC_LOG2E);
      m_run[i] = m_new;
      mscaled[i] = m_new * TC_LOG2E;
    }
    uint32_t pf[TC_BK / 16][4];   // p as the A operand of P V, rounded to bf16
    float lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < ST; ++j) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[e] = fast_exp2(fmaf(s[j][e], TC_LOG2E, -mscaled[e >> 1]));
      lsum[0] += pv[0] + pv[1];
      lsum[1] += pv[2] + pv[3];
      pf[j / 2][(j & 1) * 2 + 0] = pack_bf16(pv[0], pv[1]);
      pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(pv[2], pv[3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * corr[i] + lsum[i];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }

    // O += P V: k-step kk holds keys k0 + 16 kk .. + 15
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + j * 8 +
                              (lane >> 4) * 8);
        mma_bf16(o[j], pf[kk], vf[0], vf[1]);
        mma_bf16(o[j + 1], pf[kk], vf[2], vf[3]);
      }
    }
    __syncthreads();   // this buffer is free for the load two tiles on
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    l_run[i] = fmaxf(l_run[i], 1e-30f);
    // the quad (t4 = 0..3) holds row wq + g + 8 i of head wh; m_run is in
    // natural units of the scaled score
    const int r = wq + g + 8 * i;
    if (lse != nullptr && t4 == 0 && r < sq)
      lse[((size_t)bi * hq + wh) * sq + r] = m_run[i] + logf(l_run[i]);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = wq + g + (e >> 1) * 8, d = j * 8 + 2 * t4 + (e & 1);
      if (r < sq && d < dh)
        ob[(size_t)r * q_row + d] = __float2bfloat16_rn(o[j][e] / l_run[e >> 1]);
    }
}

template <int D, bool VEC>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, float* lse, int b,
                      int sq, int skv, int hq, int hkv, int dh, int causal, int window,
                      int q_offset, float scale, cudaStream_t stream) {
  constexpr size_t bytes = tc_smem_bytes<D>();
  const cudaError_t rc = cudaFuncSetAttribute(flash_tc_kernel<D, VEC>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              (int)bytes);
  if (rc != cudaSuccess) return rc;
  const int grp = hq / hkv;
  int hg = 1;   // query heads per CTA: the largest power of two that divides grp, <= TC_WARPS
  while (hg * 2 <= TC_WARPS && grp % (hg * 2) == 0) hg *= 2;
  const int qpos = 16 * TC_WARPS / hg;
  const long long blocks = (long long)ceil_div(sq, qpos) * b * hkv * (grp / hg);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_tc_kernel<D, VEC><<<(unsigned)blocks, TC_THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, b, sq, skv, hq, hkv, dh, causal, window, q_offset, scale,
      hg);
  return cudaGetLastError();
}

cudaError_t launch_tc_dh(const void* q, const void* k, const void* v, void* out, float* lse,
                         int b, int sq, int skv, int hq, int hkv, int dh, int causal, int window,
                         int q_offset, float scale, cudaStream_t stream) {
  // 16-byte cp.async needs every row start 16-byte aligned
  const bool vec = dh % 8 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  auto go = [&](auto kernel_launch) {
    return kernel_launch(q, k, v, out, lse, b, sq, skv, hq, hkv, dh, causal, window, q_offset,
                         scale, stream);
  };
  if (dh <= 64) return vec ? go(launch_tc<64, true>) : go(launch_tc<64, false>);
  if (dh <= 128) return vec ? go(launch_tc<128, true>) : go(launch_tc<128, false>);
  return vec ? go(launch_tc<224, true>) : go(launch_tc<224, false>);
}

}  // namespace

// window < 0 means no sliding window; lse may be null (no log-sum-exp is
// written); the scores are multiplied by `scale`.  bf16 runs the
// tensor-core kernel (Dh up to 224), f32 the FMA kernel (Dh up to 128).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     void* lse, int b, int sq, int skv, int hq, int hkv, int dh,
                                     int causal, int window, int q_offset, float scale,
                                     int dtype, void* stream) {
  if (dh < 1 || dh > (dtype == kBF16 ? 224 : 128) || hkv < 1 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  cudaError_t rc;
  if (dtype == kF32) {
    if (b * hq > 65535) return static_cast<int>(cudaErrorInvalidValue);   // gridDim.y
    rc = launch_dh<float>(q, k, v, out, lse_f, b, sq, skv, hq, hkv, dh, causal, window,
                          q_offset, scale, s);
  } else if (dtype == kBF16) {
    rc = launch_tc_dh(q, k, v, out, lse_f, b, sq, skv, hq, hkv, dh, causal, window, q_offset,
                      scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(rc);
}

// A kernel body, for csrc/attributes.cu: body 0 the f32 FMA kernel with its
// tile of Dh (dh 64 or 128), 1 the bf16 tensor-core kernel with its tile of
// Dh (64, 128 or 224) and vec 1 for 16-byte cp.async loads (0: element by
// element).  *fn is the kernel, *dyn the dynamic shared bytes its launch
// requests.
extern "C" int repro_flash_attention_body(int body, int dh, int vec, int unused0, int unused1,
                                          const void** fn, int* dyn) {
  (void)unused0;
  (void)unused1;
  if (body == 1 && dh == 224) {
    *fn = vec ? (const void*)flash_tc_kernel<224, true> : (const void*)flash_tc_kernel<224, false>;
    *dyn = (int)tc_smem_bytes<224>();
    return 0;
  }
  if (dh != 64 && dh != 128) return static_cast<int>(cudaErrorInvalidValue);
  const bool d64 = dh == 64;
  if (body == 0) {
    *fn = d64 ? (const void*)flash_attention_kernel<float, 64>
              : (const void*)flash_attention_kernel<float, 128>;
    *dyn = (int)(d64 ? smem_bytes<64>() : smem_bytes<128>());
  } else if (body == 1) {
    *fn = d64 ? (vec ? (const void*)flash_tc_kernel<64, true>
                     : (const void*)flash_tc_kernel<64, false>)
              : (vec ? (const void*)flash_tc_kernel<128, true>
                     : (const void*)flash_tc_kernel<128, false>);
    *dyn = (int)(d64 ? tc_smem_bytes<64>() : tc_smem_bytes<128>());
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}
