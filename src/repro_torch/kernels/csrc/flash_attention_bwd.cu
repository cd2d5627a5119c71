// flash_attention_bwd: dq, dk and dv of out = softmax(q k^T / sqrt(dh) + mask) v,
// the backward of flash_attention.cu's forward, in bf16 on the tensor cores.
//
//   q, out, dout (B, Sq, Hq, Dh), k and v (B, Skv, Hkv, Dh) bf16; lse (B, Hq,
//   Sq) f32, each row's log-sum-exp as the forward writes it; delta (B, Hq,
//   Sq) f32 scratch, written by pass 1 and read by pass 2; dq (B, Sq, Hq, Dh),
//   dk and dv (B, Skv, Hkv, Dh) bf16.  The mask is the forward's: query row r
//   sits at q_pos = q_offset + r; key c is visible when c < Skv, and, if
//   causal, q_pos >= c, and, with a window w >= 0, q_pos - c < w.
//
// Replaces no TPU kernel: the reference's attention backward is XLA outside
// any Pallas kernel (src/repro/models/blocks.py:120-196, _flash_backward).
// It was added because the port's plain backward (ref.flash_attention_bwd_ref)
// builds f32 score tiles of a whole chunk pair, S x S per head, and runs five
// f32 products and a chain of elementwise passes over them: on a training
// step it was half the device's time and a quarter of the host's launches.
//
// The arithmetic is flash_attention_bwd_ref's: delta = sum_d dout * out in
// f32; for a visible pair p = exp(s * scale - lse), 0 on a masked pair (so a
// row that sees no key gets dq = 0 and adds nothing to dk or dv); dp = dout
// v^T; ds = p (dp - delta); dq = scale * ds k, dk = scale * ds^T q summed
// over the GQA group, dv = p^T dout summed over the group.  Every product
// takes bf16 operands, p and ds rounded to bf16 first, which is what the
// tensor cores take, and accumulates in f32.
//
// Bound on the H100: 10 Dh operations per visible (query, key) pair and
// query head (s, dp, dq, dk, dv), q, k, v, out, dout and lse read once and
// dq, dk, dv written once.  At the training shapes (a thousand positions and
// more, Dh 80 - 128) the operations dominate, so the bound is the bf16
// tensor cores' rate.  The two passes recompute s and dp (14 Dh operations
// a pair), which buys a backward with no float atomics and no S x S tensor.
//
// Design: two launches on mma.sync m16n8k16 with ldmatrix and
// double-buffered 16-byte cp.async (flash_tc.cuh, shared with the forward).
// The tile width D is Dh rounded up to a multiple of 16 (Dh 80 runs 80
// wide); Dh <= 128.  Columns from Dh to D and rows past Sq or Skv are
// zero-filled in shared memory; a Dh that is not a multiple of 8, or an
// unaligned pointer, loads element by element.
//   - Pass 1, flash_bwd_dq_kernel: the forward's CTA (8 warps of 16 query
//     rows; under GQA hg heads of a group at 128 / hg positions, sharing K
//     and V tiles).  The prologue sums each row's delta and writes it out
//     for pass 2; each warp then holds its Q and dO rows in registers and
//     walks the visible kv tiles of 64 keys: per 8 keys S = Q K^T and dP =
//     dO V^T, then p and dS, packed to bf16 as the A operand of dQ += dS K
//     (ldmatrix.trans reads K).  dq * scale is written once.
//   - Pass 2, flash_bwd_dkdv_kernel: one CTA per (batch, kv head, 128 keys),
//     16 keys a warp, K and V tiles held in shared memory for the whole
//     launch.  It walks, in a fixed order, every query head of the GQA group
//     and each visible tile of 64 query rows (Q, dO, lse and delta
//     double-buffered): S^T = K Q^T, p, dV += P^T dO, dP^T = V dO^T, dS,
//     dK += dS^T Q, the P^T and dS^T accumulators fed back as A operands
//     in bf16.  The GQA sum never leaves the CTA.
//   - Every sum has a fixed order and no float atomics are used, so two calls
//     give the same bits.  Only tiles cut by the causal diagonal, a window
//     edge or Skv evaluate the mask; tiles the mask hides from every row are
//     never visited.  A row past Sq reads an lse of +inf (p = 0).
#include <type_traits>

#include "flash_tc.cuh"

using namespace repro_torch;

namespace {

constexpr int BW_KEYS = 16 * TC_WARPS;   // pass 2: keys a CTA, 16 a warp
constexpr int BW_BQ = 64;                // pass 2: query rows a tile

// pass 1: two buffers of a K and a V tile of TC_BK rows; Q and dO (16 rows a
// warp) are staged in buffers 1 and 0 before the kv loop
template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * (size_t)4 * TC_BK * (D + TC_PAD);
}

// pass 2: the K and V tiles, two buffers of a Q and a dO tile, and two
// buffers of the tile's lse (times log2 e) and delta
template <int D>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(bf16) * (size_t)(2 * BW_KEYS + 4 * BW_BQ) * (D + TC_PAD) +
         sizeof(float) * (size_t)4 * BW_BQ;
}

template <int D, int THREADS, typename RowPtr>
__device__ __forceinline__ void load_rows(bool vec, bf16* dst, int nrows, RowPtr row_ptr,
                                          const bf16* any, int dh, int tid) {
  if (vec)
    tc_load_rows<D, true, THREADS>(dst, nrows, row_ptr, any, dh, tid);
  else
    tc_load_rows<D, false, THREADS>(dst, nrows, row_ptr, any, dh, tid);
}

// c += a b^T over D: a 16 x D in registers (k-step kk in a[kk]), b the 8 rows
// of a shared-memory tile that start at `rows`
template <int D>
__device__ __forceinline__ void mma_rows(float (&c)[4], const uint32_t (&a)[D / 16][4],
                                         const bf16* rows, int lane) {
  constexpr int LD = D + TC_PAD, KS = D / 16;
#pragma unroll
  for (int kk = 0; kk + 1 < KS; kk += 2) {
    uint32_t f[4];
    ldsm_x4(f, rows + (lane & 7) * LD + kk * 16 + (lane >> 3) * 8);
    mma_bf16(c, a[kk], f[0], f[1]);
    mma_bf16(c, a[kk + 1], f[2], f[3]);
  }
  if constexpr (KS % 2 == 1) {
    uint32_t f[2];
    ldsm_x2(f, rows + (lane & 7) * LD + (KS - 1) * 16 + ((lane >> 3) & 1) * 8);
    mma_bf16(c, a[KS - 1], f[0], f[1]);
  }
}

// c[n-tile j] += a b^T over D for the ST n-tiles of a tile b (8 ST rows in
// shared memory): a 16 x D, the 16 rows of a shared-memory tile that start
// at `a_rows`, read one k-step at a time
template <int D, int ST>
__device__ __forceinline__ void mma_tile_t(float (&c)[ST][4], const bf16* a_rows, const bf16* b,
                                           int lane) {
  constexpr int LD = D + TC_PAD, KS = D / 16;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a_rows + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < ST; j += 2) {
      uint32_t f[4];
      ldsm_x4(f, b + (j * 8 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                     ((lane >> 3) & 1) * 8);
      mma_bf16(c[j], a, f[0], f[1]);
      mma_bf16(c[j + 1], a, f[2], f[3]);
    }
  }
}

// acc (16 x D) += x b: x a 16 x (8 ST) accumulator tile rounded to bf16 as
// the A operand, b an (8 ST) x D tile in shared memory read transposed
template <int D, int ST>
__device__ __forceinline__ void mma_acc_tile(float (&acc)[D / 8][4], const float (&x)[ST][4],
                                             const bf16* b, int lane) {
  constexpr int LD = D + TC_PAD, NT = D / 8;
#pragma unroll
  for (int kk = 0; kk < ST / 2; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t f[4];
      ldsm_x4_trans(f, b + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + j * 8 +
                           (lane >> 4) * 8);
      mma_bf16(acc[j], a, f[0], f[1]);
      mma_bf16(acc[j + 1], a, f[2], f[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// pass 1: delta and dq
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ out,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, bf16* __restrict__ dq, int b, int sq, int skv,
                    int hq, int hkv, int dh, int causal, int window, int q_offset, float scale,
                    int hg, int vec) {
  constexpr int NW = TC_WARPS, THREADS = TC_THREADS;
  constexpr int LD = D + TC_PAD;
  constexpr int KS = D / 16;        // k-steps over the head
  constexpr int NT = D / 8;         // n-tiles of dq
  constexpr int ST = TC_BK / 8;     // n-tiles of the score tile
  static_assert(16 * NW <= 2 * TC_BK, "the Q and dO tiles must each fit in one kv buffer");
  extern __shared__ __align__(16) unsigned char bw_smem[];
  bf16* kvs = reinterpret_cast<bf16*>(bw_smem);   // [buffer][K, V][TC_BK][LD]
  bf16* dos = kvs;                                // buffer 0, before the loop
  bf16* qs = kvs + 2 * TC_BK * LD;                // buffer 1, before the loop

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
  const size_t q_base = (size_t)bi * sq * q_row;
  const bf16* kb = k + (size_t)bi * skv * kv_row + (size_t)hk * dh;
  const bf16* vb = v + (size_t)bi * skv * kv_row + (size_t)hk * dh;
  // this warp: head h0 + warp / wph, positions wq .. wq + 15
  const int wq = q0 + 16 * (warp % wph);
  const int wh = h0 + warp / wph;
  const size_t row_stat = ((size_t)bi * hq + wh) * sq;   // the head's lse / delta row 0

  // the kv range some row of this tile can see
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + qpos, sq) - 1;
  int k_begin = 0, k_end = skv;
  if (causal) k_end = min(skv, q_last + 1);
  if (window >= 0) k_begin = max(0, q_first - window + 1);
  k_begin -= k_begin % TC_BK;

  auto tile_rows = [&](const bf16* t) {   // Q / dO tile row r: head h0 + r / qpos
    return [=](int r) -> const bf16* {
      const int pos = q0 + r % qpos;
      return pos < sq ? t + q_base + (size_t)pos * q_row + (size_t)(h0 + r / qpos) * dh
                      : nullptr;
    };
  };
  auto load_kv = [&](int buf, int pos0) {
    auto k_rows = [&](int r) -> const bf16* {
      return pos0 + r < skv ? kb + (size_t)(pos0 + r) * kv_row : nullptr;
    };
    auto v_rows = [&](int r) -> const bf16* {
      return pos0 + r < skv ? vb + (size_t)(pos0 + r) * kv_row : nullptr;
    };
    load_rows<D, THREADS>(vec, kvs + (2 * buf) * TC_BK * LD, TC_BK, k_rows, k, dh, tid);
    load_rows<D, THREADS>(vec, kvs + (2 * buf + 1) * TC_BK * LD, TC_BK, v_rows, v, dh, tid);
  };

  load_rows<D, THREADS>(vec, qs, 16 * NW, tile_rows(q), q, dh, tid);
  load_rows<D, THREADS>(vec, dos, 16 * NW, tile_rows(dout), dout, dh, tid);
  cp_async_commit();

  // delta of the warp's 16 rows while the tiles load: each row's sum over
  // the warp's lanes, then reduced by xor shuffles; the thread keeps its rows
  // wq + g and wq + g + 8, and lane 0 writes every row for pass 2
  float delta_r[2] = {0.f, 0.f};
  for (int i = 0; i < 16; ++i) {
    const int r = wq + i;
    float sum = 0.f;
    if (r < sq) {
      const size_t off = q_base + (size_t)r * q_row + (size_t)wh * dh;
      for (int d = lane; d < dh; d += 32)
        sum = fmaf(__bfloat162float(dout[off + d]), __bfloat162float(out[off + d]), sum);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (i == g) delta_r[0] = sum;
    if (i == g + 8) delta_r[1] = sum;
    if (lane == 0 && r < sq) delta[row_stat + r] = sum;
  }
  float lse2[2];   // the rows' lse in base 2; +inf past Sq, so p = 0 there
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wq + g + 8 * i;
    lse2[i] = r < sq ? lse[row_stat + r] * TC_LOG2E : __int_as_float(0x7f800000);
  }

  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KS][4], dof[KS][4];   // this warp's 16 rows of Q and dO, for the whole loop
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int off = (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + kk * 16 +
                    (lane >> 4) * 8;
    ldsm_x4(qf[kk], qs + off);
    ldsm_x4(dof[kk], dos + off);
  }
  __syncthreads();      // both buffers are free for the kv tiles
  if (k_begin < k_end) load_kv(0, k_begin);
  cp_async_commit();

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const float c2 = scale * TC_LOG2E;
  const int p_lo = q_offset + wq + g;   // this thread's rows sit at p_lo and p_lo + 8

  int buf = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += TC_BK, buf ^= 1) {
    if (k0 + TC_BK < k_end) load_kv(buf ^ 1, k0 + TC_BK);   // loads while this tile computes
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = kvs + (2 * buf) * TC_BK * LD;
    const bf16* vt = kt + TC_BK * LD;
    const bool interior = k0 + TC_BK <= skv && (!causal || k0 + TC_BK - 1 <= q_first) &&
                          (window < 0 || q_last - k0 < window);

    // per 8 keys: S = Q K^T, dP = dO V^T, then dS = p (dP - delta)
    float ds[ST][4];
#pragma unroll
    for (int j = 0; j < ST; ++j) {
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
      mma_rows<D>(s, qf, kt + j * 8 * LD, lane);
      mma_rows<D>(dp, dof, vt + j * 8 * LD, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = fast_exp2(fmaf(s[e], c2, -lse2[e >> 1]));
        if (!interior) {
          const int kp = k0 + j * 8 + 2 * t4 + (e & 1);
          const int qp = p_lo + (e >> 1) * 8;
          const bool vis = kp < skv && (!causal || qp >= kp) && (window < 0 || qp - kp < window);
          if (!vis) p = 0.f;
        }
        ds[j][e] = p * (dp[e] - delta_r[e >> 1]);
      }
    }
    // dQ += dS K: k-step kk holds keys k0 + 16 kk .. + 15
    mma_acc_tile<D, ST>(acc, ds, kt, lane);
    __syncthreads();   // this buffer is free for the load two tiles on
  }

  bf16* dqb = dq + q_base + (size_t)wh * dh;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = wq + g + (e >> 1) * 8, d = j * 8 + 2 * t4 + (e & 1);
      if (r < sq && d < dh) dqb[(size_t)r * q_row + d] = __float2bfloat16_rn(acc[j][e] * scale);
    }
}

// ---------------------------------------------------------------------------
// pass 2: dk and dv
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int b, int sq, int skv,
                      int hq, int hkv, int dh, int causal, int window, int q_offset, float scale,
                      int vec) {
  constexpr int THREADS = TC_THREADS;
  constexpr int LD = D + TC_PAD;
  constexpr int NT = D / 8;         // n-tiles of dk and dv
  constexpr int ST = BW_BQ / 8;     // n-tiles of the transposed score tile
  extern __shared__ __align__(16) unsigned char bw_smem[];
  bf16* ks = reinterpret_cast<bf16*>(bw_smem);    // [BW_KEYS][LD]
  bf16* vs = ks + BW_KEYS * LD;                   // [BW_KEYS][LD]
  bf16* qdo = vs + BW_KEYS * LD;                  // [buffer][Q, dO][BW_BQ][LD]
  float* stats = reinterpret_cast<float*>(qdo + 4 * BW_BQ * LD);   // [buffer][lse2, delta][BW_BQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int grp = hq / hkv;
  // flat grid, first key tiles (the most causal work) first
  const int units = b * hkv;
  const int k0 = (int)(blockIdx.x / units) * BW_KEYS;
  const int hk = (int)(blockIdx.x % units) % hkv, bi = (int)(blockIdx.x % units) / hkv;
  const size_t q_row = (size_t)hq * dh;
  const size_t kv_row = (size_t)hkv * dh;
  const size_t kv_base = (size_t)bi * skv * kv_row + (size_t)hk * dh;

  // the query rows that see some key of this tile, in tiles of BW_BQ
  const int k_last = min(k0 + BW_KEYS, skv) - 1;
  int r_begin = 0, r_end = sq;
  if (causal) r_begin = max(0, k0 - q_offset);
  if (window >= 0) r_end = min(sq, k_last + window - q_offset);
  r_begin -= r_begin % BW_BQ;
  const int n_qt = r_begin < r_end ? (r_end - r_begin + BW_BQ - 1) / BW_BQ : 0;
  const int n_it = grp * n_qt;      // (query head, query tile), head-major

  auto kv_rows = [&](const bf16* t) {
    return [=](int r) -> const bf16* {
      return k0 + r < skv ? t + kv_base + (size_t)(k0 + r) * kv_row : nullptr;
    };
  };
  auto load_q = [&](int buf, int it) {
    const int h = hk * grp + it / n_qt, q0 = r_begin + (it % n_qt) * BW_BQ;
    const size_t base = (size_t)bi * sq * q_row + (size_t)h * dh;
    auto rows = [&](const bf16* t) {
      return [=](int r) -> const bf16* {
        return q0 + r < sq ? t + base + (size_t)(q0 + r) * q_row : nullptr;
      };
    };
    bf16* qt = qdo + (2 * buf) * BW_BQ * LD;
    load_rows<D, THREADS>(vec, qt, BW_BQ, rows(q), q, dh, tid);
    load_rows<D, THREADS>(vec, qt + BW_BQ * LD, BW_BQ, rows(dout), dout, dh, tid);
    if (tid < BW_BQ) {
      const bool in = q0 + tid < sq;
      const size_t row = ((size_t)bi * hq + h) * sq + q0 + tid;
      stats[(2 * buf) * BW_BQ + tid] = in ? lse[row] * TC_LOG2E : __int_as_float(0x7f800000);
      stats[(2 * buf + 1) * BW_BQ + tid] = in ? delta[row] : 0.f;
    }
  };

  load_rows<D, THREADS>(vec, ks, BW_KEYS, kv_rows(k), k, dh, tid);
  load_rows<D, THREADS>(vec, vs, BW_KEYS, kv_rows(v), v, dh, tid);
  if (n_it > 0) load_q(0, 0);
  cp_async_commit();

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  const float c2 = scale * TC_LOG2E;
  const int wk0 = k0 + 16 * warp;           // this warp's keys wk0 .. wk0 + 15
  const bf16* kw = ks + 16 * warp * LD;
  const bf16* vw = vs + 16 * warp * LD;

  int buf = 0;
  for (int it = 0; it < n_it; ++it, buf ^= 1) {
    if (it + 1 < n_it) load_q(buf ^ 1, it + 1);   // loads while this tile computes
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* qt = qdo + (2 * buf) * BW_BQ * LD;
    const bf16* dot = qt + BW_BQ * LD;
    const float* lse_t = stats + (2 * buf) * BW_BQ;
    const float* delta_t = lse_t + BW_BQ;
    const int qa = q_offset + r_begin + (it % n_qt) * BW_BQ;   // the tile's first position
    const bool interior = wk0 + 16 <= skv && (!causal || wk0 + 15 <= qa) &&
                          (window < 0 || qa + BW_BQ - 1 - wk0 < window);

    // S^T = K Q^T: rows are the warp's keys, n-tile j the queries 8 j .. + 7
    float st[ST][4];
#pragma unroll
    for (int j = 0; j < ST; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = 0.f;
    mma_tile_t<D, ST>(st, kw, qt, lane);
#pragma unroll
    for (int j = 0; j < ST; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t4 + (e & 1);
        float p = fast_exp2(fmaf(st[j][e], c2, -lse_t[col]));
        if (!interior) {
          const int kp = wk0 + g + (e >> 1) * 8, qp = qa + col;
          const bool vis = kp < skv && (!causal || qp >= kp) && (window < 0 || qp - kp < window);
          if (!vis) p = 0.f;
        }
        st[j][e] = p;
      }
    // dV += P^T dO
    mma_acc_tile<D, ST>(dva, st, dot, lane);
    // dP^T = V dO^T, then dS^T = P^T (dP^T - delta)
    float dpt[ST][4];
#pragma unroll
    for (int j = 0; j < ST; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dpt[j][e] = 0.f;
    mma_tile_t<D, ST>(dpt, vw, dot, lane);
#pragma unroll
    for (int j = 0; j < ST; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[j][e] = st[j][e] * (dpt[j][e] - delta_t[j * 8 + 2 * t4 + (e & 1)]);
    // dK += dS^T Q
    mma_acc_tile<D, ST>(dka, dpt, qt, lane);
    __syncthreads();   // this buffer is free for the load two tiles on
  }

#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = wk0 + g + (e >> 1) * 8, d = j * 8 + 2 * t4 + (e & 1);
      if (key < skv && d < dh) {
        const size_t off = kv_base + (size_t)key * kv_row + d;
        dk[off] = __float2bfloat16_rn(dka[j][e] * scale);
        dv[off] = __float2bfloat16_rn(dva[j][e]);
      }
    }
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* out,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int b, int sq, int skv, int hq, int hkv, int dh, int causal,
                       int window, int q_offset, float scale, int vec, cudaStream_t stream) {
  constexpr size_t dq_bytes = dq_smem_bytes<D>(), dkdv_bytes = dkdv_smem_bytes<D>();
  cudaError_t rc = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)dq_bytes);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkdv_bytes);
  if (rc != cudaSuccess) return rc;
  const int grp = hq / hkv;
  int hg = 1;   // query heads per pass-1 CTA, as the forward: the largest power of two <= 8
  while (hg * 2 <= TC_WARPS && grp % (hg * 2) == 0) hg *= 2;
  const int qpos = 16 * TC_WARPS / hg;
  const long long dq_blocks = (long long)ceil_div(sq, qpos) * b * hkv * (grp / hg);
  const long long dkdv_blocks = (long long)ceil_div(skv, BW_KEYS) * b * hkv;
  if (dq_blocks > 0x7fffffffLL || dkdv_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v), *dob = static_cast<const bf16*>(dout);
  flash_bwd_dq_kernel<D><<<(unsigned)dq_blocks, TC_THREADS, dq_bytes, stream>>>(
      qb, kb, vb, static_cast<const bf16*>(out), dob, lse, delta, static_cast<bf16*>(dq), b, sq,
      skv, hq, hkv, dh, causal, window, q_offset, scale, hg, vec);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  flash_bwd_dkdv_kernel<D><<<(unsigned)dkdv_blocks, TC_THREADS, dkdv_bytes, stream>>>(
      qb, kb, vb, dob, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), b, sq, skv,
      hq, hkv, dh, causal, window, q_offset, scale, vec);
  return cudaGetLastError();
}

// f(std::integral_constant<int, D>) for the tile width of dh: dh rounded up to
// a multiple of 16, 16 .. 128
template <typename F>
cudaError_t with_tile(int dh, F&& f) {
  switch ((dh + 15) / 16) {
    case 1: return f(std::integral_constant<int, 16>{});
    case 2: return f(std::integral_constant<int, 32>{});
    case 3: return f(std::integral_constant<int, 48>{});
    case 4: return f(std::integral_constant<int, 64>{});
    case 5: return f(std::integral_constant<int, 80>{});
    case 6: return f(std::integral_constant<int, 96>{});
    case 7: return f(std::integral_constant<int, 112>{});
    case 8: return f(std::integral_constant<int, 128>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The backward of repro_flash_attention's bf16 kernel: pass 1 (delta, dq)
// then pass 2 (dk, dv) on `stream`.  window < 0 means no sliding window;
// delta is (B, Hq, Sq) f32 scratch.  Every size must be at least 1.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* out, const void* dout, const void* lse,
                                         void* delta, void* dq, void* dk, void* dv, int b, int sq,
                                         int skv, int hq, int hkv, int dh, int causal, int window,
                                         int q_offset, float scale, void* stream) {
  if (b < 1 || sq < 1 || skv < 1 || dh < 1 || dh > 128 || hkv < 1 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte cp.async needs every row start 16-byte aligned (out is read
  // element by element)
  const int vec = dh % 8 == 0 &&
                  ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout) % 16 == 0;
  return static_cast<int>(with_tile(dh, [&](auto tile) {
    return launch_bwd<decltype(tile)::value>(
        q, k, v, out, dout, static_cast<const float*>(lse), static_cast<float*>(delta), dq, dk,
        dv, b, sq, skv, hq, hkv, dh, causal, window, q_offset, scale, vec,
        static_cast<cudaStream_t>(stream));
  }));
}

// A kernel body, for csrc/attributes.cu: body 0 pass 1 (flash_bwd_dq_kernel),
// 1 pass 2 (flash_bwd_dkdv_kernel), with the tile of head dim dh (a multiple
// of 16, 16 .. 128).  *fn is the kernel, *dyn the dynamic shared bytes its
// launch requests.
extern "C" int repro_flash_attention_bwd_body(int body, int dh, int unused0, int unused1,
                                              int unused2, const void** fn, int* dyn) {
  (void)unused0;
  (void)unused1;
  (void)unused2;
  if (dh % 16 != 0 || (body != 0 && body != 1)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_tile(dh, [&](auto tile) {
    constexpr int D = decltype(tile)::value;
    *fn = body == 0 ? (const void*)flash_bwd_dq_kernel<D> : (const void*)flash_bwd_dkdv_kernel<D>;
    *dyn = (int)(body == 0 ? dq_smem_bytes<D>() : dkdv_smem_bytes<D>());
    return cudaSuccess;
  }));
}
