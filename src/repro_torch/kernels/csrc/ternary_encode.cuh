// The ternary-sparse projection shared by fused_transform's sparse body and
// ternary_matmul's sparse body: y tile (32 RL rows of x, np rows of R) =
// x_tile @ R_tile^T in f32, in proportion to R's nonzeros.
//
// Encoding, built inside the CTA and never cached: warp w owns rows w, w + 8,
// ... of the CTA's rows of R.  For each row and 32-column chunk it makes two
// 32-bit words, "nonzero" and "negative", with __ballot_sync over one
// coalesced 32-byte read; FT_EB reads are in flight at a time.
//
// Projection: lanes run over the rows of x (RL of them a lane: lane + 32 u,
// u < RL), so the warp walks each word without diverging: for each set bit,
// y += neg ? -x : x.  A CTA of 64 rows (RL = 2) encodes each word of R once
// for twice the rows of a 32-row CTA.  It visits only the nonzero words of a
// batch (a ballot lists them).  A word with few set bits (the density-1/p
// case) queues its columns, and the warp reads them straight from device
// memory, FT_BATCH reads in flight a lane and row; a word with FT_STAGE or
// more stages its 32-column chunk of x in the warp's own shared memory,
// transposed and zero-filled, and reads it there.  No step waits on another
// warp.  The staging and the queue's reads are out-of-line functions (called
// from several places, kept once), which keeps the kernels' code and
// registers small.
//
// Tile shapes: the bodies are templated over RL (rows of x a CTA: 32 RL, RL
// in {1, 2}) and PT (rows of R a CTA at most: 16, 32 or 64), the points the
// serving engine's tile race (kernels/autotune.py) chooses among; the
// resource model (kernels/resource_model.py) prices each one.
#pragma once

#include "common.cuh"

namespace repro_torch {

constexpr unsigned FULL = 0xffffffffu;
constexpr int FT_ROWS = 32;        // rows of x per CTA and RL: one per lane
constexpr int FT_WARPS = 8;
constexpr int FT_THREADS = 32 * FT_WARPS;
constexpr int FT_PMAX = 64;        // rows of R per CTA at most (the largest PT)
constexpr int FT_PMIN = FT_WARPS;  // and at least one for each warp, where p allows
constexpr int FT_CTAS_PER_SM = 2;  // the sparse grid's target
constexpr int FT_DENSE_MAX_R = 65536;   // a smaller R (p * m entries) takes the dense body
constexpr int FT_EB = 16;          // reads of R in flight per warp
constexpr int FT_SB = 16;          // reads of x in flight per lane while staging
constexpr int FT_STAGE = 8;        // a word with this many set bits stages its chunk
constexpr int FT_BATCH = 8;        // direct reads of x in flight per lane
constexpr int FT_QUEUE = 64;       // queued direct reads per warp

// padded row of a staged chunk of 32 RL rows
template <int RL> constexpr int ft_xld() { return FT_ROWS * RL + 1; }

// An empty asm that needs v: the loads that feed v are all issued before it,
// so loads written together are in flight together.
__device__ __forceinline__ void hold(uint32_t v) { asm volatile("" ::"r"(v)); }

// stage chunk cc of x for the warp: lane l loads column 32 cc + l of the
// 32 RL rows, transposed into xs[l][row], zero past rows and m
template <int RL, typename TX>
__device__ __noinline__ void ft_stage(float (*xs)[ft_xld<RL>()], const TX* __restrict__ x,
                                      int row0, int rows, int m, int cc, int lane) {
  const int col = cc * 32 + lane;
#pragma unroll
  for (int h0 = 0; h0 < FT_ROWS * RL; h0 += FT_SB) {
    float xv[FT_SB];
    uint32_t hh = 0;
#pragma unroll
    for (int u = 0; u < FT_SB; ++u) {
      const int g = row0 + h0 + u;
      xv[u] = (g < rows && col < m) ? to_f32(x[(size_t)g * m + col]) : 0.f;
      hh |= __float_as_uint(xv[u]);
    }
    hold(hh);
#pragma unroll
    for (int u = 0; u < FT_SB; ++u) xs[lane][h0 + u] = xv[u];
  }
}

// add the queued columns of x into y, FT_BATCH reads in flight a row; row u
// of the lane is xrow + 32 u m, read where bit u of rows_in is set
template <int RL, int LD, typename TX>
__device__ __noinline__ void ft_flush(const int* q, int qlen, float (*ys)[LD],
                                      const TX* xrow, int m, unsigned rows_in, int pl) {
  for (int i0 = 0; i0 < qlen; i0 += FT_BATCH) {
    int ent[FT_BATCH];
    float xv[FT_BATCH][RL];
    uint32_t h = 0;
#pragma unroll
    for (int t = 0; t < FT_BATCH; ++t) {
      ent[t] = i0 + t < qlen ? q[i0 + t] : -1;
#pragma unroll
      for (int u = 0; u < RL; ++u) {
        xv[t][u] = (((rows_in >> u) & 1u) && ent[t] >= 0)
                       ? to_f32(xrow[(size_t)u * FT_ROWS * m + (ent[t] >> 7)]) : 0.f;
        h |= __float_as_uint(xv[t][u]);
      }
    }
    hold(h);
#pragma unroll
    for (int t = 0; t < FT_BATCH; ++t) {
      if (ent[t] < 0) continue;
      float* y = ys[(ent[t] >> 1) & (FT_PMAX - 1)] + pl;
#pragma unroll
      for (int u = 0; u < RL; ++u) y[FT_ROWS * u] += (ent[t] & 1) ? -xv[t][u] : xv[t][u];
    }
  }
}

// The warp's share of the projection: ys[j][pl + 32 u] = scale * sum_k x[row0
// + lane + 32 u][k] * R[p0 + j][k] for the rows j = warp + 8 i of the CTA's np
// rows of R and u < RL, in f32 (the sum scaled once); pl = (lane & 3) * 8 +
// (lane >> 2) is the lane's column of ys in each block of 32.  xs and q are
// the warp's own staging chunk and queue.  Only the warp itself reads or
// writes them, or its rows of ys, so no CTA-wide barrier is needed before
// it; the caller syncs before reading other warps' rows.
template <int RL, int LD, typename TX>
__device__ __forceinline__ void ft_project(float (*ys)[LD], float (*xs)[ft_xld<RL>()], int* q,
                                           const TX* __restrict__ x,
                                           const int8_t* __restrict__ r, int row0, int rows,
                                           int m, int p0, int np, float scale, int warp,
                                           int lane) {
  const int gr = row0 + lane;
  unsigned rows_in = 0;
#pragma unroll
  for (int u = 0; u < RL; ++u)
    if (gr + FT_ROWS * u < rows) rows_in |= 1u << u;
  const TX* xrow = x + (size_t)(rows_in ? gr : 0) * m;
  const int pl = (lane & 3) * 8 + (lane >> 2);
  const int nchunks = (m + 31) / 32;

  // rows of R this warp owns: j = warp + 8 i, i < nrw; ys[j][pl + 32 u] are this lane's
  const int nrw = np > warp ? (np - 1 - warp) / FT_WARPS + 1 : 0;
  for (int i = 0; i < nrw; ++i)
#pragma unroll
    for (int u = 0; u < RL; ++u) ys[warp + FT_WARPS * i][pl + FT_ROWS * u] = 0.f;
  int qlen = 0, staged = -1;   // warp-uniform

  // (chunk, row) pairs in order, row fastest
  const int npairs = nrw * nchunks;
  for (int s0 = 0; s0 < npairs; s0 += FT_EB) {
    int v[FT_EB];
    uint32_t h = 0;
    {
      int c = s0 / nrw, i = s0 % nrw;
#pragma unroll
      for (int t = 0; t < FT_EB; ++t) {
        const int col = c * 32 + lane;
        v[t] = (s0 + t < npairs && col < m)
                   ? r[(size_t)(p0 + warp + FT_WARPS * i) * m + col] : 0;
        h |= (uint32_t)v[t];
        if (++i == nrw) {
          i = 0;
          ++c;
        }
      }
    }
    hold(h);
    uint32_t my_nz = 0, my_ng = 0;   // lane t keeps the words of slot t
#pragma unroll
    for (int t = 0; t < FT_EB; ++t) {
      const uint32_t nz = __ballot_sync(FULL, v[t] != 0);
      const uint32_t ng = __ballot_sync(FULL, v[t] < 0);
      if (lane == t) {
        my_nz = nz;
        my_ng = ng;
      }
    }
    // only the slots with a nonzero word, in order (about 1 in 8 of them at
    // density 1/p); slots past npairs read zeros
    uint32_t live = __ballot_sync(FULL, my_nz != 0);
    while (live) {
      const int t = __ffs(live) - 1;
      live &= live - 1;
      const uint32_t bits = __shfl_sync(FULL, my_nz, t);
      const uint32_t neg = __shfl_sync(FULL, my_ng, t);
      const int cc = (s0 + t) / nrw, j = warp + FT_WARPS * ((s0 + t) % nrw);
      const int cnt = __popc(bits);
      if (cnt >= FT_STAGE) {
        if (staged != cc) {
          __syncwarp();
          ft_stage<RL>(xs, x, row0, rows, m, cc, lane);
          __syncwarp();
          staged = cc;
        }
        float y[RL];
#pragma unroll
        for (int u = 0; u < RL; ++u) y[u] = ys[j][pl + FT_ROWS * u];
        uint32_t b2 = bits;
        while (b2) {
          const int bit = __ffs(b2) - 1;
          b2 &= b2 - 1;
          const bool ng_bit = (neg >> bit) & 1u;
#pragma unroll
          for (int u = 0; u < RL; ++u) {
            const float xv = xs[bit][lane + FT_ROWS * u];
            y[u] += ng_bit ? -xv : xv;
          }
        }
#pragma unroll
        for (int u = 0; u < RL; ++u) ys[j][pl + FT_ROWS * u] = y[u];
      } else {
        if (qlen + cnt > FT_QUEUE) {
          __syncwarp();
          ft_flush<RL>(q, qlen, ys, xrow, m, rows_in, pl);
          qlen = 0;
          __syncwarp();
        }
        if ((bits >> lane) & 1u)
          q[qlen + __popc(bits & ((1u << lane) - 1u))] =
              ((cc * 32 + lane) << 7) | (j << 1) | (int)((neg >> lane) & 1u);
        qlen += cnt;
      }
    }
  }
  __syncwarp();
  ft_flush<RL>(q, qlen, ys, xrow, m, rows_in, pl);
  for (int i = 0; i < nrw; ++i)
#pragma unroll
    for (int u = 0; u < RL; ++u) ys[warp + FT_WARPS * i][pl + FT_ROWS * u] *= scale;
}

// The sparse bodies' number of p tiles for x (rows, m) and R (p, m) on a card
// of `sms` SMs, with CTAs of cta_rows rows of x and at most pmax rows of R:
// pmax rows of R a CTA, or fewer (down to FT_PMIN) where the row tiles alone
// would put fewer than FT_CTAS_PER_SM CTAs on each SM.
__host__ inline int ft_p_tiles(int rows, int p, int sms, int pmax, int cta_rows) {
  const int row_tiles = ceil_div(rows, cta_rows), target = FT_CTAS_PER_SM * sms;
  int splits = ceil_div(p, pmax);
  if (row_tiles < target)   // more p tiles, down to FT_PMIN rows of R each
    splits = max(splits, min(ceil_div(p, FT_PMIN), ceil_div(target, row_tiles)));
  return ceil_div(p, ceil_div(p, splits));
}

// The sparse bodies' tile templates, (rows of x, rows of R at most) a CTA:
// the one list the C++ keeps (kernels/resource_model.py TILE_ROWS x TILE_P).
// ft_with_tile(bm, bp, bad, f) returns f(FtTile<RL, PT>{}) for the template
// (bm, bp) = (32 RL, PT), and `bad` for any other pair.
template <int RL_, int PT_>
struct FtTile {
  static constexpr int RL = RL_, PT = PT_;
};

template <typename R, typename F>
__host__ inline R ft_with_tile(int bm, int bp, R bad, F&& f) {
  switch (bm * 100 + bp) {
    case 3216: return f(FtTile<1, 16>{});
    case 3232: return f(FtTile<1, 32>{});
    case 3264: return f(FtTile<1, 64>{});
    case 6416: return f(FtTile<2, 16>{});
    case 6432: return f(FtTile<2, 32>{});
    case 6464: return f(FtTile<2, 64>{});
    default: return bad;
  }
}

__host__ inline bool ft_tile_ok(int bm, int bp) {
  return ft_with_tile(bm, bp, false, [](auto) { return true; });
}

}  // namespace repro_torch
