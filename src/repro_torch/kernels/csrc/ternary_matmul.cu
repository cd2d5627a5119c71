// ternary_matmul: y (b, p) = scale * x (b, m) @ R (p, m)^T, R int8 ternary.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ternary_matmul.py
// (ternary_matmul / _kernel).
//
// Bound on the H100: the work R's nonzeros need, 2*b*nnz(R) adds, against
// x, R (one byte an entry) and y moved once.  At the repo's wide row (b = 256,
// m = 1024, p = 256, R of density 1/p, about 1,030 nonzeros) the bytes bound
// it, and a kernel is bound by latency: launch and a few round trips to
// memory.  A dense product would do 256 times the work, 99.6% of it on zeros.
//
// Two bodies, chosen by R's size (repro_ternary_matmul_plan), one launch
// each, both f32 exact (adds or FMAs in f32, never TF32; bf16 x widened; the
// sum scaled once and rounded once to x's dtype; no atomics, so the same
// inputs give the same bits on every run):
//   - dense, for R of fewer than FT_DENSE_MAX_R entries (the paper's 24 x
//     32): one CTA owns one 32 x 32 output tile and loops over the whole
//     contraction in chunks of 32 (the TPU grid's k axis becomes this loop).
//     R is widened to f32 on its way into shared memory.  At these sizes its
//     one short round trip per chunk beats any encoding.
//   - sparse, for larger R: work in proportion to R's nonzeros, with the
//     encoding and projection of ternary_encode.cuh (B1's): each warp builds
//     "nonzero" / "negative" ballot masks of its rows of R per call, visits
//     only the nonzero words, and adds or subtracts x where bits are set,
//     lanes running over 32 rows of x.  Each column of y depends on one row
//     of R alone, so the p tiles are independent: no partials and no second
//     launch.  Grid: (row tiles of 32 RL) x (p tiles), the p tile chosen as
//     for B1 so that a small batch still puts about two CTAs on each SM (8 x
//     32 = 256 CTAs at the wide row with 32-row tiles).  The scaled y tile
//     sits in shared memory, padded so that the epilogue reads it without
//     bank conflicts, and is written coalesced along p.
//     Tiles: the body is templated over RL (32 or 64 rows of x a CTA) and PT
//     (at most 16, 32 or 64 rows of R a CTA), ternary_encode.cuh's tile
//     templates; the caller names one (Execution.tmm_block_m / _p, clamped
//     by kernels/resource_model.py); each sums every output in a fixed
//     order, so it gives the same bits on every run.
#include "ternary_encode.cuh"

using namespace repro_torch;

namespace {

template <typename TX>
__global__ void __launch_bounds__(NTHREADS)
ternary_matmul_dense_kernel(const TX* __restrict__ x, const int8_t* __restrict__ r,
                            TX* __restrict__ out, int b, int m, int p, float scale) {
  __shared__ float xs[TK][TILE + 1];  // x tile, transposed: xs[k][row]
  __shared__ float rs[TK][TILE + 1];  // R tile widened to f32: rs[k][col]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * HALF + tx;
  const int row0 = blockIdx.x * TILE, col0 = blockIdx.y * TILE;

  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int k0 = 0; k0 < m; k0 += TK) {
    for (int e = tid; e < TILE * TK; e += NTHREADS) {
      const int i = e / TK, kk = e % TK;  // neighbouring threads: neighbouring k
      const int gk = k0 + kk;
      const int gr = row0 + i, gc = col0 + i;
      xs[kk][i] = (gr < b && gk < m) ? to_f32(x[(size_t)gr * m + gk]) : 0.f;
      rs[kk][i] = (gc < p && gk < m) ? (float)r[(size_t)gc * m + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      const float a0 = xs[kk][ty], a1 = xs[kk][ty + HALF];
      const float b0 = rs[kk][tx], b1 = rs[kk][tx + HALF];
      acc[0][0] = fmaf(a0, b0, acc[0][0]);
      acc[0][1] = fmaf(a0, b1, acc[0][1]);
      acc[1][0] = fmaf(a1, b0, acc[1][0]);
      acc[1][1] = fmaf(a1, b1, acc[1][1]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int gr = row0 + ty + i * HALF, gc = col0 + tx + j * HALF;
      if (gr < b && gc < p) out[(size_t)gr * p + gc] = from_f32<TX>(acc[i][j] * scale);
    }
  }
}

// ---- sparse body -----------------------------------------------------------

template <int RL, int PT>
struct TmSmem {
  float ys[PT][FT_ROWS * RL + 1];         // y tile; row 32 u + r of x sits in column
                                          // 32 u + (r % 4) * 8 + r / 4
  float xs[FT_WARPS][32][ft_xld<RL>()];   // a warp's staged chunk of x, transposed:
                                          // xs[w][k][row]
  int queue[FT_WARPS][FT_QUEUE];          // a warp's queued reads: col << 7 | j << 1 | negative
};

template <typename TX, int RL, int PT>
__global__ void __launch_bounds__(FT_THREADS, 2)
ternary_matmul_sparse_kernel(const TX* __restrict__ x, const int8_t* __restrict__ r,
                             TX* __restrict__ out, int b, int m, int p, int pt, float scale) {
  extern __shared__ __align__(16) unsigned char tm_smem[];
  TmSmem<RL, PT>& sm = *reinterpret_cast<TmSmem<RL, PT>*>(tm_smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * FT_ROWS * RL, p0 = blockIdx.y * pt;
  const int np = min(pt, p - p0);
  ft_project<RL>(sm.ys, sm.xs[warp], sm.queue[warp], x, r, row0, b, m, p0, np, scale, warp,
                 lane);
  __syncthreads();
  // neighbouring threads write neighbouring columns of a row of y
  const int nr = min(FT_ROWS * RL, b - row0);
  for (int e = tid; e < nr * np; e += FT_THREADS) {
    const int i = e / np, j = e % np, ii = i & (FT_ROWS - 1);
    out[(size_t)(row0 + i) * p + p0 + j] =
        from_f32<TX>(sm.ys[j][(i / FT_ROWS) * FT_ROWS + (ii & 3) * 8 + (ii >> 2)]);
  }
}

template <typename TX, int RL, int PT>
cudaError_t launch_sparse(const TX* x, const int8_t* r, TX* out, int b, int m, int p, int tiles,
                          float scale, cudaStream_t stream) {
  constexpr int bytes = (int)sizeof(TmSmem<RL, PT>);   // above 48 KB at RL = 2: opt in
  const cudaError_t rc = cudaFuncSetAttribute(ternary_matmul_sparse_kernel<TX, RL, PT>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return rc;
  const dim3 grid(ceil_div(b, FT_ROWS * RL), tiles);
  ternary_matmul_sparse_kernel<TX, RL, PT><<<grid, FT_THREADS, bytes, stream>>>(
      x, r, out, b, m, p, ceil_div(p, tiles), scale);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch(const void* x, const int8_t* r, void* out, int b, int m, int p, int tiles,
                   int bm, int bp, float scale, cudaStream_t stream) {
  const TX* xt = static_cast<const TX*>(x);
  TX* ot = static_cast<TX*>(out);
  if (tiles == 0) {
    const dim3 grid(ceil_div(b, TILE), ceil_div(p, TILE));
    ternary_matmul_dense_kernel<TX><<<grid, dim3(HALF, HALF), 0, stream>>>(xt, r, ot, b, m, p,
                                                                            scale);
    return cudaGetLastError();
  }
  return ft_with_tile(bm, bp, cudaErrorInvalidValue, [&](auto t) {
    using T = decltype(t);
    return launch_sparse<TX, T::RL, T::PT>(xt, r, ot, b, m, p, tiles, scale, stream);
  });
}

template <typename TX>
const void* sparse_body(int bm, int bp) {
  return ft_with_tile(bm, bp, (const void*)nullptr, [](auto t) {
    using T = decltype(t);
    return (const void*)ternary_matmul_sparse_kernel<TX, T::RL, T::PT>;
  });
}

int sparse_bytes(int bm, int bp) {
  return ft_with_tile(bm, bp, -1, [](auto t) {
    using T = decltype(t);
    return (int)sizeof(TmSmem<T::RL, T::PT>);
  });
}

}  // namespace

// The body a call of x (b, m) and R (p, m) with the sparse tile template (bm,
// bp) takes on the current device: *tiles = 0 for the dense body, else the
// sparse body's number of p tiles.  Either body is one launch.
extern "C" int repro_ternary_matmul_plan(int b, int m, int p, int bm, int bp, int* tiles) {
  if (b < 1 || m < 0 || p < 1 || tiles == nullptr || !ft_tile_ok(bm, bp))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)p * m < FT_DENSE_MAX_R) {
    *tiles = 0;
    return 0;
  }
  int sms = 0;
  const cudaError_t rc = sm_count(&sms);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  *tiles = ft_p_tiles(b, p, sms, bp, bm);
  return 0;
}

extern "C" int repro_ternary_matmul(const void* x, const void* r, void* out, int b, int m,
                                    int p, int bm, int bp, float scale, int x_dtype,
                                    void* stream) {
  if (m >= (1 << 24)) return static_cast<int>(cudaErrorInvalidValue);   // queue entries
  int tiles = 0;
  const int rc = repro_ternary_matmul_plan(b, m, p, bm, bp, &tiles);
  if (rc != 0) return rc;
  const int8_t* r8 = static_cast<const int8_t*>(r);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32) return static_cast<int>(
      launch<float>(x, r8, out, b, m, p, tiles, bm, bp, scale, s));
  if (x_dtype == kBF16) return static_cast<int>(
      launch<__nv_bfloat16>(x, r8, out, b, m, p, tiles, bm, bp, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// A kernel body, for csrc/attributes.cu: body 0 the dense body, 1 the sparse
// body with the tile template (bm, bp); x_dtype as above.  *fn is the kernel,
// *dyn the dynamic shared bytes its launch requests.
extern "C" int repro_ternary_matmul_body(int body, int x_dtype, int bm, int bp, int unused,
                                         const void** fn, int* dyn) {
  (void)unused;
  const bool f32 = x_dtype == kF32;
  if (!f32 && x_dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
  *dyn = 0;
  if (body == 0) {
    *fn = f32 ? (const void*)ternary_matmul_dense_kernel<float>
              : (const void*)ternary_matmul_dense_kernel<__nv_bfloat16>;
  } else if (body == 1 && ft_tile_ok(bm, bp)) {
    *fn = f32 ? sparse_body<float>(bm, bp) : sparse_body<__nv_bfloat16>(bm, bp);
    *dyn = sparse_bytes(bm, bp);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}
