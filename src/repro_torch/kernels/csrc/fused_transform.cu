// fused_transform: out (rows, n) = (scale * x (rows, m) @ R (p, m)^T) @ B (n, p)^T
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_transform.py
// (fused_transform / _kernel): the serve transform of an RP -> EASI pair.
//
// Bound on the H100: the work R's nonzeros need, 2*rows*nnz(R) adds for the
// projection and 2*rows*p*n f32 FMAs for the whitening product, against x,
// R (one byte an entry), B and out moved once.  At the repo's shapes (R of
// density 1/p) the bytes bound it, and the kernel is bound by latency: a
// few round trips to memory per CTA.
//
// Two bodies, chosen by R's size (repro_fused_transform_tiles), both f32
// exact (FMAs or adds in f32, never TF32; bf16 inputs widened; y scaled
// once, in f32; out rounded once to B's dtype):
//   - dense, for R of fewer than FT_DENSE_MAX_R entries (the paper's 24 x
//     32): one CTA owns 32 rows and 64 columns of out, loops over p in
//     tiles of 32, builds each y tile over the whole of k with the 2 x 2
//     register tiles of common.cuh (R widened on its way into shared
//     memory), and adds y @ B_tile^T into an f32 output tile in registers.
//     At these sizes its one short round trip per tile beats any encoding.
//   - sparse, for larger R: work in proportion to R's nonzeros and a grid
//     that fills the card.
//       - Grid: (row tiles of 32 RL) x (p tiles of pt rows of R).  pt (at
//         most PT) is chosen so that a small batch still puts about two CTAs
//         on each SM (256 CTAs at (256, 1024, 256, 128) with 32-row tiles);
//         where the row tiles alone fill the card, pt is PT.
//       - Tiles: templated over RL (32 or 64 rows of x a CTA) and PT (at most
//         16, 32 or 64 rows of R a CTA), ternary_encode.cuh's tile
//         templates; the caller names one (Execution.tmm_block_m / _p,
//         clamped by kernels/resource_model.py).  Each sums every output in
//         a fixed order (within a p tile, then the partials in p-tile
//         order), so it gives the same bits on every run; tiles that split
//         p differently round differently.
//       - Encoding and projection: ternary_encode.cuh (shared with
//         ternary_matmul's sparse body): per-warp "nonzero" / "negative"
//         ballot masks of R, built per call and never cached; lanes run
//         over 32 rows of x and add or subtract x where bits are set.
//       - Occupancy: the kernel is held to 128 registers so that two CTAs
//         share an SM and the wide grid runs in one wave.
//       - Whitening: the scaled y tile (32 x pt, f32, shared memory) times
//         B's matching slice, which is loaded before the encoding when it
//         fits in shared memory.  With one p tile the CTA rounds the sum to
//         B's dtype and writes out; otherwise it writes an f32 partial to
//         scratch, and a second launch sums the partials of each output in
//         p-tile order (no float atomics, the same result on every run) and
//         rounds once to B's dtype.  That launch is a programmatic
//         dependent (Hopper's PDL), scheduled while the main grid drains.
#include "ternary_encode.cuh"

using namespace repro_torch;

namespace {

constexpr int FT_DN = 64;          // dense body: output columns per CTA
constexpr int FT_NC = 64;          // output columns per pass of the product
constexpr int FT_BCAP = 4224;      // floats of B's slice held in shared memory
constexpr int FT_BPT = 16;         // of them loaded per thread before the encoding
constexpr int FT_SUM_THREADS = 256;
constexpr int FT_SUM_BATCH = 32;   // partials read at once by the summing pass

// ---- dense body ------------------------------------------------------------

template <typename TX, typename TB>
__global__ void __launch_bounds__(NTHREADS)
fused_transform_dense_kernel(const TX* __restrict__ x, const int8_t* __restrict__ r,
                             const TB* __restrict__ bmat, TB* __restrict__ out,
                             int rows, int m, int p, int n, float scale) {
  constexpr int NJ = FT_DN / HALF;      // output columns per thread
  __shared__ float xs[TK][TILE + 1];    // x tile, transposed: xs[k][row]
  __shared__ float rs[TK][TILE + 1];    // R tile widened to f32: rs[k][p]
  __shared__ float ys[TILE][TILE + 1];  // scaled y tile: ys[row][p], f32
  __shared__ float bs[TILE][FT_DN + 1]; // B tile, transposed: bs[p][n]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * HALF + tx;
  const int row0 = blockIdx.x * TILE, n0 = blockIdx.y * FT_DN;

  float acc[2][NJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int p0 = 0; p0 < p; p0 += TILE) {
    float ya[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int k0 = 0; k0 < m; k0 += TK) {
      for (int e = tid; e < TILE * TK; e += NTHREADS) {
        const int i = e / TK, kk = e % TK;
        const int gk = k0 + kk;
        const int gr = row0 + i, gp = p0 + i;
        xs[kk][i] = (gr < rows && gk < m) ? to_f32(x[(size_t)gr * m + gk]) : 0.f;
        rs[kk][i] = (gp < p && gk < m) ? (float)r[(size_t)gp * m + gk] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < TK; ++kk) {
        const float a0 = xs[kk][ty], a1 = xs[kk][ty + HALF];
        const float b0 = rs[kk][tx], b1 = rs[kk][tx + HALF];
        ya[0][0] = fmaf(a0, b0, ya[0][0]);
        ya[0][1] = fmaf(a0, b1, ya[0][1]);
        ya[1][0] = fmaf(a1, b0, ya[1][0]);
        ya[1][1] = fmaf(a1, b1, ya[1][1]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) ys[ty + i * HALF][tx + j * HALF] = ya[i][j] * scale;
    for (int e = tid; e < FT_DN * TILE; e += NTHREADS) {
      const int jn = e / TILE, jp = e % TILE;  // neighbouring threads: neighbouring p
      const int gn = n0 + jn, gp = p0 + jp;
      bs[jp][jn] = (gn < n && gp < p) ? to_f32(bmat[(size_t)gn * p + gp]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int jp = 0; jp < TILE; ++jp) {
      const float y0 = ys[ty][jp], y1 = ys[ty + HALF][jp];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float bv = bs[jp][tx + j * HALF];
        acc[0][j] = fmaf(y0, bv, acc[0][j]);
        acc[1][j] = fmaf(y1, bv, acc[1][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int gr = row0 + ty + i * HALF, gn = n0 + tx + j * HALF;
      if (gr < rows && gn < n) out[(size_t)gr * n + gn] = from_f32<TB>(acc[i][j]);
    }
  }
}

// ---- sparse body -----------------------------------------------------------

template <int RL, int PT>
struct FtSmem {
  float ys[PT][FT_ROWS * RL];             // y tile; row 32 u + r of x sits in column
                                          // 32 u + (r % 4) * 8 + r / 4
  float xs[FT_WARPS][32][ft_xld<RL>()];   // a warp's staged chunk of x, transposed:
                                          // xs[w][k][row]
  int queue[FT_WARPS][FT_QUEUE];          // a warp's queued reads: col << 7 | j << 1 | negative
  float bs[FT_BCAP + FT_NC];              // B's slice, bs[j * ld + col] (the pad keeps the
                                          // last pass's out-of-range columns inside the array)
};

template <typename TX, typename TB, int RL, int PT>
__global__ void __launch_bounds__(FT_THREADS, 2)
fused_transform_kernel(const TX* __restrict__ x, const int8_t* __restrict__ r,
                       const TB* __restrict__ bmat, TB* __restrict__ out,
                       float* __restrict__ part, int rows, int m, int p, int n, int pt,
                       float scale) {
  extern __shared__ __align__(16) unsigned char ft_smem[];
  FtSmem<RL, PT>& sm = *reinterpret_cast<FtSmem<RL, PT>*>(ft_smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * FT_ROWS * RL, p0 = blockIdx.y * pt;
  const int np = min(pt, p - p0);
  // B's slice is held whole when it fits (else it is staged 64 output
  // columns at a time in the product); a thread's first FT_BPT elements
  // (B[c][p0 + j], j fastest) are loaded now, their round trip overlapping
  // the encoding's
  const bool b_whole = np * (n + 1) <= FT_BCAP;
  const int bld = b_whole ? n + 1 : FT_NC + 1;
  const int nb = b_whole ? np * n : 0;
  const int np1 = max(np, 1);
  const int dc = FT_THREADS / np1, dj = FT_THREADS % np1;
  float bpre[FT_BPT];
  {
    int c = tid / np1, j = tid % np1;
#pragma unroll
    for (int t = 0; t < FT_BPT; ++t) {
      bpre[t] = tid + FT_THREADS * t < nb ? to_f32(bmat[(size_t)c * p + p0 + j]) : 0.f;
      j += dj;
      c += dc;
      if (j >= np1) {
        j -= np1;
        ++c;
      }
    }
  }

  ft_project<RL>(sm.ys, sm.xs[warp], sm.queue[warp], x, r, row0, rows, m, p0, np, scale, warp,
                 lane);

  // out tile (32 RL rows x n) += y (32 RL x np) @ B[:, p0 : p0 + np]^T; thread
  // (rg, cc) owns rows 32 u + rg + 4 i (ys columns 32 u + 8 rg + i) of output
  // column cc
  const int cc = tid % FT_NC, rg = tid / FT_NC;
  if (b_whole) {
    int c = tid / np1, j = tid % np1;
#pragma unroll
    for (int t = 0; t < FT_BPT; ++t) {
      if (tid + FT_THREADS * t < nb) sm.bs[j * bld + c] = bpre[t];
      j += dj;
      c += dc;
      if (j >= np1) {
        j -= np1;
        ++c;
      }
    }
    for (int e = tid + FT_THREADS * FT_BPT; e < nb; e += FT_THREADS)
      sm.bs[(e % np) * bld + e / np] = to_f32(bmat[(size_t)(e / np) * p + p0 + e % np]);
  }
  __syncthreads();   // ys and B's slice complete
  // the summing pass may be scheduled from here on; it waits for this
  // whole grid, and its writes, before it reads a partial
  asm volatile("griddepcontrol.launch_dependents;");
  for (int n0 = 0; n0 < n; n0 += FT_NC) {
    if (!b_whole) {
      if (n0 > 0) __syncthreads();   // the previous pass no longer reads bs
      for (int e = tid; e < np * FT_NC; e += FT_THREADS) {
        const int j = e % np, c = e / np;   // neighbouring threads: neighbouring p
        sm.bs[j * bld + c] = n0 + c < n ? to_f32(bmat[(size_t)(n0 + c) * p + p0 + j]) : 0.f;
      }
      __syncthreads();
    }
    const float* bcol = sm.bs + (b_whole ? n0 : 0) + cc;
    float acc[RL][8];
#pragma unroll
    for (int u = 0; u < RL; ++u)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[u][k] = 0.f;
#pragma unroll 4
    for (int j = 0; j < np; ++j) {
      const float bv = bcol[j * bld];
#pragma unroll
      for (int u = 0; u < RL; ++u) {
        const float4 a = *reinterpret_cast<const float4*>(&sm.ys[j][FT_ROWS * u + 8 * rg]);
        const float4 b = *reinterpret_cast<const float4*>(&sm.ys[j][FT_ROWS * u + 8 * rg + 4]);
        acc[u][0] = fmaf(a.x, bv, acc[u][0]);
        acc[u][1] = fmaf(a.y, bv, acc[u][1]);
        acc[u][2] = fmaf(a.z, bv, acc[u][2]);
        acc[u][3] = fmaf(a.w, bv, acc[u][3]);
        acc[u][4] = fmaf(b.x, bv, acc[u][4]);
        acc[u][5] = fmaf(b.y, bv, acc[u][5]);
        acc[u][6] = fmaf(b.z, bv, acc[u][6]);
        acc[u][7] = fmaf(b.w, bv, acc[u][7]);
      }
    }
    const int gn = n0 + cc;
    if (gn < n) {
#pragma unroll
      for (int u = 0; u < RL; ++u) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int g = row0 + FT_ROWS * u + rg + 4 * k;
          if (g >= rows) continue;
          if (gridDim.y == 1)
            out[(size_t)g * n + gn] = from_f32<TB>(acc[u][k]);
          else
            part[((size_t)blockIdx.y * rows + g) * n + gn] = acc[u][k];
        }
      }
    }
  }
}

// out = the partials summed over p tiles in order, rounded once to B's dtype;
// a thread's reads (32 at the wide shape) are all in flight at once.  It is
// launched as a programmatic dependent of the main kernel, so its launch
// overlaps that kernel's last CTAs; griddepcontrol.wait holds it until the
// main grid has finished and its partials are visible.
template <typename TB>
__global__ void __launch_bounds__(FT_SUM_THREADS)
fused_transform_sum_kernel(const float* __restrict__ part, TB* __restrict__ out,
                           size_t count, int splits) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const size_t i = (size_t)blockIdx.x * FT_SUM_THREADS + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int t0 = 0; t0 < splits; t0 += FT_SUM_BATCH) {
    float v[FT_SUM_BATCH];
#pragma unroll
    for (int u = 0; u < FT_SUM_BATCH; ++u)
      v[u] = t0 + u < splits ? part[(size_t)(t0 + u) * count + i] : 0.f;
#pragma unroll
    for (int u = 0; u < FT_SUM_BATCH; ++u) s += v[u];   // + 0 past splits leaves s as it is
  }
  out[i] = from_f32<TB>(s);
}

template <typename TX, typename TB, int RL, int PT>
cudaError_t launch_sparse(const TX* xt, const int8_t* r, const TB* bt, TB* ot, float* part,
                          int rows, int m, int p, int n, int tiles, float scale,
                          cudaStream_t stream) {
  constexpr int bytes = (int)sizeof(FtSmem<RL, PT>);   // above 48 KB: opt in
  const cudaError_t rc = cudaFuncSetAttribute(fused_transform_kernel<TX, TB, RL, PT>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return rc;
  const int pt = ceil_div(p, tiles);
  const dim3 grid(ceil_div(rows, FT_ROWS * RL), tiles);
  fused_transform_kernel<TX, TB, RL, PT><<<grid, FT_THREADS, bytes, stream>>>(
      xt, r, bt, ot, part, rows, m, p, n, pt, scale);
  return cudaGetLastError();
}

template <typename TX, typename TB>
cudaError_t launch(const void* x, const int8_t* r, const void* bmat, void* out, float* part,
                   int rows, int m, int p, int n, int tiles, int bm, int bp, float scale,
                   cudaStream_t stream) {
  const TX* xt = static_cast<const TX*>(x);
  const TB* bt = static_cast<const TB*>(bmat);
  TB* ot = static_cast<TB*>(out);
  if (tiles == 0) {
    const dim3 grid(ceil_div(rows, TILE), ceil_div(n, FT_DN));
    fused_transform_dense_kernel<TX, TB><<<grid, dim3(HALF, HALF), 0, stream>>>(
        xt, r, bt, ot, rows, m, p, n, scale);
    return cudaGetLastError();
  }
  const cudaError_t rc = ft_with_tile(bm, bp, cudaErrorInvalidValue, [&](auto t) {
    using T = decltype(t);
    return launch_sparse<TX, TB, T::RL, T::PT>(xt, r, bt, ot, part, rows, m, p, n, tiles, scale,
                                               stream);
  });
  if (rc != cudaSuccess) return rc;
  if (tiles > 1) {
    const size_t count = (size_t)rows * n;
    cudaLaunchAttribute pdl[1];
    pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    pdl[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)((count + FT_SUM_THREADS - 1) / FT_SUM_THREADS));
    cfg.blockDim = dim3(FT_SUM_THREADS);
    cfg.stream = stream;
    cfg.attrs = pdl;
    cfg.numAttrs = 1;
    const cudaError_t rc2 = cudaLaunchKernelEx(&cfg, fused_transform_sum_kernel<TB>,
                                               static_cast<const float*>(part), ot, count, tiles);
    if (rc2 != cudaSuccess) return rc2;
  }
  return cudaGetLastError();
}

template <typename TX, typename TB>
const void* sparse_body(int bm, int bp) {
  return ft_with_tile(bm, bp, (const void*)nullptr, [](auto t) {
    using T = decltype(t);
    return (const void*)fused_transform_kernel<TX, TB, T::RL, T::PT>;
  });
}

int sparse_bytes(int bm, int bp) {
  return ft_with_tile(bm, bp, -1, [](auto t) {
    using T = decltype(t);
    return (int)sizeof(FtSmem<T::RL, T::PT>);
  });
}

template <typename TX, typename TB>
const void* body_of(int body, int bm, int bp) {
  if (body == 0) return (const void*)fused_transform_dense_kernel<TX, TB>;
  if (body == 1) return sparse_body<TX, TB>(bm, bp);
  if (body == 2) return (const void*)fused_transform_sum_kernel<TB>;
  return nullptr;
}

}  // namespace

// The body a call of (rows, m, p) with the sparse tile template (bm, bp)
// takes on the current device: *tiles = 0 for the dense body (one launch),
// else the number of p tiles of the sparse body (one launch, and a second,
// the summing pass, when *tiles > 1).
extern "C" int repro_fused_transform_tiles(int rows, int m, int p, int bm, int bp, int* tiles) {
  if (rows < 1 || m < 0 || p < 0 || tiles == nullptr || !ft_tile_ok(bm, bp))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)p * m < FT_DENSE_MAX_R) {
    *tiles = 0;
    return 0;
  }
  int sms = 0;
  const cudaError_t rc = sm_count(&sms);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  *tiles = ft_p_tiles(rows, p, sms, bp, bm);
  return 0;
}

// tiles: what repro_fused_transform_tiles gave for (rows, m, p, bm, bp).
// part: f32 scratch of tiles * rows * n values, written and read only when
// tiles > 1 (may be null otherwise).
extern "C" int repro_fused_transform(const void* x, const void* r, const void* bmat, void* out,
                                     void* part, int rows, int m, int p, int n, int tiles,
                                     int bm, int bp, float scale, int x_dtype, int b_dtype,
                                     void* stream) {
  if (rows < 1 || n < 1 || m < 0 || m >= (1 << 24) || p < 0 || tiles < 0 ||
      !ft_tile_ok(bm, bp) ||
      (tiles > 0 && (p < tiles || ceil_div(p, tiles) > bp ||
                     ceil_div(p, ceil_div(p, tiles)) != tiles)) ||
      (tiles > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* r8 = static_cast<const int8_t*>(r);
  float* pf = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (x_dtype == kF32 && b_dtype == kF32) {
    rc = launch<float, float>(x, r8, bmat, out, pf, rows, m, p, n, tiles, bm, bp, scale, s);
  } else if (x_dtype == kF32 && b_dtype == kBF16) {
    rc = launch<float, __nv_bfloat16>(x, r8, bmat, out, pf, rows, m, p, n, tiles, bm, bp, scale,
                                      s);
  } else if (x_dtype == kBF16 && b_dtype == kF32) {
    rc = launch<__nv_bfloat16, float>(x, r8, bmat, out, pf, rows, m, p, n, tiles, bm, bp, scale,
                                      s);
  } else if (x_dtype == kBF16 && b_dtype == kBF16) {
    rc = launch<__nv_bfloat16, __nv_bfloat16>(x, r8, bmat, out, pf, rows, m, p, n, tiles, bm,
                                              bp, scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(rc);
}

// A kernel body, for csrc/attributes.cu: body 0 the dense body, 1 the sparse
// body with the tile template (bm, bp), 2 the summing pass; dtypes as above.
// *fn is the kernel, *dyn the dynamic shared bytes its launch requests.
extern "C" int repro_fused_transform_body(int body, int x_dtype, int b_dtype, int bm, int bp,
                                          const void** fn, int* dyn) {
  if ((x_dtype != kF32 && x_dtype != kBF16) || (b_dtype != kF32 && b_dtype != kBF16) ||
      (body == 1 && !ft_tile_ok(bm, bp)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool xf = x_dtype == kF32, bf = b_dtype == kF32;
  *fn = xf ? (bf ? body_of<float, float>(body, bm, bp)
                 : body_of<float, __nv_bfloat16>(body, bm, bp))
           : (bf ? body_of<__nv_bfloat16, float>(body, bm, bp)
                 : body_of<__nv_bfloat16, __nv_bfloat16>(body, bm, bp));
  if (*fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  *dyn = body == 1 ? sparse_bytes(bm, bp) : 0;
  return 0;
}
