// fused_transform: out (rows, n) = (scale * x (rows, m) @ R (p, m)^T) @ B (n, p)^T
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_transform.py
// (fused_transform / _kernel): the serve transform of an RP -> EASI pair,
// with the (rows, p) intermediate kept out of device memory.
//
// Bound on the H100: 2*rows*m*p + 2*rows*p*n f32 FMA operations (no tensor
// cores in this kernel) against x, R (one byte an entry), B and out moved
// once.  The first product dominates at the repo's shapes; the work R's
// sparsity actually needs is bytes-bound.
//
// Design: one CTA owns 32 rows and 64 columns of out (a second grid axis
// over n tiles recomputes y for n > 64).  It loops over p in tiles of 32;
// for each it builds the y tile over the whole of k in registers (R loaded
// as int8 and widened on its way into shared memory), parks the scaled y
// tile in shared memory and adds y @ B_tile^T into an f32 output tile held
// in registers.  The output is rounded to B's dtype once at the end (the TPU
// kernel adds across p tiles in B's dtype).  n is not padded: ragged edges
// are masked with zeros.
#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int FN = 64;            // output columns (n) per CTA
constexpr int NJ = FN / HALF;     // output columns per thread

template <typename TX, typename TB>
__global__ void __launch_bounds__(NTHREADS)
fused_transform_kernel(const TX* __restrict__ x, const int8_t* __restrict__ r,
                       const TB* __restrict__ bmat, TB* __restrict__ out,
                       int rows, int m, int p, int n, float scale) {
  __shared__ float xs[TK][TILE + 1];    // x tile, transposed: xs[k][row]
  __shared__ float rs[TK][TILE + 1];    // R tile widened to f32: rs[k][p]
  __shared__ float ys[TILE][TILE + 1];  // scaled y tile: ys[row][p], f32
  __shared__ float bs[TILE][FN + 1];    // B tile, transposed: bs[p][n]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * HALF + tx;
  const int row0 = blockIdx.x * TILE, n0 = blockIdx.y * FN;

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
    for (int e = tid; e < FN * TILE; e += NTHREADS) {
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

template <typename TX, typename TB>
void launch(const void* x, const int8_t* r, const void* bmat, void* out, int rows, int m,
            int p, int n, float scale, cudaStream_t stream) {
  const dim3 grid(ceil_div(rows, TILE), ceil_div(n, FN));
  const dim3 block(HALF, HALF);
  fused_transform_kernel<TX, TB><<<grid, block, 0, stream>>>(
      static_cast<const TX*>(x), r, static_cast<const TB*>(bmat), static_cast<TB*>(out),
      rows, m, p, n, scale);
}

}  // namespace

extern "C" int repro_fused_transform(const void* x, const void* r, const void* bmat, void* out,
                                     int rows, int m, int p, int n, float scale, int x_dtype,
                                     int b_dtype, void* stream) {
  const int8_t* r8 = static_cast<const int8_t*>(r);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32 && b_dtype == kF32) {
    launch<float, float>(x, r8, bmat, out, rows, m, p, n, scale, s);
  } else if (x_dtype == kF32 && b_dtype == kBF16) {
    launch<float, __nv_bfloat16>(x, r8, bmat, out, rows, m, p, n, scale, s);
  } else if (x_dtype == kBF16 && b_dtype == kF32) {
    launch<__nv_bfloat16, float>(x, r8, bmat, out, rows, m, p, n, scale, s);
  } else if (x_dtype == kBF16 && b_dtype == kBF16) {
    launch<__nv_bfloat16, __nv_bfloat16>(x, r8, bmat, out, rows, m, p, n, scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
