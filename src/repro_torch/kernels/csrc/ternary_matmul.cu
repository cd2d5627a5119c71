// ternary_matmul: y (b, p) = scale * x (b, m) @ R (p, m)^T, R int8 ternary.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ternary_matmul.py
// (ternary_matmul / _kernel).
//
// Bound on the H100: the dense work is 2*b*m*p FMA operations in f32 (no
// tensor cores in this kernel), the bytes are x once, R once at one byte an
// entry and y once.  At the repo's wide row (b=256, m=1024, p=256) the dense
// FLOPs dominate; the work R's sparsity actually needs (2*b*nnz(R)) is
// bytes-bound.
//
// Design: one CTA owns one 32 x 32 output tile and loops over the whole
// contraction in chunks of 32 (the TPU grid's k axis becomes this loop,
// since CTAs keep no scratch between them).  R is loaded as int8 and widened
// to f32 on its way into shared memory, so the device-memory traffic for R
// stays one byte an entry.  The sum is kept in f32 across all of k, scaled
// once and rounded once to x's dtype (the TPU kernel rounds once per k tile
// in bf16).  Ragged edges are masked with zeros, which keeps them exact.
#include "common.cuh"

using namespace repro_torch;

namespace {

template <typename TX>
__global__ void __launch_bounds__(NTHREADS)
ternary_matmul_kernel(const TX* __restrict__ x, const int8_t* __restrict__ r,
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

template <typename TX>
void launch(const void* x, const int8_t* r, void* out, int b, int m, int p, float scale,
            cudaStream_t stream) {
  const dim3 grid(ceil_div(b, TILE), ceil_div(p, TILE));
  const dim3 block(HALF, HALF);
  ternary_matmul_kernel<TX><<<grid, block, 0, stream>>>(
      static_cast<const TX*>(x), r, static_cast<TX*>(out), b, m, p, scale);
}

}  // namespace

extern "C" int repro_ternary_matmul(const void* x, const void* r, void* out, int b, int m,
                                    int p, float scale, int x_dtype, void* stream) {
  const int8_t* r8 = static_cast<const int8_t*>(r);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32) {
    launch<float>(x, r8, out, b, m, p, scale, s);
  } else if (x_dtype == kBF16) {
    launch<__nv_bfloat16>(x, r8, out, b, m, p, scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
