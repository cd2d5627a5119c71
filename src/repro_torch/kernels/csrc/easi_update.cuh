// easi_apply's shared definitions: the constants of its two bodies, the map
// from the policy's easi_block_m to the columns of B a CTA updates, and the
// small body's entry points, which easi_small.cuh defines and
// easi_small_<CT>.cu compiles once per width (so that nvcc builds the widths
// in parallel).  easi_update.cu holds the design notes, the split body and
// the C entries.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace repro_torch {
namespace easi {

enum GKind : int { kCubic = 0, kTanh = 1, kSignCubic = 2 };

constexpr int ES_SMALL_N = 64;          // the small body's largest n
constexpr int ES_SMALL_WORK = 1 << 17;  // and largest b * n^2
constexpr int ES_SK = 32;               // small body: samples staged at a time
constexpr int ES_MAX_SLICES = 8;        // split body: a cluster's CTAs (portable limit)
constexpr int ES_SLICE_MIN = 32;        // samples in a slice, at least
constexpr int ES_GPT = TK * TILE / NTHREADS;   // Gram: Y values per thread per chunk
constexpr int ES_CT = 32;               // small body: columns a CTA, the narrowest template
constexpr int ES_UT = 16;               // update: rows of a CTA's tile, and its narrowest width
constexpr int ES_KC = 128;              // update: G and B chunk along n
constexpr int ES_KSPLIT = NTHREADS / (ES_UT * ES_UT / 4);   // update: groups sharing k
constexpr int ES_UPT = ES_KC * ES_UT / NTHREADS;   // S / H^T values of a chunk per thread

// The columns of B one CTA takes, for block_m (the policy's easi_block_m):
// the body's templates are lo, 2 lo and 4 lo columns (lo = ES_CT for the
// small body, ES_UT for the split body's update).  A block_m naming one runs
// it; any other (the reference's Pallas sizes, the policy's default 512)
// runs lo; then no wider than the narrowest template that holds m.
// resource_model.effective_easi_tile states the same rule.
__host__ inline int easi_cols(bool split, int m, int block_m) {
  const int lo = split ? ES_UT : ES_CT;
  int cols = (block_m == lo || block_m == 2 * lo || block_m == 4 * lo) ? block_m : lo;
  int fit = lo;
  while (fit < m && fit < 4 * lo) fit *= 2;
  return min(cols, fit);
}

__host__ inline bool easi_cols_valid(bool split, int cols) {
  const int lo = split ? ES_UT : ES_CT;
  return cols == lo || cols == 2 * lo || cols == 4 * lo;
}

// Dynamic shared bytes: the small body's tile of B, bs[16 NA][CT + 1], and
// the update's chunk of B, bs[ES_KC][UC + 1] (f32).
__host__ __device__ constexpr int easi_small_dyn_bytes(int na, int ct) {
  return HALF * na * (ct + 1) * (int)sizeof(float);
}
__host__ __device__ constexpr int easi_update_dyn_bytes(int uc) {
  return ES_KC * (uc + 1) * (int)sizeof(float);
}

__device__ __forceinline__ float g_fn(int g_kind, float v) {
  if (g_kind == kCubic) return v * v * v;
  if (g_kind == kTanh) return tanhf(v);
  const float s = (float)((v > 0.f) - (v < 0.f));
  return s * v * v;
}

// Every body's templates: lo, 2 lo or 4 lo columns (easi_cols_valid has
// held cols to these); f gets the width as a compile-time constant.
template <int LO, typename F>
auto with_cols(int cols, F&& f) {
  if (cols == LO) return f(std::integral_constant<int, LO>{});
  if (cols == 2 * LO) return f(std::integral_constant<int, 2 * LO>{});
  return f(std::integral_constant<int, 4 * LO>{});
}

// The small body at CT columns a CTA for one call (dtype codes as
// common.cuh's), and its kernel for na = ceil(n / 16) (csrc/attributes.cu).
template <int CT>
cudaError_t launch_small(const void* y, const void* bmat, void* out, int b, int n, int m,
                         float mu, float inv_b, int so, int ho, int g_kind, int y_dtype,
                         int b_dtype, cudaStream_t stream);
template <int CT>
const void* small_fn(int y_dtype, int b_dtype, int na);

}  // namespace easi
}  // namespace repro_torch
