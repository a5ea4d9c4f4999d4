// Device code shared by the multi-asset kernels (ma_step.cu: kernels 8/9,
// lsmc_ma_mega.cu: kernel 7): the product/basis description, the payoff
// kinds, the sorted and standardized features, the cross-term columns, and
// kernel 7's moments of one block's paths (kernel 8 has its own,
// register-blocked, in ma_step.cu).
//
// Layout: the asset planes of step t are a contiguous (A, n_paths) f32
// slice of the time-major asset-major (n_steps+1, A, n_paths) paths, so a
// warp reading asset a of 32 consecutive paths is coalesced. The per-step
// scalars are one (2A+3, n_steps+1) f32 array of rows mean_a (A rows),
// inv_std_a (A rows), c_t, 1/c_t, allow_t.
//
// Columns (amcx/ops/maxcall_pallas.py _columns, amcx.basis order): the A
// values of one path, sorted descending by amcx's bubble compare-exchange
// network when the basis is sorted, standardized x_a = (f_a - mean_a) *
// inv_std_a, the univariate columns of each by the recurrences of
// lsmc_common.cuh, then column c = prod over assets with alpha[c][a] > 0 of
// uni[a][alpha[c][a]], multiplied left to right (1 for alpha = 0). The
// multi-index table comes from the host (amcx_torch.basis._multi_index_set).
//
// Kernel 7's moments: a block stages a tile of kThreads paths in shared
// memory - the m columns, the ITM-weighted columns and the weighted target
// w y, with a row stride of kThreads + 1 floats so that threads reading
// different columns of one path hit different banks - then thread p < P
// (and p + kThreads, ...) adds packed sum p over the tile's paths in path
// order in f64: pairs (i <= j) sum f32(cw_i * c_j), the rhs sums
// f32(c_i * w y). The block
// writes one (P,) f64 partial row, and a one-block kernel sums the rows in
// a fixed order (sum_partials) and rounds once to f32. No float atomics, so
// runs are bit-identical, and the plain torch versions (f64 sums of the
// same f32 products, rounded once) give the same bits.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "lsmc_common.cuh"

namespace amcx {

constexpr int kMaxAssets = 8;
constexpr int kMaxCols = 32;
constexpr int kMaxMaDegree = 4;
static_assert(kMaxCols <= kMaxSolveK, "the induction's m x m solve must fit solve_kernel<0>");

enum PayoffKind : int {
  kMaxCall = 0,
  kFirst = 1,
  kSecond = 2,
  kSpread = 3,
  kSpreadK = 4,
  kBasket = 5,
  kGeoBasket = 6
};

// The static description of a product and its basis; mirrors
// amcx_torch.ops.maxcall_pallas.MaParams. Passed to the kernels by value.
struct MaParams {
  int n_assets;
  int n_cols;  // m
  int degree;
  int basis;
  int sorted;
  int payoff_kind;
  float strike;
  float phi;
  float weights[kMaxAssets];
  unsigned char alpha[kMaxCols][kMaxAssets];
};

inline bool bad_params(const MaParams& p) {
  return p.n_assets < 1 || p.n_assets > kMaxAssets || p.n_cols < 1 || p.n_cols > kMaxCols ||
         p.degree < 0 || p.degree > kMaxMaDegree || p.basis < 0 || p.basis > 4 ||
         p.payoff_kind < 0 || p.payoff_kind > 6;
}

// Bytes of the moments tile: m columns, m weighted columns (ITM fits only)
// and the weighted target.
inline size_t moments_smem_bytes(int m, int itm_weights) {
  return static_cast<size_t>((itm_weights ? 2 * m : m) + 1) * kTileStride * sizeof(float);
}

__host__ __device__ inline int pack_dim(int m) { return m * (m + 1) / 2 + m; }

// Exercise value of one path's asset values, in amcx's operation order
// (amcx/ops/maxcall_pallas.py _payoff_for).
template <int A>
__device__ __forceinline__ float ma_payoff(const float (&s)[A], const MaParams& p) {
  constexpr int k1 = A > 1 ? 1 : 0;  // the two-plane kinds need A >= 2 (host-checked)
  switch (p.payoff_kind) {
    case kMaxCall: {
      float ex = s[0];
#pragma unroll
      for (int a = 1; a < A; ++a) ex = fmaxf(ex, s[a]);
      return fmaxf(ex - p.strike, 0.0f);
    }
    case kFirst:
      return fmaxf(p.phi * (s[0] - p.strike), 0.0f);
    case kSecond:
      return fmaxf(p.phi * (s[k1] - p.strike), 0.0f);
    case kSpread:
      return fmaxf(p.phi * (s[0] - s[k1]), 0.0f);
    case kSpreadK:
      return fmaxf(p.phi * (s[0] - s[k1] - p.strike), 0.0f);
    case kBasket: {
      float acc = s[0] * p.weights[0];
#pragma unroll
      for (int a = 1; a < A; ++a) acc = acc + s[a] * p.weights[a];
      return fmaxf(p.phi * (acc - p.strike), 0.0f);
    }
    default: {  // kGeoBasket
      float acc = logf(s[0]) * p.weights[0];
#pragma unroll
      for (int a = 1; a < A; ++a) acc = acc + logf(s[a]) * p.weights[a];
      return fmaxf(p.phi * (expf(acc) - p.strike), 0.0f);
    }
  }
}

// Per-asset univariate columns uni[a][0..kMaxMaDegree] of the (sorted,)
// standardized features of one path; only degrees <= p.degree are read.
template <int A>
__device__ __forceinline__ void ma_features(const float (&s)[A], const MaParams& p,
                                            const float* __restrict__ stats, int T1, int t,
                                            float (&uni)[A][kMaxMaDegree + 1]) {
  float f[A];
#pragma unroll
  for (int a = 0; a < A; ++a) f[a] = s[a];
  if (p.sorted) {
#pragma unroll
    for (int i = 0; i < A; ++i) {
#pragma unroll
      for (int j = 0; j < A - 1 - i; ++j) {
        const float hi = fmaxf(f[j], f[j + 1]);
        const float lo = fminf(f[j], f[j + 1]);
        f[j] = hi;
        f[j + 1] = lo;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const float x = (f[a] - stats[a * T1 + t]) * stats[(A + a) * T1 + t];
    basis_cols<kMaxMaDegree + 1>(x, p.basis, uni[a]);
  }
}

// Cross-term column c: the product of uni[a][alpha[c][a]] over the assets
// with alpha > 0, left to right; 1 for the constant.
template <int A>
__device__ __forceinline__ float ma_column(const float (&uni)[A][kMaxMaDegree + 1],
                                           const unsigned char* alpha) {
  float term = 1.0f;
  bool any = false;
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const int d = alpha[a];
    if (d == 0) continue;
    float f = uni[a][1];
#pragma unroll
    for (int dd = 2; dd <= kMaxMaDegree; ++dd) f = d == dd ? uni[a][dd] : f;
    term = any ? term * f : f;
    any = true;
  }
  return term;
}

template <int A>
__device__ __forceinline__ void load_assets(const float* __restrict__ planes, size_t n_paths,
                                            int i, float (&s)[A]) {
#pragma unroll
  for (int a = 0; a < A; ++a) s[a] = planes[a * n_paths + i];
}

// Fitted continuation sum_c coef_c col_c(x), in amcx's order (c = 0 first,
// then added left to right), clamped at 0 keeping a NaN fit NaN (as
// torch.clamp_min and jnp.maximum do; then no path exercises).
template <int A>
__device__ __forceinline__ float ma_continuation(const float (&uni)[A][kMaxMaDegree + 1],
                                                 const MaParams& p, const float* coef) {
  float fitted = ma_column<A>(uni, p.alpha[0]) * coef[0];
  for (int c = 1; c < p.n_cols; ++c) fitted = fitted + ma_column<A>(uni, p.alpha[c]) * coef[c];
  return fitted > 0.0f ? fitted : (fitted != fitted ? fitted : 0.0f);
}

// The packed moments of this block's paths (grid-stride over tiles of
// kThreads paths) into partials_row[0..P). y(i) gives path i's regression
// target; dynamic shared memory holds moments_smem_bytes(m, itm_weights).
template <int A, class YFn>
__device__ __forceinline__ void ma_moments_block(const float* __restrict__ planes, int n_paths,
                                                 const float* __restrict__ stats, int T1, int t,
                                                 const MaParams& p, int itm_weights, YFn y,
                                                 double* __restrict__ partials_row) {
  extern __shared__ float tile[];
  constexpr int kMaxPack = kMaxCols * (kMaxCols + 1) / 2 + kMaxCols;
  constexpr int kSlots = (kMaxPack + kThreads - 1) / kThreads;
  const int m = p.n_cols;
  const int n_pairs = m * (m + 1) / 2;
  const int P = n_pairs + m;
  float* cols = tile;
  float* cols_w = itm_weights ? tile + m * kTileStride : cols;
  float* yw = tile + (itm_weights ? 2 * m : m) * kTileStride;
  const int tid = threadIdx.x;
  // this thread's sums: pair (ia, ib) or rhs ia (ib = -1)
  int ia[kSlots], ib[kSlots];
  double acc[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    acc[s] = 0.0;
    ia[s] = -1;
    ib[s] = -1;
    const int q = tid + s * kThreads;
    if (q < n_pairs) {
      int i = 0, rest = q;
      while (rest >= m - i) {
        rest -= m - i;
        ++i;
      }
      ia[s] = i;
      ib[s] = i + rest;
    } else if (q < P) {
      ia[s] = q - n_pairs;
    }
  }
  for (int base = blockIdx.x * kThreads; base < n_paths; base += gridDim.x * kThreads) {
    const int count = min(kThreads, n_paths - base);
    if (tid < count) {
      const int i = base + tid;
      float s[A];
      load_assets<A>(planes, static_cast<size_t>(n_paths), i, s);
      float uni[A][kMaxMaDegree + 1];
      ma_features<A>(s, p, stats, T1, t, uni);
      // w is 0 or 1, so weighting is exact: the all-paths fit (w = 1)
      // rounds as the plain version's unweighted products
      const float w = itm_weights ? (ma_payoff<A>(s, p) > 0.0f ? 1.0f : 0.0f) : 1.0f;
      for (int c = 0; c < m; ++c) {
        const float v = ma_column<A>(uni, p.alpha[c]);
        cols[c * kTileStride + tid] = v;
        if (itm_weights) cols_w[c * kTileStride + tid] = v * w;
      }
      yw[tid] = y(i) * w;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (ia[s] < 0) continue;
      double a = acc[s];
      if (ib[s] >= 0) {
        const float* ci = cols_w + ia[s] * kTileStride;
        const float* cj = cols + ib[s] * kTileStride;
        for (int k = 0; k < count; ++k) a += static_cast<double>(ci[k] * cj[k]);
      } else {
        const float* ci = cols + ia[s] * kTileStride;
        for (int k = 0; k < count; ++k) a += static_cast<double>(ci[k] * yw[k]);
      }
      acc[s] = a;
    }
    __syncthreads();
  }
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int q = tid + s * kThreads;
    if (q < P) partials_row[q] = acc[s];
  }
}

}  // namespace amcx

// Dispatch a template on the asset count A = 1..kMaxAssets.
#define AMCX_ASSETS_SWITCH(N, CALL) \
  switch (N) {                      \
    CALL(1)                         \
    CALL(2)                         \
    CALL(3)                         \
    CALL(4)                         \
    CALL(5)                         \
    CALL(6)                         \
    CALL(7)                         \
    CALL(8)                         \
    default:                        \
      return static_cast<int>(cudaErrorInvalidValue); \
  }
