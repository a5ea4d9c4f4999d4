// Device code shared by the multi-asset kernels (ma_step.cu: kernels 8/9,
// lsmc_ma_mega.cu: kernel 7, ma_prepare.cu: their inputs): the
// product/basis description, the payoff kinds, the sorting network, the
// sorted and standardized features, the cross-term columns and
// the fitted continuation. The register-blocked moments of both inductions
// are ma_moments.cuh's.
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
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "lsmc_common.cuh"

namespace amcx {

constexpr int kMaxAssets = 8;
constexpr int kMaxCols = 32;
constexpr int kMaxMaDegree = 4;
static_assert(kMaxCols <= kMaxSolveK, "the induction's m x m solve must fit one warp");

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

// amcx's bubble compare-exchange network: one path's A values sorted
// descending in place (amcx/ops/maxcall_pallas.py _sort_desc).
template <int A>
__device__ __forceinline__ void sort_desc(float (&f)[A]) {
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

// Per-asset univariate columns uni[a][0..kMaxMaDegree] of the (sorted,)
// standardized features of one path; only degrees <= p.degree are read.
template <int A>
__device__ __forceinline__ void ma_features(const float (&s)[A], const MaParams& p,
                                            const float* __restrict__ stats, int T1, int t,
                                            float (&uni)[A][kMaxMaDegree + 1]) {
  float f[A];
#pragma unroll
  for (int a = 0; a < A; ++a) f[a] = s[a];
  if (p.sorted) sort_desc<A>(f);
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
