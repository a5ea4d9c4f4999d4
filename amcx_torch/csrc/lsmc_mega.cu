// Longstaff-Schwartz backward induction for a vanilla put/call, one pricing
// per call of amcx_lsmc_mega.
//
// Replaces: amcx/ops/lsmc_megakernel.py::_mega_kernel (via
// lsmc_price_megakernel / _run) with its in-kernel solve
// _factor_equilibrated_ridge + _solve_factored (_solve_equilibrated_ridge).
//
// Per step t = T-1 .. 0, on time-major paths (n_steps+1, n_paths) f32:
//   moments: x = (S_t - mean_t) * inv_std_t, y = c_t * V, w = 1[phi(S-K) > 0]
//            (or 1), and the P = k(k+1)/2 + k explicit-pair moments
//            sum w B_a B_b (a <= b) and sum w y B_a;
//   solve:   column-equilibrate, add the rcond ridge, Cholesky, two
//            refinement steps against the UN-ridged Gram, de-equilibrate;
//   apply:   cont = max(sum c_a B_a(x), 0), ex = max(phi(S-K), 0), and
//            V <- ex / c_t where ex > cont. V is never touched otherwise.
//            With the cf/tau planes (amcx's return_cf_tau) the same select
//            also writes cf <- ex and tau <- t; maturity sets cf = V_T and
//            tau = n_steps (SURVEY Q5/Q7). V's arithmetic is the same with
//            or without them.
// V is carried in time-T units (value * e^{+r dt (T - tau)}): written only
// at exercise, discounted by the scalar c_t, never multiplied per step.
// Finally sum c_0 V and sum (c_0 V)^2.
//
// Bound on the H100: device-memory traffic, per step one read of S_t and V
// for the moments plus a second read of both (from the 50 MB L2 at 1M
// paths: S_t and V are 4 MB each) and a sparse write of V for the apply,
// about 2 GB per 1M x 100 pricing; and the ~300 launches, since the per-step
// Gram is a grid-wide dependency. Design: the steps are driven by a host
// loop on one stream with no syncs; the moments kernel keeps its P sums in
// registers over a grid-stride loop and reduces each block in a fixed order
// (warp shuffles, then warps in order) into a per-block partial row; a
// one-block solve kernel sums those rows in a fixed block order. No float
// atomics anywhere, so two runs give identical bits.
//
// Numerics: the moments (and the final two sums) are accumulated in f64
// from f32 products and rounded once to f32; the solve and every per-path
// operation are f32. In the closed-form GBM frame with ITM weights the
// equilibrated Gram has cond ~3e4, and a 1e-7 relative nudge to the inputs
// moves the 131k x 100 price by ~3e-3 through exercise-decision flips that
// feed back into later fits. The f64 order noise of a 1M-term sum is about
// 1e-6 of an f32 ulp, so the once-rounded f32 sum is the same in any order
// unless it lies that close to a rounding boundary; and the library is
// built with -fmad=false, so each multiply and add rounds as in torch's
// separate elementwise ops. The kernel and its plain version
// (ops/lsmc_megakernel.py, _mega_reference) then give the same bits on the
// card, whatever the grid. The TPU's blocked (T+1, N/512, 512) layout and
// its n_paths % 4096 rule are dropped: a warp reading 32 consecutive paths
// of row t is already coalesced. A persistent
// kernel with a grid barrier per step, CUDA graphs and fusing apply(t) into
// moments(t-1) are later work.
//
// Degenerate t = 0 at S0 == K with ITM weights: every weight is 0, the Gram
// is exactly 0, and the solve returns exactly 0 coefficients (ridge-only
// Cholesky of a zero system). Like the TPU kernel, there is deliberately no
// degenerate-weight fallback. `tiny` = 1e-30 makes d = 1e15 on a zero
// diagonal; that is safe because the zero entries stay exactly zero, so the
// expression order below matches amcx's.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "lsmc_common.cuh"

namespace {

using namespace amcx;

// V_T = max(phi (S_T - K), 0); cf = V_T and tau = n_steps where asked.
__global__ void __launch_bounds__(kThreads)
maturity_kernel(const float* __restrict__ S, float* __restrict__ V, float* __restrict__ cf,
                float* __restrict__ tau, int n_steps, int n_paths, float strike, float phi) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n_paths; i += gridDim.x * kThreads) {
    const float v = fmaxf(phi * (S[i] - strike), 0.0f);
    V[i] = v;
    if (cf != nullptr) {
      cf[i] = v;
      tau[i] = static_cast<float>(n_steps);
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
moments_kernel(const float* __restrict__ S, const float* __restrict__ V,
               const float* __restrict__ stats, double* __restrict__ partials,
               int t, int n_steps, int n_paths, float strike, float phi,
               int basis, int itm_weights) {
  constexpr int P = Layout<K>::kMoments;
  constexpr int kPairs = Layout<K>::kPairs;
  const int T1 = n_steps + 1;
  const float mean = stats[t];
  const float inv_std = stats[T1 + t];
  const float c_t = stats[2 * T1 + t];
  double acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = 0.0;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n_paths; i += gridDim.x * kThreads) {
    const float s = S[i];
    const float y = c_t * V[i];
    const float xhat = (s - mean) * inv_std;
    const float w = (!itm_weights || fmaxf(phi * (s - strike), 0.0f) > 0.0f) ? 1.0f : 0.0f;
    float cols[K];
    basis_cols<K>(xhat, basis, cols);
    const float yw = y * w;
#pragma unroll
    for (int a = 0; a < K; ++a) {
      const float ca = cols[a] * w;
#pragma unroll
      for (int b = a; b < K; ++b) acc[pair_index(K, a, b)] += static_cast<double>(ca * cols[b]);
    }
#pragma unroll
    for (int a = 0; a < K; ++a) acc[kPairs + a] += static_cast<double>(cols[a] * yw);
  }
  block_reduce_store<P>(acc, partials + static_cast<size_t>(blockIdx.x) * P);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const float* __restrict__ S, float* __restrict__ V, float* __restrict__ cf,
             float* __restrict__ tau, const float* __restrict__ stats,
             const float* __restrict__ coeffs_row, int t, int n_steps, int n_paths,
             float strike, float phi, int basis) {
  const int T1 = n_steps + 1;
  const float mean = stats[t];
  const float inv_std = stats[T1 + t];
  const float inv_c_t = stats[3 * T1 + t];
  float coef[K];
#pragma unroll
  for (int a = 0; a < K; ++a) coef[a] = coeffs_row[a];
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n_paths; i += gridDim.x * kThreads) {
    const float s = S[i];
    const float xhat = (s - mean) * inv_std;
    float cols[K];
    basis_cols<K>(xhat, basis, cols);
    float fitted = cols[0] * coef[0];
#pragma unroll
    for (int a = 1; a < K; ++a) fitted = fitted + cols[a] * coef[a];
    // max(fitted, 0) that keeps a NaN fit NaN (then no path exercises), as
    // torch.clamp_min and jnp.maximum do; fmaxf would return 0
    const float cont = fitted > 0.0f ? fitted : (fitted != fitted ? fitted : 0.0f);
    const float ex = fmaxf(phi * (s - strike), 0.0f);
    // ex > cont implies ex > 0 (cont >= 0): the ITM clause is implied
    if (ex > cont) {
      V[i] = ex * inv_c_t;
      if (cf != nullptr) {
        cf[i] = ex;
        tau[i] = static_cast<float>(t);
      }
    }
  }
}

// Per-block partials of sum c_0 V and sum (c_0 V)^2.
__global__ void __launch_bounds__(kThreads)
final_partials_kernel(const float* __restrict__ V, const float* __restrict__ stats,
                      double* __restrict__ partials, int n_steps, int n_paths) {
  const float c_0 = stats[2 * (n_steps + 1)];
  double acc[2] = {0.0, 0.0};
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n_paths; i += gridDim.x * kThreads) {
    const float v = c_0 * V[i];
    acc[0] += static_cast<double>(v);
    acc[1] += static_cast<double>(v * v);
  }
  block_reduce_store<2>(acc, partials + static_cast<size_t>(blockIdx.x) * 2);
}

template <int K>
cudaError_t run_mega(const float* paths, const float* stats, float* V, float* cf, float* tau,
                     double* partials, float* coeffs, float* sums, int n_steps, int n_paths,
                     int n_blocks, float strike, float phi, float rcond, int basis,
                     int american, int itm_weights, cudaStream_t stream) {
  const size_t row = static_cast<size_t>(n_paths);
  maturity_kernel<<<n_blocks, kThreads, 0, stream>>>(
      paths + static_cast<size_t>(n_steps) * row, V, cf, tau, n_steps, n_paths, strike, phi);
  AMCX_LAUNCH_CHECK();
  for (int t = n_steps - 1; t >= 0; --t) {
    const float* S_t = paths + static_cast<size_t>(t) * row;
    float* coeffs_row = coeffs + static_cast<size_t>(t) * K;
    moments_kernel<K><<<n_blocks, kThreads, 0, stream>>>(
        S_t, V, stats, partials, t, n_steps, n_paths, strike, phi, basis, itm_weights);
    AMCX_LAUNCH_CHECK();
    solve_kernel<K><<<1, kThreads, 0, stream>>>(partials, n_blocks, K, rcond, coeffs_row);
    AMCX_LAUNCH_CHECK();
    // European: the regression still runs (coefficient export) but the
    // time-T-units carry needs no update at all
    if (american) {
      apply_kernel<K><<<n_blocks, kThreads, 0, stream>>>(
          S_t, V, cf, tau, stats, coeffs_row, t, n_steps, n_paths, strike, phi, basis);
      AMCX_LAUNCH_CHECK();
    }
  }
  final_partials_kernel<<<n_blocks, kThreads, 0, stream>>>(V, stats, partials, n_steps, n_paths);
  AMCX_LAUNCH_CHECK();
  sum_partials_kernel<<<1, kThreads, 0, stream>>>(partials, n_blocks, 2, sums);
  return cudaGetLastError();
}

}  // namespace

// paths (n_steps+1, n_paths) f32; stats 4 (n_steps+1) f32 rows
// [mean_t, inv_std_t, c_t, 1/c_t]; V (n_paths) scratch; cf, tau (n_paths)
// out, or both null; partials (n_blocks, max(P, 2)) f64 scratch; coeffs
// (n_steps+1, degree+1), zeroed by the caller (the maturity row stays 0);
// sums (2) out. Returns a cudaError_t.
extern "C" int amcx_lsmc_mega(const float* paths, const float* stats, float* V, float* cf,
                              float* tau, double* partials, float* coeffs, float* sums,
                              int n_steps, int n_paths, int n_blocks, float strike,
                              float phi, float rcond, int basis, int degree, int american,
                              int itm_weights, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_steps < 1 || n_paths < 1 || n_blocks < 1 || basis < 0 || basis > 4 ||
      (cf == nullptr) != (tau == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define AMCX_MEGA_CASE(KK)                                                                \
  case KK:                                                                                \
    return static_cast<int>(run_mega<KK>(paths, stats, V, cf, tau, partials, coeffs, sums, \
                                         n_steps, n_paths, n_blocks, strike, phi, rcond,   \
                                         basis, american, itm_weights, s));
  switch (degree + 1) {
    AMCX_MEGA_CASE(1)
    AMCX_MEGA_CASE(2)
    AMCX_MEGA_CASE(3)
    AMCX_MEGA_CASE(4)
    AMCX_MEGA_CASE(5)
    AMCX_MEGA_CASE(6)
    AMCX_MEGA_CASE(7)
    AMCX_MEGA_CASE(8)
    AMCX_MEGA_CASE(9)
    AMCX_MEGA_CASE(10)
    AMCX_MEGA_CASE(11)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef AMCX_MEGA_CASE
}
