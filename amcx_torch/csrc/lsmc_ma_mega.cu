// Multi-asset Longstaff-Schwartz backward induction, one pricing per call of
// amcx_lsmc_ma_mega.
//
// Replaces: amcx/ops/lsmc_ma_mega.py::_ma_mega_kernel (via
// lsmc_price_ma_mega / _run_ma_mega) with its in-kernel solve
// (amcx/ops/lsmc_megakernel.py _solve_equilibrated_ridge, generic in m).
//
// On time-major asset-major planes (n_steps+1, A, n_paths) f32 and the
// (2A+3, n_steps+1) stats rows [mean_a, inv_std_a, c_t, 1/c_t, allow_t]:
//   maturity: V = payoff(S_T); with the cf/tau planes cf = V, tau = n_steps;
//   per step t = T-1 .. 0:
//     moments: y = c_t * V, the cross-term columns and ITM weights of
//              ma_common.cuh, the packed f64 block sums;
//     solve:   one block sums the partial rows in a fixed order (rounded
//              once to f32) and one thread solves the m x m system in
//              shared memory (lsmc_common.cuh solve_equilibrated_ridge);
//     apply:   cont = max(fit, 0); where payoff > cont and allow_t,
//              V <- payoff * (1/c_t), cf <- payoff, tau <- t;
//   final: sum c_0 V and sum (c_0 V)^2, or with antithetic pairs the sum of
//          the squared pair means 0.5 (v_i + v_{i+n/2}).
// V is carried in time-T units: written only at exercise, discounted by the
// scalar c_t, never multiplied per step.
//
// Bound on the H100 (5 assets, m = 21, 1M paths x 9 steps): every step reads
// its 5 planes (20 MB) and V twice, once for the moments and once for the
// apply; the ~2.3 GFLOP of f32 products and f64 sums of the moments (kernel
// 8's, per step) bound it, not HBM. Hopper's blocks are not sequential and
// the per-step Gram is a grid-wide dependency, so the steps are driven by a
// host loop on one stream (maturity + 9 x 3 + 2 launches) with no syncs, as
// csrc/lsmc_mega.cu does for the univariate induction. No float atomics:
// two runs give identical bits, and with -fmad=false the plain version
// (ops/lsmc_ma_mega.py) gives the same bits.
#include <cuda_runtime.h>

#include <cstddef>

#include "ma_common.cuh"

namespace {

using namespace amcx;

template <int A>
__global__ void __launch_bounds__(kThreads)
ma_maturity_kernel(const float* __restrict__ planes_T, float* __restrict__ V,
                   float* __restrict__ cf, float* __restrict__ tau, int n_steps, int n_paths,
                   const __grid_constant__ MaParams p) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n_paths; i += gridDim.x * kThreads) {
    float s[A];
    load_assets<A>(planes_T, static_cast<size_t>(n_paths), i, s);
    const float v = ma_payoff<A>(s, p);
    V[i] = v;
    if (cf != nullptr) {
      cf[i] = v;
      tau[i] = static_cast<float>(n_steps);
    }
  }
}

template <int A>
__global__ void __launch_bounds__(kThreads)
ma_mega_moments_kernel(const float* __restrict__ planes_t, const float* __restrict__ V,
                       const float* __restrict__ stats, double* __restrict__ partials, int t,
                       int n_steps, int n_paths, int itm_weights,
                       const __grid_constant__ MaParams p) {
  const float c_t = stats[2 * A * (n_steps + 1) + t];
  auto y = [&](int i) { return c_t * V[i]; };
  ma_moments_block<A>(planes_t, n_paths, stats, n_steps + 1, t, p, itm_weights, y,
                      partials + static_cast<size_t>(blockIdx.x) * pack_dim(p.n_cols));
}

template <int A>
__global__ void __launch_bounds__(kThreads)
ma_mega_apply_kernel(const float* __restrict__ planes_t, float* __restrict__ V,
                     float* __restrict__ cf, float* __restrict__ tau,
                     const float* __restrict__ stats, const float* __restrict__ coeffs, int t,
                     int n_steps, int n_paths, const __grid_constant__ MaParams p) {
  __shared__ float coef[kMaxCols];
  if (threadIdx.x < p.n_cols) coef[threadIdx.x] = coeffs[threadIdx.x];
  __syncthreads();
  const int T1 = n_steps + 1;
  if (!(stats[(2 * A + 2) * T1 + t] > 0.0f)) return;  // not an exercise date
  const float inv_c_t = stats[(2 * A + 1) * T1 + t];
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n_paths; i += gridDim.x * kThreads) {
    float s[A];
    load_assets<A>(planes_t, static_cast<size_t>(n_paths), i, s);
    float uni[A][kMaxMaDegree + 1];
    ma_features<A>(s, p, stats, T1, t, uni);
    const float cont = ma_continuation<A>(uni, p, coef);
    const float ex = ma_payoff<A>(s, p);
    if (ex > cont) {
      V[i] = ex * inv_c_t;
      if (cf != nullptr) {
        cf[i] = ex;
        tau[i] = static_cast<float>(t);
      }
    }
  }
}

// Per-block partials of sum c_0 V and of sum (c_0 V)^2 (or, for antithetic
// pairs, of sum (0.5 (v_i + v_{i+half}))^2 over i < half).
__global__ void __launch_bounds__(kThreads)
ma_final_partials_kernel(const float* __restrict__ V, const float* __restrict__ c_row,
                         double* __restrict__ partials, int n_paths, int antithetic) {
  const float c_0 = c_row[0];
  const int half = n_paths / 2;
  double acc[2] = {0.0, 0.0};
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n_paths; i += gridDim.x * kThreads) {
    const float v = c_0 * V[i];
    acc[0] += static_cast<double>(v);
    if (!antithetic) {
      acc[1] += static_cast<double>(v * v);
    } else if (i < half) {
      const float f = 0.5f * (v + c_0 * V[i + half]);
      acc[1] += static_cast<double>(f * f);
    }
  }
  block_reduce_store<2>(acc, partials + static_cast<size_t>(blockIdx.x) * 2);
}

template <int A>
cudaError_t run_ma_mega(const float* planes, const float* stats, float* V, float* cf, float* tau,
                        double* partials, float* coeffs, float* sums, int n_steps, int n_paths,
                        int n_blocks, float rcond, int itm_weights, int antithetic,
                        const MaParams& p, cudaStream_t stream) {
  const size_t step = static_cast<size_t>(A) * n_paths;
  const size_t smem = moments_smem_bytes(p.n_cols, itm_weights);
  cudaError_t err = allow_smem(ma_mega_moments_kernel<A>, smem);
  if (err != cudaSuccess) return err;
  ma_maturity_kernel<A><<<n_blocks, kThreads, 0, stream>>>(
      planes + static_cast<size_t>(n_steps) * step, V, cf, tau, n_steps, n_paths, p);
  AMCX_LAUNCH_CHECK();
  for (int t = n_steps - 1; t >= 0; --t) {
    const float* planes_t = planes + static_cast<size_t>(t) * step;
    ma_mega_moments_kernel<A><<<n_blocks, kThreads, smem, stream>>>(
        planes_t, V, stats, partials, t, n_steps, n_paths, itm_weights, p);
    AMCX_LAUNCH_CHECK();
    solve_kernel<0><<<1, kThreads, 0, stream>>>(partials, n_blocks, p.n_cols, rcond, coeffs);
    AMCX_LAUNCH_CHECK();
    ma_mega_apply_kernel<A><<<n_blocks, kThreads, 0, stream>>>(planes_t, V, cf, tau, stats,
                                                               coeffs, t, n_steps, n_paths, p);
    AMCX_LAUNCH_CHECK();
  }
  ma_final_partials_kernel<<<n_blocks, kThreads, 0, stream>>>(
      V, stats + static_cast<size_t>(2 * A) * (n_steps + 1), partials, n_paths, antithetic);
  AMCX_LAUNCH_CHECK();
  sum_partials_kernel<<<1, kThreads, 0, stream>>>(partials, n_blocks, 2, sums);
  return cudaGetLastError();
}

}  // namespace

// planes (n_steps+1, A, n_paths) f32; stats (2A+3, n_steps+1) f32; V
// (n_paths) scratch; cf, tau (n_paths) out, or both null; partials
// (n_blocks, max(P, 2)) f64 scratch; coeffs (m) f32 scratch; sums (2) out;
// params on the host. Returns a cudaError_t.
extern "C" int amcx_lsmc_ma_mega(const float* planes, const float* stats, float* V, float* cf,
                                 float* tau, double* partials, float* coeffs, float* sums,
                                 int n_steps, int n_paths, int n_blocks, float rcond,
                                 int itm_weights, int antithetic, const MaParams* params,
                                 void* stream) {
  if (params == nullptr || bad_params(*params) || n_steps < 1 || n_paths < 1 || n_blocks < 1 ||
      (cf == nullptr) != (tau == nullptr) || (antithetic && n_paths % 2 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AMCX_MA_MEGA_CASE(AA)                                                              \
  case AA:                                                                                 \
    return static_cast<int>(run_ma_mega<AA>(planes, stats, V, cf, tau, partials, coeffs,   \
                                            sums, n_steps, n_paths, n_blocks, rcond,       \
                                            itm_weights, antithetic, *params, s));
  AMCX_ASSETS_SWITCH(params->n_assets, AMCX_MA_MEGA_CASE)
#undef AMCX_MA_MEGA_CASE
}
