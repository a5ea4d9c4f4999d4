// Longstaff-Schwartz multiple stopping: the swing option's whole rights
// ladder (R exercises of phi (S - K), at most one per date) on one path
// set, one pricing per call of amcx_lsmc_swing.
//
// Replaces: amcx/ops/lsmc_swing.py::_swing_kernel (via lsmc_price_swing /
// _run_swing), with its one factorization of the shared Gram
// (_factor_equilibrated_ridge) and one refined back-solve per right
// (_solve_factored).
//
// The value planes V^1..V^R (V^0 = 0 is not stored) live in device memory
// as an (R, n_paths) f32 array in time-T units. take(S) = phi (S - K),
// floored at 0 for the option kind and signed for the forward kind;
// owed(k) = max(0, n_min - (R - k)) takes are still owed while k rights
// remain.
//   maturity: V^k = take(S_T) where owed(k) >= 1, else max(take, 0): one
//            take, forced by an obligation.
//   per step t = T-1 .. 0, on time-major paths (n_steps+1, n_paths) f32:
//   moments: x = (S_t - mean_t) * inv_std_t and its k basis columns B_a,
//            w = 1[phi (S - K) > 0] for the option kind with ITM weights,
//            else 1; one explicit-pair Gram head sum (B_a w) B_b (a <= b)
//            and, for each right j, the k rhs sums sum B_a (c_t V^j) w:
//            P = k(k+1)/2 + k R packed moments;
//   solve:   one factor of the Gram (equilibrate, rcond ridge, Cholesky),
//            then thread j back-solves right j (two refinement steps
//            against the UN-ridged Gram, de-equilibrate);
//   apply:   C^j = sum c_a B_a(x) (floored at 0, a NaN fit staying NaN, for
//            the option kind only), C^0 = 0, ex = take(S_t); for k = R
//            down to 1: hit = ex + C^{k-1} > C^k (and ex > 0 for the
//            option kind), or forced where the dates left, T - t + 1, are
//            at most owed(k); where hit, V^k <- ex / c_t + V^{k-1}, with
//            V^{k-1} read before its own update.
// Finally sum c_0 V^R and sum (c_0 V^R)^2, or with antithetic pairs the sum
// of the squared pair means 0.5 (v_i + v_{i+n/2}).
//
// Bound on the H100 (3 rights, degree 4, 1M paths x 100 steps): every step
// reads S_t and the R planes for the moments and again for the apply, ~16
// B per path per read, about 3.4 GB per pricing from device memory (the
// planes are 4 MB each, so much of the second read hits the 50 MB L2); and
// the P = 30 f32 products and f64 sums of the moments plus R fitted
// continuations of 2k - 1 operations per path-step. Each of the P products
// is rounded to f32 and widened to f64 (the result is defined so): at 16
// conversions a clock a SM that floors the moments at ~7.5 us a step. The
// Gram is a grid-wide dependency per step, so a C host loop drives
// maturity + n_steps x (moments, one-block solve, apply) + 2 launches on
// one stream with no syncs, as lsmc_book.cu does. The design (the first
// one staged a shared tile of kThreads paths and summed each moment with
// one warp, 32 us a step):
// - Moments: roles_moments_kernel of lsmc_roles.cuh, kernel 3's warp
//   roles: a Gram role recomputes the basis and the ITM weight from S_t
//   and sums (B_a w) B_b; a rights role sums B_a ((c_t V^j) w) for up to 4
//   rights (2 above degree 6); the forward kind and all-paths fits run with
//   w = 1. Each warp streams 128-path chunks through a two-stage cp.async
//   ring; a persistent grid of 2 blocks a SM (the wrapper's n_blocks;
//   gridDim.y splits the roles when R is large) writes ~264 partial rows.
// - Solve: multi_rhs_solve_kernel at kSolveThreads sums those rows in a
//   fixed order, thread 0 factors the Gram, thread j back-solves right j.
// - Apply: one thread a 4-path group walks k = R .. 1 with the cascade in
//   registers (two planes and two continuations a path live at a time),
//   with 16-byte loads of S_t and of each plane where the rows are 16-byte
//   aligned; V^{k-2}'s load starts before right k's store of V^k, so it is
//   in flight while right k's hit is decided (loading two rights ahead
//   measured slower). V^k is written only where the path exercises.
// No float atomics: two runs give identical bits, and with -fmad=false the
// plain version (ops/lsmc_swing.py, _swing_reference) gives the same bits;
// at R = 1 the products, sums, solve and select are those of lsmc_mega.cu,
// so the price equals kernel 2's on the same paths and frame. The
// obligations come from integers, never from floats.
//
// The rights cap, kMaxRights = 128, sizes the static shared arrays of the
// solve (the packed moments, P = 1474 at degree 10) and of the apply (the
// R x k coefficients). amcx's TPU kernel held all planes in 64 MB of VMEM
// and stopped at 12 rights; here the planes are in device memory (4 MB
// each at 1M paths).
#include <cuda_runtime.h>

#include <cstddef>

#include "lsmc_roles.cuh"

namespace {

using namespace amcx;

constexpr int kMaxRights = 128;

struct SwingArgs {
  int n_steps;
  int n_paths;
  int n_rights;
  int n_min;
  int basis;
  int itm_weights;
  int forward;
  float strike;
  float phi;
};

__device__ __forceinline__ float take(const SwingArgs& a, float s) {
  const float signed_take = a.phi * (s - a.strike);
  return a.forward ? signed_take : fmaxf(signed_take, 0.0f);
}

__device__ __forceinline__ int owed(const SwingArgs& a, int k) {
  return max(0, a.n_min - (a.n_rights - k));
}

__global__ void __launch_bounds__(kThreads)
swing_maturity_kernel(const float* __restrict__ S, float* __restrict__ V, const SwingArgs a) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < a.n_paths; i += gridDim.x * kThreads) {
    const float pay = take(a, S[i]);
    for (int k = 1; k <= a.n_rights; ++k) {
      V[static_cast<size_t>(k - 1) * a.n_paths + i] = owed(a, k) >= 1 ? pay : fmaxf(pay, 0.0f);
    }
  }
}

// C^{j+1} of right j from its coefficients coef[j * K ..].
template <int K>
__device__ __forceinline__ float continuation(const float (&cols)[K], const float* coef,
                                              int forward) {
  float fitted = cols[0] * coef[0];
#pragma unroll
  for (int c = 1; c < K; ++c) fitted = fitted + cols[c] * coef[c];
  if (forward) return fitted;
  // max(fitted, 0) that keeps a NaN fit NaN, as torch.clamp_min does
  return fitted > 0.0f ? fitted : (fitted != fitted ? fitted : 0.0f);
}

// One thread a group of 4 paths (i0 = 4 g): the R continuations and the
// cascade k = R .. 1 in registers. Right k reads V^{k-1} and writes V^k;
// the load of V^{k-2}, which right k-1 reads, starts before right k's
// store.
template <int K>
__global__ void __launch_bounds__(kThreads)
swing_apply_kernel(const float* __restrict__ S, float* __restrict__ V,
                   const float* __restrict__ stats, const float* __restrict__ coeffs, int t,
                   const SwingArgs a, int vec) {
  __shared__ float coef[K * kMaxRights];
  const int R = a.n_rights;
  for (int q = threadIdx.x; q < K * R; q += kThreads) coef[q] = coeffs[q];
  __syncthreads();
  const int T1 = a.n_steps + 1;
  const float mean = stats[t];
  const float inv_std = stats[T1 + t];
  const float inv_c_t = stats[3 * T1 + t];
  const int dates_left = a.n_steps - t + 1;
  const size_t plane = static_cast<size_t>(a.n_paths);
  const int n_groups = (a.n_paths + 3) / 4;
  for (int g = blockIdx.x * kThreads + threadIdx.x; g < n_groups; g += gridDim.x * kThreads) {
    const int i0 = 4 * g;
    const int n_here = min(4, a.n_paths - i0);
    float s[4];
    load_row4(S, i0, n_here, vec, s);
    float cols[4][K];
    float ex[4], c_hi[4], v_next[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      basis_cols<K>((s[e] - mean) * inv_std, a.basis, cols[e]);
      ex[e] = take(a, s[e]);
      c_hi[e] = continuation<K>(cols[e], coef + (R - 1) * K, a.forward);
      v_next[e] = 0.0f;
    }
    if (R >= 2) load_row4(V + (R - 2) * plane, i0, n_here, vec, v_next);
    for (int k = R; k >= 1; --k) {
      float v_lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v_lo[e] = k >= 2 ? v_next[e] : 0.0f;
      if (k >= 3) load_row4(V + (k - 3) * plane, i0, n_here, vec, v_next);
      const int o = owed(a, k);
      const bool forced = o > 0 && dates_left <= o;
      float* Vk = V + (k - 1) * plane + i0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float c_lo = k >= 2 ? continuation<K>(cols[e], coef + (k - 2) * K, a.forward)
                                  : 0.0f;
        bool hit = ex[e] + c_lo > c_hi[e];
        if (!a.forward) hit = ex[e] > 0.0f && hit;
        if (forced) hit = true;
        if (hit && e < n_here) Vk[e] = ex[e] * inv_c_t + v_lo[e];
        c_hi[e] = c_lo;
      }
    }
  }
}

// Per-block partials of sum c_0 V^R and sum (c_0 V^R)^2 (or, for antithetic
// pairs, sum (0.5 (v_i + v_{i+half}))^2 over i < half).
__global__ void __launch_bounds__(kThreads)
swing_final_kernel(const float* __restrict__ VR, const float* __restrict__ stats,
                   double* __restrict__ partials, int n_steps, int n_paths, int antithetic) {
  const float c_0 = stats[2 * (n_steps + 1)];
  const int half = n_paths / 2;
  double acc[2] = {0.0, 0.0};
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n_paths; i += gridDim.x * kThreads) {
    const float v = c_0 * VR[i];
    acc[0] += static_cast<double>(v);
    if (!antithetic) {
      acc[1] += static_cast<double>(v * v);
    } else if (i < half) {
      const float f = 0.5f * (v + c_0 * VR[i + half]);
      acc[1] += static_cast<double>(f * f);
    }
  }
  block_reduce_store<2>(acc, partials + static_cast<size_t>(blockIdx.x) * 2);
}

template <int K>
cudaError_t run_swing(const float* paths, const float* stats, float* V, double* partials,
                      float* coeffs, float* sums, int n_blocks, float rcond, int antithetic,
                      const SwingArgs& a, cudaStream_t stream) {
  const size_t row = static_cast<size_t>(a.n_paths);
  const RolePlan<K> plan(a.n_rights);
  const dim3 grid(n_blocks, plan.n_groups);
  const int threads = plan.threads();
  const size_t ring = ring_bytes_per_warp<K>() * (threads / 32);
  const int vec = rows_aligned16(a.n_paths, paths, V);
  const RoleArgs roles{a.n_rights, a.basis, a.itm_weights && !a.forward, vec, a.strike, a.phi};
  cudaError_t err = allow_smem(roles_moments_kernel<K, true>, ring);
  if (err != cudaSuccess) return err;
  const int apply_blocks = min((a.n_paths + 4 * kThreads - 1) / (4 * kThreads), 1024);
  swing_maturity_kernel<<<apply_blocks, kThreads, 0, stream>>>(paths + a.n_steps * row, V, a);
  AMCX_LAUNCH_CHECK();
  for (int t = a.n_steps - 1; t >= 0; --t) {
    const float* S_t = paths + t * row;
    roles_moments_kernel<K, true><<<grid, threads, ring, stream>>>(S_t, V, stats, partials, t,
                                                                  a.n_steps, a.n_paths, roles);
    AMCX_LAUNCH_CHECK();
    multi_rhs_solve_kernel<K, kMaxRights, kSolveThreads><<<1, kSolveThreads, 0, stream>>>(
        partials, n_blocks, a.n_rights, rcond, coeffs);
    AMCX_LAUNCH_CHECK();
    swing_apply_kernel<K><<<apply_blocks, kThreads, 0, stream>>>(S_t, V, stats, coeffs, t, a,
                                                                 vec);
    AMCX_LAUNCH_CHECK();
  }
  swing_final_kernel<<<n_blocks, kThreads, 0, stream>>>(V + (a.n_rights - 1) * row, stats,
                                                        partials, a.n_steps, a.n_paths,
                                                        antithetic);
  AMCX_LAUNCH_CHECK();
  sum_partials_kernel<<<1, kThreads, 0, stream>>>(partials, n_blocks, 2, sums);
  return cudaGetLastError();
}

}  // namespace

// paths (n_steps+1, n_paths) f32; stats 4 (n_steps+1) f32 rows [mean_t,
// inv_std_t, c_t, 1/c_t]; V (n_rights, n_paths) f32 scratch; partials
// (n_blocks, max(P, 2)) f64 scratch; coeffs (n_rights, degree+1) f32
// scratch; sums (2) out [sum c_0 V^R, sum of squares]. Returns a
// cudaError_t.
extern "C" int amcx_lsmc_swing(const float* paths, const float* stats, float* V,
                               double* partials, float* coeffs, float* sums, int n_steps,
                               int n_paths, int n_blocks, int n_rights, int n_min, int degree,
                               int basis, int itm_weights, int forward, int antithetic,
                               float strike, float phi, float rcond, void* stream) {
  if (n_steps < 1 || n_paths < 1 || n_blocks < 1 || n_rights < 1 || n_rights > kMaxRights ||
      n_min < 0 || n_min > n_rights || basis < 0 || basis > 4 ||
      (antithetic && n_paths % 2 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SwingArgs a{n_steps, n_paths, n_rights, n_min, basis, itm_weights, forward, strike, phi};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AMCX_SWING_CASE(KK)                                                                 \
  case KK:                                                                                  \
    return static_cast<int>(run_swing<KK>(paths, stats, V, partials, coeffs, sums, n_blocks, \
                                          rcond, antithetic, a, s));
  switch (degree + 1) {
    AMCX_SWING_CASE(1)
    AMCX_SWING_CASE(2)
    AMCX_SWING_CASE(3)
    AMCX_SWING_CASE(4)
    AMCX_SWING_CASE(5)
    AMCX_SWING_CASE(6)
    AMCX_SWING_CASE(7)
    AMCX_SWING_CASE(8)
    AMCX_SWING_CASE(9)
    AMCX_SWING_CASE(10)
    AMCX_SWING_CASE(11)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef AMCX_SWING_CASE
}
