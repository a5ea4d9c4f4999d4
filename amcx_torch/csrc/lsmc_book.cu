// Longstaff-Schwartz backward induction of a whole strike/maturity book of
// vanilla puts and calls on one path set, one book per call of
// amcx_lsmc_book.
//
// Replaces: amcx/ops/lsmc_megakernel.py::_book_kernel (via
// lsmc_book_megakernel / _run_book), with its one factorization of the
// shared Gram (_factor_equilibrated_ridge) and one refined back-solve per
// option (_solve_factored).
//
// The fit is on all paths (SURVEY Q1), so the Gram of the basis columns
// does not depend on the option: per step t = T-1 .. 0, on time-major paths
// (n_steps+1, n_paths) f32 and the per-option V planes (n_strikes, n_paths):
//   moments: x = (S_t - mean_t) * inv_std_t and its k basis columns B_a;
//            one shared explicit-pair Gram head sum B_a B_b (a <= b) and,
//            for each option s, the k rhs sums sum B_a y_s with
//            y_s = c_t * V_s: P = k(k+1)/2 + k n_strikes packed moments;
//   solve:   one factor of the shared Gram (equilibrate, rcond ridge,
//            Cholesky), then thread s back-solves option s (two refinement
//            steps against the UN-ridged Gram, de-equilibrate);
//   apply:   per option, cont = max(sum c_a B_a(x), 0) (a NaN fit stays
//            NaN), ex = max(phi (S - K), 0); below the option's maturity
//            step m, V_s <- ex / c_t where ex > cont and the knock gate is
//            open; at t == m (a shorter-dated option) V_s <- pay / c_t with
//            pay = ex where the gate is open, else 0; above m, V_s stays 0.
// The maturity pass sets V_s = pay(S_T) for a full-term option and 0 for a
// shorter-dated one; with the cf/tau planes cf = V_s and tau = m. At the end
// sum c_0 V_s and sum (c_0 V_s)^2 per option, or with antithetic pairs the
// sum of the squared pair means 0.5 (v_i + v_{i+n/2}). A European book runs
// no regression and writes V only at short maturities.
// V is carried in time-T units: written only at exercise or at the option's
// own maturity, discounted by the scalar c_t, never multiplied per step.
//
// Barriers: one knock level shared by the ladder, as the (n_steps+1,
// n_paths) byte plane of amcx_torch.payoff.barrier_gate (1 where the option
// may pay or exercise). amcx folds the knock state into the spot's sign
// bit, which loses it at S = 0; the plane does not.
//
// Bound on the H100 (16 puts, degree 4, 1M paths x 100 steps): the
// roofline counts each input byte once and the ~95 f32 products and f64
// sums plus 16 fitted continuations per path-step: 0.667 ms. Two floors of
// this design sit above it. Bytes: the 16 V planes (64 MB) do not fit the
// 50 MB L2, so every step's moments read them from device memory with S_t
// (68 MB, ~20 us at 3.35 TB/s) and the apply writes back the re-exercised
// entries: ~2 ms a book. Conversions: each of the 95 products a path-step
// is rounded to f32 and widened to f64 (the result is defined so), 16 a
// clock a SM: 9.5e9 a book, >= ~2.4 ms.
// Hopper's blocks are not sequential and the per-step Gram is a grid-wide
// dependency, so a C host loop drives maturity + n_steps x (moments, one-
// block solve, apply) + 2 launches on one stream with no syncs, as
// lsmc_mega.cu does. The design, and what the first one (PR 4) lacked:
// - Moments with every thread busy and no shared tile (roles_moments_kernel
//   of lsmc_roles.cuh, shared with the swing's kernel 10; the first design
//   gave each of the 95 moments one of 256 threads and read two shared
//   values a product). A warp is one role over 128-path chunks, 4
//   consecutive paths a lane: a Gram role recomputes the basis from S_t and
//   sums the 15 pairs; an option role sums the 4 x k rhs block of its 4
//   options (2 above degree 6) in f64 registers. The slots are template
//   arguments, so only real products are emitted. Products equal the plain
//   version's: B_a B_b (a <= b) and B_a (c_t V_s).
// - Each warp streams its chunks through a two-stage ring in shared memory
//   (cp.async, 16 bytes a lane and row where every row is 16-byte aligned,
//   masked past the end): chunk c + stride's S_t and V rows are in flight
//   while chunk c is summed.
// - A persistent grid of 2 blocks a SM (the wrapper's n_blocks; more than 8
//   roles split over gridDim.y), so the one-block solve sums ~264 partial
//   rows, not 512, with 1024 threads (one sum a warp instead of 12).
// - The apply stays PR 4's pass (one thread a path over all options,
//   writing V, cf and tau only where a path exercises). A one-pass step
//   (apply t, then moments t-1 from V in registers, which saves S_t's second
//   read and a launch) was built and measured slower than the two passes:
//   its 96 registers a thread leave 20 warps a SM to hide the loads and the
//   apply's branches.
// Sums run per lane in path order, then a fixed shuffle tree, then the
// role's warps in order, then the fixed-order sum over blocks: no float
// atomics, so two runs give identical bits, and with -fmad=false the plain
// version (ops/lsmc_megakernel.py, _book_reference) gives the same bits.
// The strike cap, kMaxStrikes = 64, keeps the per-option arrays in a
// __grid_constant__ parameter block.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "lsmc_roles.cuh"

namespace amcx {

constexpr int kMaxStrikes = 64;

// The options of a book and the induction's switches; mirrors
// amcx_torch.ops.lsmc_megakernel.BookParams. Passed to the kernels by value.
struct BookParams {
  int n_strikes;
  int basis;
  int american;
  int antithetic;
  float rcond;
  float strikes[kMaxStrikes];
  float phis[kMaxStrikes];
  int mats[kMaxStrikes];  // maturity step of each option, 1..n_steps
};

}  // namespace amcx

namespace {

using namespace amcx;

__device__ __forceinline__ float exercise_value(const BookParams& p, int j, float s) {
  return fmaxf(p.phis[j] * (s - p.strikes[j]), 0.0f);
}

__global__ void __launch_bounds__(kThreads)
book_maturity_kernel(const float* __restrict__ S, const uint8_t* __restrict__ knock,
                     float* __restrict__ V, float* __restrict__ cf, float* __restrict__ tau,
                     int n_steps, int n_paths, const __grid_constant__ BookParams p) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n_paths; i += gridDim.x * kThreads) {
    const float s = S[i];
    const bool open = knock == nullptr || knock[i] != 0;
    for (int j = 0; j < p.n_strikes; ++j) {
      const size_t at = static_cast<size_t>(j) * n_paths + i;
      const float v = (p.mats[j] == n_steps && open) ? exercise_value(p, j, s) : 0.0f;
      V[at] = v;
      if (cf != nullptr) {
        cf[at] = v;
        tau[at] = static_cast<float>(p.mats[j]);
      }
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
book_apply_kernel(const float* __restrict__ S, const uint8_t* __restrict__ knock,
                  float* __restrict__ V, float* __restrict__ cf, float* __restrict__ tau,
                  const float* __restrict__ stats, const float* __restrict__ coeffs, int t,
                  int n_steps, int n_paths, const __grid_constant__ BookParams p) {
  __shared__ float coef[K * kMaxStrikes];
  const int ns = p.n_strikes;
  if (p.american) {
    for (int q = threadIdx.x; q < K * ns; q += kThreads) coef[q] = coeffs[q];
  }
  __syncthreads();
  const int T1 = n_steps + 1;
  const float mean = stats[t];
  const float inv_std = stats[T1 + t];
  const float inv_c_t = stats[3 * T1 + t];
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n_paths; i += gridDim.x * kThreads) {
    const float s = S[i];
    const bool open = knock == nullptr || knock[i] != 0;
    float cols[K];
    if (p.american) basis_cols<K>((s - mean) * inv_std, p.basis, cols);
    for (int j = 0; j < ns; ++j) {
      const int m = p.mats[j];
      if (t > m) continue;  // nothing alive above the option's maturity
      const float ex = exercise_value(p, j, s);
      const size_t at = static_cast<size_t>(j) * n_paths + i;
      if (t == m) {  // a shorter-dated option starts at its own maturity
        const float pay = open ? ex : 0.0f;
        V[at] = pay * inv_c_t;
        if (cf != nullptr) {
          cf[at] = pay;
          tau[at] = static_cast<float>(m);
        }
        continue;
      }
      if (!p.american) continue;
      const float* cj = coef + j * K;
      float fitted = cols[0] * cj[0];
#pragma unroll
      for (int a = 1; a < K; ++a) fitted = fitted + cols[a] * cj[a];
      const float cont = fitted > 0.0f ? fitted : (fitted != fitted ? fitted : 0.0f);
      if (ex > cont && open) {  // ex > cont implies ex > 0 (cont >= 0)
        V[at] = ex * inv_c_t;
        if (cf != nullptr) {
          cf[at] = ex;
          tau[at] = static_cast<float>(t);
        }
      }
    }
  }
}

// Per-block partials of option blockIdx.y's sum c_0 V and sum (c_0 V)^2 (or,
// for antithetic pairs, sum (0.5 (v_i + v_{i+half}))^2 over i < half), at
// partials[(blockIdx.x * n_strikes + blockIdx.y) * 2 ..].
__global__ void __launch_bounds__(kThreads)
book_final_kernel(const float* __restrict__ V, const float* __restrict__ stats,
                  double* __restrict__ partials, int n_steps, int n_paths, int antithetic) {
  const int j = blockIdx.y;
  const float c_0 = stats[2 * (n_steps + 1)];
  const float* Vj = V + static_cast<size_t>(j) * n_paths;
  const int half = n_paths / 2;
  double acc[2] = {0.0, 0.0};
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n_paths; i += gridDim.x * kThreads) {
    const float v = c_0 * Vj[i];
    acc[0] += static_cast<double>(v);
    if (!antithetic) {
      acc[1] += static_cast<double>(v * v);
    } else if (i < half) {
      const float f = 0.5f * (v + c_0 * Vj[i + half]);
      acc[1] += static_cast<double>(f * f);
    }
  }
  block_reduce_store<2>(
      acc, partials + (static_cast<size_t>(blockIdx.x) * gridDim.y + j) * 2);
}

template <int K>
cudaError_t run_book(const float* paths, const uint8_t* knock, const float* stats, float* V,
                     float* cf, float* tau, double* partials, float* coeffs, float* sums,
                     int n_steps, int n_paths, int n_blocks, const BookParams& p,
                     cudaStream_t stream) {
  const RolePlan<K> plan(p.n_strikes);
  const dim3 grid(n_blocks, plan.n_groups);
  const int threads = plan.threads();
  const size_t ring = ring_bytes_per_warp<K>() * (threads / 32);
  const RoleArgs roles{p.n_strikes, p.basis, 0, rows_aligned16(n_paths, paths, V), 0.0f, 0.0f};
  cudaError_t err = allow_smem(roles_moments_kernel<K, false>, ring);
  if (err != cudaSuccess) return err;
  const int apply_blocks = min((n_paths + kThreads - 1) / kThreads, 1024);
  bool short_dated = false;
  for (int j = 0; j < p.n_strikes; ++j) short_dated = short_dated || p.mats[j] < n_steps;
  book_maturity_kernel<<<apply_blocks, kThreads, 0, stream>>>(
      paths + static_cast<size_t>(n_steps) * n_paths,
      knock == nullptr ? nullptr : knock + static_cast<size_t>(n_steps) * n_paths, V, cf, tau,
      n_steps, n_paths, p);
  AMCX_LAUNCH_CHECK();
  for (int t = n_steps - 1; t >= 0; --t) {
    const float* S_t = paths + static_cast<size_t>(t) * n_paths;
    const uint8_t* knock_t = knock == nullptr ? nullptr : knock + static_cast<size_t>(t) * n_paths;
    // European: no exercise decision needs the regression
    if (p.american) {
      roles_moments_kernel<K, false><<<grid, threads, ring, stream>>>(S_t, V, stats, partials, t,
                                                                      n_steps, n_paths, roles);
      AMCX_LAUNCH_CHECK();
      multi_rhs_solve_kernel<K, kMaxStrikes, kSolveThreads><<<1, kSolveThreads, 0, stream>>>(
          partials, n_blocks, p.n_strikes, p.rcond, coeffs);
      AMCX_LAUNCH_CHECK();
    }
    if (p.american || short_dated) {
      book_apply_kernel<K><<<apply_blocks, kThreads, 0, stream>>>(S_t, knock_t, V, cf, tau, stats,
                                                                  coeffs, t, n_steps, n_paths, p);
      AMCX_LAUNCH_CHECK();
    }
  }
  book_final_kernel<<<dim3(n_blocks, p.n_strikes), kThreads, 0, stream>>>(
      V, stats, partials, n_steps, n_paths, p.antithetic);
  AMCX_LAUNCH_CHECK();
  sum_partials_kernel<<<1, kThreads, 0, stream>>>(partials, n_blocks, 2 * p.n_strikes, sums);
  return cudaGetLastError();
}

}  // namespace

// paths (n_steps+1, n_paths) f32; knock (n_steps+1, n_paths) bytes (1 where
// the options may pay or exercise) or null; stats 4 (n_steps+1) f32 rows
// [mean_t, inv_std_t, c_t, 1/c_t]; V (n_strikes, n_paths) scratch; cf, tau
// (n_strikes, n_paths) out, or both null; partials (n_blocks, max(P,
// 2 n_strikes)) f64 scratch; coeffs (n_strikes, degree+1) f32 scratch; sums
// (n_strikes, 2) out [sum c_0 V, sum of squares]; params on the host.
// Returns a cudaError_t.
extern "C" int amcx_lsmc_book(const float* paths, const unsigned char* knock, const float* stats,
                              float* V, float* cf, float* tau, double* partials, float* coeffs,
                              float* sums, int n_steps, int n_paths, int n_blocks, int degree,
                              const amcx::BookParams* params, void* stream) {
  if (params == nullptr || n_steps < 1 || n_paths < 1 || n_blocks < 1 ||
      params->n_strikes < 1 || params->n_strikes > amcx::kMaxStrikes || params->basis < 0 ||
      params->basis > 4 || (cf == nullptr) != (tau == nullptr) ||
      (params->antithetic && n_paths % 2 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int j = 0; j < params->n_strikes; ++j) {
    if (params->mats[j] < 1 || params->mats[j] > n_steps) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AMCX_BOOK_CASE(KK)                                                                 \
  case KK:                                                                                 \
    return static_cast<int>(run_book<KK>(paths, knock, stats, V, cf, tau, partials, coeffs, \
                                         sums, n_steps, n_paths, n_blocks, *params, s));
  switch (degree + 1) {
    AMCX_BOOK_CASE(1)
    AMCX_BOOK_CASE(2)
    AMCX_BOOK_CASE(3)
    AMCX_BOOK_CASE(4)
    AMCX_BOOK_CASE(5)
    AMCX_BOOK_CASE(6)
    AMCX_BOOK_CASE(7)
    AMCX_BOOK_CASE(8)
    AMCX_BOOK_CASE(9)
    AMCX_BOOK_CASE(10)
    AMCX_BOOK_CASE(11)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef AMCX_BOOK_CASE
}
