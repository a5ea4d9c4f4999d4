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
// Bound on the H100 (16 puts, 1M paths x 100 steps): every step reads S_t
// and the 16 V planes for the moments (68 B per path) and S_t again for the
// apply, about 7 GB per book from device memory; and the ~95 f32 products
// and f64 sums of the moments plus ~16 x 13 f32 operations of the apply per
// path-step. Hopper's blocks are not sequential and the per-step Gram is a
// grid-wide dependency, so a C host loop drives maturity + n_steps x
// (moments, one-block solve, apply) + 2 launches on one stream with no
// syncs, as lsmc_mega.cu does. P = 95 f64 accumulators per thread would
// spill, so a block stages the k columns and the n_strikes targets of
// kThreads paths in shared memory (row stride kThreads + 1) and thread p
// adds moment p over the tile in path order (the scheme of ma_common.cuh);
// one f64 partial row per block, summed in a fixed order by sum_partials.
// No float atomics: two runs give identical bits, and with -fmad=false the
// plain version (ops/lsmc_megakernel.py, _book_reference) gives the same
// bits. The strike cap, kMaxStrikes = 64, keeps the per-option arrays in a
// __grid_constant__ parameter block and the moments tile at (k + 64) x 257
// floats (77 KB at degree 10).
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "lsmc_common.cuh"

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

// The packed moments of this block's paths (grid-stride over tiles of
// kThreads paths) into partials[blockIdx.x * P ..]; dynamic shared memory
// holds (K + n_strikes) rows of kTileStride floats.
template <int K>
__global__ void __launch_bounds__(kThreads)
book_moments_kernel(const float* __restrict__ S, const float* __restrict__ V,
                    const float* __restrict__ stats, double* __restrict__ partials, int t,
                    int n_steps, int n_paths, const __grid_constant__ BookParams p) {
  extern __shared__ float tile[];
  constexpr int kPairs = Layout<K>::kPairs;
  constexpr int kSlots = (kPairs + K * kMaxStrikes + kThreads - 1) / kThreads;
  const int ns = p.n_strikes;
  const int P = kPairs + K * ns;
  const int T1 = n_steps + 1;
  const float mean = stats[t];
  const float inv_std = stats[T1 + t];
  const float c_t = stats[2 * T1 + t];
  const int tid = threadIdx.x;
  // this thread's sums: tile row ia times tile row ib - a Gram pair
  // (ia <= ib < K), or the rhs of option (q - kPairs) / K on column
  // (q - kPairs) % K (ib = K + option)
  int ia[kSlots], ib[kSlots];
  double acc[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    acc[s] = 0.0;
    ia[s] = -1;
    ib[s] = -1;
    const int q = tid + s * kThreads;
    if (q < kPairs) {
      int i = 0, rest = q;
      while (rest >= K - i) {
        rest -= K - i;
        ++i;
      }
      ia[s] = i;
      ib[s] = i + rest;
    } else if (q < P) {
      ia[s] = (q - kPairs) % K;
      ib[s] = K + (q - kPairs) / K;
    }
  }
  for (int base = blockIdx.x * kThreads; base < n_paths; base += gridDim.x * kThreads) {
    const int count = min(kThreads, n_paths - base);
    if (tid < count) {
      const int i = base + tid;
      float cols[K];
      basis_cols<K>((S[i] - mean) * inv_std, p.basis, cols);
#pragma unroll
      for (int a = 0; a < K; ++a) tile[a * kTileStride + tid] = cols[a];
      for (int j = 0; j < ns; ++j) {
        tile[(K + j) * kTileStride + tid] = c_t * V[static_cast<size_t>(j) * n_paths + i];
      }
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (ia[s] < 0) continue;
      const float* x = tile + ia[s] * kTileStride;
      const float* y = tile + ib[s] * kTileStride;
      double a = acc[s];
      for (int k = 0; k < count; ++k) a += static_cast<double>(x[k] * y[k]);
      acc[s] = a;
    }
    __syncthreads();
  }
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int q = tid + s * kThreads;
    if (q < P) partials[static_cast<size_t>(blockIdx.x) * P + q] = acc[s];
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
  const size_t row = static_cast<size_t>(n_paths);
  const size_t smem = static_cast<size_t>(K + p.n_strikes) * kTileStride * sizeof(float);
  cudaError_t err = allow_smem(book_moments_kernel<K>, smem);
  if (err != cudaSuccess) return err;
  bool short_dated = false;
  for (int j = 0; j < p.n_strikes; ++j) short_dated = short_dated || p.mats[j] < n_steps;
  book_maturity_kernel<<<n_blocks, kThreads, 0, stream>>>(
      paths + n_steps * row, knock == nullptr ? nullptr : knock + n_steps * row, V, cf, tau,
      n_steps, n_paths, p);
  AMCX_LAUNCH_CHECK();
  for (int t = n_steps - 1; t >= 0; --t) {
    const float* S_t = paths + t * row;
    const uint8_t* knock_t = knock == nullptr ? nullptr : knock + t * row;
    // European: no exercise decision needs the regression
    if (p.american) {
      book_moments_kernel<K><<<n_blocks, kThreads, smem, stream>>>(S_t, V, stats, partials, t,
                                                                   n_steps, n_paths, p);
      AMCX_LAUNCH_CHECK();
      multi_rhs_solve_kernel<K, kMaxStrikes><<<1, kThreads, 0, stream>>>(
          partials, n_blocks, p.n_strikes, p.rcond, coeffs);
      AMCX_LAUNCH_CHECK();
    }
    if (p.american || short_dated) {
      book_apply_kernel<K><<<n_blocks, kThreads, 0, stream>>>(S_t, knock_t, V, cf, tau, stats,
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
