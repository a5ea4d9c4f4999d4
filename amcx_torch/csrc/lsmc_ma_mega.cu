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
//              ma_common.cuh, the packed f64 sums of exact products;
//     solve:   the partial rows summed in a fixed order (rounded once to
//              f32) and the equilibrated ridge Cholesky with two refinements
//              (lsmc_common.cuh);
//     apply:   cont = max(fit, 0); where payoff > cont and allow_t,
//              V <- payoff * (1/c_t), cf <- payoff, tau <- t;
//   final: sum c_0 V and sum (c_0 V)^2, or with antithetic pairs the sum of
//          the squared pair means 0.5 (v_i + v_{i+n/2}).
// V is carried in time-T units: written only at exercise, discounted by the
// scalar c_t, never multiplied per step.
//
// Bound on the H100 (5 assets, m = 21, 1M paths x 9 steps): reading the
// planes once (0.063 ms) and the moments' 252 exact f64 products and f64
// sums a path-step (0.068 ms at the FP64 tensor cores' 67 TFLOP/s). The
// design floor is the moments' 1.5 DMMA (m8n8k4) a path-step at that rate
// (~12 us a step, 0.108 ms); their 24 widenings a path-step take ~6 us a
// step. Measured: the step kernel 1.06 ms a pricing (moments ~72 us a step,
// their build most of it; ma_step.cu). Before the moments were exact
// products, each of their 252 f32 products a path-step was widened on its
// own (~63 us a step, 0.5687 ms: that design's floor), and the step kernel
// took 1.65 ms. The per-step Gram is a grid-wide dependency.
//
// Design: a host loop on one stream with no syncs, two launches a step.
// - ma_mega_step_kernel: step t's moments on kernel 8's design
//   (ma_moments.cuh: X^T X's upper 8 x 8 tiles by mma.sync f64 a warp over
//   its own paths, double-buffered tiles, the per-block factor table, a
//   persistent grid of one block an SM, so ~132 partial rows); at t = T-1
//   its build first sets V from the maturity payoff. The block that takes
//   the last ticket sums the rows, a thread a sum (sum_rows_coalesced), and
//   one warp solves (warp_solve_equilibrated_ridge) into coefficient row t.
// - ma_mega_apply_kernel: step t's exercise on a grid-stride grid of
//   kThreads blocks, the columns from the univariate columns staged in
//   shared memory by the factor table, as kernel 8's moments build them.
// - ma_mega_final_kernel: step 0's exercise and the final sums, the last
//   block summing the rows.
// 2 T launches a pricing (18 at 9 dates). The first design ran 3 T + 3
// (30): 1,024 partial rows a step that one block summed and one thread
// solved (189 us a step), moments at 132 us and an apply of 51 us a step
// (ma_continuation's scan of every asset for every column). Built, timed
// on the card and dropped (PERF.md): the exercise folded into the next
// step's moments build (one launch a step; 63 us a step against this
// apply's 35: the build runs on the moments' 21 warps an SM); the warp
// solve with every row in registers and its loops unrolled (54-107 us a
// step against 33-46, and a minutes-long compile); the rows summed in
// sum_partials' order (24 us a step, 31 with its loads batched, against
// 6.3 a thread a sum).
//
// Numerics: no float atomics, so two runs give identical bits; with
// -fmad=false the plain version (ops/lsmc_ma_mega.py) gives the same bits.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

#include "ma_moments.cuh"

namespace {

using namespace amcx;

// Bytes of shared memory the last block's row sum and solve take: the
// packed sums, then the warp solve's scratch.
constexpr int kMaxPack = kMaxCols * (kMaxCols + 1) / 2 + kMaxCols;
constexpr size_t kSolveBytes = sizeof(float) * (kMaxPack + warp_solve_floats());
constexpr int kMaxApplyBlocks = 1024;  // the exercise's grid-stride grid

// One path's device-memory inputs of a tile, loaded a tile ahead of its
// build: the spots of step t and V (at t = T-1 the spots of step T instead
// of V, whose payoff V becomes).
template <int A>
struct StepIn {
  float s[A];
  float sT[A];
  float v;
};

// The fixed-order sum of one step's (n_rows, P) partial rows (P up to 560
// sums) on the threads of ONE block, read through L2 and rounded once to
// f32: thread p adds sum p's rows in row order, sixteen loads issued at a
// time (each from a valid address, so that no branch keeps them apart; a
// row past n_rows adds +0.0, which leaves the sum's bits alone: it starts
// at +0.0 and is never -0.0). A warp's loads of one row are 32 consecutive
// sums, one coalesced read. Any fixed order of the f64 sums gives the same
// f32 bits unless a sum lies within f64 noise of an f32 rounding boundary.
__device__ __forceinline__ void sum_rows_coalesced(const double* rows, int n_rows, int P,
                                              float* out) {
  constexpr int kBatch = 16;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    double v = 0.0;
    for (int b0 = 0; b0 < n_rows; b0 += kBatch) {
      double x[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const bool in = b0 + u < n_rows;
        const double y = __ldcg(rows + static_cast<size_t>(in ? b0 + u : 0) * P + p);
        x[u] = in ? y : 0.0;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) v += x[u];
    }
    out[p] = static_cast<float>(v);
  }
}

// Step t's moments in one launch (the header's design): y = c_t V (at t =
// T-1 from the maturity payoff, written to V and, where asked, cf/tau);
// the last block sums the rows and warp 0 solves step t into coeffs row t.
template <int A, bool kItm>
__global__ void __launch_bounds__(kMomentsThreads, 1)
ma_mega_step_kernel(const float* __restrict__ planes, float* V, float* __restrict__ cf,
                    float* __restrict__ tau, const float* __restrict__ stats, float* coeffs,
                    double* partials, unsigned* ticket, int t, int n_steps, int n_paths,
                    float rcond, int uni_slots, const __grid_constant__ MaParams p) {
  extern __shared__ float4 smem4[];
  const int m = p.n_cols;
  const int T1 = n_steps + 1;
  const bool maturity = t + 1 == n_steps;
  const MomentsPlan q = moments_plan(m);
  const MomentsTiles sm = moments_tiles(smem4, q, uni_slots);
  const int tid = threadIdx.x;
  const int n_tiles = (n_paths + kMomentsThreads - 1) / kMomentsThreads;
  const size_t plane = static_cast<size_t>(n_paths);
  const float* planes_t = planes + static_cast<size_t>(t) * A * plane;
  const float* planes_T = planes + static_cast<size_t>(n_steps) * A * plane;
  const float c_t = stats[2 * A * T1 + t];
  init_factors<A>(p, sm.factors);
  if (tid < 2 * A) sm.frame[tid] = stats[tid * T1 + t];  // the mean_a and inv_std_a rows
  __syncthreads();

  auto fetch = [&](int tile, StepIn<A>& in) {
    const int i = tile * kMomentsThreads + tid;
    if (tile >= n_tiles || i >= n_paths) return;
    load_assets<A>(planes_t, plane, i, in.s);
    if (maturity) {
      load_assets<A>(planes_T, plane, i, in.sT);
    } else {
      in.v = V[i];
    }
  };
  auto build = [&](int tile, const StepIn<A>& in, int b) {
    const int i = tile * kMomentsThreads + tid;
    if (tile >= n_tiles) return;
    if (i >= n_paths) return zero_row(q, sm, b);
    float v = in.v;
    if (maturity) {
      v = ma_payoff<A>(in.sT, p);
      V[i] = v;
      if (cf != nullptr) {
        cf[i] = v;
        tau[i] = static_cast<float>(n_steps);
      }
    }
    float uni[A][kMaxMaDegree + 1];
    ma_features<A>(in.s, p, sm.frame, 1, 0, uni);  // the frame as a one-step stats array
    // w is 0 or 1, so weighting is exact: the all-paths fit (w = 1)
    // rounds as the plain version's unweighted columns
    const float w = kItm ? (ma_payoff<A>(in.s, p) > 0.0f ? 1.0f : 0.0f) : 1.0f;
    build_row<A, kItm>(q, p, uni_slots, sm, uni, w, c_t * v * w, b);
  };
  const int P = pack_dim(m);
  moments_walk<StepIn<A>>(q, m, n_paths, sm, fetch, build,
                          partials + static_cast<size_t>(blockIdx.x) * P);
  if (!last_ticket(ticket, gridDim.x)) return;
  float* packed = reinterpret_cast<float*>(smem4);  // the tiles are free
  sum_rows_coalesced(partials, gridDim.x, P, packed);
  __syncthreads();
  if (tid < 32) warp_solve_equilibrated_ridge(packed, m, rcond, coeffs + t * m, packed + kMaxPack);
}

// Step t's exercise (an exercise date only): cont = max(fit, 0) on the
// step's coefficients; where payoff > cont, V <- payoff / c_t, cf <- payoff
// and tau <- t. The columns multiply the univariate columns staged in
// shared memory by the factor table (ma_column's bits), as kernel 8's
// moments do; the grid strides over the paths.
template <int A>
__global__ void __launch_bounds__(kThreads)
ma_mega_apply_kernel(const float* __restrict__ planes, float* __restrict__ V,
                     float* __restrict__ cf, float* __restrict__ tau,
                     const float* __restrict__ stats, const float* __restrict__ coeffs, int t,
                     int n_steps, int n_paths, const __grid_constant__ MaParams p) {
  extern __shared__ float uni_s[];  // [slot][thread]
  __shared__ unsigned char factors[kMaxCols * kMaxMaDegree];
  __shared__ float frame[2 * kMaxAssets];
  __shared__ float coef[kMaxCols];
  const int T1 = n_steps + 1;
  if (!(stats[(2 * A + 2) * T1 + t] > 0.0f)) return;  // not an exercise date
  const int m = p.n_cols;
  const int tid = threadIdx.x;
  const float inv_c_t = stats[(2 * A + 1) * T1 + t];
  const float tf = static_cast<float>(t);
  const float* planes_t = planes + static_cast<size_t>(t) * A * n_paths;
  init_factors<A>(p, factors);
  if (tid < 2 * A) frame[tid] = stats[tid * T1 + t];
  if (tid < m) coef[tid] = coeffs[t * m + tid];
  __syncthreads();
  for (int i = blockIdx.x * kThreads + tid; i < n_paths; i += gridDim.x * kThreads) {
    float s[A];
    load_assets<A>(planes_t, static_cast<size_t>(n_paths), i, s);
    float uni[A][kMaxMaDegree + 1];
    ma_features<A>(s, p, frame, 1, 0, uni);
    stage_uni<A>(uni, p.degree, uni_s, kThreads);
    // ma_continuation's order
    float fitted = staged_column(factors, uni_s, kThreads, 0) * coef[0];
    for (int c = 1; c < m; ++c) {
      fitted = fitted + staged_column(factors, uni_s, kThreads, c) * coef[c];
    }
    const float cont = fitted > 0.0f ? fitted : (fitted != fitted ? fitted : 0.0f);
    const float ex = ma_payoff<A>(s, p);
    // ex > cont implies ex > 0 (cont >= 0): amcx's ITM clause is implied
    if (ex > cont) {
      V[i] = ex * inv_c_t;
      if (cf != nullptr) {
        cf[i] = ex;
        tau[i] = tf;
      }
    }
  }
}

// Step 0's exercise and the final sums: sum c_0 V and sum (c_0 V)^2, or with
// antithetic pairs the sum of the squared pair means 0.5 (v_i + v_{i+n/2});
// the last block sums the rows into sums.
template <int A>
__global__ void __launch_bounds__(kThreads)
ma_mega_final_kernel(const float* __restrict__ planes, const float* __restrict__ V,
                     float* __restrict__ cf, float* __restrict__ tau,
                     const float* __restrict__ stats, const float* __restrict__ coeffs,
                     double* partials, unsigned* ticket, float* __restrict__ sums, int n_steps,
                     int n_paths, int antithetic, const __grid_constant__ MaParams p) {
  __shared__ float coef[kMaxCols];
  const int T1 = n_steps + 1;
  const bool apply = stats[(2 * A + 2) * T1] > 0.0f;
  const float inv_c_0 = stats[(2 * A + 1) * T1];
  const float c_0 = stats[2 * A * T1];
  if (apply && threadIdx.x < p.n_cols) coef[threadIdx.x] = coeffs[threadIdx.x];
  __syncthreads();
  // c_0 V of path i after step 0's exercise
  auto value = [&](int i) {
    float v = V[i];
    if (apply) {
      float s[A];
      load_assets<A>(planes, static_cast<size_t>(n_paths), i, s);
      float uni[A][kMaxMaDegree + 1];
      ma_features<A>(s, p, stats, T1, 0, uni);
      const float cont = ma_continuation<A>(uni, p, coef);
      const float ex = ma_payoff<A>(s, p);
      if (ex > cont) {
        v = ex * inv_c_0;
        if (cf != nullptr) {
          cf[i] = ex;
          tau[i] = 0.0f;
        }
      }
    }
    return c_0 * v;
  };
  double acc[2] = {0.0, 0.0};
  const int half = n_paths / 2;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < (antithetic ? half : n_paths);
       i += gridDim.x * kThreads) {
    const float va = value(i);
    acc[0] += static_cast<double>(va);
    if (!antithetic) {
      acc[1] += static_cast<double>(va * va);
    } else {
      const float vb = value(i + half);
      acc[0] += static_cast<double>(vb);
      const float f = 0.5f * (va + vb);
      acc[1] += static_cast<double>(f * f);
    }
  }
  block_reduce_store<2>(acc, partials + static_cast<size_t>(blockIdx.x) * 2);
  if (!last_ticket(ticket, gridDim.x)) return;
  sum_partials_coherent(partials, gridDim.x, 2, sums);
}

template <int A, bool kItm>
cudaError_t run_steps(const float* planes, const float* stats, float* V, float* cf, float* tau,
                      double* partials, unsigned* ticket, float* coeffs, int n_steps,
                      int n_paths, int n_blocks, int n_apply_blocks, float rcond,
                      const MaParams& p, cudaStream_t stream) {
  const MomentsPlan q = moments_plan(p.n_cols);
  const int uni_slots = moments_uni_slots(q, p, kMaxSmem);
  size_t smem = moments_tile_bytes(q, uni_slots);
  if (smem < kSolveBytes) smem = kSolveBytes;
  const size_t apply_smem = sizeof(float) * kThreads * p.n_assets * p.degree;
  static size_t allowed = 0;  // the opt-in is per kernel: set it once per size
  if (smem > allowed) {
    const cudaError_t err = allow_smem(ma_mega_step_kernel<A, kItm>, smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  for (int t = n_steps - 1; t >= 0; --t) {
    ma_mega_step_kernel<A, kItm><<<n_blocks, kMomentsThreads, smem, stream>>>(
        planes, V, cf, tau, stats, coeffs, partials, ticket, t, n_steps, n_paths, rcond,
        uni_slots, p);
    AMCX_LAUNCH_CHECK();
    if (t == 0) break;  // step 0's exercise goes with the final sums
    ma_mega_apply_kernel<A><<<n_apply_blocks, kThreads, apply_smem, stream>>>(
        planes, V, cf, tau, stats, coeffs, t, n_steps, n_paths, p);
    AMCX_LAUNCH_CHECK();
  }
  return cudaSuccess;
}

template <int A>
cudaError_t run_ma_mega(const float* planes, const float* stats, float* V, float* cf, float* tau,
                        double* partials, float* coeffs, float* sums, int n_steps, int n_paths,
                        int n_blocks, int n_final_blocks, float rcond, int itm_weights,
                        int antithetic, const MaParams& p, cudaStream_t stream) {
  unsigned* ticket = reinterpret_cast<unsigned*>(partials);
  double* rows = partials + 1;
  const int n_apply_blocks = static_cast<int>(
      std::min<long long>(kMaxApplyBlocks, (n_paths + kThreads - 1) / kThreads));
  const cudaError_t err =
      itm_weights ? run_steps<A, true>(planes, stats, V, cf, tau, rows, ticket, coeffs, n_steps,
                                       n_paths, n_blocks, n_apply_blocks, rcond, p, stream)
                  : run_steps<A, false>(planes, stats, V, cf, tau, rows, ticket, coeffs, n_steps,
                                        n_paths, n_blocks, n_apply_blocks, rcond, p, stream);
  if (err != cudaSuccess) return err;
  ma_mega_final_kernel<A><<<n_final_blocks, kThreads, 0, stream>>>(
      planes, V, cf, tau, stats, coeffs, rows, ticket, sums, n_steps, n_paths, antithetic, p);
  return cudaGetLastError();
}

}  // namespace

// planes (n_steps+1, A, n_paths) f32; stats (2A+3, n_steps+1) f32; V
// (n_paths) scratch; cf, tau (n_paths) out, or both null; partials: the
// ticket (the first 8 bytes, zeroed by the caller; it wraps back to 0 after
// each launch), then max(n_blocks P, 2 n_final_blocks) f64 of scratch;
// coeffs (n_steps+1, m) f32 scratch; sums (2) out; params on the host.
// n_blocks: the step kernel's persistent grid (kernel 8's sizing);
// n_final_blocks: the final sums' grid of kThreads blocks. Returns a
// cudaError_t.
extern "C" int amcx_lsmc_ma_mega(const float* planes, const float* stats, float* V, float* cf,
                                 float* tau, double* partials, float* coeffs, float* sums,
                                 int n_steps, int n_paths, int n_blocks, int n_final_blocks,
                                 float rcond, int itm_weights, int antithetic,
                                 const MaParams* params, void* stream) {
  if (params == nullptr || bad_params(*params) || n_steps < 1 || n_paths < 1 || n_blocks < 1 ||
      n_final_blocks < 1 || (cf == nullptr) != (tau == nullptr) ||
      (antithetic && n_paths % 2 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AMCX_MA_MEGA_CASE(AA)                                                                  \
  case AA:                                                                                     \
    return static_cast<int>(run_ma_mega<AA>(planes, stats, V, cf, tau, partials, coeffs,       \
                                            sums, n_steps, n_paths, n_blocks, n_final_blocks,  \
                                            rcond, itm_weights, antithetic, *params, s));
  AMCX_ASSETS_SWITCH(params->n_assets, AMCX_MA_MEGA_CASE)
#undef AMCX_MA_MEGA_CASE
}
