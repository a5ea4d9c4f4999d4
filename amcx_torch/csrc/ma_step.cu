// One backward step of the fused multi-asset LSMC engine as two passes over
// the step's asset planes: the cross-term regression moments
// (amcx_ma_step_moments) and the exercise apply (amcx_ma_step_apply). The
// m x m solve between them stays in torch (amcx_torch.regress.pinv_solve),
// as amcx leaves it to XLA.
//
// Replaces: amcx/ops/maxcall_pallas.py::_ma_moments_kernel (via
// ma_step_moments) and amcx/ops/maxcall_pallas.py::_ma_apply_kernel (via
// ma_step_apply).
//
// Moments, per path i of step t: y = cf * expf(-rdt * (tau - t)) (or y = cf
// with direct_y), the cross-term columns c_0..c_{m-1} and w = 1[payoff > 0]
// (ITM fits; w = 1 otherwise), then the P = m(m+1)/2 + m packed sums
// sum (c_i w)(c_j) (i <= j) and sum c_i (w y), each product exact in f64
// (an f32 x f32 product has 48 significant bits), f64 per block, summed
// over blocks in a fixed order and rounded once.
// Apply, per path: cont = max(sum coef_c col_c, 0) (a NaN fit stays NaN);
// where payoff > cont and the step is an exercise date, cf <- payoff and
// tau <- t IN PLACE (amcx donates these buffers).
//
// Bound on the H100, 5 assets and m = 21 at 1M paths: the moments read 5
// planes + cf + tau, 28 MB (8.4 us at 3.35 TB/s), and form 252 f64
// products and their f64 sums a path (7.6 us at the FP64 tensor cores' 67
// TFLOP/s). Until the moments were defined by exact products they were f32
// products summed in f64, so each of the 252 products a path was widened
// on its own (F2F; 16 a clock a SM, 14.6-15.3 measured): a floor of ~63
// us, which that design (4 x 4 f32 outer-product tasks a warp) reached
// within a factor of two, at 132 us. This design (ma_step_moments_kernel;
// its parts are ma_moments.cuh's, which kernel 7's moments share):
// - The packed sums are X^T X without its entry (m, m), X = [c_0 w ..
//   c_{m-1} w | y w | 0 ..] padded to n_cb = ceil((m + 1) / 8) blocks of 8
//   columns (w is 0 or 1: c_i w is exact, and (c_i w)(y w) = c_i (w y)).
//   A warp owns every upper 8 x 8 tile (I <= J) of X^T X over its own 32
//   paths of a tile: a k-step of 4 paths, each lane loads one f32 of each
//   column block, widens it once, and the tiles' mma.sync m8n8k4 f64 take
//   x_I as A's fragment and x_J as B's. At m = 21: 24 widenings and 1.5
//   DMMA a path (3 blocks, 6 tiles), against 252 widenings; the products
//   are exact, so the sums differ from the plain version's in f64 order
//   only. Accumulators stay in registers (15 tiles at m = 32).
// - The tile is one path per thread (32 x 16 paths), kept per warp
//   column-major, a column of 32 paths padded to 36 floats: the build's
//   stores (a column, 32 lanes) and the fragment loads (8 columns x 4
//   paths) both hit 32 distinct banks. Two tiles live in shared memory: a
//   thread builds its path of tile i+1 from loads issued a tile earlier,
//   then its warp sums tile i, one warp barrier a tile (a warp reads only
//   the paths it built). The threads stage their univariate columns in
//   shared memory and each column multiplies its factors from a per-block
//   table, in asset order (ma_column's bits), when they fit beside the
//   tiles. At the end the warps' accumulators are summed in warp order into
//   the block's partial row.
// - A persistent grid (the wrapper's n_blocks: one block of 16 warps an SM,
//   ~132 partial rows), each block walking many tiles.
// Measured on the H100 (1M paths, m = 21): 72.4 us a call, the build alone
// (products switched off) 55 us, the products alone 28-31 us; 128
// registers a thread. Measured and dropped: mma m16n8k8 (0.5 DMMA a path)
// spilled its 36 accumulators (kernel 7 1.14 ms against 1.06); a build of 4
// paths a lane in float4 slots (kernel 9's) on 8 warps an SM, 77-83 us.
// The sums are per lane in path order (each DMMA's four products in the
// unit's fixed order), then the warps in order, then the fixed-order
// cross-block sum: no float atomics, so runs are bit-identical, and f64
// noise never reaches the f32 rounding, so the plain version's torch.sum
// gives the same bits.
// The apply reads only the 5 planes (21 MB, 6.3 us at 3.35 TB/s) and writes
// cf/tau (8 B) only where a path exercises; it never reads cf or tau. Its
// first design (one path a thread on a 1,024-block grid, ma_continuation's
// scan of every asset for every column: 105 (column, asset) visits a path
// at m = 21, each a compare and a chain of selects) took 55 us a call. This
// design (ma_step_apply_kernel):
// - returns before any path is read on a step that is no exercise date;
// - takes 4 consecutive paths a thread, with a 16-byte load of each asset
//   plane where the planes are so aligned (16-byte base, n_paths a multiple
//   of 4; one load a path otherwise, the tail past n_paths masked): 4 A
//   loads in flight a thread, not one path's A dependent ones;
// - builds each path's univariate columns by its basis's recurrence (the
//   basis a template argument, degrees 1..D only) and stages them in
//   shared memory, a float4 of the 4 paths a (asset, degree) slot; column
//   c then multiplies its factor slots, packed on the host a byte each in
//   asset order into one word (maxcall_pallas.ma_factor_words), left to
//   right: ma_column's products, so its bits;
// - runs on a persistent grid that the C entry sizes from the occupancy
//   query under that shared memory.
// cf and tau stay masked scalar stores, written only where a path
// exercises. The TPU's (A, rows, 512) blocks and its n_paths % 4096 rule
// are dropped.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "ma_moments.cuh"

// The apply's static description: the product and basis, and column c's
// factor slots (a D + d - 1 of each asset a with alpha = d > 0, in asset
// order) a byte each from the low byte, 0xff past the last; a column has at
// most kMaxMaDegree factors. Mirrors amcx_torch.ops.maxcall_pallas.MaApply;
// passed to the kernel by value.
struct MaApply {
  amcx::MaParams params;
  unsigned factors[amcx::kMaxCols];
};

namespace {

using namespace amcx;

// One path's device-memory inputs of a tile, loaded a tile ahead of its build.
template <int A>
struct PathIn {
  float s[A];
  float cf, tau;
};

// uni_slots > 0: the columns are built from the univariate columns staged
// in shared memory (slot a degree + d - 1 of asset a's degree d), by the
// factor table; 0 (no room in shared memory): by ma_column in registers.
template <int A, bool kItm>
__global__ void __launch_bounds__(kMomentsThreads, 1)
ma_step_moments_kernel(const float* __restrict__ planes, const float* __restrict__ cf,
                       const float* __restrict__ tau, const float* __restrict__ stats,
                       double* __restrict__ partials, int t, int n_steps, int n_paths, float rdt,
                       int direct_y, int uni_slots, const __grid_constant__ MaParams p) {
  extern __shared__ float4 smem4[];
  const int m = p.n_cols;
  const MomentsPlan q = moments_plan(m);
  const MomentsTiles sm = moments_tiles(smem4, q, uni_slots);
  const int T1 = n_steps + 1;
  const float tf = static_cast<float>(t);
  const int tid = threadIdx.x;
  const int n_tiles = (n_paths + kMomentsThreads - 1) / kMomentsThreads;
  init_factors<A>(p, sm.factors);
  if (tid < 2 * A) sm.frame[tid] = stats[tid * T1 + t];  // the mean_a and inv_std_a rows
  __syncthreads();

  // this thread's path of a tile: its loads, issued a tile ahead...
  auto fetch = [&](int tile, PathIn<A>& in) {
    const int i = tile * kMomentsThreads + tid;
    if (tile >= n_tiles || i >= n_paths) return;
    load_assets<A>(planes, static_cast<size_t>(n_paths), i, in.s);
    in.cf = cf[i];
    if (!direct_y) in.tau = tau[i];
  };
  // ...then its column of the tile
  auto build = [&](int tile, const PathIn<A>& in, int b) {
    const int i = tile * kMomentsThreads + tid;
    if (tile >= n_tiles) return;
    if (i >= n_paths) return zero_row(q, sm, b);
    float uni[A][kMaxMaDegree + 1];
    ma_features<A>(in.s, p, sm.frame, 1, 0, uni);  // the frame as a one-step stats array
    // w is 0 or 1, so weighting is exact: the all-paths fit (w = 1)
    // rounds as the plain version's unweighted columns
    const float w = kItm ? (ma_payoff<A>(in.s, p) > 0.0f ? 1.0f : 0.0f) : 1.0f;
    const float yw = (direct_y ? in.cf : in.cf * expf(-rdt * (in.tau - tf))) * w;
    build_row<A, kItm>(q, p, uni_slots, sm, uni, w, yw, b);
  };
  moments_walk<PathIn<A>>(q, m, n_paths, sm, fetch, build,
                          partials + static_cast<size_t>(blockIdx.x) * pack_dim(m));
}

// Basis column n >= 2 of x from columns n-1 and n-2: basis_cols' operations
// for basis kBasis (lsmc_common.cuh), so its bits.
template <int kBasis>
__device__ __forceinline__ float basis_next(float x, int n, float prev, float prev2) {
  const float fn = static_cast<float>(n);
  if constexpr (kBasis == kPower) {
    return prev * x;
  } else if constexpr (kBasis == kChebyshev) {
    return 2.0f * x * prev - prev2;
  } else if constexpr (kBasis == kLegendre) {
    return ((2.0f * fn - 1.0f) * x * prev - (fn - 1.0f) * prev2) / fn;
  } else if constexpr (kBasis == kLaguerre) {
    return ((2.0f * fn - 1.0f - x) * prev - (fn - 1.0f) * prev2) / fn;
  } else {
    return 2.0f * x * prev - 2.0f * (fn - 1.0f) * prev2;
  }
}

// Univariate columns 1..D of four paths' feature x into the slots slot[0],
// slot[kThreads], ... (degree d in slot d - 1), a float4 of the paths each.
template <int kBasis>
__device__ __forceinline__ void stage_uni4(const float (&x)[4], int D, float4* slot) {
  if (D < 1) return;
  float prev2[4], prev[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    prev2[e] = 1.0f;
    prev[e] = kBasis == kLaguerre ? 1.0f - x[e] : (kBasis == kHermite ? 2.0f * x[e] : x[e]);
  }
  slot[0] = make_float4(prev[0], prev[1], prev[2], prev[3]);
#pragma unroll
  for (int n = 2; n <= kMaxMaDegree; ++n) {
    if (n > D) break;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = basis_next<kBasis>(x[e], n, prev[e], prev2[e]);
      prev2[e] = prev[e];
      prev[e] = v[e];
    }
    slot[(n - 1) * kThreads] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// amcx's bubble compare-exchange network: a descending sort in place
// (ma_features' order).
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

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

// Step t's exercise (the header's design). uni_s: the block's staged
// columns, [slot][thread] float4; q.factors[c]: column c's factor slots.
template <int A, int kBasis>
__global__ void __launch_bounds__(kThreads)
ma_step_apply_kernel(const float* __restrict__ planes, float* __restrict__ cf,
                     float* __restrict__ tau, const float* __restrict__ stats,
                     const float* __restrict__ coeffs, int t, int n_steps, int n_paths, int vec,
                     const __grid_constant__ MaApply q) {
  extern __shared__ float4 uni_s[];
  __shared__ unsigned factors[kMaxCols];
  __shared__ float coef[kMaxCols];
  const int T1 = n_steps + 1;
  if (!(stats[(2 * A + 2) * T1 + t] > 0.0f)) return;  // not an exercise date
  const MaParams& p = q.params;
  const int m = p.n_cols;
  const int D = p.degree;
  const int tid = threadIdx.x;
  if (tid < m) {
    coef[tid] = coeffs[tid];
    factors[tid] = q.factors[tid];
  }
  float mean[A], inv_std[A];
#pragma unroll
  for (int a = 0; a < A; ++a) {
    mean[a] = stats[a * T1 + t];
    inv_std[a] = stats[(A + a) * T1 + t];
  }
  __syncthreads();
  const float tf = static_cast<float>(t);
  const size_t plane = static_cast<size_t>(n_paths);
  float4* mine = uni_s + tid;
  const int n_groups = (n_paths + 3) / 4;
  for (int g = blockIdx.x * kThreads + tid; g < n_groups; g += gridDim.x * kThreads) {
    const int i0 = 4 * g;
    const int n_here = min(4, n_paths - i0);
    float s[4][A];
#pragma unroll
    for (int a = 0; a < A; ++a) {
      float x4[4];
      load_row4(planes + a * plane, i0, n_here, vec, x4);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e][a] = x4[e];
    }
    float ex[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ex[e] = ma_payoff<A>(s[e], p);
      if (p.sorted) sort_desc<A>(s[e]);
    }
#pragma unroll
    for (int a = 0; a < A; ++a) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = (s[e][a] - mean[a]) * inv_std[a];
      stage_uni4<kBasis>(x, D, mine + a * D * kThreads);
    }
    // ma_continuation's order: column 0 times its coefficient, then each
    // further product added left to right
    float4 fit = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int c = 0; c < m; ++c) {
      unsigned w = factors[c];
      float4 col = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
      if ((w & 0xffu) != 0xffu) {
        col = mine[(w & 0xffu) * kThreads];
#pragma unroll
        for (int k = 1; k < kMaxMaDegree; ++k) {
          w >>= 8;
          if ((w & 0xffu) == 0xffu) break;
          col = mul4(col, mine[(w & 0xffu) * kThreads]);
        }
      }
      const float4 term = mul4(col, make_float4(coef[c], coef[c], coef[c], coef[c]));
      fit = c == 0 ? term
                   : make_float4(fit.x + term.x, fit.y + term.y, fit.z + term.z, fit.w + term.w);
    }
    const float f4[4] = {fit.x, fit.y, fit.z, fit.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float fitted = f4[e];
      const float cont = fitted > 0.0f ? fitted : (fitted != fitted ? fitted : 0.0f);
      // ex > cont implies ex > 0 (cont >= 0): amcx's ITM clause is implied
      if (e < n_here && ex[e] > cont) {
        cf[i0 + e] = ex[e];
        tau[i0 + e] = tf;
      }
    }
  }
}

template <int A, bool kItm>
cudaError_t launch_moments(const float* planes, const float* cf, const float* tau,
                           const float* stats, double* partials, int t, int n_steps, int n_paths,
                           int n_blocks, float rdt, int direct_y, const MaParams& p,
                           cudaStream_t stream) {
  const MomentsPlan q = moments_plan(p.n_cols);
  const int uni_slots = moments_uni_slots(q, p, kMaxSmem);
  const size_t smem = moments_tile_bytes(q, uni_slots);
  static size_t allowed = 0;  // the opt-in is per kernel: set it once per size
  if (smem > allowed) {
    const cudaError_t err = allow_smem(ma_step_moments_kernel<A, kItm>, smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  ma_step_moments_kernel<A, kItm><<<n_blocks, kMomentsThreads, smem, stream>>>(
      planes, cf, tau, stats, partials, t, n_steps, n_paths, rdt, direct_y, uni_slots, p);
  return cudaGetLastError();
}

template <int A>
cudaError_t run_moments(const float* planes, const float* cf, const float* tau,
                        const float* stats, double* partials, float* packed, int t, int n_steps,
                        int n_paths, int n_blocks, float rdt, int itm_weights, int direct_y,
                        const MaParams& p, cudaStream_t stream) {
  const cudaError_t err =
      itm_weights ? launch_moments<A, true>(planes, cf, tau, stats, partials, t, n_steps,
                                            n_paths, n_blocks, rdt, direct_y, p, stream)
                  : launch_moments<A, false>(planes, cf, tau, stats, partials, t, n_steps,
                                             n_paths, n_blocks, rdt, direct_y, p, stream);
  if (err != cudaSuccess) return err;
  const int P = pack_dim(p.n_cols);
  sum_partials_kernel<<<(P + kWarps - 1) / kWarps, kThreads, 0, stream>>>(partials, n_blocks, P,
                                                                          packed);
  return cudaGetLastError();
}

template <int A, int kBasis>
cudaError_t launch_apply(const float* planes, float* cf, float* tau, const float* stats,
                         const float* coeffs, int t, int n_steps, int n_paths, int n_sm, int vec,
                         const MaApply& q, cudaStream_t stream) {
  const int slots = A * q.params.degree;
  const size_t smem = sizeof(float4) * kThreads * slots;
  // blocks a SM under this shared memory, from the occupancy query, kept
  // per slot count; the dynamic size is opted in with it (always: with the
  // static arrays, 48 KB of it would already exceed the default)
  static int per_sm[kMaxCols + 1] = {};
  if (per_sm[slots] == 0) {
    cudaError_t err = cudaFuncSetAttribute(ma_step_apply_kernel<A, kBasis>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ma_step_apply_kernel<A, kBasis>,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    if (blocks < 1) return cudaErrorInvalidConfiguration;
    per_sm[slots] = blocks;
  }
  const long long groups = (static_cast<long long>(n_paths) + 3) / 4;
  const int n_blocks =
      static_cast<int>(std::min<long long>(static_cast<long long>(per_sm[slots]) * n_sm,
                                           (groups + kThreads - 1) / kThreads));
  ma_step_apply_kernel<A, kBasis><<<n_blocks, kThreads, smem, stream>>>(
      planes, cf, tau, stats, coeffs, t, n_steps, n_paths, vec, q);
  return cudaGetLastError();
}

// The vector loads are decided here from the planes' base, each launch.
template <int A>
cudaError_t run_apply(const float* planes, float* cf, float* tau, const float* stats,
                      const float* coeffs, int t, int n_steps, int n_paths, int n_sm,
                      const MaApply& q, cudaStream_t stream) {
  const int vec = (reinterpret_cast<uintptr_t>(planes) & 15) == 0 && n_paths % 4 == 0;
#define AMCX_APPLY_ARGS planes, cf, tau, stats, coeffs, t, n_steps, n_paths, n_sm, vec, q, stream
  switch (q.params.basis) {
    case kPower:
      return launch_apply<A, kPower>(AMCX_APPLY_ARGS);
    case kChebyshev:
      return launch_apply<A, kChebyshev>(AMCX_APPLY_ARGS);
    case kLegendre:
      return launch_apply<A, kLegendre>(AMCX_APPLY_ARGS);
    case kLaguerre:
      return launch_apply<A, kLaguerre>(AMCX_APPLY_ARGS);
    default:
      return launch_apply<A, kHermite>(AMCX_APPLY_ARGS);
  }
#undef AMCX_APPLY_ARGS
}

bool bad_args(int t, int n_steps, int n_paths, int n_blocks, const MaParams* p) {
  return p == nullptr || bad_params(*p) || n_steps < 1 || t < 0 || t >= n_steps ||
         n_paths < 1 || n_blocks < 1;
}

// Every factor slot of the m columns lies below A D, and each word lists
// its slots before its 0xff bytes.
bool bad_factors(const MaApply& q) {
  const int slots = q.params.n_assets * q.params.degree;
  for (int c = 0; c < q.params.n_cols; ++c) {
    bool done = false;
    for (int k = 0; k < kMaxMaDegree; ++k) {
      const unsigned f = (q.factors[c] >> (8 * k)) & 0xffu;
      if (f == 0xffu) {
        done = true;
      } else if (done || static_cast<int>(f) >= slots) {
        return true;
      }
    }
  }
  return false;
}

}  // namespace

// Step t's planes (A, n_paths) f32; cf, tau (n_paths) f32; stats (2A+3,
// n_steps+1) f32; partials (n_blocks, P) f64 scratch; packed (P) f32 out;
// params on the host. Returns a cudaError_t.
extern "C" int amcx_ma_step_moments(const float* planes, const float* cf, const float* tau,
                                    const float* stats, double* partials, float* packed, int t,
                                    int n_steps, int n_paths, int n_blocks, float rdt,
                                    int itm_weights, int direct_y, const MaParams* params,
                                    void* stream) {
  if (bad_args(t, n_steps, n_paths, n_blocks, params)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AMCX_MOMENTS_CASE(AA)                                                                 \
  case AA:                                                                                    \
    return static_cast<int>(run_moments<AA>(planes, cf, tau, stats, partials, packed, t,      \
                                            n_steps, n_paths, n_blocks, rdt, itm_weights,     \
                                            direct_y, *params, s));
  AMCX_ASSETS_SWITCH(params->n_assets, AMCX_MOMENTS_CASE)
#undef AMCX_MOMENTS_CASE
}

// Step t's planes (A, n_paths) f32; cf, tau (n_paths) f32 updated in place;
// stats (2A+3, n_steps+1) f32; coeffs (m) f32 on the device; n_sm the
// device's SM count (the grid is sized from it and the occupancy query);
// q on the host: the product, its basis and the columns' factor words.
// Returns a cudaError_t.
extern "C" int amcx_ma_step_apply(const float* planes, float* cf, float* tau, const float* stats,
                                  const float* coeffs, int t, int n_steps, int n_paths, int n_sm,
                                  const MaApply* q, void* stream) {
  if (q == nullptr || bad_args(t, n_steps, n_paths, n_sm, &q->params) || bad_factors(*q)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AMCX_APPLY_CASE(AA)                                                                \
  case AA:                                                                                 \
    return static_cast<int>(run_apply<AA>(planes, cf, tau, stats, coeffs, t, n_steps,      \
                                          n_paths, n_sm, *q, s));
  AMCX_ASSETS_SWITCH(q->params.n_assets, AMCX_APPLY_CASE)
#undef AMCX_APPLY_CASE
}

// A fused loop's apply, validated once (amcx_torch.ops.maxcall_pallas
// ma_step_apply_launcher); mirrors maxcall_pallas._MaApplyPlan. Step t's
// planes are planes + t A n_paths.
struct MaApplyPlan {
  const float* planes;  // (n_steps+1, A, n_paths) f32
  float* cf;            // (n_paths) f32, updated in place
  float* tau;           // (n_paths) f32, updated in place
  const float* stats;   // (2A+3, n_steps+1) f32
  int n_steps, n_paths, n_sm;
  MaApply q;
};

// Step t of a fused loop's plan (above) on the device coefficients coeffs
// (m) f32. Returns a cudaError_t.
extern "C" int amcx_ma_step_apply_planes(const MaApplyPlan* plan, int t, const float* coeffs,
                                         void* stream) {
  if (plan == nullptr || t < 0 || t >= plan->n_steps || plan->n_paths < 1 ||
      plan->q.params.n_assets < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t step = static_cast<size_t>(t) * plan->q.params.n_assets * plan->n_paths;
  return amcx_ma_step_apply(plan->planes + step, plan->cf, plan->tau, plan->stats, coeffs, t,
                            plan->n_steps, plan->n_paths, plan->n_sm, &plan->q, stream);
}
