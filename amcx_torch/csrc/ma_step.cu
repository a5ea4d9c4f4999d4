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
// sum f32(c_i w * c_j) (i <= j) and sum f32(c_i * w y), f64 per block,
// summed over blocks in a fixed order and rounded once.
// Apply, per path: cont = max(sum coef_c col_c, 0) (a NaN fit stays NaN);
// where payoff > cont and the step is an exercise date, cf <- payoff and
// tau <- t IN PLACE (amcx donates these buffers).
//
// Bound on the H100, 5 assets and m = 21 at 1M paths: the moments read 5
// planes + cf + tau, 28 MB (8.4 us at 3.35 TB/s), and do 252 f32 products
// and 252 f64 additions per path (3.9 us at 67 TFLOP/s f32, 7.8 us at
// 34 TFLOP/s f64): 0.0117 ms of roofline. The result is defined as f32
// products summed in f64, so each product is widened (F2F), and Hopper
// widens 16 values a clock a SM (14.6-15.3 measured by
// amcx_torch/widen_probe.py): 252 a path take >= ~63 us at 1M paths, this
// design's floor. The first design (one thread a packed sum over a shared
// tile: two shared-memory loads a product) summed 1024 partial rows on one
// block (82 us of its 212). This design (ma_step_moments_kernel; its parts
// are ma_moments.cuh's, which kernel 7's moments share):
// - Register-blocked outer products. The packed sums are the upper triangle
//   plus last column of the m x (m+1) product of the rows [c_i w] with the
//   columns [c_j, y w]; a warp owns one 4 x 4 block of it (a task), its
//   lanes a stripe of the tile's paths, 16 f64 sums a lane. Per path a lane
//   loads two float4 (one on the diagonal): 16 products for 2 shared loads.
//   A diagonal block skips its lower triangle, the last column block its
//   padding columns (the slots are template arguments), and pairs its y w
//   column with the unweighted c_i, as the rhs sums are defined: 253
//   products a path at m = 21 for 252 sums.
// - The tile is one path per thread (32 x warps paths), a row of
//   [c_0..c_{m-1}, y w, 0..] padded to an odd number of float4 so that a
//   quarter-warp's 16-byte loads hit distinct banks, and w beside it. Two
//   tiles live in shared memory: a thread builds its path of tile i+1 from
//   loads issued a tile earlier, then the warps sum tile i, one barrier a
//   tile. The build took about as long as the sums (each timed alone in a
//   copy with the other switched off), mostly ma_column's scan of all
//   assets for every column:
//   the threads stage their univariate columns in shared memory and each
//   column multiplies its factors from a per-block table, in asset order
//   (ma_column's bits), when they fit beside the tiles.
// - A persistent grid (the wrapper's n_blocks: blocks that fill 24 warps a
//   SM), each walking many tiles, so the fixed-order final sum reads ~132
//   rows, one warp a sum. Above kMaxTaskWarps tasks (m >= 24) gridDim.y
//   splits the tasks into groups that each build the tile and write
//   disjoint entries of the partial row.
// Widening on the integer unit instead (sign, exponent + 896, mantissa <<
// 29, exact for 0 and normal values) was measured and dropped: it reached
// 10.8 values a clock a SM in widen_probe.py, below F2F's, and did not speed
// the kernel up at any split.
// The sums are per lane in path order, then a fixed shuffle tree, then the
// fixed-order cross-block sum: no float atomics, so runs are bit-identical,
// and f64 noise never reaches the f32 rounding, so the plain version's
// torch.sum gives the same bits.
// The apply reads only the 5 planes (21 MB, 6.3 us at 3.35 TB/s) and writes
// cf/tau (8 B) only where a path exercises; it never reads cf or tau. The
// TPU's (A, rows, 512) blocks and its n_paths % 4096 rule are dropped.
#include <cuda_runtime.h>

#include <cstddef>

#include "ma_moments.cuh"

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
__global__ void __launch_bounds__(kMaxTaskWarps * 32)
ma_step_moments_kernel(const float* __restrict__ planes, const float* __restrict__ cf,
                       const float* __restrict__ tau, const float* __restrict__ stats,
                       double* __restrict__ partials, int t, int n_steps, int n_paths, float rdt,
                       int direct_y, int uni_slots, const __grid_constant__ MaParams p) {
  extern __shared__ float4 smem4[];
  const int m = p.n_cols;
  const MomentsPlan q = moments_plan(m);
  const int tp = 32 * q.n_warps;  // paths per tile = threads per block
  const MomentsTiles sm = moments_tiles(smem4, q, uni_slots);
  const int T1 = n_steps + 1;
  const float tf = static_cast<float>(t);
  const int tid = threadIdx.x;
  const int n_tiles = (n_paths + tp - 1) / tp;
  init_factors<A>(p, sm.factors);
  if (tid < 2 * A) sm.frame[tid] = stats[tid * T1 + t];  // the mean_a and inv_std_a rows
  __syncthreads();

  // this thread's path of a tile: its loads, issued a tile ahead...
  auto fetch = [&](int tile, PathIn<A>& in) {
    const int i = tile * tp + tid;
    if (tile >= n_tiles || i >= n_paths) return;
    load_assets<A>(planes, static_cast<size_t>(n_paths), i, in.s);
    in.cf = cf[i];
    if (!direct_y) in.tau = tau[i];
  };
  // ...then its row of the tile
  auto build = [&](int tile, const PathIn<A>& in, int b) {
    const int i = tile * tp + tid;
    if (tile >= n_tiles || i >= n_paths) return;
    float uni[A][kMaxMaDegree + 1];
    ma_features<A>(in.s, p, sm.frame, 1, 0, uni);  // the frame as a one-step stats array
    // w is 0 or 1, so weighting is exact: the all-paths fit (w = 1)
    // rounds as the plain version's unweighted products
    const float w = kItm ? (ma_payoff<A>(in.s, p) > 0.0f ? 1.0f : 0.0f) : 1.0f;
    const float yw = (direct_y ? in.cf : in.cf * expf(-rdt * (in.tau - tf))) * w;
    build_row<A, kItm>(q, p, uni_slots, sm, uni, w, yw, b);
  };
  moments_walk<kItm, PathIn<A>>(q, m, n_paths, sm, fetch, build,
                                partials + static_cast<size_t>(blockIdx.x) * pack_dim(m));
}

template <int A>
__global__ void __launch_bounds__(kThreads)
ma_step_apply_kernel(const float* __restrict__ planes, float* __restrict__ cf,
                     float* __restrict__ tau, const float* __restrict__ stats,
                     const float* __restrict__ coeffs, int t, int n_steps, int n_paths,
                     const __grid_constant__ MaParams p) {
  __shared__ float coef[kMaxCols];
  if (threadIdx.x < p.n_cols) coef[threadIdx.x] = coeffs[threadIdx.x];
  __syncthreads();
  const int T1 = n_steps + 1;
  if (!(stats[(2 * A + 2) * T1 + t] > 0.0f)) return;  // not an exercise date
  const float tf = static_cast<float>(t);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n_paths; i += gridDim.x * kThreads) {
    float s[A];
    load_assets<A>(planes, static_cast<size_t>(n_paths), i, s);
    float uni[A][kMaxMaDegree + 1];
    ma_features<A>(s, p, stats, T1, t, uni);
    const float cont = ma_continuation<A>(uni, p, coef);
    const float ex = ma_payoff<A>(s, p);
    // ex > cont implies ex > 0 (cont >= 0): amcx's ITM clause is implied
    if (ex > cont) {
      cf[i] = ex;
      tau[i] = tf;
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
  ma_step_moments_kernel<A, kItm><<<dim3(n_blocks, q.n_groups), 32 * q.n_warps, smem, stream>>>(
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

template <int A>
cudaError_t run_apply(const float* planes, float* cf, float* tau, const float* stats,
                      const float* coeffs, int t, int n_steps, int n_paths, int n_blocks,
                      const MaParams& p, cudaStream_t stream) {
  ma_step_apply_kernel<A><<<n_blocks, kThreads, 0, stream>>>(planes, cf, tau, stats, coeffs, t,
                                                             n_steps, n_paths, p);
  return cudaGetLastError();
}

bool bad_args(int t, int n_steps, int n_paths, int n_blocks, const MaParams* p) {
  return p == nullptr || bad_params(*p) || n_steps < 1 || t < 0 || t >= n_steps ||
         n_paths < 1 || n_blocks < 1;
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

// Step t's planes; cf, tau updated in place; stats as above; coeffs (m) f32
// on the device. Returns a cudaError_t.
extern "C" int amcx_ma_step_apply(const float* planes, float* cf, float* tau, const float* stats,
                                  const float* coeffs, int t, int n_steps, int n_paths,
                                  int n_blocks, const MaParams* params, void* stream) {
  if (bad_args(t, n_steps, n_paths, n_blocks, params)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AMCX_APPLY_CASE(AA)                                                                \
  case AA:                                                                                 \
    return static_cast<int>(run_apply<AA>(planes, cf, tau, stats, coeffs, t, n_steps,      \
                                          n_paths, n_blocks, *params, s));
  AMCX_ASSETS_SWITCH(params->n_assets, AMCX_APPLY_CASE)
#undef AMCX_APPLY_CASE
}
