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
// design's floor. The first design (ma_moments_block in ma_common.cuh, which kernel 7 still
// runs) gave each packed sum to one thread over a shared tile (two
// shared-memory loads a product) and summed 1024 partial rows on one block
// (82 us of its 212). This design (ma_step_moments_kernel):
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
#include <utility>

#include "ma_common.cuh"

namespace {

using namespace amcx;

constexpr int kMaxTaskWarps = 21;  // one 4 x 4 task per warp (m = 21: every task)
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on the H100

// The register-blocked layout of m columns: row blocks of c_0..c_{m-1},
// column blocks of c_0..c_{m-1}, y w; tasks (I, J) with I <= J, J-major;
// the tile's row stride in float4 (odd); task groups over gridDim.y.
struct MomentsPlan {
  int n_rb, n_cb, n_tasks, stride4, n_warps, n_groups;
};

__host__ __device__ inline MomentsPlan moments_plan(int m) {
  MomentsPlan q;
  q.n_rb = (m + 3) / 4;
  q.n_cb = (m + 4) / 4;
  q.n_tasks = 0;
  for (int J = 0; J < q.n_cb; ++J) q.n_tasks += J + 1 < q.n_rb ? J + 1 : q.n_rb;
  q.stride4 = q.n_cb | 1;
  q.n_warps = q.n_tasks < kMaxTaskWarps ? q.n_tasks : kMaxTaskWarps;
  q.n_groups = (q.n_tasks + kMaxTaskWarps - 1) / kMaxTaskWarps;
  return q;
}

// Shared memory: two tiles of 32 n_warps paths (the float4 rows, then the
// w values), the columns' factor slots and the step's frame; with
// uni_slots > 0 also each thread's univariate columns (uni_slots of them).
inline size_t moments_tile_bytes(const MomentsPlan& q, int uni_slots) {
  const size_t paths = 32 * static_cast<size_t>(q.n_warps);
  return 2 * paths * (q.stride4 * sizeof(float4) + sizeof(float)) +
         sizeof(float) * (paths * uni_slots + kMaxCols * kMaxMaDegree + 2 * kMaxAssets);
}

// Product slot E = 4 ii + jj of a 4 x 4 task on one path: x_ii b_jj with
// x = c_i w (kItm), or the unweighted c_i in the y w column (kLast, column
// kNv - 1); kDiag skips jj < ii, and columns from kNv on are padding. E is
// a template argument, so only the task's real products are emitted.
template <bool kDiag, bool kLast, int kNv, int E>
__device__ __forceinline__ void task_product(const float (&a)[4], const float (&aw)[4],
                                             const float (&b)[4], double (&acc)[16]) {
  constexpr int ii = E / 4, jj = E % 4;
  if constexpr (jj < kNv && (!kDiag || jj >= ii)) {
    const float x = (kLast && jj == kNv - 1) ? a[ii] : aw[ii];
    acc[E] += static_cast<double>(x * b[jj]);
  }
}

template <bool kDiag, bool kLast, int kNv, int... E>
__device__ __forceinline__ void task_products(const float (&a)[4], const float (&aw)[4],
                                              const float (&b)[4], double (&acc)[16],
                                              std::integer_sequence<int, E...>) {
  (task_product<kDiag, kLast, kNv, E>(a, aw, b, acc), ...);
}

// One lane's share of a 4 x 4 task over a tile: rows i0.. (c_i, weighted by
// w when kItm) against columns j0.. (the first kNv valid).
template <bool kDiag, bool kLast, int kNv, bool kItm>
__device__ __forceinline__ void task_sums(const float4* __restrict__ rows,
                                          const float* __restrict__ wv, int count, int s4,
                                          int i4, int j4, double (&acc)[16]) {
  for (int p = threadIdx.x & 31; p < count; p += 32) {
    const float4 a4 = rows[p * s4 + i4];
    const float4 b4 = kDiag ? a4 : rows[p * s4 + j4];
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    const float b[4] = {b4.x, b4.y, b4.z, b4.w};
    float aw[4];
    if constexpr (kItm) {
      const float w = wv[p];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) aw[ii] = a[ii] * w;
    } else {
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) aw[ii] = a[ii];
    }
    task_products<kDiag, kLast, kNv>(a, aw, b, acc, std::make_integer_sequence<int, 16>{});
  }
}

// Dispatch a task's kind (diagonal, last column block and its valid
// columns) to its unrolled loop.
template <bool kItm>
__device__ __forceinline__ void task_dispatch(bool diag, bool last, int nv,
                                              const float4* __restrict__ rows,
                                              const float* __restrict__ wv, int count, int s4,
                                              int I, int J, double (&acc)[16]) {
#define AMCX_TASK(D, L, NV) task_sums<D, L, NV, kItm>(rows, wv, count, s4, I, J, acc)
  if (!last) {
    if (diag) {
      AMCX_TASK(true, false, 4);
    } else {
      AMCX_TASK(false, false, 4);
    }
    return;
  }
  switch (nv + (diag ? 4 : 0)) {
    case 1: AMCX_TASK(false, true, 1); break;
    case 2: AMCX_TASK(false, true, 2); break;
    case 3: AMCX_TASK(false, true, 3); break;
    case 4: AMCX_TASK(false, true, 4); break;
    case 5: AMCX_TASK(true, true, 1); break;
    case 6: AMCX_TASK(true, true, 2); break;
    case 7: AMCX_TASK(true, true, 3); break;
    default: AMCX_TASK(true, true, 4); break;
  }
#undef AMCX_TASK
}

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
  const int D = p.degree;
  const MomentsPlan q = moments_plan(m);
  const int tp = 32 * q.n_warps;  // paths per tile = threads per block
  const int s4 = q.stride4;
  float4* rows[2] = {smem4, smem4 + tp * s4};
  float* wv[2] = {reinterpret_cast<float*>(smem4 + 2 * tp * s4),
                  reinterpret_cast<float*>(smem4 + 2 * tp * s4) + tp};
  float* uni_s = wv[1] + tp;  // [slot][thread]
  unsigned char* factors = reinterpret_cast<unsigned char*>(uni_s + uni_slots * tp);
  float* frame = reinterpret_cast<float*>(factors + kMaxCols * kMaxMaDegree);
  const int T1 = n_steps + 1;
  const float tf = static_cast<float>(t);
  const int tid = threadIdx.x;
  const int n_tiles = (n_paths + tp - 1) / tp;
  const int stride = static_cast<int>(gridDim.x);

  // column c's factors in asset order: the slots of its assets with
  // alpha = d > 0 (0xff past the last); and the step's frame
  if (tid < m) {
    int k = 0;
    for (int a = 0; a < A; ++a) {
      const int d = p.alpha[tid][a];
      if (d > 0) factors[tid * kMaxMaDegree + k++] = static_cast<unsigned char>(a * D + d - 1);
    }
    for (; k < kMaxMaDegree; ++k) factors[tid * kMaxMaDegree + k] = 0xff;
  }
  if (tid < 2 * A) frame[tid] = stats[tid * T1 + t];  // the mean_a and inv_std_a rows
  __syncthreads();

  // this warp's task: (I, J) of the task list, J-major
  const int task = blockIdx.y * kMaxTaskWarps + (tid >> 5);
  int I = -1, J = 0;
  if (task < q.n_tasks) {
    int rest = task;
    for (J = 0;; ++J) {
      const int in_col = J + 1 < q.n_rb ? J + 1 : q.n_rb;
      if (rest < in_col) break;
      rest -= in_col;
    }
    I = rest;
  }
  const bool diag = I == J;
  const bool last = J == q.n_cb - 1;
  const int nv = last ? m + 1 - 4 * J : 4;  // valid columns of the block

  // this thread's path of a tile: its loads, issued a tile ahead...
  auto fetch = [&](int tile, PathIn<A>& in) {
    const int i = tile * tp + tid;
    if (tile >= n_tiles || i >= n_paths) return;
    load_assets<A>(planes, static_cast<size_t>(n_paths), i, in.s);
    in.cf = cf[i];
    if (!direct_y) in.tau = tau[i];
  };
  // ...then its row of the tile: c_0..c_{m-1}, y w, zeros; and w
  auto build = [&](int tile, const PathIn<A>& in, int b) {
    const int i = tile * tp + tid;
    if (tile >= n_tiles || i >= n_paths) return;
    float uni[A][kMaxMaDegree + 1];
    ma_features<A>(in.s, p, frame, 1, 0, uni);  // the frame as a one-step stats array
    if (uni_slots > 0) {
#pragma unroll
      for (int a = 0; a < A; ++a) {
#pragma unroll
        for (int d = 1; d <= kMaxMaDegree; ++d) {
          if (d <= D) uni_s[(a * D + d - 1) * tp + tid] = uni[a][d];
        }
      }
    }
    // w is 0 or 1, so weighting is exact: the all-paths fit (w = 1)
    // rounds as the plain version's unweighted products
    const float w = kItm ? (ma_payoff<A>(in.s, p) > 0.0f ? 1.0f : 0.0f) : 1.0f;
    const float yw = (direct_y ? in.cf : in.cf * expf(-rdt * (in.tau - tf))) * w;
    float4* row = rows[b] + tid * s4;
    for (int c4 = 0; c4 < q.n_cb; ++c4) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * c4 + e;
        if (c >= m) {
          v[e] = c == m ? yw : 0.0f;
        } else if (uni_slots > 0) {
          // ma_column's product: the factors left to right, 1 for none
          const unsigned char* f = factors + c * kMaxMaDegree;
          float term = f[0] == 0xff ? 1.0f : uni_s[f[0] * tp + tid];
#pragma unroll
          for (int k = 1; k < kMaxMaDegree; ++k) {
            if (f[k] == 0xff) break;
            term = term * uni_s[f[k] * tp + tid];
          }
          v[e] = term;
        } else {
          v[e] = ma_column<A>(uni, p.alpha[c]);
        }
      }
      row[c4] = make_float4(v[0], v[1], v[2], v[3]);
    }
    if (kItm) wv[b][tid] = w;
  };

  double acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.0;
  PathIn<A> in;
  const int first = blockIdx.x;
  fetch(first, in);
  build(first, in, 0);
  fetch(first + stride, in);
  __syncthreads();
  int b = 0;
  for (int tile = first; tile < n_tiles; tile += stride) {
    build(tile + stride, in, b ^ 1);  // the next tile, from loads issued a tile ago
    fetch(tile + 2 * stride, in);     // in flight while this tile is summed
    if (I >= 0) {
      task_dispatch<kItm>(diag, last, nv, rows[b], wv[b], min(tp, n_paths - tile * tp), s4, I,
                          J, acc);
    }
    __syncthreads();
    b ^= 1;
  }
  if (I < 0) return;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[e] += __shfl_down_sync(0xffffffffu, acc[e], off);
  }
  if ((tid & 31) != 0) return;
  const int n_pairs = m * (m + 1) / 2;
  double* row = partials + static_cast<size_t>(blockIdx.x) * pack_dim(m);
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int i = 4 * I + ii, j = 4 * J + jj;
      if (i >= m || j < i) continue;
      if (j < m) {
        row[pair_index(m, i, j)] = acc[ii * 4 + jj];
      } else if (j == m) {
        row[n_pairs + i] = acc[ii * 4 + jj];
      }
    }
  }
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
  // the univariate columns go to shared memory when they fit beside the tiles
  int uni_slots = p.n_assets * p.degree;
  if (moments_tile_bytes(q, uni_slots) > kMaxSmem) uni_slots = 0;
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
