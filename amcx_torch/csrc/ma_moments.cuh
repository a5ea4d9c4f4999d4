// The register-blocked multi-asset moments of one step, shared by kernel 8
// (ma_step.cu: ma_step_moments_kernel, regression target y = cf e^{-r dt
// (tau - t)}) and kernel 7 (lsmc_ma_mega.cu: ma_mega_step_kernel, y = c_t V
// after the previous step's exercise). ma_step.cu's header gives the
// design; this file holds its parts:
// - MomentsPlan: the 4 x 4 warp tasks of the m x (m+1) product of the rows
//   [c_i w] with the columns [c_j, y w], J-major, kMaxTaskWarps a block
//   (task groups over gridDim.y above that);
// - the block's shared memory (MomentsTiles): two tiles of one path a
//   thread (a row of odd float4 stride, and w), the univariate columns
//   staged a slot a (asset, degree), the columns' factor table and the
//   step's frame;
// - build_row: a path's row from its univariate columns, the factor table's
//   products in asset order (ma_column's bits);
// - moments_walk: the double-buffered walk over a persistent grid's tiles
//   (loads issued a tile ahead, one barrier a tile) and the tasks' lane
//   sums into the block's f64 partial row.
// Every product is an f32 product summed in f64 in a fixed order: the
// partial rows, summed in sum_partials' order and rounded once, are the
// plain versions' bits.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <utility>

#include "ma_common.cuh"

namespace amcx {

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

// The univariate columns go to shared memory when they fit beside the
// tiles in `budget` bytes; else the columns are built by ma_column.
inline int moments_uni_slots(const MomentsPlan& q, const MaParams& p, size_t budget) {
  const int uni_slots = p.n_assets * p.degree;
  return moments_tile_bytes(q, uni_slots) > budget ? 0 : uni_slots;
}

// The pieces of a block's dynamic shared memory (moments_tile_bytes).
struct MomentsTiles {
  float4* rows[2];
  float* wv[2];
  float* uni_s;  // [slot][thread]
  unsigned char* factors;
  float* frame;  // the step's mean_a and inv_std_a rows
};

__device__ __forceinline__ MomentsTiles moments_tiles(float4* smem4, const MomentsPlan& q,
                                                      int uni_slots) {
  const int tp = 32 * q.n_warps;
  MomentsTiles sm;
  sm.rows[0] = smem4;
  sm.rows[1] = smem4 + tp * q.stride4;
  sm.wv[0] = reinterpret_cast<float*>(smem4 + 2 * tp * q.stride4);
  sm.wv[1] = sm.wv[0] + tp;
  sm.uni_s = sm.wv[1] + tp;
  sm.factors = reinterpret_cast<unsigned char*>(sm.uni_s + uni_slots * tp);
  sm.frame = reinterpret_cast<float*>(sm.factors + kMaxCols * kMaxMaDegree);
  return sm;
}

// Column c's factors in asset order: the slots a D + d - 1 of its assets
// with alpha = d > 0 (0xff past the last); threads c < m write them.
template <int A>
__device__ __forceinline__ void init_factors(const MaParams& p, unsigned char* factors) {
  const int c = threadIdx.x;
  if (c >= p.n_cols) return;
  int k = 0;
  for (int a = 0; a < A; ++a) {
    const int d = p.alpha[c][a];
    if (d > 0) factors[c * kMaxMaDegree + k++] = static_cast<unsigned char>(a * p.degree + d - 1);
  }
  for (; k < kMaxMaDegree; ++k) factors[c * kMaxMaDegree + k] = 0xff;
}

// This thread's univariate columns into its slots (degree d of asset a in
// slot a D + d - 1).
template <int A>
__device__ __forceinline__ void stage_uni(const float (&uni)[A][kMaxMaDegree + 1], int D,
                                          float* uni_s, int tp) {
#pragma unroll
  for (int a = 0; a < A; ++a) {
#pragma unroll
    for (int d = 1; d <= kMaxMaDegree; ++d) {
      if (d <= D) uni_s[(a * D + d - 1) * tp + threadIdx.x] = uni[a][d];
    }
  }
}

// Column c of this thread's staged slots: ma_column's product, the factors
// left to right, 1 for none.
__device__ __forceinline__ float staged_column(const unsigned char* factors, const float* uni_s,
                                               int tp, int c) {
  const unsigned char* f = factors + c * kMaxMaDegree;
  float term = f[0] == 0xff ? 1.0f : uni_s[f[0] * tp + threadIdx.x];
#pragma unroll
  for (int k = 1; k < kMaxMaDegree; ++k) {
    if (f[k] == 0xff) break;
    term = term * uni_s[f[k] * tp + threadIdx.x];
  }
  return term;
}

// This thread's path row of tile buffer b: c_0..c_{m-1}, y w, zeros; and w.
// With uni_slots > 0 the columns come from the staged slots, else from
// ma_column in registers.
template <int A, bool kItm>
__device__ __forceinline__ void build_row(const MomentsPlan& q, const MaParams& p, int uni_slots,
                                          const MomentsTiles& sm,
                                          const float (&uni)[A][kMaxMaDegree + 1], float w,
                                          float yw, int b) {
  const int tp = 32 * q.n_warps;
  const int m = p.n_cols;
  if (uni_slots > 0) stage_uni<A>(uni, p.degree, sm.uni_s, tp);
  float4* row = sm.rows[b] + threadIdx.x * q.stride4;
  for (int c4 = 0; c4 < q.n_cb; ++c4) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * c4 + e;
      if (c >= m) {
        v[e] = c == m ? yw : 0.0f;
      } else if (uni_slots > 0) {
        v[e] = staged_column(sm.factors, sm.uni_s, tp, c);
      } else {
        v[e] = ma_column<A>(uni, p.alpha[c]);
      }
    }
    row[c4] = make_float4(v[0], v[1], v[2], v[3]);
  }
  if (kItm) sm.wv[b][threadIdx.x] = w;
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

// The block's share of one step's moments: tiles blockIdx.x, + gridDim.x,
// ... of tp = 32 n_warps paths. fetch(tile, in) issues a thread's loads of
// its path a tile ahead of build(tile, in, b), which writes its row of
// buffer b (both skip tiles and paths past the end); then each warp sums
// its task over the tile, one barrier a tile. The lanes' sums fold by a
// fixed shuffle tree into the entries of the block's partial row that the
// warp's task owns. Every thread of the block calls it; on return the
// tiles are free.
template <bool kItm, class In, class Fetch, class Build>
__device__ __forceinline__ void moments_walk(const MomentsPlan& q, int m, int n_paths,
                                             const MomentsTiles& sm, Fetch fetch, Build build,
                                             double* __restrict__ row) {
  const int tid = threadIdx.x;
  const int tp = 32 * q.n_warps;
  const int n_tiles = (n_paths + tp - 1) / tp;
  const int stride = static_cast<int>(gridDim.x);
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

  double acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.0;
  In in;
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
      task_dispatch<kItm>(diag, last, nv, sm.rows[b], sm.wv[b], min(tp, n_paths - tile * tp),
                          q.stride4, I, J, acc);
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

}  // namespace amcx
