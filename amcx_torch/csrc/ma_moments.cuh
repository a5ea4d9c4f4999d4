// The multi-asset moments of one step on the FP64 tensor cores, shared by
// kernel 8 (ma_step.cu: ma_step_moments_kernel, regression target y = cf
// e^{-r dt (tau - t)}) and kernel 7 (lsmc_ma_mega.cu: ma_mega_step_kernel,
// y = c_t V after the previous step's exercise). ma_step.cu's header gives
// the design; this file holds its parts:
// - MomentsPlan: X = [c_0 w .. c_{m-1} w | y w | 0 ..], m + 1 columns
//   padded to n_cb blocks of 8; the packed sums are X^T X's upper 8 x 8
//   tiles (I <= J) without its entry (m, m);
// - the block's shared memory (MomentsTiles): per warp two tiles of its 32
//   paths, column-major (a column of 32 paths padded to kLaneStride, so
//   that both the build's stores and the fragment loads hit distinct
//   banks), the univariate columns staged a slot a (asset, degree), the
//   columns' factor table and the step's frame;
// - build_row: a path's column of the tile from its univariate columns,
//   the factor table's products in asset order (ma_column's bits), times w;
// - moments_walk: the double-buffered walk over a persistent grid's tiles
//   (loads issued a tile ahead, one warp barrier a tile), each warp's
//   mma.sync m8n8k4 f64 products over its own paths, and the warps' sums
//   into the block's f64 partial row.
// Every product is exact: the f32 columns are widened once and an f32 x f32
// product has 48 significant bits, so only the order of the f64 sums
// differs from the plain version's (maxcall_pallas._moments_from_cols),
// whose rounding once to f32 the partial rows, summed in a fixed order and
// rounded once, reproduce.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "ma_common.cuh"

namespace amcx {

constexpr int kMomentsWarps = 16;  // a block: 16 warps, each all tiles of its own paths
constexpr int kMomentsThreads = 32 * kMomentsWarps;  // paths a tile, one a thread
constexpr int kLaneStride = 36;  // floats a column of a warp's tile: 32 paths + 4
constexpr int kMaxColBlocks = (kMaxCols + 8) / 8;  // 8-column blocks of X at m = kMaxCols
constexpr int kMaxTiles = kMaxColBlocks * (kMaxColBlocks + 1) / 2;
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on the H100

// The column blocks of X for m columns: ceil((m + 1) / 8).
struct MomentsPlan {
  int n_cb;
};

__host__ __device__ inline MomentsPlan moments_plan(int m) { return MomentsPlan{(m + 8) / 8}; }

// Shared memory: per warp two tiles of 8 n_cb columns of kLaneStride
// floats, the columns' factor slots and the step's frame; with uni_slots >
// 0 also each thread's univariate columns (uni_slots of them).
inline size_t moments_tile_bytes(const MomentsPlan& q, int uni_slots) {
  return sizeof(float) * (2 * kMomentsWarps * 8 * static_cast<size_t>(q.n_cb) * kLaneStride +
                          static_cast<size_t>(kMomentsThreads) * uni_slots +
                          2 * kMaxAssets) +
         kMaxCols * kMaxMaDegree;
}

// The univariate columns go to shared memory when they fit beside the
// tiles in `budget` bytes; else the columns are built by ma_column.
inline int moments_uni_slots(const MomentsPlan& q, const MaParams& p, size_t budget) {
  const int uni_slots = p.n_assets * p.degree;
  return moments_tile_bytes(q, uni_slots) > budget ? 0 : uni_slots;
}

// The pieces of a block's dynamic shared memory (moments_tile_bytes). Tile
// buffer b of warp w starts at cols + b tile + w warp_floats (offsets, not
// an array of pointers: a pointer picked by a runtime index sends the
// struct to local memory and its loads and stores to generic addressing).
struct MomentsTiles {
  float* cols;  // [buffer][warp][column][kLaneStride]
  int tile, warp_floats;
  float* uni_s;  // [slot][thread]
  float* frame;  // the step's mean_a and inv_std_a rows
  unsigned char* factors;
};

__device__ __forceinline__ MomentsTiles moments_tiles(float4* smem4, const MomentsPlan& q,
                                                      int uni_slots) {
  MomentsTiles sm;
  sm.warp_floats = 8 * q.n_cb * kLaneStride;
  sm.tile = kMomentsWarps * sm.warp_floats;
  sm.cols = reinterpret_cast<float*>(smem4);
  sm.uni_s = sm.cols + 2 * sm.tile;
  sm.frame = sm.uni_s + uni_slots * kMomentsThreads;
  sm.factors = reinterpret_cast<unsigned char*>(sm.frame + 2 * kMaxAssets);
  return sm;
}

// This thread's place in its warp's tile of buffer b: column c at c kLaneStride.
__device__ __forceinline__ float* tile_column(const MomentsTiles& sm, int b) {
  return sm.cols + b * sm.tile + (threadIdx.x >> 5) * sm.warp_floats + (threadIdx.x & 31);
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

// This thread's path in its warp's tile of buffer b: column c of X at
// [c][lane], c_c w for c < m, then y w, then zeros. w is 0 or 1, so c_c w
// is exact and (c_c w)(y w) = c_c (w y). With uni_slots > 0 the columns
// come from the staged slots, else from ma_column in registers.
template <int A, bool kItm>
__device__ __forceinline__ void build_row(const MomentsPlan& q, const MaParams& p, int uni_slots,
                                          const MomentsTiles& sm,
                                          const float (&uni)[A][kMaxMaDegree + 1], float w,
                                          float yw, int b) {
  const int m = p.n_cols;
  if (uni_slots > 0) stage_uni<A>(uni, p.degree, sm.uni_s, kMomentsThreads);
  float* col = tile_column(sm, b);
  for (int c = 0; c < 8 * q.n_cb; ++c) {
    float v;
    if (c >= m) {
      v = c == m ? yw : 0.0f;
    } else {
      v = uni_slots > 0 ? staged_column(sm.factors, sm.uni_s, kMomentsThreads, c)
                        : ma_column<A>(uni, p.alpha[c]);
      if (kItm) v = v * w;
    }
    col[c * kLaneStride] = v;
  }
}

// A zero path (past n_paths) in this thread's place of buffer b: it adds
// exactly 0 to every sum.
__device__ __forceinline__ void zero_row(const MomentsPlan& q, const MomentsTiles& sm, int b) {
  float* col = tile_column(sm, b);
  for (int c = 0; c < 8 * q.n_cb; ++c) col[c * kLaneStride] = 0.0f;
}

// One m8n8k4 f64 product on the FP64 tensor cores, d += a b: lane l holds
// A[l / 4][l % 4] and B[l % 4][l / 4], and D[l / 4][2 (l % 4) + e] in d[e].
__device__ __forceinline__ void dmma_8x8x4(double (&d)[2], double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// A warp's products over the first `count` paths of its tile: the upper
// 8 x 8 tiles (I <= J, I-major) of X^T X, 4 paths a k-step. Lane (g, k) =
// (lane / 4, lane % 4) reads x_I = X[path 4 s + k][column 8 I + g] of each
// column block once and widens it once; tile (I, J) takes x_I as A's
// fragment and x_J as B's, so D[g][2 k + e] sums x[8 I + g] x[8 J + 2 k + e]
// over the paths. Rows past `count` in the last k-step are zero rows.
template <int NCB>
__device__ __forceinline__ void tile_products(const float* __restrict__ t, int count,
                                              double (&acc)[kMaxTiles][2]) {
  const int lane = threadIdx.x & 31;
  const float* base = t + (lane >> 2) * kLaneStride + (lane & 3);
  const int ksteps = (count + 3) >> 2;
  for (int s = 0; s < ksteps; ++s) {
    double x[NCB];
#pragma unroll
    for (int I = 0; I < NCB; ++I) x[I] = static_cast<double>(base[8 * I * kLaneStride + 4 * s]);
    int tile = 0;
#pragma unroll
    for (int I = 0; I < NCB; ++I) {
#pragma unroll
      for (int J = I; J < NCB; ++J) dmma_8x8x4(acc[tile++], x[I], x[J]);
    }
  }
}

// This lane's fragment entries of the NCB (NCB + 1) / 2 tiles into their
// packed positions of `out`: Σ w c_i c_j (i <= j < m) and Σ c_i w y (j = m);
// the entry (m, m) and the padding columns are dropped. Every packed entry
// is written by one lane.
template <int NCB>
__device__ __forceinline__ void store_tiles(const double (&acc)[kMaxTiles][2], int m,
                                            double* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int n_pairs = m * (m + 1) / 2;
  int tile = 0;
#pragma unroll
  for (int I = 0; I < NCB; ++I) {
#pragma unroll
    for (int J = I; J < NCB; ++J, ++tile) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 8 * I + (lane >> 2), j = 8 * J + 2 * (lane & 3) + e;
        if (i >= m || j < i) continue;
        if (j < m) {
          out[pair_index(m, i, j)] = acc[tile][e];
        } else if (j == m) {
          out[n_pairs + i] = acc[tile][e];
        }
      }
    }
  }
}

// Dispatch the column-block count (1..kMaxColBlocks) to its unrolled form.
#define AMCX_COL_BLOCKS_SWITCH(N, CALL) \
  switch (N) {                          \
    case 1: CALL(1); break;             \
    case 2: CALL(2); break;             \
    case 3: CALL(3); break;             \
    case 4: CALL(4); break;             \
    default: CALL(5); break;            \
  }

// The block's share of one step's moments: tiles blockIdx.x, + gridDim.x,
// ... of kMomentsThreads paths. fetch(tile, in) issues a thread's loads of
// its path a tile ahead of build(tile, in, b), which writes its column of
// its warp's buffer b (a zero column past n_paths; both skip tiles past
// the end); then each warp sums the products of its own 32 paths, one warp
// barrier a tile. At the end the warps' accumulators are summed in warp
// order into the block's f64 partial row. Every thread of the block calls
// it; on return the tiles are free.
template <class In, class Fetch, class Build>
__device__ __forceinline__ void moments_walk(const MomentsPlan& q, int m, int n_paths,
                                             const MomentsTiles& sm, Fetch fetch, Build build,
                                             double* __restrict__ row) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int n_tiles = (n_paths + kMomentsThreads - 1) / kMomentsThreads;
  const int stride = static_cast<int>(gridDim.x);

  double acc[kMaxTiles][2];
#pragma unroll
  for (int e = 0; e < kMaxTiles; ++e) acc[e][0] = acc[e][1] = 0.0;
  In in;
  const int first = blockIdx.x;
  fetch(first, in);
  build(first, in, 0);
  fetch(first + stride, in);
  __syncwarp();
  int b = 0;
  for (int tile = first; tile < n_tiles; tile += stride) {
    build(tile + stride, in, b ^ 1);  // the next tile, from loads issued a tile ago
    fetch(tile + 2 * stride, in);     // in flight while this tile is summed
    const int count = min(32, n_paths - tile * kMomentsThreads - 32 * warp);
    if (count > 0) {
      const float* t = sm.cols + b * sm.tile + warp * sm.warp_floats;
#define AMCX_TILE_PRODUCTS(NCB) tile_products<NCB>(t, count, acc)
      AMCX_COL_BLOCKS_SWITCH(q.n_cb, AMCX_TILE_PRODUCTS)
#undef AMCX_TILE_PRODUCTS
    }
    __syncwarp();
    b ^= 1;
  }
  const int P = pack_dim(m);
  double* red = reinterpret_cast<double*>(sm.cols);  // [warp][P]; the tiles are free
  __syncthreads();
#define AMCX_STORE_TILES(NCB) store_tiles<NCB>(acc, m, red + warp * P)
  AMCX_COL_BLOCKS_SWITCH(q.n_cb, AMCX_STORE_TILES)
#undef AMCX_STORE_TILES
  __syncthreads();
  for (int p = tid; p < P; p += kMomentsThreads) {
    double v = red[p];
    for (int w = 1; w < kMomentsWarps; ++w) v += red[w * P + p];
    row[p] = v;
  }
}

}  // namespace amcx
