// The multi-asset inductions' inputs in one pass over the paths, one launch
// a pricing of amcx_ma_prepare.
//
// Replaces: the torch operations that built them (amcx_torch/ops/
// maxcall_pallas.py ma_inputs: the compare-exchange network as 2 x 10
// elementwise maximum/minimum calls over strided (n_steps+1, n_paths)
// views, 2A strided reductions, the transposing copy and two scalar copies
// from the host); amcx builds the same with XLA operations
// (amcx/models/maxcall.py maxcall_standardization and a transpose), no
// Pallas kernel.
//
// From time-major (n_steps+1, n_paths, A) f32 paths it writes
//   planes (n_steps+1, A, n_paths): the same values asset-major, the bits
//     of paths.permute(0, 2, 1).contiguous();
//   stats rows 0 .. 2A-1 (of the (2A+3, n_steps+1) rows of ma_common.cuh):
//     for each step t and column a of the values (sorted descending by
//     amcx's bubble network where `sorted`), S1 and S2, the f64 sums of x
//     and x^2, then mean = S1 / n and inv_std = 1 / max(sqrt(max(S2 / n -
//     mean^2, 0)), 1e-6), each in f64 and rounded once to f32;
//   stats rows 2A .. 2A+2 (c_t, 1/c_t, allow_t): copied from `tail`, which
//     the host builds once a grid and rate.
// The plain version (ops/maxcall_pallas.py ma_prepare_reference) computes
// the same in torch; any fixed order of the f64 sums gives the same f32
// bits unless a value lies within f64 noise of an f32 rounding boundary.
//
// Bound on the H100 (5 assets, 1M paths x 10 dates): reading the paths
// once and writing the planes once, 2 x 209.7 MB, 0.125 ms at 3.35 TB/s.
// The arithmetic (the network's 2 x 10 min/max, 5 f32 -> f64 conversions
// and 15 f64 operations a path-step) is far below it.
//
// Design: one launch of n_chunks blocks a step (block b = t * n_chunks +
// chunk; about two blocks an SM in all, ops/maxcall_pallas.py
// ma_prepare_chunks), kThreads threads, a tile of kTilePaths consecutive paths of step
// t at a time, the chunk's tiles strided by n_chunks. A tile's values are
// kTilePaths * A contiguous floats: the block reads them with 16-byte loads
// (one load a float where the tile is not 16-byte aligned or not full) into
// registers one tile ahead, stages them in shared memory (double-buffered,
// one barrier a tile, padded so that neither the block's row-wise writes
// nor a thread's read of its path's A values conflict on a bank), and each
// thread takes two paths: their A values go to the planes (a warp writes
// 128 contiguous bytes of each asset row), through the network in
// registers, and into the thread's f64 sums. The block reduces its sums in
// a fixed order into one partial row of 2A values; the block that takes
// the last ticket (zeroed by the C entry, wraps back to 0) adds the rows of
// each (t, a) in chunk order, writes the frame and copies the tail rows.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "ma_common.cuh"

namespace {

using namespace amcx;

constexpr int kPathsPerThread = 2;
constexpr int kTilePaths = kPathsPerThread * kThreads;

// Shared-memory slot of float i of a tile: one pad word every 32 floats.
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

template <int A>
struct Tile {
  static constexpr int kFloats = kTilePaths * A;
  static constexpr int kVec = kFloats / 4;  // float4s of a full tile
  static constexpr int kVecPerThread = (kVec + kThreads - 1) / kThreads;
  static constexpr int kSlots = kFloats + kFloats / 32;
};

// The tile's floats into the thread's registers: float4 v = tid + k
// kThreads holds floats 4v .. 4v+3 of the tile (0 past n_floats).
template <int A>
__device__ __forceinline__ void load_tile(const float* __restrict__ src, int n_floats,
                                          float4 (&r)[Tile<A>::kVecPerThread]) {
  const bool vec = n_floats == Tile<A>::kFloats && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
#pragma unroll
  for (int k = 0; k < Tile<A>::kVecPerThread; ++k) {
    const int v = threadIdx.x + k * kThreads;
    if (v >= Tile<A>::kVec) continue;
    if (vec) {
      r[k] = reinterpret_cast<const float4*>(src)[v];
    } else {
      const int i = 4 * v;
      r[k] = make_float4(i < n_floats ? src[i] : 0.0f, i + 1 < n_floats ? src[i + 1] : 0.0f,
                         i + 2 < n_floats ? src[i + 2] : 0.0f,
                         i + 3 < n_floats ? src[i + 3] : 0.0f);
    }
  }
}

template <int A>
__device__ __forceinline__ void stage_tile(const float4 (&r)[Tile<A>::kVecPerThread],
                                           float* __restrict__ buf) {
#pragma unroll
  for (int k = 0; k < Tile<A>::kVecPerThread; ++k) {
    const int v = threadIdx.x + k * kThreads;
    if (v >= Tile<A>::kVec) continue;
    buf[padded(4 * v)] = r[k].x;
    buf[padded(4 * v + 1)] = r[k].y;
    buf[padded(4 * v + 2)] = r[k].z;
    buf[padded(4 * v + 3)] = r[k].w;
  }
}

template <int A>
__global__ void __launch_bounds__(kThreads)
ma_prepare_kernel(const float* __restrict__ paths, float* __restrict__ planes,
                  float* __restrict__ stats, const float* __restrict__ tail,
                  double* rows, unsigned* ticket, int n_steps, int n_paths,
                  int n_chunks, int sorted) {
  __shared__ float buf[2][Tile<A>::kSlots];
  const int T1 = n_steps + 1;
  const int t = blockIdx.x / n_chunks;
  const int chunk = blockIdx.x - t * n_chunks;
  const size_t n = static_cast<size_t>(n_paths);
  const float* src_t = paths + static_cast<size_t>(t) * n * A;
  float* dst_t = planes + static_cast<size_t>(t) * A * n;
  const int n_tiles = (n_paths + kTilePaths - 1) / kTilePaths;
  auto tile_floats = [&](int tile) {
    const int here = n_paths - tile * kTilePaths;
    return (here < kTilePaths ? here : kTilePaths) * A;
  };

  double acc[2 * A];  // S1 of each column, then S2
#pragma unroll
  for (int a = 0; a < 2 * A; ++a) acc[a] = 0.0;
  float4 r[Tile<A>::kVecPerThread];
  int tile = chunk;
  if (tile < n_tiles) {
    load_tile<A>(src_t + static_cast<size_t>(tile) * kTilePaths * A, tile_floats(tile), r);
  }
  for (int b = 0; tile < n_tiles; tile += n_chunks, b ^= 1) {
    stage_tile<A>(r, buf[b]);
    const int next = tile + n_chunks;
    if (next < n_tiles) {
      load_tile<A>(src_t + static_cast<size_t>(next) * kTilePaths * A, tile_floats(next), r);
    }
    __syncthreads();
    const int p0 = tile * kTilePaths;
#pragma unroll
    for (int h = 0; h < kPathsPerThread; ++h) {
      const int j = threadIdx.x + h * kThreads;
      if (p0 + j >= n_paths) continue;
      float x[A];
#pragma unroll
      for (int a = 0; a < A; ++a) {
        x[a] = buf[b][padded(j * A + a)];
        dst_t[a * n + p0 + j] = x[a];
      }
      if (sorted) sort_desc<A>(x);
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const double d = static_cast<double>(x[a]);
        acc[a] += d;
        acc[A + a] += d * d;
      }
    }
  }
  block_reduce_store<2 * A>(acc, rows + static_cast<size_t>(blockIdx.x) * 2 * A);
  if (!last_ticket(ticket, gridDim.x)) return;
  for (int o = threadIdx.x; o < T1 * A; o += kThreads) {
    const int ts = o / A;
    const int a = o - ts * A;
    const double* row = rows + static_cast<size_t>(ts) * n_chunks * 2 * A;
    double s1 = 0.0, s2 = 0.0;
    for (int c = 0; c < n_chunks; ++c) {
      s1 += __ldcg(row + static_cast<size_t>(c) * 2 * A + a);
      s2 += __ldcg(row + static_cast<size_t>(c) * 2 * A + A + a);
    }
    // torch.clamp_min's order: a NaN stays NaN
    const double nd = static_cast<double>(n_paths);
    const double mean = s1 / nd;
    double var = s2 / nd - mean * mean;
    var = var < 0.0 ? 0.0 : var;
    double sd = sqrt(var);
    sd = sd < 1e-6 ? 1e-6 : sd;
    stats[a * T1 + ts] = static_cast<float>(mean);
    stats[(A + a) * T1 + ts] = static_cast<float>(1.0 / sd);
  }
  for (int i = threadIdx.x; i < 3 * T1; i += kThreads) stats[2 * A * T1 + i] = tail[i];
}

}  // namespace

// paths (n_steps+1, n_paths, n_assets) f32, contiguous; planes (n_steps+1,
// n_assets, n_paths) f32 out; stats (2 n_assets + 3, n_steps+1) f32 out;
// tail (3, n_steps+1) f32 (c_t, 1/c_t, allow_t); partials: the ticket (the
// first 8 bytes, zeroed here on the stream), then (n_steps+1) n_chunks
// 2 n_assets f64 of scratch. n_chunks: blocks a step. Returns a
// cudaError_t.
extern "C" int amcx_ma_prepare(const float* paths, float* planes, float* stats, const float* tail,
                               double* partials, int n_steps, int n_paths, int n_assets,
                               int n_chunks, int sorted, void* stream) {
  if (paths == nullptr || planes == nullptr || stats == nullptr || tail == nullptr ||
      partials == nullptr || n_steps < 1 || n_paths < 1 || n_chunks < 1 ||
      static_cast<long long>(n_steps + 1) * n_chunks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* ticket = reinterpret_cast<unsigned*>(partials);
  double* rows = partials + 1;
  cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blocks = (n_steps + 1) * n_chunks;
#define AMCX_PREPARE_CASE(AA)                                                                \
  case AA:                                                                                   \
    ma_prepare_kernel<AA><<<n_blocks, kThreads, 0, s>>>(paths, planes, stats, tail, rows,    \
                                                        ticket, n_steps, n_paths, n_chunks,  \
                                                        sorted);                             \
    return static_cast<int>(cudaGetLastError());
  AMCX_ASSETS_SWITCH(n_assets, AMCX_PREPARE_CASE)
#undef AMCX_PREPARE_CASE
}
