// Correlated multi-asset GBM paths from given standard normals, in one pass.
//
// Replaces: no Pallas kernel. amcx builds basket paths with XLA operations
// (amcx/paths.py:137 simulate_gbm_multi). This kernel replaces the torch
// operations that amcx_torch ran after torch.randn (ops/gbm_multi.py
// gbm_multi_paths_reference: the correlation products, the scale product
// and the drift sum, torch.cumsum, the concatenated zero row, exp and the
// product with S0), and the host copies of their scalars.
//
// From time-major normals z (n_steps, n_paths, A) f32 it writes the
// time-major paths out (n_steps+1, n_paths, A): row 0 is S0, row t+1 is
//   S0[b] * expf(sum_{s<=t} (drift[b] + scale[b] * W_s[b])),
// with W = z, or with a Cholesky factor L (row-major A x A)
//   W_b = z_0 L[b,0] + z_1 L[b,1] + ... + z_b L[b,b]
// summed in that order. Each product and sum is rounded on its own
// (-fmad=false), as torch's separate elementwise operations round them, and
// the running sum is sequential in f32 from step 0, the order of torch's
// outer-dimension scan, so on the card kernel and plain version agree to
// the bit. S0, drift = (r - q - sigma^2/2) dt and scale = sigma sqrt(dt)
// arrive by value, formed on the host in f32 in the plain version's order:
// the launch copies nothing from the host and waits for nothing.
//
// Bound on the H100 (maxcall-5-1M: 5 assets, 1,048,576 paths, 9 dates):
// reading z once and writing the paths once, 188.7 + 209.7 MB, 0.119 ms at
// 3.35 TB/s. The arithmetic (four f32 operations and an accurate expf a
// value and step, 2A - 1 more with a factor) is far below it.
//
// Design: a block takes a tile of kTilePaths consecutive paths with 64 A
// threads. Each thread owns 4 consecutive floats of the tile's
// kTilePaths * A, the same 4 in every row, so their running sums stay in
// registers across the steps, and moves them as one 16-byte load and one
// 16-byte store a row, neighbouring threads on neighbouring addresses (one
// float at a time where a row of n_paths * A floats is no multiple of 4 or
// a pointer is not 16-byte aligned). A tile starts at a path, so float j of
// it belongs to asset j mod A, and each thread reads its floats' S0, drift
// and scale once. The load of step t + 1 is issued before step t's
// arithmetic. With a factor, each row's tile is staged through shared
// memory (two barriers a row), so a thread reads the A normals of its
// floats' paths wherever they lie. A template instance per asset count 1-8
// and per choice of those two; 64-bit offsets; any n_paths below 2^31.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxAssets = 8;  // ops/gbm_multi.py MAX_ASSETS
constexpr int kTilePaths = 256;
constexpr int kOwn = 4;  // consecutive floats a thread owns in each row

struct Rows {
  float s0[kMaxAssets];
  float drift[kMaxAssets];
  float scale[kMaxAssets];
};

template <bool kVec>
__device__ __forceinline__ void load_own(const float* __restrict__ src, int n_own,
                                         float (&v)[kOwn]) {
  if (kVec) {
    const float4 x = __ldcs(reinterpret_cast<const float4*>(src));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
#pragma unroll
    for (int e = 0; e < kOwn; ++e) v[e] = e < n_own ? __ldcs(src + e) : 0.0f;
  }
}

template <bool kVec>
__device__ __forceinline__ void store_own(float* __restrict__ dst, int n_own,
                                          const float (&v)[kOwn]) {
  if (kVec) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < kOwn; ++e) {
      if (e < n_own) dst[e] = v[e];
    }
  }
}

// kVec: 16-byte rows (n_own is kOwn or at most 0); kCorr: a factor in chol.
template <int A, bool kVec, bool kCorr>
__global__ void __launch_bounds__(kTilePaths * A / kOwn)
gbm_multi_kernel(const float* __restrict__ z, float* __restrict__ out,
                 const float* __restrict__ chol, Rows rows, int n_steps, int n_paths) {
  constexpr int kTileFloats = kTilePaths * A;
  __shared__ float tile[kCorr ? kTileFloats : 1];
  __shared__ float lower[kCorr ? A * A : 1];
  const size_t row = static_cast<size_t>(n_paths) * A;
  const size_t first = static_cast<size_t>(blockIdx.x) * kTileFloats;
  const int f0 = kOwn * static_cast<int>(threadIdx.x);
  const size_t left = row - first;
  const int in_tile = left < static_cast<size_t>(kTileFloats) ? static_cast<int>(left)
                                                               : kTileFloats;
  const int n_own = in_tile - f0 < kOwn ? in_tile - f0 : kOwn;
  if (!kCorr && n_own <= 0) return;  // no barrier below without a factor
  if (kCorr) {
    for (int i = threadIdx.x; i < A * A; i += blockDim.x) lower[i] = chol[i];
  }
  int asset[kOwn];
  float s0[kOwn], drift[kOwn], scale[kOwn], cum[kOwn];
#pragma unroll
  for (int e = 0; e < kOwn; ++e) {
    asset[e] = (f0 + e) % A;
    s0[e] = rows.s0[asset[e]];
    drift[e] = rows.drift[asset[e]];
    scale[e] = rows.scale[asset[e]];
    cum[e] = 0.0f;
  }
  const float* src = z + first + f0;
  float* dst = out + first + f0;
  if (n_own > 0) store_own<kVec>(dst, n_own, s0);
  float next[kOwn] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (n_own > 0) load_own<kVec>(src, n_own, next);
  for (int t = 0; t < n_steps; ++t) {
    float w[kOwn];
#pragma unroll
    for (int e = 0; e < kOwn; ++e) w[e] = next[e];
    if (n_own > 0 && t + 1 < n_steps) {
      load_own<kVec>(src + static_cast<size_t>(t + 1) * row, n_own, next);
    }
    if (kCorr) {
      __syncthreads();  // the previous row's reads of tile are done; lower is written
#pragma unroll
      for (int e = 0; e < kOwn; ++e) {
        if (e < n_own) tile[f0 + e] = w[e];
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < kOwn; ++e) {
        if (e < n_own) {
          const int b = asset[e];
          const float* zp = tile + (f0 + e - b);  // the A normals of the float's path
          const float* lb = lower + b * A;
          float acc = zp[0] * lb[0];
          for (int a = 1; a <= b; ++a) acc = acc + zp[a] * lb[a];
          w[e] = acc;
        }
      }
    }
    float v[kOwn];
#pragma unroll
    for (int e = 0; e < kOwn; ++e) {
      cum[e] = cum[e] + (drift[e] + scale[e] * w[e]);
      v[e] = s0[e] * expf(cum[e]);
    }
    if (n_own > 0) store_own<kVec>(dst + static_cast<size_t>(t + 1) * row, n_own, v);
  }
}

template <int A>
cudaError_t launch(const float* z, float* out, const float* chol, const Rows& rows, int n_steps,
                   int n_paths, bool vec, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>((n_paths + kTilePaths - 1) / kTilePaths);
  constexpr unsigned threads = kTilePaths * A / kOwn;
  if (chol != nullptr) {
    if (vec) {
      gbm_multi_kernel<A, true, true><<<grid, threads, 0, s>>>(z, out, chol, rows, n_steps,
                                                               n_paths);
    } else {
      gbm_multi_kernel<A, false, true><<<grid, threads, 0, s>>>(z, out, chol, rows, n_steps,
                                                                n_paths);
    }
  } else if (vec) {
    gbm_multi_kernel<A, true, false><<<grid, threads, 0, s>>>(z, out, chol, rows, n_steps,
                                                              n_paths);
  } else {
    gbm_multi_kernel<A, false, false><<<grid, threads, 0, s>>>(z, out, chol, rows, n_steps,
                                                               n_paths);
  }
  return cudaGetLastError();
}

}  // namespace

// z (n_steps, n_paths, n_assets) f32, contiguous; out (n_steps+1, n_paths,
// n_assets) f32; chol: the row-major (n_assets, n_assets) f32 Cholesky
// factor on the device, or null for independent assets; rows: 3 n_assets
// host floats, S0, then drift, then scale, each a row of n_assets.
// Returns a cudaError_t.
extern "C" int amcx_gbm_multi_paths(const float* z, float* out, const float* chol,
                                    const float* rows, int n_steps, int n_paths, int n_assets,
                                    void* stream) {
  if (z == nullptr || out == nullptr || rows == nullptr || n_steps < 1 || n_paths < 1 ||
      n_assets < 1 || n_assets > kMaxAssets) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Rows r{};
  for (int a = 0; a < n_assets; ++a) {
    r.s0[a] = rows[a];
    r.drift[a] = rows[n_assets + a];
    r.scale[a] = rows[2 * n_assets + a];
  }
  const bool vec = (static_cast<size_t>(n_paths) * n_assets) % kOwn == 0 &&
                   (reinterpret_cast<uintptr_t>(z) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_assets) {
#define AMCX_GBM_MULTI_CASE(AA) \
  case AA:                      \
    return static_cast<int>(launch<AA>(z, out, chol, r, n_steps, n_paths, vec, s));
    AMCX_GBM_MULTI_CASE(1)
    AMCX_GBM_MULTI_CASE(2)
    AMCX_GBM_MULTI_CASE(3)
    AMCX_GBM_MULTI_CASE(4)
    AMCX_GBM_MULTI_CASE(5)
    AMCX_GBM_MULTI_CASE(6)
    AMCX_GBM_MULTI_CASE(7)
    AMCX_GBM_MULTI_CASE(8)
#undef AMCX_GBM_MULTI_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
