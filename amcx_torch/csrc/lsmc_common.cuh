// Device helpers shared by the LSMC kernels (lsmc_mega.cu, lsmc_step.cu):
// the packed moment layout, the basis recurrences, and the fixed-order
// f64 block and cross-block reductions that make the moments independent
// of the grid.
#pragma once

#include <cstddef>

namespace amcx {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum Basis : int { kPower = 0, kChebyshev = 1, kLegendre = 2, kLaguerre = 3, kHermite = 4 };

template <int K>
struct Layout {
  static constexpr int kPairs = K * (K + 1) / 2;
  static constexpr int kMoments = kPairs + K;
};

// Index of Gram entry (a, b), a <= b, in the packed upper-triangle order
// [(0,0), (0,1), ..., (0,K-1), (1,1), ...] that amcx's _pairs uses.
__host__ __device__ constexpr int pair_index(int K, int a, int b) {
  return a * K - a * (a - 1) / 2 + (b - a);
}

// Basis columns by the same recurrences and operation order as
// amcx.basis / amcx_torch.basis.
template <int K>
__device__ __forceinline__ void basis_cols(float x, int basis, float (&cols)[K]) {
  cols[0] = 1.0f;
  if constexpr (K >= 2) {
    cols[1] = basis == kLaguerre ? 1.0f - x : (basis == kHermite ? 2.0f * x : x);
  }
#pragma unroll
  for (int n = 2; n < K; ++n) {
    const float fn = static_cast<float>(n);
    const float prev = cols[n - 1];
    const float prev2 = cols[n - 2];
    float v;
    switch (basis) {
      case kPower:
        v = prev * x;
        break;
      case kChebyshev:
        v = 2.0f * x * prev - prev2;
        break;
      case kLegendre:
        v = ((2.0f * fn - 1.0f) * x * prev - (fn - 1.0f) * prev2) / fn;
        break;
      case kLaguerre:
        v = ((2.0f * fn - 1.0f - x) * prev - (fn - 1.0f) * prev2) / fn;
        break;
      default:  // kHermite
        v = 2.0f * x * prev - 2.0f * (fn - 1.0f) * prev2;
        break;
    }
    cols[n] = v;
  }
}

// Fixed-order block reduction of P per-thread sums; thread p < P writes the
// block's total of sum p to dst[p]. Requires blockDim.x == kThreads.
template <int P>
__device__ __forceinline__ void block_reduce_store(double (&acc)[P], double* __restrict__ dst) {
  __shared__ double warp_sums[kWarps][P];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    double v = acc[p];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp][p] = v;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += kThreads) {
    double v = warp_sums[0][p];
    for (int w = 1; w < kWarps; ++w) v += warp_sums[w][p];
    dst[p] = v;
  }
}

// Fixed-order sum of the (n_blocks, P) partial rows, by one block, rounded
// once to f32 into out[0..P): warp w owns sums p = w, w + kWarps, ...; lane
// l adds blocks l, l + 32, ... in order, then the lanes fold by shuffles.
template <int P>
__device__ __forceinline__ void sum_partials(const double* __restrict__ partials,
                                             int n_blocks, float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int p = warp; p < P; p += kWarps) {
    double v = 0.0;
    for (int b = lane; b < n_blocks; b += 32) v += partials[static_cast<size_t>(b) * P + p];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) out[p] = static_cast<float>(v);
  }
}

}  // namespace amcx

// Launch-error check for the host loops: return the first error.
#define AMCX_LAUNCH_CHECK()                      \
  do {                                           \
    const cudaError_t err_ = cudaGetLastError(); \
    if (err_ != cudaSuccess) return err_;        \
  } while (0)
