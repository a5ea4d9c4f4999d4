// Device helpers shared by the LSMC kernels (lsmc_mega.cu, lsmc_step.cu,
// lsmc_book.cu, lsmc_swing.cu, lsmc_fusedpath.cu, and through ma_common.cuh
// ma_step.cu, lsmc_ma_mega.cu and ma_prepare.cu): the packed moment layout,
// the basis recurrences, a four-path row load, the fixed-order f64 block
// and cross-block reductions that make the moments independent of the grid
// (the last-block ticket, and the one-block kernel that sums the partial
// rows), the one-thread equilibrated ridge-Cholesky solve - a factor step
// and a refined solve per right-hand side - with its one-block kernel for
// one shared factor and many right-hand sides, and the same solve on the
// lanes of one warp.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace amcx {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

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

// Paths i0 .. i0 + 3 of a row into x: one 16-byte load where vec (the row
// 16-byte aligned) and all four exist, else one load a path, 0 past n_here.
__device__ __forceinline__ void load_row4(const float* __restrict__ row, int i0, int n_here,
                                          bool vec, float (&x)[4]) {
  if (vec && n_here == 4) {
    const float4 q = *reinterpret_cast<const float4*>(row + i0);
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = e < n_here ? row[i0 + e] : 0.0f;
}

// Fixed-order sum of the (n_blocks, P) partial rows, rounded once to f32
// into out[0..P): warp w of the grid's W warps owns sums p = w, w + W, ...;
// lane l adds blocks l, l + 32, ... in order, then the lanes fold by
// shuffles. Any grid adds the same values in the same order.
__device__ __forceinline__ void sum_partials(const double* __restrict__ partials, int n_blocks,
                                             int P, float* out) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int warp = blockIdx.x * warps + (threadIdx.x >> 5);
  for (int p = warp; p < P; p += gridDim.x * warps) {
    double v = 0.0;
    for (int b = lane; b < n_blocks; b += 32) v += partials[static_cast<size_t>(b) * P + p];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) out[p] = static_cast<float>(v);
  }
}

// The block that takes the last of `total` tickets returns true (every
// block's row fenced before its ticket); the counter wraps back to 0.
__device__ __forceinline__ bool last_ticket(unsigned* ticket, unsigned total) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(ticket, total - 1) == total - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// sum_partials' order on the warps of ONE block, for rows that blocks of
// the running grid wrote (each fenced by __threadfence before taking a
// ticket): read through L2 (ld.global.cg), never a stale L1 line.
__device__ __forceinline__ void sum_partials_coherent(const double* partials, int n_blocks,
                                                      int P, float* out) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int p = threadIdx.x >> 5; p < P; p += warps) {
    double v = 0.0;
    for (int b = lane; b < n_blocks; b += 32) {
      v += __ldcg(partials + static_cast<size_t>(b) * P + p);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) out[p] = static_cast<float>(v);
  }
}

// sum_partials into out[0..P) (the fused engines' moment vectors, the
// inductions' final two sums), one warp a sum: one block, or ceil(P /
// kWarps) blocks for one wave of warps. Either grid adds the same values
// in the same order.
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const double* __restrict__ partials, int n_blocks, int P,
                    float* __restrict__ out) {
  sum_partials(partials, n_blocks, P, out);
}

// The one-thread ridge-Cholesky solve below: KC > 0 is the compile-time
// size (kernels 2, 3, 6 and 10, k <= 11), every loop unrolls and the
// scratch is a local array that lives in registers; KC == 0 takes a runtime
// k <= kMaxSolveK with the scratch in shared memory (the multi-asset
// induction's first design; it now runs warp_solve_equilibrated_ridge,
// further below, which keeps this order per element). Both forms run the
// same operations in the same order, so the results do not depend on KC.
constexpr int kMaxSolveK = 32;

// Floats of scratch that solve_equilibrated_ridge needs for a k x k system:
// the factor (Gnr, L, d) and the work of one right-hand side.
__host__ __device__ constexpr int factor_floats(int k) { return 2 * k * k + k; }
__host__ __device__ constexpr int solve_work_floats(int k) { return 5 * k; }
__host__ __device__ constexpr int solve_scratch_floats(int k) {
  return factor_floats(k) + solve_work_floats(k);
}

// Two triangular solves with the factor L (k x k, row-major) of the ridged
// Gram; z is scratch.
template <int KC>
__device__ __forceinline__ void chol_solve(const float* L, const float* rhs, float* c, float* z,
                                           int k_rt) {
  const int k = KC > 0 ? KC : k_rt;
#pragma unroll
  for (int i = 0; i < k; ++i) {
    float s = rhs[i];
#pragma unroll
    for (int m = 0; m < i; ++m) s = s - L[i * k + m] * z[m];
    z[i] = s / L[i * k + i];
  }
#pragma unroll
  for (int i = k - 1; i >= 0; --i) {
    float s = z[i];
#pragma unroll
    for (int m = i + 1; m < k; ++m) s = s - L[m * k + i] * c[m];
    c[i] = s / L[i * k + i];
  }
}

// The factor step of amcx's _factor_equilibrated_ridge
// (amcx/ops/lsmc_megakernel.py), on ONE thread, from the Gram head of the
// packed [G upper triangle..., ...] moments: column equilibration d, the
// UN-ridged equilibrated Gram Gnr (k x k), and the Cholesky factor L of Gnr
// plus the rcond ridge. The strike book factors its shared Gram once and
// back-solves every strike against it (solve_factored).
template <int KC>
__device__ __forceinline__ void factor_equilibrated_ridge(const float* packed, int k_rt,
                                                          float rcond, float* Gnr, float* L,
                                                          float* d) {
  const int k = KC > 0 ? KC : k_rt;
  const float tiny = 1e-30f;
#pragma unroll
  for (int i = 0; i < k; ++i) d[i] = 1.0f / sqrtf(fmaxf(packed[pair_index(k, i, i)], tiny));
#pragma unroll
  for (int i = 0; i < k; ++i) {
#pragma unroll
    for (int j = 0; j < k; ++j) {
      const float g = packed[i <= j ? pair_index(k, i, j) : pair_index(k, j, i)];
      Gnr[i * k + j] = g * d[i] * d[j];
      L[i * k + j] = 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < k; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = Gnr[i * k + j] + (i == j ? rcond : 0.0f);
#pragma unroll
      for (int m = 0; m < j; ++m) s = s - L[i * k + m] * L[j * k + m];
      L[i * k + j] = (i == j) ? sqrtf(fmaxf(s, tiny)) : s / L[j * k + j];
    }
  }
}

// The refined solve of amcx's _solve_factored for one right-hand side b_raw
// (k raw moments), on ONE thread: equilibrate b, two triangular solves with
// L, two refinement steps against the UN-ridged Gnr, de-equilibrate into
// coeffs[0..k). work holds solve_work_floats(k) floats.
template <int KC>
__device__ __forceinline__ void solve_factored(const float* L, const float* d, const float* Gnr,
                                               const float* b_raw, int k_rt, float* coeffs,
                                               float* work) {
  const int k = KC > 0 ? KC : k_rt;
  float* b = work;
  float* c = b + k;
  float* resid = c + k;
  float* dc = resid + k;
  float* z = dc + k;
#pragma unroll
  for (int i = 0; i < k; ++i) b[i] = b_raw[i] * d[i];
  chol_solve<KC>(L, b, c, z, k);
#pragma unroll
  for (int step = 0; step < 2; ++step) {
#pragma unroll
    for (int i = 0; i < k; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < k; ++j) acc = acc + Gnr[i * k + j] * c[j];
      resid[i] = b[i] - acc;
    }
    chol_solve<KC>(L, resid, dc, z, k);
#pragma unroll
    for (int i = 0; i < k; ++i) c[i] = c[i] + dc[i];
  }
#pragma unroll
  for (int i = 0; i < k; ++i) coeffs[i] = c[i] * d[i];
}

// Solve the packed [G upper triangle..., b...] system of size k on ONE
// thread: the factor step, then the refined solve of its one right-hand
// side, in amcx's operation order. scratch holds solve_scratch_floats(k)
// floats.
template <int KC>
__device__ __forceinline__ void solve_equilibrated_ridge(const float* packed, int k_rt,
                                                         float rcond, float* coeffs,
                                                         float* scratch) {
  const int k = KC > 0 ? KC : k_rt;
  float* Gnr = scratch;
  float* L = Gnr + k * k;
  float* d = L + k * k;
  factor_equilibrated_ridge<KC>(packed, k, rcond, Gnr, L, d);
  solve_factored<KC>(L, d, Gnr, packed + k * (k + 1) / 2, k, coeffs, d + k);
}

// solve_equilibrated_ridge on the 32 lanes of ONE warp, for a runtime k <=
// kMaxSolveK (the multi-asset induction's m x m system): the same
// operations in the same order per element, so the same bits. Lane i owns
// row i.
// - d, Gnr and the refinement's residual rows are independent per element;
//   each inner sum keeps its j order.
// - The factor is right-looking: when column m is final, every entry
//   (i, j), m < j <= i, subtracts L[i][m] L[j][m], so each entry sees the
//   subtractions of the one-thread loop in its m order, from the same start
//   Gnr + (i == j ? rcond : 0).
// - Forward substitution goes by columns (lane m divides, the lanes below
//   subtract), the same m order per entry.
// - Back substitution stays one serial chain on lane 0: c[i] sums m = i+1
//   ascending, but c[m] becomes known descending, so no reordering keeps
//   its bits. It is O(k^2), the factor O(k^3).
// The matrices lie in shared memory and the loops stay loops: the same
// schedule with every row in registers and every loop unrolled (each
// register index a constant) was built and ran slower on the card, and took
// minutes to compile.
// Call with every lane of the warp; scratch holds warp_solve_floats()
// floats of shared memory; coeffs[0..k) is written by lanes 0..k-1.
constexpr int kWarpSolveStride = kMaxSolveK + 1;  // a row a lane, distinct banks

__host__ __device__ constexpr int warp_solve_floats() {
  return 2 * kMaxSolveK * kWarpSolveStride + 3 * kMaxSolveK;
}

// The two triangular solves of chol_solve with the factor in L (lower
// triangle, row stride kWarpSolveStride): lane i's rhs in, its c[i] out.
__device__ __forceinline__ float warp_chol_solve(const float* L, float rhs, int k, float* z_sh,
                                                 float* c_sh) {
  const int i = threadIdx.x & 31;
  const bool row = i < k;
  float s = rhs, z = 0.0f;
  for (int m = 0; m < k; ++m) {
    if (i == m) z = s / L[m * kWarpSolveStride + m];
    const float zm = __shfl_sync(0xffffffffu, z, m);
    if (row && i > m) s = s - L[i * kWarpSolveStride + m] * zm;
  }
  if (row) z_sh[i] = z;
  __syncwarp();
  if (i == 0) {
    for (int r = k - 1; r >= 0; --r) {
      float b = z_sh[r];
      for (int m = r + 1; m < k; ++m) b = b - L[m * kWarpSolveStride + r] * c_sh[m];
      c_sh[r] = b / L[r * kWarpSolveStride + r];
    }
  }
  __syncwarp();
  return row ? c_sh[i] : 0.0f;
}

__device__ __forceinline__ void warp_solve_equilibrated_ridge(const float* packed, int k,
                                                              float rcond, float* coeffs,
                                                              float* scratch) {
  constexpr int S = kWarpSolveStride;
  const int i = threadIdx.x & 31;
  const bool row = i < k;
  const float tiny = 1e-30f;
  float* L = scratch;  // the ridged Gram, factored in place (lower triangle)
  float* Gnr = L + kMaxSolveK * S;
  float* d = Gnr + kMaxSolveK * S;
  float* z_sh = d + kMaxSolveK;
  float* c_sh = z_sh + kMaxSolveK;
  float di = 0.0f;
  if (row) {
    di = 1.0f / sqrtf(fmaxf(packed[pair_index(k, i, i)], tiny));
    d[i] = di;
  }
  __syncwarp();
  if (row) {
    for (int j = 0; j < k; ++j) {
      const float g = packed[i <= j ? pair_index(k, i, j) : pair_index(k, j, i)];
      const float gn = g * di * d[j];
      Gnr[i * S + j] = gn;
      if (j <= i) L[i * S + j] = gn + (i == j ? rcond : 0.0f);
    }
  }
  __syncwarp();
  for (int m = 0; m < k; ++m) {
    if (i == m) L[m * S + m] = sqrtf(fmaxf(L[m * S + m], tiny));
    __syncwarp();
    float lim = 0.0f;
    if (row && i > m) {
      lim = L[i * S + m] / L[m * S + m];
      L[i * S + m] = lim;
    }
    __syncwarp();
    if (row && i > m) {
      for (int j = m + 1; j <= i; ++j) L[i * S + j] = L[i * S + j] - lim * L[j * S + m];
    }
  }
  __syncwarp();
  const float b = row ? packed[k * (k + 1) / 2 + i] * di : 0.0f;
  float c = warp_chol_solve(L, b, k, z_sh, c_sh);
  for (int step = 0; step < 2; ++step) {
    // every lane has read c_sh (warp_chol_solve's last sync) before it
    // changes; broadcast this lane's c for the residual rows
    __syncwarp();
    if (row) c_sh[i] = c;
    __syncwarp();
    float resid = 0.0f;
    if (row) {
      float acc = 0.0f;
      for (int j = 0; j < k; ++j) acc = acc + Gnr[i * S + j] * c_sh[j];
      resid = b - acc;
    }
    __syncwarp();
    const float dc = warp_chol_solve(L, resid, k, z_sh, c_sh);
    c = c + dc;
  }
  if (row) coeffs[i] = c * di;
}

// One block: sum the (n_blocks, P) partial rows of a system with one shared
// k x k Gram head and n_rhs right-hand sides of k moments each (P = k(k+1)/2
// + k n_rhs, n_rhs <= kMaxRhs) in a fixed order (rounded once to f32), factor
// the Gram on thread 0, then thread j back-solves right-hand side j into
// coeffs[j * K ..] (the strike book's options, the swing's rights). kBlock
// threads: the book's wide sums take 1024, so each warp adds few rows.
template <int K, int kMaxRhs, int kBlock = kThreads>
__global__ void __launch_bounds__(kBlock)
multi_rhs_solve_kernel(const double* __restrict__ partials, int n_blocks, int n_rhs,
                       float rcond, float* __restrict__ coeffs) {
  constexpr int kPairs = Layout<K>::kPairs;
  __shared__ float packed[kPairs + K * kMaxRhs];
  __shared__ float factor[factor_floats(K)];  // Gnr, L, d
  sum_partials(partials, n_blocks, kPairs + K * n_rhs, packed);
  __syncthreads();
  float* Gnr = factor;
  float* L = Gnr + K * K;
  float* d = L + K * K;
  if (threadIdx.x == 0) factor_equilibrated_ridge<K>(packed, K, rcond, Gnr, L, d);
  __syncthreads();
  for (int j = threadIdx.x; j < n_rhs; j += kBlock) {
    float work[solve_work_floats(K)];
    solve_factored<K>(L, d, Gnr, packed + kPairs + j * K, K, coeffs + j * K, work);
  }
}

}  // namespace amcx

// Launch-error check for the host loops: return the first error.
#define AMCX_LAUNCH_CHECK()                      \
  do {                                           \
    const cudaError_t err_ = cudaGetLastError(); \
    if (err_ != cudaSuccess) return err_;        \
  } while (0)
