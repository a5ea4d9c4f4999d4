// The cooperative induction's protocol, shared by kernel 2 (lsmc_mega.cu:
// paths read from device memory) and kernel 6 (lsmc_fusedpath.cu: paths
// regenerated). One launch a pricing on a grid that is all co-resident
// (cudaLaunchCooperativeKernel):
// - Block 0 is the solver (solver_block). For each step t = T-1 .. 0 it
//   waits until every worker's f64 row of step t has arrived (an arrival
//   count), sums the rows through L2 in sum_partials' fixed order, solves
//   on one thread (solve_equilibrated_ridge), writes the coefficient row
//   and bumps a generation word. Then it sums the workers' final rows.
// - Blocks 1.. are workers. A worker thread owns quads of paths for the
//   whole pricing and keeps their state in shared-memory slots (quad_slot;
//   past chip_slots in global spill planes). Per step t its pass A needs no
//   coefficients (the Gram head of step t) and runs while block 0 solves
//   step t+1; it then waits for the generation of step t+1 (wait_for), and
//   its pass B applies step t+1's exercise and sums step t's right-hand side
//   on the new V; the row goes out and the block counts its arrival
//   (arrive). No worker writes its row again before block 0 has bumped the
//   generation, so one row buffer serves.
// The words are the first 8 bytes of the partials buffer: the arrival count,
// then the generation; both zeroed by the caller. Posting the Gram head as
// a row of its own after pass A, so that block 0 could factor it during
// pass B, was built and timed slower (PERF.md): the workers' passes,
// not block 0, set a step's time, and the extra post lengthened pass A.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "lsmc_common.cuh"

namespace amcx {

// Thread 0 waits until *word reaches target, then the block may read what
// was fenced before it.
__device__ __forceinline__ void wait_for(const volatile unsigned* word, unsigned target) {
  if (threadIdx.x == 0) {
    while (*word < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// After a block's row is written: fence it and count the arrival.
__device__ __forceinline__ void arrive(unsigned* arrivals) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(arrivals, 1u);
}

__device__ __forceinline__ void load4(const float4* x, float (&v)[4]) {
  const float4 a = *x;
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

__device__ __forceinline__ void store4(float4* x, const float (&v)[4]) {
  *x = make_float4(v[0], v[1], v[2], v[3]);
}

// Where plane `plane` of this thread's quad slot k (quad q of the paths)
// lies: shared memory below chip_slots (chip_slots x kThreads quads a
// plane), else the global spill planes (plane_floats floats each) at q.
__device__ __forceinline__ float4* quad_slot(float4* chip, float* spill, int plane, int k, int q,
                                             int chip_slots, size_t plane_floats) {
  if (k < chip_slots) return chip + (plane * chip_slots + k) * kThreads + threadIdx.x;
  return reinterpret_cast<float4*>(spill + static_cast<size_t>(plane) * plane_floats) + q;
}

// basis_cols of a quad's four paths with the basis switch outside the
// recurrences, so the four chains interleave (basis_cols' operations, so
// its bits).
template <int K, int kBasis>
__device__ __forceinline__ void quad_cols_of(const float (&x)[4], float (&cols)[4][K]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) basis_cols<K>(x[j], kBasis, cols[j]);
}

template <int K>
__device__ __forceinline__ void quad_cols(int basis, const float (&x)[4], float (&cols)[4][K]) {
  switch (basis) {
    case kPower:
      quad_cols_of<K, kPower>(x, cols);
      break;
    case kChebyshev:
      quad_cols_of<K, kChebyshev>(x, cols);
      break;
    case kLegendre:
      quad_cols_of<K, kLegendre>(x, cols);
      break;
    case kLaguerre:
      quad_cols_of<K, kLaguerre>(x, cols);
      break;
    default:
      quad_cols_of<K, kHermite>(x, cols);
      break;
  }
}

// Block 0's part of the pricing: with `solve`, the rows of each step t =
// T-1 .. 0 summed and solved into coeffs row t, the generation bumped after
// each; then the workers' final rows summed into sums[0..2). arrivals and
// the generation are the first two words of the partials buffer, the rows
// follow them; packed and coef are the block's shared arrays (P and K
// floats).
template <int K>
__device__ __forceinline__ void solver_block(unsigned* arrivals, const double* rows,
                                             int n_workers, int T, bool solve, float rcond,
                                             float* coeffs, float* sums, float* packed,
                                             float* coef) {
  constexpr int P = Layout<K>::kMoments;
  for (int t = T - 1; t >= 0 && solve; --t) {
    wait_for(arrivals, static_cast<unsigned>(n_workers * (T - t)));
    sum_partials_coherent(rows, n_workers, P, packed);
    __syncthreads();
    if (threadIdx.x == 0) {
      float scratch[solve_scratch_floats(K)];
      solve_equilibrated_ridge<K>(packed, K, rcond, coef, scratch);
#pragma unroll
      for (int i = 0; i < K; ++i) coeffs[t * K + i] = coef[i];
      __threadfence();
      atomicAdd(arrivals + 1, 1u);
    }
  }
  wait_for(arrivals, static_cast<unsigned>(n_workers * (solve ? T + 1 : 1)));
  sum_partials_coherent(rows, n_workers, 2, sums);
}

}  // namespace amcx
