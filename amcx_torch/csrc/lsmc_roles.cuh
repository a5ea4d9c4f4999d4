// The moments of a shared-Gram LSMC step by warp roles, for the inductions
// that fit many targets on one design matrix: the strike book (lsmc_book.cu,
// kernel 3: one value plane per option) and the swing (lsmc_swing.cu,
// kernel 10: one value plane per right).
//
// Per step t, on row t of the time-major paths S and the target planes V
// (n_targets, n_paths): x = (S_t - mean_t) * inv_std_t and its K basis
// columns B_a; the packed P = K(K+1)/2 + K n_targets moments
//   sum (B_a w) B_b (a <= b)      the shared Gram head, and
//   sum B_a y_j, y_j = (c_t V_j) w   each target's right-hand side,
// with w = 1[phi (S - strike) > 0] in a kWeighted kernel whose RoleArgs
// ask for it, else w = 1 and no product by it (a kWeighted kernel with
// weighted = 0 multiplies by 1, which is exact). Each product is rounded to
// f32 as the plain versions round it and added in f64.
//
// Design (kernel 3's): a warp is one role over chunks of 128 paths, 4
// consecutive paths a lane. A Gram role recomputes the basis (and w) from
// S_t and sums all pairs (K <= 7) or kGramRows rows of them; a target role
// sums the kOpr x K right-hand-side block of its kOpr targets (a role's
// missing targets, past n_targets, are skipped, not summed as zeros). The
// slots are template arguments, so only real products are emitted. Each
// warp streams its chunks through a two-stage ring in shared memory
// (cp.async, 16 bytes a lane and row where RoleArgs::vec says every row is
// 16-byte aligned, else 4; zero-filled past n_paths, and those paths are
// masked, never summed: a zero S still has B_0 = 1): chunk c + stride's
// rows are in flight while chunk c is summed. A persistent grid of about 2
// blocks a SM (the wrapper's n_blocks; more than kRolesMax roles split over
// gridDim.y) writes one f64 partial row a block, which the one-block solve
// (multi_rhs_solve_kernel at kSolveThreads) sums in a fixed order. Sums run
// per lane in path order, then a fixed shuffle tree, then the role's warps
// in order: no float atomics, and any grid gives the same once-rounded f32
// sums as the plain versions.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <utility>

#include "lsmc_common.cuh"

namespace amcx {

// What a roles kernel reads besides its pointers. vec: every row of S and V
// starts 16-byte aligned (n_paths % 4 == 0 and aligned bases).
struct RoleArgs {
  int n_targets;
  int basis;
  int weighted;  // kWeighted kernels: 1 for the ITM weight, 0 for w = 1
  int vec;
  float strike;
  float phi;
};

// The roles at degree K - 1: Gram roles (all pairs when K <= 7, else
// kGramRows rows each) and target roles of kOpr targets. A block holds up
// to kRolesMax roles x wpr warps of each (the same chunks); gridDim.y
// splits the roles into groups.
template <int K>
struct RolePlan {
  static constexpr int kPairs = Layout<K>::kPairs;
  static constexpr int kOpr = K <= 7 ? 4 : 2;            // targets per role
  static constexpr int kGramRows = K <= 7 ? K : 3;       // Gram rows per role
  static constexpr int kGramRoles = (K + kGramRows - 1) / kGramRows;
  static constexpr int kGramAcc = K <= 7 ? kPairs : kGramRows * K;
  static constexpr int kAcc = kOpr * K > kGramAcc ? kOpr * K : kGramAcc;
  static constexpr int kRolesMax = 8;
  static constexpr int kMaxWarps = 10;  // at most 10 warps (320 threads) a block
  int n_roles, roles_per_block, wpr, n_groups;
  __host__ __device__ explicit RolePlan(int n_targets) {
    n_roles = kGramRoles + (n_targets + kOpr - 1) / kOpr;
    roles_per_block = n_roles < kRolesMax ? n_roles : kRolesMax;
    wpr = kMaxWarps / roles_per_block;
    n_groups = (n_roles + roles_per_block - 1) / roles_per_block;
  }
  __host__ __device__ int threads() const { return 32 * roles_per_block * wpr; }
};

constexpr int kChunk = 128;  // paths per warp and chunk (4 a lane)
constexpr int kSolveThreads = 1024;  // the one-block solve over ~264 rows

// Row and column of packed Gram pair q (the inverse of pair_index).
__host__ __device__ constexpr int pair_row(int K, int q) {
  int a = 0;
  while (q >= K - a) {
    q -= K - a;
    ++a;
  }
  return a;
}
__host__ __device__ constexpr int pair_col(int K, int q) {
  const int a = pair_row(K, q);
  return q - pair_index(K, a, a) + a;
}

// The Gram products of one path, one per slot E (a template argument, so
// the loops vanish at compile time): Bl[a] B[b] for the pairs (K <= 7:
// every pair; above, kGramRows rows from row a0), Bl the left factors
// (B_a w, or B itself). Each is rounded to f32 and added in f64.
template <int K, int kAcc, int... E>
__device__ __forceinline__ void gram_products(const float (&Bl)[K], const float (&B)[K], int a0,
                                              double (&acc)[kAcc],
                                              std::integer_sequence<int, E...>) {
  if constexpr (K <= 7) {
    ((acc[E] += static_cast<double>(Bl[pair_row(K, E)] * B[pair_col(K, E)])), ...);
  } else {
    constexpr int kRows = RolePlan<K>::kGramRows;
    float Ba[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      Ba[r] = Bl[0];
#pragma unroll
      for (int a = 1; a < K; ++a) Ba[r] = a == a0 + r ? Bl[a] : Ba[r];
    }
    ((E % K >= a0 + E / K ? void(acc[E] += static_cast<double>(Ba[E / K] * B[E % K]))
                          : void()),
     ...);
  }
}

// A target role's products B_a y_o into slot o K + a, for its n_opt (a
// warp-uniform count) targets.
template <int K, int kOpr, int kAcc, int... E>
__device__ __forceinline__ void rhs_products(const float (&B)[K], const float (&y)[kOpr],
                                             int n_opt, double (&acc)[kAcc],
                                             std::integer_sequence<int, E...>) {
  ((E / K < n_opt ? void(acc[E] += static_cast<double>(B[E % K] * y[E / K])) : void()), ...);
}

// Asynchronous copies into shared memory (cp.async): 16 bytes (the row's
// 4 paths of a lane, 16-byte aligned) or 4; a copy that is not valid
// writes zeros and reads nothing.
__device__ __forceinline__ void copy16_async(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void copy4_async(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void copies_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most one group (the chunk ahead) is still in flight
__device__ __forceinline__ void copies_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// A warp's two-stage ring of chunks in shared memory: per stage the rows
// S_t and the role's kOpr V rows, 128 paths each (a lane's 4 paths at 4
// lane).
template <int K>
__host__ __device__ constexpr int ring_rows() {
  return 1 + RolePlan<K>::kOpr;
}
template <int K>
__host__ __device__ constexpr size_t ring_bytes_per_warp() {
  return 2 * ring_rows<K>() * kChunk * sizeof(float);
}

// One step's moments into partials[blockIdx.x * P ..] (P = kPairs + K
// n_targets); stats holds the (n_steps+1) rows [mean_t, inv_std_t, c_t,
// ...]. Launch with RolePlan<K>(n_targets).threads() threads, grid
// (n_blocks, n_groups) and ring_bytes_per_warp<K>() a warp of dynamic
// shared memory.
template <int K, bool kWeighted>
__global__ void __launch_bounds__(320, 2)
roles_moments_kernel(const float* __restrict__ S, const float* __restrict__ V,
                     const float* __restrict__ stats, double* __restrict__ partials, int t,
                     int n_steps, int n_paths, const RoleArgs a) {
  using Plan = RolePlan<K>;
  constexpr int kOpr = Plan::kOpr;
  constexpr int kAcc = Plan::kAcc;
  constexpr int kRows = ring_rows<K>();
  __shared__ double red[Plan::kMaxWarps][kAcc];
  extern __shared__ __align__(16) float ring_all[];  // ring_bytes_per_warp<K>() a warp
  const Plan plan(a.n_targets);
  const int ns = a.n_targets;
  const int T1 = n_steps + 1;
  const size_t row_n = static_cast<size_t>(n_paths);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int local = warp % plan.roles_per_block;
  const int sub = warp / plan.roles_per_block;
  const int role = blockIdx.y * plan.roles_per_block + local;
  const bool gram = role < Plan::kGramRoles;
  const int opt0 = (role - Plan::kGramRoles) * kOpr;
  const int n_opt = min(kOpr, ns - opt0);
  const bool active = role < plan.n_roles;
  const float mean = stats[t];
  const float inv_std = stats[T1 + t];
  const float c_t = stats[2 * T1 + t];

  double acc[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) acc[e] = 0.0;

  // each warp streams its chunks through its two-stage ring: the copies of
  // chunk c + stride are in flight while chunk c is summed
  const int stride = gridDim.x * plan.wpr;
  const int n_chunks = (n_paths + kChunk - 1) / kChunk;
  float* ring = ring_all + warp * 2 * kRows * kChunk;
  auto fetch = [&](int c, int st) {
    if (c < n_chunks) {
      const int i0 = c * kChunk + 4 * lane;
      float* dst = ring + st * kRows * kChunk + 4 * lane;
      auto row = [&](int r, const float* src) {
        if (a.vec) {
          copy16_async(dst + r * kChunk, i0 < n_paths ? src + i0 : src, i0 < n_paths);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = i0 + e < n_paths;
            copy4_async(dst + r * kChunk + e, ok ? src + i0 + e : src, ok);
          }
        }
      };
      row(0, S);
      if (!gram) {
#pragma unroll
        for (int o = 0; o < kOpr; ++o) {
          if (o < n_opt) row(1 + o, V + (opt0 + o) * row_n);
        }
      }
    }
    copies_commit();  // an empty group past the last chunk keeps the count
  };
  // the weight of spot s: 1 or 0, or 1 where the args ask for none
  auto weight = [&](float s) {
    return (!a.weighted || a.phi * (s - a.strike) > 0.0f) ? 1.0f : 0.0f;
  };
  int st = 0;
  int c = blockIdx.x * plan.wpr + sub;
  if (active) fetch(c, 0);
  for (; active && c < n_chunks; c += stride) {
    fetch(c + stride, st ^ 1);
    copies_wait_all_but_one();  // this lane's copies of chunk c have landed
    const float* here = ring + st * kRows * kChunk + 4 * lane;
    st ^= 1;
    const int n_here = min(4, n_paths - (c * kChunk + 4 * lane));
    auto read4 = [&](int r, float (&x)[4]) {
      const float4 q4 = *reinterpret_cast<const float4*>(here + r * kChunk);
      x[0] = q4.x;
      x[1] = q4.y;
      x[2] = q4.z;
      x[3] = q4.w;
    };
    float s[4];
    read4(0, s);
    if (gram) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e >= n_here) break;
        float B[K];
        basis_cols<K>((s[e] - mean) * inv_std, a.basis, B);
        if constexpr (kWeighted) {
          const float w = weight(s[e]);
          float Bw[K];
#pragma unroll
          for (int q = 0; q < K; ++q) Bw[q] = B[q] * w;
          gram_products<K>(Bw, B, role * Plan::kGramRows, acc,
                           std::make_integer_sequence<int, Plan::kGramAcc>{});
        } else {
          gram_products<K>(B, B, role * Plan::kGramRows, acc,
                           std::make_integer_sequence<int, Plan::kGramAcc>{});
        }
      }
      continue;
    }
    float v[kOpr][4];
#pragma unroll
    for (int o = 0; o < kOpr; ++o) {
      if (o < n_opt) {
        read4(1 + o, v[o]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[o][e] = 0.0f;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e >= n_here) break;
      float B[K];
      basis_cols<K>((s[e] - mean) * inv_std, a.basis, B);
      float y[kOpr];
#pragma unroll
      for (int o = 0; o < kOpr; ++o) y[o] = c_t * v[o][e];
      if constexpr (kWeighted) {
        const float w = weight(s[e]);
#pragma unroll
        for (int o = 0; o < kOpr; ++o) y[o] = y[o] * w;
      }
      rhs_products<K, kOpr>(B, y, n_opt, acc, std::make_integer_sequence<int, kOpr * K>{});
    }
  }
  // fixed-order reduction: lanes by shuffles, then the wpr warps of a role
#pragma unroll
  for (int e = 0; e < kAcc; ++e) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[e] += __shfl_down_sync(0xffffffffu, acc[e], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int e = 0; e < kAcc; ++e) red[warp][e] = acc[e];
  }
  __syncthreads();
  const int P = Plan::kPairs + K * ns;
  double* row = partials + static_cast<size_t>(blockIdx.x) * P;
  for (int q = threadIdx.x; q < plan.roles_per_block * kAcc; q += blockDim.x) {
    const int r_local = q / kAcc;
    const int e = q % kAcc;
    const int r = blockIdx.y * plan.roles_per_block + r_local;
    if (r >= plan.n_roles) continue;
    int dst = -1;
    if (r < Plan::kGramRoles) {
      if constexpr (K <= 7) {
        if (e < Plan::kPairs) dst = e;
      } else {
        const int ra = r * Plan::kGramRows + e / K;
        const int b = e % K;
        if (e < Plan::kGramAcc && ra < K && b >= ra) dst = pair_index(K, ra, b);
      }
    } else if (e < kOpr * K) {
      const int j = (r - Plan::kGramRoles) * kOpr + e / K;
      if (j < ns) dst = Plan::kPairs + j * K + e % K;
    }
    if (dst < 0) continue;
    double total = red[r_local][e];
    for (int w = 1; w < plan.wpr; ++w) total += red[w * plan.roles_per_block + r_local][e];
    row[dst] = total;
  }
}

// vec for RoleArgs: n_paths % 4 == 0 and 16-byte aligned bases.
inline int rows_aligned16(int n_paths, const void* a, const void* b) {
  return n_paths % 4 == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(b) & 15) == 0;
}

}  // namespace amcx
