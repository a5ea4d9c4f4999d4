// CCR exposure profile of a pricing from its exported coefficients, one call
// of amcx_ccr_exposures a profile (a memset and six launches).
//
// Replaces: amcx/exposures.py exposures_from_coeffs (a lax.scan of XLA
// operations with a sort a step; amcx has no Pallas kernel for it) and the
// port's Python loop of torch operations and a torch.sort a step
// (amcx_torch/exposures.py). The reference computes the same profile at
// american_monte_carlo.py:400-414 (compute_ccr_exposures) over the
// continuation surface of an all-paths fit.
//
// For each step t < n_steps, over the paths of row t of the time-major
// (n_steps+1, n_paths) f32 paths:
//   C_t = max(sum_a c_{t,a} B_a((S_t - mean_t) * inv_std_t), 0), kernel 2's
//         own fit (csrc/lsmc_mega.cu pass B: quad_cols, the left-to-right
//         sum, the clamp that keeps a NaN), so the profile is taken over the
//         continuation the induction compared with the payoff;
//   EPE   the f64 sum of the finite C_t over their count n_valid, rounded
//         once to f32 (NaN where none is finite);
//   PFE   amcx's linear-interpolation percentile (exposures.py
//         _percentiles): pos = q (n_valid - 1) in f32, the order statistics
//         of ranks floor(pos) and the next one (the same one at the top),
//         then vlo + frac (vhi - vlo) in f32, for q = 5% and 95%.
// Row n_steps (maturity) is zero in all three. The surface is never stored.
//
// Bound on the H100 (1M paths x 100 steps): one read of the paths' first
// n_steps rows, 419 MB, 0.1252 ms at 3.35 TB/s; the ~21 f32 operations of
// the fit a path-step (Chebyshev degree 4) take ~0.03 ms.
//
// Design: exact selection of the four order statistics a step (PFE-5's two
// ranks, PFE-95's two) with one full pass over the paths, on a 32-bit key
// whose unsigned order is that of the finite f32 values (-0.0 as +0.0).
// 1. ccr_sample, a block of kSelectThreads a step: the keys of C_t on the
//    step's first kSample paths (the paths are independent, so any kSample
//    of them are a sample) in shared memory, and by block_select (three
//    rounds of counting the 13-, 10- and 9-bit digits in shared memory) the
//    sample's keys kMargin ranks below and above each pair's sample rank: a
//    window [lo, hi] a pair that holds the pair's order statistics unless
//    the sample errs by more than 8 standard deviations of its rank.
// 2. ccr_window, (n_chunks, n_steps) blocks of kChunkQuads quads: C_t of
//    every path, the f64 EPE partials, and per window the counts below lo
//    and equal to lo (the clamped zeros, and t = 0 where every path is
//    equal, select with no candidate), and the keys in (lo, hi], kept in
//    each thread's slots in shared memory and appended to the window's list
//    with one reservation a block (kCap at most). The last block of a step (a
//    ticket) writes EPE, and from n_valid the ranks: each is lo, or a rank
//    among the candidates, or outside the window (then the step falls back).
// 3. ccr_pick, a block of kSelectThreads a window: block_select over the
//    window's candidates (~2% of the paths at 1M) in shared memory, and PFE.
// Fallback, exact for any data: three radix passes (ccr_pass<K, 0..2>) over
// the paths of the steps whose window missed, on the same digits, each
// block counting into shared memory and adding its nonzero bins to the
// step's histogram, the last block of the step narrowing each target to
// its bin (pass 2 writes PFE; EPE is the window pass's); the blocks of
// every other step return at once. Above ~1.6M paths the windows hold more
// than kCap candidates and every step falls back.
// Built, timed on the card (1M x 100) and dropped: the three radix passes
// as the only route, 1.25 ms with a warp's leader bin added once, 0.86 ms
// with one atomic a value (each pass's shared-memory counting of every
// value, not its read, set the time); candidates appended by one global
// atomic a warp (0.89 ms for the window pass alone), one shared atomic a
// warp (0.50 ms) or a stage a warp (0.34 ms; 0.33 with the thread slots);
// the sample and the candidates read from device memory by 256 threads
// (0.13 and 0.09 ms).
// The floor of the window route is the one read of the paths, plus the
// sample's 1/32 of it.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "lsmc_coop.cuh"

namespace amcx {

// The profile's shape; mirrors amcx_torch.ops.ccr_exposures.CcrParams.
// Passed by value.
struct CcrParams {
  int n_steps;
  int n_paths;
  int basis;
};

}  // namespace amcx

namespace {

using namespace amcx;

constexpr int kTargets = 4;  // ranks floor(pos) and the next of PFE-5, then of PFE-95
constexpr int kWindows = 2;  // a window a pair of targets
constexpr int kQuadsPerThread = 32;
constexpr int kBatch = 4;  // quads a thread loads before it evaluates them
constexpr int kChunkQuads = kQuadsPerThread * kThreads;
constexpr int kSample = 32768;  // paths of a step's sample
// sample ranks on each side of a pair's: 8 standard deviations of the
// sample rank of a 5% (or 95%) quantile, sqrt(kSample 0.05 0.95) = 39.45, and 2
constexpr int kMargin = 318;
constexpr int kCap = 32768;  // candidates a window keeps (~20k at 1M paths)
constexpr int kThreadSlots = 8;  // candidates a thread keeps in shared memory, a window
constexpr int kSelectThreads = 1024;  // threads of the sample's and the candidates' blocks
constexpr unsigned kNoKey = 0xffffffffu;  // above every finite value's key
constexpr unsigned kFull = 0xffffffffu;

// The key's digits, most significant first: bits [31:19], [18:9], [8:0]
// (the fallback's passes and block_select's rounds).
template <int kPass>
struct Digit;
template <>
struct Digit<0> {
  static constexpr int kBits = 13, kShift = 19;
};
template <>
struct Digit<1> {
  static constexpr int kBits = 10, kShift = 9;
};
template <>
struct Digit<2> {
  static constexpr int kBits = 9, kShift = 0;
};

// Counts of a round: one histogram of the first digit (every target shares
// the empty prefix), a histogram a target of each later digit.
constexpr int kHistWords = 1 << Digit<0>::kBits;
static_assert(kTargets << Digit<1>::kBits <= kHistWords, "the counts fit");

// The fallback's selection of a step between passes: n_valid, the two
// fractions, and each target's key prefix so far and its rank under it.
struct Select {
  unsigned n_valid;
  float frac[2];
  unsigned prefix[kTargets];
  unsigned rank[kTargets];
};

// The window pass's counts of a step (zeroed before each profile).
struct Counts {
  unsigned n_valid;
  unsigned below[kWindows];
  unsigned equal[kWindows];
  unsigned cand[kWindows];
};

// The window pass's verdict on a step: fallback, or for each target its
// key (at_lo) or its rank among its window's candidates.
struct Pick {
  unsigned n_valid;
  unsigned fallback;
  float frac[2];
  unsigned at_lo[kTargets];
  unsigned value[kTargets];
};

struct Scratch {
  unsigned* tickets;  // (n_steps)
  unsigned* hist0;  // (n_steps, 2^13)
  unsigned* hist1;  // (n_steps, kTargets, 2^10)
  unsigned* hist2;  // (n_steps, kTargets, 2^9)
  Select* select;  // (n_steps)
  Counts* counts;  // (n_steps)
  unsigned* windows;  // (n_steps, kTargets): lo and hi of each window
  Pick* pick;  // (n_steps)
  unsigned* cand;  // (n_steps, kWindows, kCap)
  double* partials;  // (n_steps, n_chunks)
};

template <int kPass>
__device__ __forceinline__ unsigned* pass_hist(const Scratch& s, int t) {
  constexpr int kBins = 1 << Digit<kPass>::kBits;
  if constexpr (kPass == 0) return s.hist0 + static_cast<size_t>(t) * kBins;
  if constexpr (kPass == 1) return s.hist1 + static_cast<size_t>(t) * kTargets * kBins;
  return s.hist2 + static_cast<size_t>(t) * kTargets * kBins;
}

// A key whose unsigned order is the order of the finite f32 values, with
// -0.0 and +0.0 one key; key_value inverts it (to +0.0).
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned b = v == 0.0f ? 0u : __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The continuation of a step's paths, kernel 2's fit and clamp.
template <int K>
struct StepFit {
  float c[K];
  float mean, inv_std;
  int basis;

  __device__ __forceinline__ StepFit(const CcrParams& p, const float* coeffs,
                                     const float* mean_t, const float* inv_std_t, int t)
      : mean(mean_t[t]), inv_std(inv_std_t[t]), basis(p.basis) {
#pragma unroll
    for (int i = 0; i < K; ++i) c[i] = coeffs[t * K + i];
  }

  // C of a quad's spots, its keys, and valid: present and finite.
  __device__ __forceinline__ void eval(const float (&s)[4], int n_here, float (&cont)[4],
                                       unsigned (&key)[4], bool (&valid)[4]) const {
    float x[4], cols[4][K];
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = j < n_here ? (s[j] - mean) * inv_std : 0.0f;
    quad_cols<K>(basis, x, cols);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float fitted = cols[j][0] * c[0];
#pragma unroll
      for (int a = 1; a < K; ++a) fitted = fitted + cols[j][a] * c[a];
      // kernel 2's clamp: a NaN fit stays NaN (and is left out)
      cont[j] = fitted > 0.0f ? fitted : (fitted != fitted ? fitted : 0.0f);
      valid[j] = j < n_here && isfinite(cont[j]);
      key[j] = order_key(cont[j]);
    }
  }
};

// fn(cont, key, valid) on each quad of block (chunk, t)'s chunk of the
// step's paths, kBatch quads loaded at a time; every lane of the block calls
// fn equally often (past n_paths with nothing valid).
template <int K, class Fn>
__device__ __forceinline__ void for_chunk(const CcrParams& p, const float* paths,
                                          const StepFit<K>& fit, int t, Fn&& fn) {
  const float* row = paths + static_cast<size_t>(t) * p.n_paths;
  const bool vec = (reinterpret_cast<uintptr_t>(row) & 15u) == 0;
  const int n_quads = (p.n_paths + 3) / 4;
  const int first = blockIdx.x * kChunkQuads;
  for (int i = 0; i < kQuadsPerThread; i += kBatch) {
    if (first + i * kThreads >= n_quads) break;  // the same for the whole block
    float sq[kBatch][4];
    int n_here[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int q = first + (i + b) * kThreads + threadIdx.x;
      n_here[b] = q < n_quads ? min(4, p.n_paths - 4 * q) : 0;
      load_row4(row, 4 * q, n_here[b], vec, sq[b]);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      float cont[4];
      unsigned key[4];
      bool valid[4];
      fit.eval(sq[b], n_here[b], cont, key, valid);
      fn(cont, key, valid);
    }
  }
}

// The used targets' distinct prefixes (in target order) into want[0..n),
// and each used target's slot among them (-1 for the others).
__device__ __forceinline__ int distinct_prefixes(const unsigned (&prefix)[kTargets],
                                                 const bool (&use)[kTargets],
                                                 unsigned (&want)[kTargets],
                                                 int (&slot)[kTargets]) {
  int n = 0;
#pragma unroll
  for (int j = 0; j < kTargets; ++j) {
    slot[j] = -1;
    if (!use[j]) continue;
    for (int i = 0; i < n; ++i) {
      if (want[i] == prefix[j]) slot[j] = i;
    }
    if (slot[j] < 0) {
      slot[j] = n;
      want[n++] = prefix[j];
    }
  }
  return n;
}

// The block's exclusive prefix sum of `sum` in thread order, and its total
// in every thread. blockDim.x == kBlock.
template <int kBlock>
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned sum, unsigned* total) {
  constexpr int kBlockWarps = kBlock / 32;
  __shared__ unsigned warp_total[kBlockWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned inc = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned up = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += up;
  }
  if (lane == 31) warp_total[warp] = inc;
  __syncthreads();
  unsigned before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kBlockWarps; ++w) {
    const unsigned x = warp_total[w];
    if (w < warp) before += x;
    all += x;
  }
  __syncthreads();
  *total = all;
  return before + inc - sum;
}

// Over the kBins counts h (device memory that other blocks' atomics wrote:
// read through L2; or this block's shared memory), for each target j with
// use[j]: the bin holding the value of rank rank[j] (< the total) into
// bin[j], and that value's rank among the bin's values into rest[j] (bin
// and rest in shared memory, set when the block returns). Returns the total.
template <int kBins, bool kDevice, int kBlock>
__device__ __forceinline__ unsigned locate(const unsigned* h, const bool (&use)[kTargets],
                                           const unsigned (&rank)[kTargets], unsigned* bin,
                                           unsigned* rest) {
  constexpr int kPer = kBins >= kBlock ? kBins / kBlock : 1;
  static_assert(kBins % kBlock == 0 || kBlock % kBins == 0, "whole bins a thread");
  const bool has = threadIdx.x * kPer < kBins;
  unsigned v[kPer];
  unsigned sum = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const unsigned* at = h + threadIdx.x * kPer + i;
    v[i] = !has ? 0u : (kDevice ? __ldcg(at) : *at);
    sum += v[i];
  }
  unsigned total;
  const unsigned below = block_exclusive_scan<kBlock>(sum, &total);
#pragma unroll
  for (int j = 0; j < kTargets; ++j) {
    if (!use[j] || rank[j] < below || rank[j] - below >= sum) continue;
    unsigned c = below;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (rank[j] - c < v[i]) {
        bin[j] = threadIdx.x * kPer + i;
        rest[j] = rank[j] - c;
        break;
      }
      c += v[i];
    }
  }
  __syncthreads();
  return total;
}

// One round of block_select: each used target's prefix grows by the digit
// of the bin its rank falls in.
template <int kRound, int kBlock>
__device__ __forceinline__ void select_round(const unsigned* keys, unsigned count,
                                             const bool (&use)[kTargets],
                                             unsigned (&prefix)[kTargets],
                                             unsigned (&rank)[kTargets], unsigned* hist,
                                             unsigned* bin, unsigned* rest) {
  using D = Digit<kRound>;
  constexpr int kBins = 1 << D::kBits;
  unsigned want[kTargets];
  int slot[kTargets];
  const int n = distinct_prefixes(prefix, use, want, slot);
  for (int i = threadIdx.x; i < n * kBins; i += kBlock) hist[i] = 0u;
  __syncthreads();
  for (unsigned i = threadIdx.x; i < count; i += kBlock) {
    const unsigned k = keys[i];
    const unsigned d = (k >> D::kShift) & (kBins - 1);
    for (int u = 0; u < n; ++u) {
      bool hit = true;
      if constexpr (kRound > 0) hit = (k >> (D::kShift + D::kBits)) == want[u];
      if (hit) atomicAdd(hist + u * kBins + d, 1u);
    }
  }
  __syncthreads();
  for (int u = 0; u < n; ++u) {
    bool mine[kTargets];
#pragma unroll
    for (int j = 0; j < kTargets; ++j) mine[j] = slot[j] == u;
    locate<kBins, false, kBlock>(hist + u * kBins, mine, rank, bin, rest);
  }
#pragma unroll
  for (int j = 0; j < kTargets; ++j) {
    if (!use[j]) continue;
    prefix[j] = (prefix[j] << D::kBits) | bin[j];
    rank[j] = rest[j];
  }
  __syncthreads();
}

// The keys of ranks rank[j] (each < count; for use[j]) among keys[0..count)
// (shared memory) into out[j] (shared memory, set when the block returns): a
// round of counting a digit, a histogram for each distinct prefix of the
// targets. blockDim.x == kBlock.
template <int kBlock>
__device__ __forceinline__ void block_select(const unsigned* keys, unsigned count,
                                             const bool (&use)[kTargets],
                                             const unsigned (&rank)[kTargets], unsigned* out) {
  __shared__ unsigned hist[kHistWords];
  __shared__ unsigned bin[kTargets], rest[kTargets];
  unsigned prefix[kTargets] = {0u, 0u, 0u, 0u};
  unsigned r[kTargets];
#pragma unroll
  for (int j = 0; j < kTargets; ++j) r[j] = rank[j];
  select_round<0, kBlock>(keys, count, use, prefix, r, hist, bin, rest);
  select_round<1, kBlock>(keys, count, use, prefix, r, hist, bin, rest);
  select_round<2, kBlock>(keys, count, use, prefix, r, hist, bin, rest);
  if (threadIdx.x < kTargets && use[threadIdx.x]) out[threadIdx.x] = prefix[threadIdx.x];
  __syncthreads();
}

// The ranks of the four targets and the two fractions, as _percentiles
// computes them from n_valid (> 0).
__device__ __forceinline__ void target_ranks(unsigned n_valid, unsigned (&rank)[kTargets],
                                             float (&frac)[2]) {
  const float qs[2] = {0.05f, 0.95f};
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    // torch's (q / 100) * (n_valid - 1.0) on an f32 count: each step rounded
    const float pos = __fmul_rn(qs[b], __fsub_rn(__uint2float_rn(n_valid), 1.0f));
    const unsigned lo = static_cast<unsigned>(floorf(pos));
    frac[b] = __fsub_rn(pos, __uint2float_rn(lo));
    rank[2 * b] = lo;
    rank[2 * b + 1] = lo + 1u < n_valid ? lo + 1u : lo;
  }
}

__device__ __forceinline__ float band(unsigned klo, unsigned khi, float frac) {
  const float vlo = key_value(klo), vhi = key_value(khi);
  return __fadd_rn(vlo, __fmul_rn(frac, __fsub_rn(vhi, vlo)));
}

// EPE of step t from the chunks' f64 partials in chunk order (one thread).
__device__ __forceinline__ float epe_of(const Scratch& s, int t, int n_chunks,
                                        unsigned n_valid) {
  const double* row = s.partials + static_cast<size_t>(t) * n_chunks;
  double sum = 0.0;
  for (int c = 0; c < n_chunks; ++c) sum += __ldcg(row + c);
  return static_cast<float>(sum / static_cast<double>(n_valid));
}

// ---- the window route ----

template <int K>
__global__ void __launch_bounds__(kSelectThreads)
ccr_sample(const __grid_constant__ CcrParams p, const float* __restrict__ paths,
           const float* __restrict__ coeffs, const float* __restrict__ mean_t,
           const float* __restrict__ inv_std_t, const Scratch s) {
  extern __shared__ unsigned keys[];  // kSample
  __shared__ unsigned bounds[kTargets];
  const int t = blockIdx.x;
  const StepFit<K> fit(p, coeffs, mean_t, inv_std_t, t);
  const int m = min(p.n_paths, kSample);
  const float* row = paths + static_cast<size_t>(t) * p.n_paths;
  const bool vec = (reinterpret_cast<uintptr_t>(row) & 15u) == 0;
  unsigned mine = 0;
  for (int q0 = 0; 4 * q0 < m; q0 += kBatch * kSelectThreads) {
    float sq[kBatch][4];
    int n_here[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int q = q0 + b * kSelectThreads + threadIdx.x;
      n_here[b] = 4 * q < m ? min(4, m - 4 * q) : 0;
      load_row4(row, 4 * q, n_here[b], vec, sq[b]);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int q = q0 + b * kSelectThreads + threadIdx.x;
      float cont[4];
      unsigned key[4];
      bool valid[4];
      fit.eval(sq[b], n_here[b], cont, key, valid);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= n_here[b]) break;
        keys[4 * q + j] = valid[j] ? key[j] : kNoKey;
        mine += valid[j] ? 1u : 0u;
      }
    }
  }
  unsigned m_valid;
  block_exclusive_scan<kSelectThreads>(mine, &m_valid);  // its barriers publish the keys
  const bool all[kTargets] = {true, true, true, true};
  unsigned rank[kTargets] = {0u, 0u, 0u, 0u};
  if (m_valid > 0u) {
    const float qs[2] = {0.05f, 0.95f};
#pragma unroll
    for (int w = 0; w < kWindows; ++w) {
      const int c = static_cast<int>(floorf(qs[w] * static_cast<float>(m_valid - 1u)));
      rank[2 * w] = static_cast<unsigned>(max(c - kMargin, 0));
      rank[2 * w + 1] = static_cast<unsigned>(min(c + 1 + kMargin, static_cast<int>(m_valid) - 1));
    }
  }
  block_select<kSelectThreads>(keys, static_cast<unsigned>(m), all, rank, bounds);
  if (threadIdx.x < kTargets) s.windows[t * kTargets + threadIdx.x] = bounds[threadIdx.x];
}

// The window pass's last block of step t (one thread): EPE, then each
// target's place: lo, a candidate rank, or the fallback.
__device__ __forceinline__ void window_verdict(const CcrParams& p, const Scratch& s, int t,
                                               int n_chunks, float* out) {
  const int T1 = p.n_steps + 1;
  if (t == p.n_steps - 1) {
    for (int r = 0; r < 3; ++r) out[r * T1 + p.n_steps] = 0.0f;
  }
  const Counts* cnt = s.counts + t;
  Pick& pick = s.pick[t];
  const unsigned n_valid = __ldcg(&cnt->n_valid);
  pick.n_valid = n_valid;
  pick.fallback = 0u;
  if (n_valid == 0u) {
    const float nan = __int_as_float(0x7fc00000);
    for (int r = 0; r < 3; ++r) out[r * T1 + t] = nan;
    return;
  }
  out[t] = epe_of(s, t, n_chunks, n_valid);
  unsigned rank[kTargets];
  float frac[2];
  target_ranks(n_valid, rank, frac);
  pick.frac[0] = frac[0];
  pick.frac[1] = frac[1];
  bool miss = false;
#pragma unroll
  for (int j = 0; j < kTargets; ++j) {
    const int w = j / 2;
    const unsigned below = __ldcg(&cnt->below[w]), equal = __ldcg(&cnt->equal[w]);
    const unsigned cand = __ldcg(&cnt->cand[w]);
    const unsigned r = rank[j];
    pick.at_lo[j] = 0u;
    if (r >= below && r - below < equal) {
      pick.at_lo[j] = 1u;
      pick.value[j] = s.windows[t * kTargets + 2 * w];
    } else if (cand <= static_cast<unsigned>(kCap) && r >= below + equal &&
               r - below - equal < cand) {
      pick.value[j] = r - below - equal;
    } else {
      miss = true;
    }
  }
  pick.fallback = miss ? 1u : 0u;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
ccr_window(const __grid_constant__ CcrParams p, const float* __restrict__ paths,
           const float* __restrict__ coeffs, const float* __restrict__ mean_t,
           const float* __restrict__ inv_std_t, const Scratch s, float* __restrict__ out) {
  const int t = blockIdx.y;
  const StepFit<K> fit(p, coeffs, mean_t, inv_std_t, t);
  unsigned lo[kWindows], hi[kWindows];
#pragma unroll
  for (int w = 0; w < kWindows; ++w) {
    lo[w] = s.windows[t * kTargets + 2 * w];
    hi[w] = s.windows[t * kTargets + 2 * w + 1];
  }
  // a thread keeps its candidates of a window in its own kThreadSlots slots
  // in shared memory (no atomic; past them one atomic a candidate on the
  // list); the block appends them all with one reservation a window
  __shared__ unsigned slots[kWindows * kThreadSlots * kThreads];
  __shared__ unsigned start[kWindows];
  Counts* cnt = s.counts + t;
  unsigned* cand = s.cand + static_cast<size_t>(t) * kWindows * kCap;
  const int lane = threadIdx.x & 31;
  unsigned width[kWindows], kept[kWindows] = {0u, 0u};
#pragma unroll
  for (int w = 0; w < kWindows; ++w) width[w] = hi[w] - lo[w];
  unsigned n_valid = 0, below[kWindows] = {0u, 0u}, equal[kWindows] = {0u, 0u};
  double acc = 0.0;
  for_chunk<K>(p, paths, fit, t, [&](const float (&cont)[4], const unsigned (&key)[4],
                                     const bool (&valid)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (valid[j]) acc += static_cast<double>(cont[j]);
      n_valid += valid[j] ? 1u : 0u;
#pragma unroll
      for (int w = 0; w < kWindows; ++w) {
        const unsigned d = key[j] - lo[w];
        below[w] += valid[j] && key[j] < lo[w] ? 1u : 0u;
        equal[w] += valid[j] && d == 0u ? 1u : 0u;
        if (!valid[j] || d - 1u >= width[w]) continue;  // in (lo, hi]: 0 < d <= width
        if (kept[w] < static_cast<unsigned>(kThreadSlots)) {
          slots[(w * kThreadSlots + kept[w]++) * kThreads + threadIdx.x] = key[j];
        } else {
          const unsigned at = atomicAdd(&cnt->cand[w], 1u);
          if (at < static_cast<unsigned>(kCap)) cand[w * kCap + at] = key[j];
        }
      }
    }
  });
#pragma unroll
  for (int w = 0; w < kWindows; ++w) {
    unsigned total;
    const unsigned before = block_exclusive_scan<kThreads>(kept[w], &total);
    if (threadIdx.x == 0) start[w] = atomicAdd(&cnt->cand[w], total);
    __syncthreads();
    for (unsigned i = 0; i < kept[w]; ++i) {
      const unsigned at = start[w] + before + i;
      if (at < static_cast<unsigned>(kCap)) {
        cand[w * kCap + at] = slots[(w * kThreadSlots + i) * kThreads + threadIdx.x];
      }
    }
  }
  n_valid = __reduce_add_sync(kFull, n_valid);
#pragma unroll
  for (int w = 0; w < kWindows; ++w) {
    below[w] = __reduce_add_sync(kFull, below[w]);
    equal[w] = __reduce_add_sync(kFull, equal[w]);
  }
  if (lane == 0) {
    atomicAdd(&cnt->n_valid, n_valid);
#pragma unroll
    for (int w = 0; w < kWindows; ++w) {
      atomicAdd(&cnt->below[w], below[w]);
      atomicAdd(&cnt->equal[w], equal[w]);
    }
  }
  double a[1] = {acc};
  block_reduce_store<1>(a, s.partials + static_cast<size_t>(t) * gridDim.x + blockIdx.x);
  if (!last_ticket(s.tickets + t, gridDim.x)) return;
  if (threadIdx.x == 0) window_verdict(p, s, t, gridDim.x, out);
}

// Block (w, t): the window's targets among its candidates, and PFE.
__global__ void __launch_bounds__(kSelectThreads)
ccr_pick(const __grid_constant__ CcrParams p, const Scratch s, float* __restrict__ out) {
  extern __shared__ unsigned cand[];  // kCap
  __shared__ unsigned keys[kTargets];
  const int w = blockIdx.x, t = blockIdx.y;
  const Pick& pick = s.pick[t];
  if (pick.n_valid == 0u || pick.fallback) return;
  bool use[kTargets] = {false, false, false, false};
  unsigned rank[kTargets] = {0u, 0u, 0u, 0u};
  bool any = false;
#pragma unroll
  for (int j = 2 * w; j < 2 * w + 2; ++j) {
    use[j] = !pick.at_lo[j];
    rank[j] = pick.value[j];
    any = any || use[j];
  }
  if (any) {
    const unsigned count = s.counts[t].cand[w];
    const unsigned* list = s.cand + (static_cast<size_t>(t) * kWindows + w) * kCap;
    for (unsigned i = threadIdx.x; i < count; i += kSelectThreads) cand[i] = list[i];
    __syncthreads();
    block_select<kSelectThreads>(cand, count, use, rank, keys);
  }
  if (threadIdx.x == 0) {
    const unsigned klo = use[2 * w] ? keys[2 * w] : pick.value[2 * w];
    const unsigned khi = use[2 * w + 1] ? keys[2 * w + 1] : pick.value[2 * w + 1];
    out[(1 + w) * (p.n_steps + 1) + t] = band(klo, khi, pick.frac[w]);
  }
}

// ---- the fallback: radix passes over the paths of the steps that missed ----

// Pass 0's last block of step t: n_valid, EPE, the ranks and fractions, and
// each target's 13-bit bucket.
__device__ __forceinline__ void select_first(const Scratch& s, int t) {
  __shared__ unsigned bin[kTargets], rest[kTargets];
  constexpr int kBins = 1 << Digit<0>::kBits;
  const bool all[kTargets] = {true, true, true, true};
  const unsigned n_valid = s.pick[t].n_valid;  // > 0: the window pass counted it
  unsigned rank[kTargets];
  float frac[2];
  target_ranks(n_valid, rank, frac);
  locate<kBins, true, kThreads>(pass_hist<0>(s, t), all, rank, bin, rest);
  if (threadIdx.x == 0) {
    Select& sel = s.select[t];
    sel.n_valid = n_valid;
    sel.frac[0] = frac[0];
    sel.frac[1] = frac[1];
#pragma unroll
    for (int j = 0; j < kTargets; ++j) {
      sel.prefix[j] = bin[j];
      sel.rank[j] = rest[j];
    }
  }
}

// Pass kPass > 0's last block of step t: each target's prefix grows by the
// digit of its bin; after pass 2 the prefix is the key, and PFE is written.
template <int kPass>
__device__ __forceinline__ void select_next(const CcrParams& p, const Scratch& s, int t,
                                            float* out) {
  constexpr int kBins = 1 << Digit<kPass>::kBits;
  __shared__ unsigned bin[kTargets], rest[kTargets];
  const Select& sel = s.select[t];
  const bool all[kTargets] = {true, true, true, true};
  unsigned prefix[kTargets], rank[kTargets], want[kTargets];
  int slot[kTargets];
#pragma unroll
  for (int j = 0; j < kTargets; ++j) {
    prefix[j] = sel.prefix[j];
    rank[j] = sel.rank[j];
  }
  const int n_slots = distinct_prefixes(prefix, all, want, slot);
  for (int u = 0; u < n_slots; ++u) {
    bool use[kTargets];
#pragma unroll
    for (int j = 0; j < kTargets; ++j) use[j] = slot[j] == u;
    locate<kBins, true, kThreads>(pass_hist<kPass>(s, t) + u * kBins, use, rank, bin, rest);
  }
  if (threadIdx.x != 0) return;
#pragma unroll
  for (int j = 0; j < kTargets; ++j) prefix[j] = (prefix[j] << Digit<kPass>::kBits) | bin[j];
  if constexpr (kPass == 2) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      out[(1 + b) * (p.n_steps + 1) + t] = band(prefix[2 * b], prefix[2 * b + 1], sel.frac[b]);
    }
  } else {
    Select& next = s.select[t];
#pragma unroll
    for (int j = 0; j < kTargets; ++j) {
      next.prefix[j] = prefix[j];
      next.rank[j] = rest[j];
    }
  }
}

// One radix pass over the paths of a step that missed: block (chunk, t).
template <int K, int kPass>
__global__ void __launch_bounds__(kThreads)
ccr_pass(const __grid_constant__ CcrParams p, const float* __restrict__ paths,
         const float* __restrict__ coeffs, const float* __restrict__ mean_t,
         const float* __restrict__ inv_std_t, const Scratch s, float* __restrict__ out) {
  using D = Digit<kPass>;
  constexpr int kBins = 1 << D::kBits;
  constexpr int kSlots = kPass == 0 ? 1 : kTargets;
  __shared__ unsigned hist[kSlots * kBins];
  __shared__ unsigned want_s[kTargets];
  __shared__ int n_slots_s;
  const int t = blockIdx.y;

  if (threadIdx.x == 0) {
    int n = s.pick[t].fallback ? 1 : 0;
    if constexpr (kPass > 0) {
      n = 0;
      const Select& sel = s.select[t];
      if (sel.n_valid > 0u) {
        const bool all[kTargets] = {true, true, true, true};
        unsigned prefix[kTargets], want[kTargets];
        int slot[kTargets];
#pragma unroll
        for (int j = 0; j < kTargets; ++j) prefix[j] = sel.prefix[j];
        n = distinct_prefixes(prefix, all, want, slot);
#pragma unroll
        for (int j = 0; j < kTargets; ++j) want_s[j] = want[j];
      }
    }
    n_slots_s = n;
  }
  __syncthreads();
  const int n_slots = n_slots_s;
  if (n_slots == 0) return;  // a step the window route resolved
  for (int i = threadIdx.x; i < n_slots * kBins; i += kThreads) hist[i] = 0u;
  unsigned want[kTargets];
#pragma unroll
  for (int j = 0; j < kTargets; ++j) want[j] = kPass > 0 ? want_s[j] : 0u;
  __syncthreads();

  const StepFit<K> fit(p, coeffs, mean_t, inv_std_t, t);
  for_chunk<K>(p, paths, fit, t, [&](const float (&cont)[4], const unsigned (&key)[4],
                                     const bool (&valid)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned digit = (key[j] >> D::kShift) & (kBins - 1);
      if constexpr (kPass == 0) {
        if (valid[j]) atomicAdd(hist + digit, 1u);
      } else {
        const unsigned above = key[j] >> (D::kShift + D::kBits);
#pragma unroll
        for (int u = 0; u < kSlots; ++u) {
          if (u < n_slots && valid[j] && above == want[u]) atomicAdd(hist + u * kBins + digit, 1u);
        }
      }
    }
  });
  __syncthreads();
  unsigned* g = pass_hist<kPass>(s, t);
  for (int i = threadIdx.x; i < n_slots * kBins; i += kThreads) {
    const unsigned v = hist[i];
    if (v != 0u) atomicAdd(g + i, v);
  }
  if (!last_ticket(s.tickets + t, gridDim.x)) return;
  if constexpr (kPass == 0) {
    select_first(s, t);
  } else {
    select_next<kPass>(p, s, t, out);
  }
}

size_t align256(size_t b) { return (b + 255) & ~static_cast<size_t>(255); }

int n_chunks_of(int n_paths) {
  const int n_quads = (n_paths + 3) / 4;
  return (n_quads + kChunkQuads - 1) / kChunkQuads;
}

// The scratch layout: first what is zeroed before each profile (tickets,
// the fallback's histograms and selections, the window pass's counts),
// then the rest. Returns the bytes to zero.
size_t layout(int n_steps, int n_paths, char* base, Scratch* s, size_t* total) {
  const size_t T = static_cast<size_t>(n_steps);
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* at = base == nullptr ? nullptr : base + off;
    off += align256(bytes);
    return at;
  };
  s->tickets = reinterpret_cast<unsigned*>(take(T * sizeof(unsigned)));
  s->hist0 = reinterpret_cast<unsigned*>(take(T * (1u << Digit<0>::kBits) * sizeof(unsigned)));
  s->hist1 = reinterpret_cast<unsigned*>(
      take(T * kTargets * (1u << Digit<1>::kBits) * sizeof(unsigned)));
  s->hist2 = reinterpret_cast<unsigned*>(
      take(T * kTargets * (1u << Digit<2>::kBits) * sizeof(unsigned)));
  s->select = reinterpret_cast<Select*>(take(T * sizeof(Select)));
  s->counts = reinterpret_cast<Counts*>(take(T * sizeof(Counts)));
  const size_t zeroed = off;
  s->windows = reinterpret_cast<unsigned*>(take(T * kTargets * sizeof(unsigned)));
  s->pick = reinterpret_cast<Pick*>(take(T * sizeof(Pick)));
  s->cand = reinterpret_cast<unsigned*>(take(T * kWindows * kCap * sizeof(unsigned)));
  s->partials = reinterpret_cast<double*>(
      take(T * static_cast<size_t>(n_chunks_of(n_paths)) * sizeof(double)));
  *total = off;
  return zeroed;
}

template <int K>
cudaError_t launch(const CcrParams& p, const float* paths, const float* coeffs,
                   const float* mean_t, const float* inv_std_t, const Scratch& s, float* out,
                   cudaStream_t stream) {
  const dim3 grid(n_chunks_of(p.n_paths), p.n_steps);
  constexpr size_t kSampleBytes = kSample * sizeof(unsigned), kCapBytes = kCap * sizeof(unsigned);
  cudaError_t err = allow_smem(ccr_sample<K>, kSampleBytes);
  if (err == cudaSuccess) err = allow_smem(ccr_pick, kCapBytes);
  if (err != cudaSuccess) return err;
  ccr_sample<K><<<p.n_steps, kSelectThreads, kSampleBytes, stream>>>(p, paths, coeffs, mean_t,
                                                                      inv_std_t, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ccr_window<K><<<grid, kThreads, 0, stream>>>(p, paths, coeffs, mean_t, inv_std_t, s, out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ccr_pick<<<dim3(kWindows, p.n_steps), kSelectThreads, kCapBytes, stream>>>(p, s, out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ccr_pass<K, 0><<<grid, kThreads, 0, stream>>>(p, paths, coeffs, mean_t, inv_std_t, s, out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ccr_pass<K, 1><<<grid, kThreads, 0, stream>>>(p, paths, coeffs, mean_t, inv_std_t, s, out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ccr_pass<K, 2><<<grid, kThreads, 0, stream>>>(p, paths, coeffs, mean_t, inv_std_t, s, out);
  return cudaGetLastError();
}

}  // namespace

// The scratch bytes a profile of n_steps x n_paths takes. Returns a
// cudaError_t.
extern "C" int amcx_ccr_scratch_bytes(int n_steps, int n_paths, long long* bytes) {
  if (n_steps < 1 || n_paths < 1 || bytes == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Scratch s;
  size_t total = 0;
  layout(n_steps, n_paths, nullptr, &s, &total);
  *bytes = static_cast<long long>(total);
  return 0;
}

// params: the shape and the basis (host memory; n_steps < 65536); paths
// (n_steps+1, n_paths) f32, any alignment; coeffs (n_steps+1, degree+1)
// f32 (the maturity row unused); mean_t, inv_std_t
// (n_steps+1) f32; scratch (amcx_ccr_scratch_bytes, 256-byte aligned; its
// counts are zeroed here on the stream); out (3, n_steps+1) f32: EPE,
// PFE-5, PFE-95. Returns a cudaError_t.
extern "C" int amcx_ccr_exposures(const amcx::CcrParams* params, const float* paths,
                                  const float* coeffs, const float* mean_t,
                                  const float* inv_std_t, void* scratch, long long scratch_bytes,
                                  float* out, int degree, void* stream) {
  const amcx::CcrParams& p = *params;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.n_steps < 1 || p.n_steps > 65535 || p.n_paths < 1 || p.basis < 0 || p.basis > 4 ||
      paths == nullptr || coeffs == nullptr || mean_t == nullptr || inv_std_t == nullptr ||
      scratch == nullptr || out == nullptr ||
      (reinterpret_cast<uintptr_t>(scratch) & 255u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Scratch s;
  size_t total = 0;
  const size_t zeroed = layout(p.n_steps, p.n_paths, static_cast<char*>(scratch), &s, &total);
  if (static_cast<long long>(total) > scratch_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaMemsetAsync(scratch, 0, zeroed, st);
  if (err != cudaSuccess) return static_cast<int>(err);
#define AMCX_CCR_LAUNCH(KK) launch<KK>(p, paths, coeffs, mean_t, inv_std_t, s, out, st)
  switch (degree + 1) {
    case 1: return static_cast<int>(AMCX_CCR_LAUNCH(1));
    case 2: return static_cast<int>(AMCX_CCR_LAUNCH(2));
    case 3: return static_cast<int>(AMCX_CCR_LAUNCH(3));
    case 4: return static_cast<int>(AMCX_CCR_LAUNCH(4));
    case 5: return static_cast<int>(AMCX_CCR_LAUNCH(5));
    case 6: return static_cast<int>(AMCX_CCR_LAUNCH(6));
    case 7: return static_cast<int>(AMCX_CCR_LAUNCH(7));
    case 8: return static_cast<int>(AMCX_CCR_LAUNCH(8));
    case 9: return static_cast<int>(AMCX_CCR_LAUNCH(9));
    case 10: return static_cast<int>(AMCX_CCR_LAUNCH(10));
    case 11: return static_cast<int>(AMCX_CCR_LAUNCH(11));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef AMCX_CCR_LAUNCH
}
