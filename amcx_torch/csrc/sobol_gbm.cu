// Exact-GBM paths from scrambled-Sobol points, one launch per path array.
//
// Replaces: amcx/ops/sobol_pallas.py::_sobol_gbm_kernel (via
// sobol_gbm_paths / _run), the TPU kernel that XORs two direction tables
// into the Sobol point of each (step, path), maps it to a normal by
// Acklam's inverse CDF and builds the log path by a prefix sum or by the
// Brownian-bridge matrix.
//
// Computes, for path p and step j (Sobol dimension j):
//   u     = u_hi[j, p >> 9] ^ u_lo[j, p & 511]   (30-bit digital-net point)
//   f     = bitcast(((u >> 7) & 0x7FFFFF) | 0x3F800000) - (1 - 2^-24)
//   z_j   = Acklam's inverse normal CDF of f (its central form where
//           |f - 1/2| <= f32(0.5 - 0.02425), else its tail form)
//   increment mode: cum_t = sum_{j<t} (drift_dt + vol z_j)
//   bridge mode:    cum_t = drift_dt t + vol W_t, W_t = sum_s B[t-1, s] z_s
//                   with B the (n_steps, n_steps) bridge matrix carrying
//                   sqrt(dt), summed in ascending s
// and S[0] = S0, S[t] = S0 exp(cum_t), time-major (n_steps+1, n_paths) f32.
// The tables are scipy's scrambled engine's (ops/sobol_pallas.py,
// _direction_tables), built on the card by sobol_tables_kernel below; the
// XOR over the index bits factors over the bit ranges 0..8 and 9..29, so
// one XOR per element rebuilds the point in natural order.
//
// Bound on the H100 (1M paths x 100 steps): the store of the path array (4
// B per path-step, 424 MB, about 0.13 ms at 3.35 TB/s; the tables add 1
// MB), with ~60 f32 operations per path-step (the inverse CDF's two
// rational forms, a log and a sqrt) and, in bridge mode, the 2 nnz(B) /
// n_steps operations of the bridge product (B is sparse: 673 of its
// 10,000 entries are nonzero at 100 steps, at most 8 a row). The
// branchless inverse CDF made one path a thread 145 SASS instructions a
// path-step, an issue floor (0.455 ms) far above that bound, and its tail
// form (a log, a sqrt, two polynomials and a division) is half of it
// though only 4.85% of the points select it. The increment kernel below
// takes 82 (amcx_torch/pathgen_probe.py).
// The u_hi word is uniform over a 512-path group (a broadcast load) and
// u_lo's 512 words per step stay in L2.
//
// The increment mode evaluates the tail form only where it is selected:
// a warp compacts its tail points of a chunk of steps into shared memory
// and evaluates them densely (sobol_increment_kernel). A thread runs 4
// consecutive paths, so a row's store is one 16-byte access and u_lo's
// words one 16-byte load, and walks its steps with a running sum in a
// register (amcx's log-step doubling scan was a TPU layout choice).
//
// The bridge mode walks the rows of B in time order over its nonzeros
// only (the host's schedule, ops/sobol_pallas.py _bridge_schedule): row t
// lists its nonzero columns s in ascending order, each as (s, slot,
// born, B[t, s]). Dimension s's normal is computed once, at the first row
// that uses it (born), and kept in a shared-memory slot until its last
// row; the bisection's nesting keeps few dimensions live (8 at 100 steps,
// 11 at 1,000), so a block holds a few KB of normals and the step count is
// not bounded by shared memory. The schedule is read as warp-uniform __ldg
// loads (every thread of a warp reads the same entry), each once for the
// kBridgePaths paths of a thread (1, 2 and 4 paths a thread timed 1.12,
// 0.87 and 0.82 ms of device time at 1M x 100 on an H100).
// W_t = 0 + B[t, s0] z_s0 + B[t, s1] z_s1 + ... in ascending s is the dense
// ascending sum with its exact zeros skipped: a skipped term is b z = +-0
// (z is finite: the uniform lies in [2^-24, 1 - 2^-24]), w + +-0 = w but
// for the sign of a zero, and drift_dt (t+1) + vol w then exp cannot tell
// +0 from -0. So both modes run in full f32, in a fixed order: no tensor
// cores, no TF32, no library call. Built with -fmad=false and without fast
// math: logf, sqrtf, expf and the division give torch's CUDA bits, so the
// plain version (ops/sobol_pallas.py, sobol_gbm_paths_reference: the dense
// ascending sum) equals the kernel to the bit.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kLanes = 512;  // paths per u_hi column (the low 9 index bits)
constexpr int kLowBits = 9;
// the increment kernel's chunk of steps and consecutive paths a thread:
// chunks of 4 steps timed 0.290 ms at 1M x 100 against 0.300 for 8
// (amcx_torch/pathgen_probe.py, NVIDIA H100 80GB HBM3, 700 W)
constexpr int kIncSteps = 4;
constexpr int kIncPaths = 4;
constexpr int kIncThreads = kLanes / kIncPaths;
constexpr int kBridgePaths = 4;  // paths a thread in bridge mode
constexpr int kBridgeThreads = kLanes / kBridgePaths;
// A schedule entry's first word: the column s (bits 8..30), its slot (bits
// 0..7) and, in bit 31, born: the first row that uses column s
constexpr int kSlotBits = 8;

__device__ __forceinline__ float bits_to_uniform(uint32_t u) {
  const uint32_t mant = (u >> 7) & 0x007FFFFFu;
  // 0x3F7FFFFF is 1 - 2^-24: the uniform lies in [2^-24, 1 - 2^-24]
  return __uint_as_float(mant | 0x3F800000u) - __uint_as_float(0x3F7FFFFFu);
}

// amcx's norm_ppf, operation for operation, in its two forms, with Acklam's
// coefficients rounded from double to float as amcx rounds its Python
// floats (as immediates: no constant-bank loads). Each form is an
// independent computation of p and the select keeps one of them, so
// evaluating only the selected form gives the same bits (the increment
// kernel does; tests/test_torch_qmc.py holds the split against norm_ppf on
// every uniform bits_to_uniform can produce).
#define F(x) static_cast<float>(x)
__device__ __forceinline__ float norm_ppf_central(float p) {
  constexpr float a[6] = {F(-3.969683028665376e+01), F(2.209460984245205e+02),
                          F(-2.759285104469687e+02), F(1.383577518672690e+02),
                          F(-3.066479806614716e+01), F(2.506628277459239e+00)};
  constexpr float b[5] = {F(-5.447609879822406e+01), F(1.615858368580409e+02),
                          F(-1.556989798598866e+02), F(6.680131188771972e+01),
                          F(-1.328068155288572e+01)};
  const float half = p - 0.5f;
  const float r = half * half;
  float num = a[0];
#pragma unroll
  for (int i = 1; i < 6; ++i) num = num * r + a[i];
  float den = b[0];
#pragma unroll
  for (int i = 1; i < 5; ++i) den = den * r + b[i];
  den = den * r + 1.0f;
  return num * half / den;
}

__device__ __forceinline__ float norm_ppf_tail(float p) {
  constexpr float c[6] = {F(-7.784894002430293e-03), F(-3.223964580411365e-01),
                          F(-2.400758277161838e+00), F(-2.549732539343734e+00),
                          F(4.374664141464968e+00), F(2.938163982698783e+00)};
  constexpr float d[4] = {F(7.784695709041462e-03), F(3.224671290700398e-01),
                          F(2.445134137142996e+00), F(3.754408661907416e+00)};
  const float half = p - 0.5f;
  const float pt = fminf(p, 1.0f - p);
  const float qt = sqrtf(-2.0f * logf(fmaxf(pt, static_cast<float>(1e-38))));
  float num = c[0];
#pragma unroll
  for (int i = 1; i < 6; ++i) num = num * qt + c[i];
  float den = d[0];
#pragma unroll
  for (int i = 1; i < 4; ++i) den = den * qt + d[i];
  den = den * qt + 1.0f;
  const float x_t = num / den;  // the lower-tail form
  return half < 0.0f ? x_t : -x_t;
}
#undef F

// |p - 1/2| > f32(0.5 - 0.02425): 4.85% of the points
__device__ __forceinline__ bool norm_ppf_in_tail(float p) {
  return !(fabsf(p - 0.5f) <= static_cast<float>(0.5 - 0.02425));
}

// The branchless select of both forms (the bridge kernel).
__device__ __forceinline__ float norm_ppf(float p) {
  const float x_c = norm_ppf_central(p);
  const float x_t = norm_ppf_tail(p);
  return norm_ppf_in_tail(p) ? x_t : x_c;
}

__device__ __forceinline__ float sobol_normal(const uint32_t* __restrict__ u_hi,
                                              const uint32_t* __restrict__ u_lo, int j,
                                              int n_blocks, int p) {
  const uint32_t u = u_hi[static_cast<size_t>(j) * n_blocks + (p >> kLowBits)] ^
                     u_lo[j * kLanes + (p & (kLanes - 1))];
  return norm_ppf(bits_to_uniform(u));
}

// One chunk of kIncSteps steps (n_used of them when !kFull) for the
// thread's kIncPaths paths, in three phases:
//   1. each (step, path) gets the central form, into the block's tile in
//      shared memory (one 16-byte store a step); a tail point keeps its
//      uniform there and sets its bit of the thread's mask;
//   2. the warp lists the tile offsets of its tail points (an exclusive
//      scan of the per-thread counts, then each thread's set bits), and
//      its 32 lanes evaluate the list densely with the tail form, in place;
//   3. each thread walks its paths' steps from the tile: the running sum in
//      step order, expf, one 16-byte store a row.
// A warp meets ~25 tail points in a chunk of 4 steps x 128 paths, so the
// tail form runs in ~1 dense round where the branchless select ran it for
// all 4 x 4 points of every thread.
template <bool kFull>
__device__ __forceinline__ void increment_chunk(
    const uint32_t*& hi, const uint4*& lo, float*& dst, float* tile, uint16_t* list,
    float (&cum)[kIncPaths], int n_used, int n_blocks, size_t row, float S0, float drift_dt,
    float vol) {
  const int lane = threadIdx.x & 31;
  float4* mine = reinterpret_cast<float4*>(tile) + threadIdx.x;  // step s at mine[s kIncThreads]
  uint32_t tail = 0u;
#pragma unroll
  for (int s = 0; s < kIncSteps; ++s) {
    if (kFull || s < n_used) {
      const uint32_t h = __ldg(hi);
      const uint4 l = __ldg(lo);
      hi += n_blocks;
      lo += kIncThreads;
      const uint32_t w[kIncPaths] = {h ^ l.x, h ^ l.y, h ^ l.z, h ^ l.w};
      float v[kIncPaths];
#pragma unroll
      for (int k = 0; k < kIncPaths; ++k) {
        const float p = bits_to_uniform(w[k]);
        const bool in_tail = norm_ppf_in_tail(p);
        const float x_c = norm_ppf_central(p);
        v[k] = in_tail ? p : x_c;
        tail |= static_cast<uint32_t>(in_tail) << (s * kIncPaths + k);
      }
      mine[s * kIncThreads] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  const int n_mine = __popc(tail);
  int incl = n_mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += y;
  }
  const int total = __shfl_sync(0xFFFFFFFFu, incl, 31);
  if (total > 0) {  // warp-uniform
    for (int pos = incl - n_mine; tail != 0u; tail &= tail - 1u, ++pos) {
      const int b = __ffs(static_cast<int>(tail)) - 1;  // step b / 4, path b % 4
      list[pos] = static_cast<uint16_t>((b >> 2) * kLanes + kIncPaths * threadIdx.x + (b & 3));
    }
    __syncwarp();
    for (int i = lane; i < total; i += 32) {
      const int o = list[i];
      tile[o] = norm_ppf_tail(tile[o]);
    }
    __syncwarp();
  }
#pragma unroll
  for (int s = 0; s < kIncSteps; ++s) {
    if (kFull || s < n_used) {
      const float4 z4 = mine[s * kIncThreads];
      const float z[kIncPaths] = {z4.x, z4.y, z4.z, z4.w};
      float v[kIncPaths];
#pragma unroll
      for (int k = 0; k < kIncPaths; ++k) {
        cum[k] = cum[k] + (drift_dt + vol * z[k]);
        v[k] = S0 * expf(cum[k]);
      }
      dst += row;
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// A block is one 512-path group (one u_hi column), each thread kIncPaths
// consecutive paths; full chunks of kIncSteps steps, then the rest.
__global__ void __launch_bounds__(kIncThreads)
sobol_increment_kernel(const uint32_t* __restrict__ u_hi, const uint32_t* __restrict__ u_lo,
                       float* __restrict__ out, int n_steps, int n_paths, float S0,
                       float drift_dt, float vol) {
  static_assert(kIncSteps * kIncPaths <= 32 && kIncPaths == 4, "one 32-bit tail mask, float4s");
  __shared__ __align__(16) float tile[kIncSteps * kLanes];
  __shared__ uint16_t lists[kIncThreads / 32][32 * kIncSteps * kIncPaths];
  uint16_t* list = lists[threadIdx.x >> 5];
  const int n_blocks = n_paths / kLanes;
  const size_t row = static_cast<size_t>(n_paths);
  float* dst = out + static_cast<size_t>(blockIdx.x) * kLanes + kIncPaths * threadIdx.x;
  const uint32_t* hi = u_hi + blockIdx.x;  // step j at hi[j n_blocks]
  const uint4* lo = reinterpret_cast<const uint4*>(u_lo) + threadIdx.x;  // at lo[j kIncThreads]
  float cum[kIncPaths];
#pragma unroll
  for (int k = 0; k < kIncPaths; ++k) cum[k] = 0.0f;
  *reinterpret_cast<float4*>(dst) = make_float4(S0, S0, S0, S0);
  const int n_full = n_steps / kIncSteps;
  for (int c = 0; c < n_full; ++c) {
    increment_chunk<true>(hi, lo, dst, tile, list, cum, kIncSteps, n_blocks, row, S0, drift_dt,
                          vol);
  }
  if (n_steps > n_full * kIncSteps) {
    increment_chunk<false>(hi, lo, dst, tile, list, cum, n_steps - n_full * kIncSteps, n_blocks,
                           row, S0, drift_dt, vol);
  }
}

// Dynamic shared memory: n_slots x kBridgePaths columns of kBridgeThreads
// normals. row_ptr (n_steps + 1) and entries (nnz x {column|slot|born, bits
// of B[t, s]}): the schedule, rows in time order, columns ascending. A
// block covers one 512-path group, each thread kBridgePaths paths
// kBridgeThreads apart, so each schedule entry is loaded once for them.
__global__ void __launch_bounds__(kBridgeThreads)
sobol_bridge_kernel(const uint32_t* __restrict__ u_hi, const uint32_t* __restrict__ u_lo,
                    const int* __restrict__ row_ptr, const int2* __restrict__ entries,
                    float* __restrict__ out, int n_steps, int n_paths, float S0, float drift_dt,
                    float vol) {
  extern __shared__ float slots[];
  const int p0 = blockIdx.x * kLanes + threadIdx.x;
  float* z_of = slots + threadIdx.x;  // path j of slot k at z_of[(k kBridgePaths + j) threads]
  const size_t row = static_cast<size_t>(n_paths);
  const int n_blocks = n_paths / kLanes;
#pragma unroll
  for (int j = 0; j < kBridgePaths; ++j) out[p0 + j * kBridgeThreads] = S0;
  int e = __ldg(row_ptr);
  for (int t = 0; t < n_steps; ++t) {
    const int end = __ldg(row_ptr + t + 1);
    float w[kBridgePaths];
#pragma unroll
    for (int j = 0; j < kBridgePaths; ++j) w[j] = 0.0f;
    for (; e < end; ++e) {
      const int2 entry = __ldg(entries + e);
      const float b = __int_as_float(entry.y);
      float* slot = z_of + (entry.x & ((1 << kSlotBits) - 1)) * kBridgePaths * kBridgeThreads;
      if (entry.x < 0) {  // born here: the normals of Sobol dimension s
        const int s = (entry.x & 0x7FFFFFFF) >> kSlotBits;
#pragma unroll
        for (int j = 0; j < kBridgePaths; ++j) {
          const float z = sobol_normal(u_hi, u_lo, s, n_blocks, p0 + j * kBridgeThreads);
          slot[j * kBridgeThreads] = z;
          w[j] = w[j] + b * z;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kBridgePaths; ++j) w[j] = w[j] + b * slot[j * kBridgeThreads];
      }
    }
    const float drift = drift_dt * static_cast<float>(t + 1);
#pragma unroll
    for (int j = 0; j < kBridgePaths; ++j) {
      out[(static_cast<size_t>(t) + 1) * row + p0 + j * kBridgeThreads] =
          S0 * expf(drift + vol * w[j]);
    }
  }
}

// ---- a new seed's direction tables ------------------------------------
//
// Replaces: the host build of ops/sobol_pallas.py (_scramble ->
// _scrambled_numbers -> _table_factors -> _xor_tables) and its upload. It
// ports no TPU kernel: amcx builds the tables on the host too.
//
// scipy's qmc.Sobol(d, scramble=True, seed) draws its scramble from
// np.random.default_rng(seed) as rng.integers(0, 2, size, dtype=uint32):
// Lemire's method with a range of 2, which never rejects, so draw i is bit
// 31 of 32-bit word i of numpy's PCG64, the low half (i even) or the high
// half (i odd) of its 64-bit output i / 2 + 1. That output is the XSL-RR
// rotation rotr64(hi ^ lo, hi >> 58) of the 128-bit LCG state after i / 2 +
// 1 steps of s <- s M + inc (mod 2^128). The draws come in the engine's
// order: the shift (n_steps, bits), then the lower-triangular matrices
// (n_steps, bits, bits), every entry drawn, those above the diagonal
// included. So a thread reaches any draw from the seeded (state, inc) by
// jump-ahead (Brown's algorithm: O(log k) compositions of the affine step)
// and then steps.
//
// Block (d, y) rebuilds dimension d's scramble and writes its share of the
// tables: thread r <= bits reads row r of the draws (r = 0 the shift, r =
// 1 + p row p of L), one jump to the row's first word and bits / 2 steps;
// threads j < bits take scrambled number j as the parities of the rows of L
// AND the direction number (bit bits-1-p from row p, as _scramble); then
//   u_lo[d, i] = XOR of numbers[b] over the set bits b of i (b < 9),
//   u_hi[d, c] = shift XOR the XOR of numbers[9 + b] over the set bits b of c,
// every number left-aligned to 30 bits, u_hi's columns grid-strided over
// the y blocks. Bound: the stores of u_hi, 4 n_steps n_paths / 512 bytes
// (0.8 MB at 1M x 100, ~0.25 us at 3.35 TB/s), beside ~1.5k dependent
// integer operations of the longest draw thread; the launch sets the time.
constexpr int kTableThreads = 256;
constexpr int kMaxBits = 30;  // the numbers are left-aligned to 30 bits
constexpr int kTableColsPerBlock = 4096;  // u_hi columns a block (y) at least

struct U128 {
  uint64_t hi, lo;
};

__device__ __forceinline__ U128 mul128(U128 a, U128 b) {
  return {__umul64hi(a.lo, b.lo) + a.lo * b.hi + a.hi * b.lo, a.lo * b.lo};
}

__device__ __forceinline__ U128 add128(U128 a, U128 b) {
  const uint64_t lo = a.lo + b.lo;
  return {a.hi + b.hi + (lo < a.lo ? 1u : 0u), lo};
}

// numpy's PCG64 multiplier (PCG_DEFAULT_MULTIPLIER_128)
__device__ __forceinline__ U128 pcg_mult() {
  return {0x2360ED051FC65DA4ull, 0x4385DF649FCCF645ull};
}

// The state k LCG steps after s.
__device__ U128 pcg_advance(U128 s, U128 inc, uint64_t k) {
  U128 acc_mult = {0u, 1u}, acc_plus = {0u, 0u}, cur_mult = pcg_mult(), cur_plus = inc;
  for (; k != 0u; k >>= 1) {
    if (k & 1u) {
      acc_mult = mul128(acc_mult, cur_mult);
      acc_plus = add128(mul128(acc_plus, cur_mult), cur_plus);
    }
    cur_plus = mul128(add128(cur_mult, {0u, 1u}), cur_plus);
    cur_mult = mul128(cur_mult, cur_mult);
  }
  return add128(mul128(acc_mult, s), acc_plus);
}

__device__ __forceinline__ uint64_t pcg_output(U128 s) {
  const uint64_t x = s.hi ^ s.lo;
  const unsigned rot = static_cast<unsigned>(s.hi >> 58);
  return (x >> rot) | (x << ((64u - rot) & 63u));
}

// Row r of dimension d's draws as an integer: r = 0 the shift (draw b at
// bit b), r = 1 + p row p of L (draw q < p at bit bits-1-q, 1 at bit
// bits-1-p, the draws on and above the diagonal dropped).
__device__ uint32_t draw_row(U128 state, U128 inc, int d, int r, int n_steps, int bits) {
  const uint64_t first = r == 0 ? static_cast<uint64_t>(d) * bits
                                : static_cast<uint64_t>(n_steps) * bits +
                                      (static_cast<uint64_t>(d) * bits + (r - 1)) * bits;
  U128 s = pcg_advance(state, inc, first / 2 + 1);
  uint64_t word = pcg_output(s);
  uint32_t row = 0u;
  for (int b = 0; b < bits; ++b) {
    const uint64_t i = first + b;
    if (b > 0 && (i & 1u) == 0u) {
      s = add128(mul128(s, pcg_mult()), inc);
      word = pcg_output(s);
    }
    const uint32_t bit = static_cast<uint32_t>(word >> ((i & 1u) ? 63 : 31)) & 1u;
    if (r == 0) {
      row |= bit << b;
    } else if (b < r - 1) {
      row |= bit << (bits - 1 - b);
    }
  }
  return r == 0 ? row : row | (1u << (bits - r));
}

__global__ void __launch_bounds__(kTableThreads)
sobol_tables_kernel(const uint32_t* __restrict__ sv, U128 state, U128 inc, int n_steps,
                    int bits, int n_cols, uint32_t* __restrict__ u_hi,
                    uint32_t* __restrict__ u_lo) {
  __shared__ uint32_t rows[kMaxBits + 1];  // the shift, then the rows of L
  __shared__ uint32_t numbers[kMaxBits];
  const int d = blockIdx.x;
  const int t = threadIdx.x;
  const int align = kMaxBits - bits;
  if (t <= bits) rows[t] = draw_row(state, inc, d, t, n_steps, bits);
  __syncthreads();
  if (t < bits) {
    const uint32_t v = __ldg(sv + static_cast<size_t>(d) * bits + t);
    uint32_t x = 0u;
    for (int p = 0; p < bits; ++p) {
      x |= (static_cast<uint32_t>(__popc(rows[1 + p] & v)) & 1u) << (bits - 1 - p);
    }
    numbers[t] = x << align;
  }
  __syncthreads();
  if (blockIdx.y == 0) {
    for (int i = t; i < kLanes; i += kTableThreads) {
      uint32_t v = 0u;
      for (int m = i; m != 0; m &= m - 1) v ^= numbers[__ffs(m) - 1];
      u_lo[d * kLanes + i] = v;
    }
  }
  const uint32_t shift = rows[0] << align;
  uint32_t* hi = u_hi + static_cast<size_t>(d) * n_cols;
  for (int c = blockIdx.y * kTableThreads + t; c < n_cols; c += gridDim.y * kTableThreads) {
    uint32_t v = shift;
    for (int m = c; m != 0; m &= m - 1) v ^= numbers[kLowBits + __ffs(m) - 1];
    hi[c] = v;
  }
}

}  // namespace

// u_hi (n_steps, n_paths / 512) and u_lo (n_steps, 512) uint32 tables;
// row_ptr and entries: the bridge schedule (see sobol_bridge_kernel), or
// both null (increment mode); n_slots its live normals a path; out
// (n_steps+1, n_paths) f32. n_paths a multiple of 512. The increment mode
// reads u_lo and writes out in 16-byte accesses, the bridge mode reads
// entries in 8-byte ones: a base not aligned to them is refused. Returns a
// cudaError_t.
extern "C" int amcx_sobol_gbm_paths(const unsigned int* u_hi, const unsigned int* u_lo,
                                    const int* row_ptr, const int* entries, float* out,
                                    int n_steps, int n_paths, float S0, float drift_dt, float vol,
                                    int n_slots, void* stream) {
  const auto misaligned = [](const void* p, uintptr_t bytes) {
    return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) != 0;
  };
  if (n_steps < 1 || n_paths < kLanes || n_paths % kLanes != 0 ||
      (row_ptr == nullptr) != (entries == nullptr) || misaligned(u_hi, 4) ||
      misaligned(u_lo, row_ptr == nullptr ? 16 : 4) ||
      misaligned(out, row_ptr == nullptr ? 16 : 4) || misaligned(entries, 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row_ptr == nullptr) {
    sobol_increment_kernel<<<n_paths / kLanes, kIncThreads, 0, s>>>(u_hi, u_lo, out, n_steps,
                                                                   n_paths, S0, drift_dt, vol);
    return static_cast<int>(cudaGetLastError());
  }
  if (n_slots < 1 || n_slots > (1 << kSlotBits)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(n_slots) * kLanes * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sobol_bridge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sobol_bridge_kernel<<<n_paths / kLanes, kBridgeThreads, smem, s>>>(
      u_hi, u_lo, row_ptr, reinterpret_cast<const int2*>(entries), out, n_steps, n_paths, S0,
      drift_dt, vol);
  return static_cast<int>(cudaGetLastError());
}

// A new seed's tables: sv (n_steps, bits) uint32, scipy's unscrambled
// direction numbers; (state, inc) the seed's PCG64 state and increment
// (np.random.PCG64(seed).state), each as its high and low 64 bits; u_hi
// (n_steps, n_paths / 512) and u_lo (n_steps, 512) uint32 outputs. n_paths a
// multiple of 512 within the 2^bits points, 9 <= bits <= 30. Returns a
// cudaError_t.
extern "C" int amcx_sobol_tables(const unsigned int* sv, unsigned long long state_hi,
                                 unsigned long long state_lo, unsigned long long inc_hi,
                                 unsigned long long inc_lo, int n_steps, int bits, int n_paths,
                                 unsigned int* u_hi, unsigned int* u_lo, void* stream) {
  if (n_steps < 1 || bits < kLowBits || bits > kMaxBits || n_paths < kLanes ||
      n_paths % kLanes != 0 || (n_paths - 1) >> bits != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_cols = n_paths / kLanes;
  const dim3 grid(n_steps, (n_cols + kTableColsPerBlock - 1) / kTableColsPerBlock);
  sobol_tables_kernel<<<grid, kTableThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sv, U128{state_hi, state_lo}, U128{inc_hi, inc_lo}, n_steps, bits, n_cols, u_hi, u_lo);
  return static_cast<int>(cudaGetLastError());
}
