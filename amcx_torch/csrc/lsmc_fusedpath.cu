// Longstaff-Schwartz backward induction that regenerates its own paths: no
// (T+1, n) path array exists anywhere. One cooperative launch per pricing
// (amcx_lsmc_fusedpath).
//
// Replaces: amcx/ops/lsmc_fusedpath.py::_fusedpath_kernel (via
// lsmc_price_fusedpath / _run_fusedpath).
//
// State per path: the bridge value W, the value carry V (time-T units, as in
// lsmc_mega.cu), the spot S of the two latest steps and, with a barrier, the
// first-crossing step tau_B.
//   maturity: vanilla W_T = sqrt(dt T) xi(T). Barrier: each thread walks its
//            quad of paths forward, W_s = W_{s-1} + sqrt(dt) xi(s) for
//            s = 1..T, and records tau_B = the first s with S_s across the
//            level (0 when S0 itself crosses, T + 1 for never); it lands on
//            W_T. V = max(phi (S_T - K), 0), masked by the knock gate at T;
//            cf = V and tau = T where asked.
//   per step t = T-1 .. 0:
//     regen + moments: W_t = t/(t+1) W_{t+1} + sqrt(dt t/(t+1)) xi(t)
//            (exactly 0 at t = 0), or with a barrier the backward difference
//            W_t = W_{t+1} - sqrt(dt) xi(t+1) of the walk's own increments;
//            S_t = S0 exp(drift_dt t + sigma W_t); the P = k(k+1)/2 + k
//            explicit-pair moments of lsmc_mega.cu, with fit weights ITM and
//            the knock gate (the all-paths fit is not gated), summed in f64
//            into one partial row per block;
//     solve:  the fixed-order sum of the rows (sum_partials' order) and the
//            equilibrated ridge Cholesky with two refinements of
//            lsmc_common.cuh;
//     apply:  on S_t: cont = max(fit, 0), ex = max(phi (S - K), 0), exercise
//            where ex > cont, the date is allowed (Bermudan row) and the
//            knock gate is open: V <- ex / c_t, cf <- ex, tau <- t.
//   final:   sum c_0 V and sum (c_0 V)^2, or with antithetic pairs the sum
//            of the squared pair means 0.5 (v_p + v_{p+n/2}).
// Replay (frozen coefficients): no moments and no solve; the apply reads the
// given rows.
//
// The normals xi(t) of paths 4q .. 4q+3 are one Philox4x32-10 call with key
// (seed mod 2^32, seed >> 32) and counter (t, q, 1, 0), through
// philox_normals4_cos_sin; with antithetic, quad q of the second half draws
// the negated normals of quad q - n/8.
//
// Bound on the H100: arithmetic. The work moves no path bytes (only the
// result planes and the stats rows are needed), while per path-step it
// draws a quarter of a Philox call and half a Box-Muller pair, runs the
// bridge and the exp, and forms the P f32 products and f64 sums of the
// moments; its design floor is the P f32 -> f64 conversions of those
// products a path-step. The per-step Gram is a grid-wide dependency.
//
// Design: one persistent launch a pricing instead of the maturity + T x
// (regen + moments, solve, apply) + 2 launches of a host loop. It is a
// cooperative launch (cudaLaunchCooperativeKernel) on a grid the wrapper
// sizes from the occupancy query, so every block is co-resident and may
// wait on another; a grid that cannot be co-resident is refused by the
// runtime and the error returned, never run another way.
// - Block 0 solves; blocks 1.. are workers. A worker thread owns units of
//   paths for the whole pricing (grid-stride: a quad, or with antithetic
//   the quad pair q, q + n/8, which share one Philox call and fold their
//   pair means locally) and keeps their W, V, S_t, S_{t+1} (and tau_B) in
//   shared-memory slots (p.chip_slots quads a thread; past them in global
//   spill planes: large n_paths, or a degree whose registers leave room
//   for fewer blocks).
// - Per step t a worker runs pass A, which needs no coefficients: it
//   regenerates W_t and S_t and sums the Gram head of step t's moments,
//   while block 0 solves step t+1. It then waits for step t+1's
//   coefficients (a generation word block 0 bumps), and pass B applies the
//   exercise of step t+1 on S_{t+1} and sums the right-hand side of step t
//   on the new V; the block's f64 row goes out and the block counts its
//   arrival.
// - Block 0 waits for every row of a step, sums them through L2 (__ldcg,
//   never a stale L1 line) in sum_partials' fixed order, solves on one
//   thread, writes the coefficient row and bumps the generation. No worker
//   writes its row again before that bump, so one row buffer serves.
// - The basis recurrences run on a quad's four paths with the basis switch
//   hoisted out of them (quad_cols), so the four chains interleave.
// Replay runs the same passes with no moments and no waits; the final two
// sums are one more row a worker. Built, timed on the card and slower
// (PERF.md): a grid barrier a step after which every block sums the rows
// and solves (264 blocks reading the same L2 lines), block 0 solving
// between two grid barriers, and the last block to arrive solving while
// the others wait.
//
// Numerics: as lsmc_mega.cu, moments in f64 rounded once, no float atomics,
// built with -fmad=false; every per-path operation is the plain version's
// (ops/lsmc_fusedpath.py) in its order, so the two agree to the bit.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "lsmc_coop.cuh"
#include "philox.cuh"

namespace amcx {

// The pricing's switches and scalars; mirrors
// amcx_torch.ops.lsmc_fusedpath.FusedpathParams. Passed by value.
struct FusedpathParams {
  int n_steps;
  int n_paths;  // a multiple of 4 (of 8 with antithetic)
  int n_blocks;  // the cooperative grid
  int chip_slots;  // quads a thread keeps in shared memory
  int basis;
  int american;
  int itm_weights;
  int antithetic;
  int barrier;  // 0: vanilla
  int barrier_down;
  int barrier_in;
  unsigned int key_lo;
  unsigned int key_hi;
  float strike;
  float phi;
  float rcond;
  float sigma;
  float drift_dt;  // (r - q - sigma^2 / 2) dt, rounded once to f32
  float dt;
  float S0;
  float level;  // the barrier
};

}  // namespace amcx

namespace {

using namespace amcx;

// The normals of step t for the quad of paths 4q .. 4q+3 (q < n/8 with
// antithetic: the mirror quad negates them).
__device__ __forceinline__ void draw4(const FusedpathParams& p, int t, int q, float (&z)[4]) {
  const uint4 ctr = make_uint4(static_cast<uint32_t>(t), static_cast<uint32_t>(q), 1u, 0u);
  philox_normals4_cos_sin(philox4x32_10(ctr, make_uint2(p.key_lo, p.key_hi)), z);
}

__device__ __forceinline__ bool crosses(const FusedpathParams& p, float s) {
  return p.barrier_down ? s <= p.level : s >= p.level;
}

// Open where the knock state at step t lets the option pay or exercise.
__device__ __forceinline__ bool gate_open(const FusedpathParams& p, float tau_b, float t) {
  const bool knocked = tau_b <= t;
  return p.barrier_in ? knocked : !knocked;
}

__device__ __forceinline__ float spot(const FusedpathParams& p, float w, float tf) {
  return p.S0 * expf(p.drift_dt * tf + p.sigma * w);
}

// Maturity of one unit (qpu quads, the second the antithetic mirror).
__device__ __forceinline__ void maturity(const FusedpathParams& p, int u, int qpu,
                                         float (&w)[2][4], float (&v)[2][4], float (&tb)[2][4]) {
  const float T = static_cast<float>(p.n_steps);
  float z[4];
  if (p.barrier) {
    const float sqrt_dt = sqrtf(p.dt);
    const float never = static_cast<float>(p.n_steps + 1);
    const float tb0 = crosses(p, p.S0) ? 0.0f : never;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[h][j] = 0.0f;
        tb[h][j] = tb0;
      }
    }
    for (int step = 1; step <= p.n_steps; ++step) {
      draw4(p, step, u, z);
      const float sf = static_cast<float>(step);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h >= qpu) break;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          w[h][j] = w[h][j] + sqrt_dt * (h ? -z[j] : z[j]);
          const float s = spot(p, w[h][j], sf);
          if (crosses(p, s) && sf < tb[h][j]) tb[h][j] = sf;
        }
      }
    }
  } else {
    draw4(p, p.n_steps, u, z);
    const float wT = sqrtf(p.dt * T);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 4; ++j) w[h][j] = wT * (h ? -z[j] : z[j]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float s = spot(p, w[h][j], T);
      v[h][j] = fmaxf(p.phi * (s - p.strike), 0.0f);
      if (p.barrier && !gate_open(p, tb[h][j], T)) v[h][j] = 0.0f;
    }
  }
}

// The state planes of a quad slot, [W | V | S even | S odd | tau_B]: S_t
// lives in plane 2 + (t & 1), so S_{t+1} survives the pass that makes S_t.
constexpr int kW = 0, kV = 1, kS = 2, kTB = 4;

// Where plane `plane` of quad slot k of this thread lies (quad_slot: shared
// memory below chip_slots, else the global spill planes at quad q).
__device__ __forceinline__ float4* state(const FusedpathParams& p, float4* chip, float* spill,
                                         int plane, int k, int q) {
  return quad_slot(chip, spill, plane, k, q, p.chip_slots, static_cast<size_t>(p.n_paths));
}

// The fit's basis columns and weights of a quad's spots of step t.
template <int K>
__device__ __forceinline__ void fit_quad(const FusedpathParams& p, const float (&s)[4],
                                         const float (&tb)[4], float tf, float mean,
                                         float inv_std, float (&cols)[4][K], float (&wgt)[4]) {
  float x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = (s[j] - mean) * inv_std;
  quad_cols<K>(p.basis, x, cols);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wgt[j] = 1.0f;
    if (p.itm_weights) {
      wgt[j] = fmaxf(p.phi * (s[j] - p.strike), 0.0f) > 0.0f ? 1.0f : 0.0f;
      if (p.barrier && !gate_open(p, tb[j], tf)) wgt[j] = 0.0f;
    }
  }
}

// The pricing (the header's design): block 0 solves, blocks 1.. run the
// passes A and B of each step.
template <int K>
__global__ void __launch_bounds__(kThreads, K <= 6 ? 2 : 1)
fusedpath_kernel(const __grid_constant__ FusedpathParams p, const float* __restrict__ stats,
                 const unsigned char* __restrict__ allow, float* spill, float* __restrict__ cf,
                 float* __restrict__ tau, double* partials, float* coeffs,
                 float* __restrict__ sums, int replay) {
  constexpr int P = Layout<K>::kMoments;
  constexpr int kPairs = Layout<K>::kPairs;
  extern __shared__ float4 chip[];
  __shared__ float packed[P];
  __shared__ float coef[K];
  const int T = p.n_steps;
  const int T1 = T + 1;
  unsigned* arrivals = reinterpret_cast<unsigned*>(partials);
  const volatile unsigned* generation = arrivals + 1;
  double* rows = partials + 1;
  const int n_workers = gridDim.x - 1;

  if (blockIdx.x == 0) {
    solver_block<K>(arrivals, rows, n_workers, T, !replay, p.rcond, coeffs, sums, packed, coef);
    return;
  }

  const int qpu = p.antithetic ? 2 : 1;
  const int n_units = p.n_paths / (4 * qpu);
  const int half_quads = p.n_paths / 8;
  const int first = (blockIdx.x - 1) * kThreads + threadIdx.x;
  const int stride = n_workers * kThreads;
  const float sqrt_dt = sqrtf(p.dt);
  double* row = rows + static_cast<size_t>(blockIdx.x - 1) * P;

  // step t = T-1 .. 0, then t = -1 for the final sums
  for (int t = T - 1; t >= -1; --t) {
    const int a = t + 1;  // the step whose exercise pass B applies
    const bool at_maturity = a == T;
    const bool moments = t >= 0 && !replay;
    const int tc = t < 0 ? 0 : t;
    const float tf = static_cast<float>(tc), fa = static_cast<float>(a);
    const float mean = stats[tc], inv_std = stats[T1 + tc], c_t = stats[2 * T1 + tc];
    const float ratio = tf / (tf + 1.0f);
    const float bscale = sqrtf(p.dt * ratio);
    double acc[P];
#pragma unroll
    for (int m = 0; m < P; ++m) acc[m] = 0.0;

    // pass A: maturity (t = T-1) or the stored W_{t+1}; regenerate W_t,
    // S_t; the Gram head of step t
    for (int u = first, k = 0; t >= 0 && u < n_units; u += stride, k += qpu) {
      float w[2][4], v[2][4], tb[2][4], z[4];
      if (at_maturity) maturity(p, u, qpu, w, v, tb);
      draw4(p, p.barrier ? t + 1 : t, u, z);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h >= qpu) break;
        const int q = u + h * half_quads;
        if (at_maturity) {
          store4(state(p, chip, spill, kV, k + h, q), v[h]);
          if (p.barrier) store4(state(p, chip, spill, kTB, k + h, q), tb[h]);
          if (cf != nullptr) {
            const float taus[4] = {fa, fa, fa, fa};
            store4(reinterpret_cast<float4*>(cf) + q, v[h]);
            store4(reinterpret_cast<float4*>(tau) + q, taus);
          }
        } else {
          load4(state(p, chip, spill, kW, k + h, q), w[h]);
          if (p.barrier && moments) load4(state(p, chip, spill, kTB, k + h, q), tb[h]);
        }
        float s[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float zj = h ? -z[j] : z[j];
          w[h][j] = p.barrier ? w[h][j] - sqrt_dt * zj : ratio * w[h][j] + bscale * zj;
          s[j] = spot(p, w[h][j], tf);
        }
        if (moments) {
          float cols[4][K], wgt[4];
          fit_quad<K>(p, s, tb[h], tf, mean, inv_std, cols, wgt);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int i = 0; i < K; ++i) {
              const float ci = cols[j][i] * wgt[j];
#pragma unroll
              for (int b = i; b < K; ++b) {
                acc[pair_index(K, i, b)] += static_cast<double>(ci * cols[j][b]);
              }
            }
          }
        }
        store4(state(p, chip, spill, kW, k + h, q), w[h]);
        store4(state(p, chip, spill, kS + (t & 1), k + h, q), s);
      }
    }

    // the coefficients of step a: block 0 has solved it (and so read every
    // row of step a) before this block's row is written again
    const bool apply = !at_maturity && p.american && (allow == nullptr || allow[a]);
    float cf_row[K];
    if (!at_maturity && !replay) {
      wait_for(generation, static_cast<unsigned>(T - a));
      if (apply && threadIdx.x < K) coef[threadIdx.x] = __ldcg(coeffs + a * K + threadIdx.x);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < K; ++i) cf_row[i] = apply ? (replay ? coeffs[a * K + i] : coef[i]) : 0.0f;
    const float mean_a = stats[a], inv_std_a = stats[T1 + a], inv_c_a = stats[3 * T1 + a];
    const float c_0 = stats[2 * T1];

    // pass B: the exercise of step a on S_a, then the right-hand side of
    // step t on the new V (or, at t = -1, the final sums)
    for (int u = first, k = 0; u < n_units && (apply || moments || t < 0); u += stride,
                                                                          k += qpu) {
      float v[2][4], tb[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h >= qpu) break;
        const int q = u + h * half_quads;
        load4(state(p, chip, spill, kV, k + h, q), v[h]);
        if (p.barrier && (apply || moments)) load4(state(p, chip, spill, kTB, k + h, q), tb[h]);
        if (apply) {
          float s[4], x[4], cols[4][K];
          load4(state(p, chip, spill, kS + (a & 1), k + h, q), s);
#pragma unroll
          for (int j = 0; j < 4; ++j) x[j] = (s[j] - mean_a) * inv_std_a;
          quad_cols<K>(p.basis, x, cols);
          bool exercise[4];
          float ex[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float fitted = cols[j][0] * cf_row[0];
#pragma unroll
            for (int i = 1; i < K; ++i) fitted = fitted + cols[j][i] * cf_row[i];
            // max(fitted, 0) that keeps a NaN fit NaN, as torch.clamp_min does
            const float cont = fitted > 0.0f ? fitted : (fitted != fitted ? fitted : 0.0f);
            ex[j] = fmaxf(p.phi * (s[j] - p.strike), 0.0f);
            exercise[j] = ex[j] > cont && (!p.barrier || gate_open(p, tb[h][j], fa));
            v[h][j] = exercise[j] ? ex[j] * inv_c_a : v[h][j];
          }
          store4(state(p, chip, spill, kV, k + h, q), v[h]);
          if (cf != nullptr) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (!exercise[j]) continue;
              cf[4 * static_cast<size_t>(q) + j] = ex[j];
              tau[4 * static_cast<size_t>(q) + j] = fa;
            }
          }
        }
        if (moments) {
          float s[4], cols[4][K], wgt[4];
          load4(state(p, chip, spill, kS + (t & 1), k + h, q), s);
          fit_quad<K>(p, s, tb[h], tf, mean, inv_std, cols, wgt);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float yw = c_t * v[h][j] * wgt[j];
#pragma unroll
            for (int i = 0; i < K; ++i) acc[kPairs + i] += static_cast<double>(cols[j][i] * yw);
          }
        }
      }
      if (t >= 0) continue;
      if (p.antithetic) {  // the final sums
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float va = c_0 * v[0][j];
          const float vb = c_0 * v[1][j];
          const float fold = 0.5f * (va + vb);
          acc[0] += static_cast<double>(va);
          acc[0] += static_cast<double>(vb);
          acc[1] += static_cast<double>(fold * fold);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x = c_0 * v[0][j];
          acc[0] += static_cast<double>(x);
          acc[1] += static_cast<double>(x * x);
        }
      }
    }

    if (t < 0) {
      double fin[2] = {acc[0], acc[1]};
      block_reduce_store<2>(fin, rows + static_cast<size_t>(blockIdx.x - 1) * 2);
      arrive(arrivals);
    } else if (moments) {
      block_reduce_store<P>(acc, row);
      arrive(arrivals);
    }
  }
}

template <int K>
cudaError_t occupancy(int smem, int* blocks_per_sm) {
  const auto kernel = fusedpath_kernel<K>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int device = 0, optin = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return err;
  if (static_cast<size_t>(smem) + attr.sharedSizeBytes > static_cast<size_t>(optin)) {
    *blocks_per_sm = 0;
    return cudaSuccess;
  }
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, smem);
}

template <int K>
cudaError_t launch(const FusedpathParams& p, const float* stats, const unsigned char* allow,
                   float* spill, float* cf, float* tau, double* partials, float* coeffs,
                   float* sums, int replay, size_t smem, cudaStream_t stream) {
  const auto kernel = fusedpath_kernel<K>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  void* args[] = {const_cast<FusedpathParams*>(&p), &stats, &allow, &spill, &cf, &tau,
                  &partials, &coeffs, &sums, &replay};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(p.n_blocks),
                                     dim3(kThreads), args, smem, stream);
}

// Quad slots a worker thread needs: its units times the quads a unit.
int slots_needed(const FusedpathParams& p) {
  const int qpu = p.antithetic ? 2 : 1;
  const long long threads = static_cast<long long>(p.n_blocks - 1) * kThreads;
  const long long units = p.n_paths / (4 * qpu);
  return static_cast<int>((units + threads - 1) / threads) * qpu;
}

}  // namespace

#define AMCX_FUSEDPATH_DISPATCH(CALL)        \
  switch (degree + 1) {                      \
    case 1: return static_cast<int>(CALL(1)); \
    case 2: return static_cast<int>(CALL(2)); \
    case 3: return static_cast<int>(CALL(3)); \
    case 4: return static_cast<int>(CALL(4)); \
    case 5: return static_cast<int>(CALL(5)); \
    case 6: return static_cast<int>(CALL(6)); \
    case 7: return static_cast<int>(CALL(7)); \
    case 8: return static_cast<int>(CALL(8)); \
    case 9: return static_cast<int>(CALL(9)); \
    case 10: return static_cast<int>(CALL(10)); \
    case 11: return static_cast<int>(CALL(11)); \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

// blocks_per_sm: how many blocks of the degree's kernel with smem bytes of
// dynamic shared memory one SM holds at once (0 when smem exceeds a block's
// limit). Returns a cudaError_t.
extern "C" int amcx_lsmc_fusedpath_occupancy(int degree, int smem, int* blocks_per_sm) {
  if (smem < 0 || blocks_per_sm == nullptr) return static_cast<int>(cudaErrorInvalidValue);
#define AMCX_OCCUPANCY(KK) occupancy<KK>(smem, blocks_per_sm)
  AMCX_FUSEDPATH_DISPATCH(AMCX_OCCUPANCY)
#undef AMCX_OCCUPANCY
}

// params: the pricing and its grid (host memory; n_blocks >= 2 blocks of
// kThreads, all co-resident, else the launch is refused); stats 4
// (n_steps+1) f32 rows [mean_t, inv_std_t, c_t, 1/c_t]; allow (n_steps+1)
// device bytes, 1 where a date may exercise, or null for every date; spill
// (4 or, with a barrier, 5 planes of n_paths f32: W, V, S even, S odd,
// tau_B) scratch for the quads past chip_slots, null where every quad stays
// in shared memory; cf, tau (n_paths) out, or both null; partials: the
// arrival and generation words (the first 8 bytes, zeroed by the caller),
// then (n_blocks - 1, max(P, 2)) f64 rows of scratch; coeffs
// (n_steps+1, degree+1): out, zeroed by the caller, or with replay the
// frozen rows (maturity row 0); sums (2) out. Every plane 16-byte aligned.
// Returns a cudaError_t.
extern "C" int amcx_lsmc_fusedpath(const amcx::FusedpathParams* params, const float* stats,
                                   const unsigned char* allow, float* spill, float* cf,
                                   float* tau, double* partials, float* coeffs, float* sums,
                                   int degree, int replay, void* stream) {
  const amcx::FusedpathParams& p = *params;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int quantum = p.antithetic ? 8 : 4;
  if (p.n_steps < 1 || p.n_paths < quantum || p.n_paths % quantum != 0 || p.n_blocks < 2 ||
      p.chip_slots < 0 || p.basis < 0 || p.basis > 4 || (cf == nullptr) != (tau == nullptr) ||
      (slots_needed(p) > p.chip_slots && spill == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(p.chip_slots) * kThreads * sizeof(float4) *
                      (p.barrier ? 5 : 4);
#define AMCX_LAUNCH(KK) \
  launch<KK>(p, stats, allow, spill, cf, tau, partials, coeffs, sums, replay, smem, s)
  AMCX_FUSEDPATH_DISPATCH(AMCX_LAUNCH)
#undef AMCX_LAUNCH
}

#undef AMCX_FUSEDPATH_DISPATCH
