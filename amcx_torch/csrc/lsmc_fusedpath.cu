// Longstaff-Schwartz backward induction that regenerates its own paths: no
// (T+1, n) path array exists anywhere. One pricing per call of
// amcx_lsmc_fusedpath.
//
// Replaces: amcx/ops/lsmc_fusedpath.py::_fusedpath_kernel (via
// lsmc_price_fusedpath / _run_fusedpath).
//
// State per path: the bridge value W, the value carry V (time-T units, as in
// lsmc_mega.cu), the spot stage S_t of the current step and, with a barrier,
// the first-crossing step tau_B; four (or five) f32 planes of n_paths.
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
//            S_t = S0 exp(drift_dt t + sigma W_t) into the stage plane; the
//            P = k(k+1)/2 + k explicit-pair moments of lsmc_mega.cu, with
//            fit weights ITM and the knock gate (the all-paths fit is not
//            gated), summed in f64 into one partial row per block;
//     solve:  solve_kernel<K> of lsmc_common.cuh (fixed-order sum of the
//            rows, equilibrated ridge Cholesky, two refinements);
//     apply:  on the staged S_t: cont = max(fit, 0), ex = max(phi (S - K), 0),
//            exercise where ex > cont, the date is allowed (Bermudan row)
//            and the knock gate is open: V <- ex / c_t, cf <- ex, tau <- t.
//   final:   sum c_0 V and sum (c_0 V)^2, or with antithetic pairs the sum
//            of the squared pair means 0.5 (v_p + v_{p+n/2}).
// Replay (frozen coefficients): the regen kernel only regenerates, the solve
// is skipped, and the apply reads the given rows.
//
// The normals xi(t) of paths 4q .. 4q+3 are one Philox4x32-10 call with key
// (seed mod 2^32, seed >> 32) and counter (t, q, 1, 0), through
// philox_normals4_cos_sin; with antithetic, quad q of the second half draws
// the negated normals of quad q - n/8. A thread owns a quad of paths, so the
// planes move as float4.
//
// Bound on the H100: arithmetic. The work moves no path bytes (only the
// result planes and the stats rows are needed), while per path-step it
// draws a quarter of a Philox call and half a Box-Muller pair, runs the
// bridge and the exp, and forms the P f32 products and f64 sums of the
// moments. This simple design keeps the step loop on the host, as
// lsmc_mega.cu does (the per-step Gram is a grid-wide dependency: maturity +
// T x (regen + moments, one-block solve, apply) + 2 launches on one stream,
// no syncs), and so reads and writes W, V and the stage plane every step
// (12 B per path-step in, 8 B out at 1M paths, mostly from the 50 MB L2). A
// persistent kernel that keeps W and V on chip (8 MB at 1M paths fits the
// register files and shared memory of the 132 SMs) is later work.
//
// Numerics: as lsmc_mega.cu, moments in f64 rounded once, no float atomics,
// built with -fmad=false; every per-path operation is the plain version's
// (ops/lsmc_fusedpath.py) in its order, so the two agree to the bit.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "lsmc_common.cuh"
#include "philox.cuh"

namespace amcx {

// The pricing's switches and scalars; mirrors
// amcx_torch.ops.lsmc_fusedpath.FusedpathParams. Passed by value.
struct FusedpathParams {
  int n_steps;
  int n_paths;  // a multiple of 4 (of 8 with antithetic)
  int n_blocks;
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

// The normals of step t for the quad of paths 4q .. 4q+3.
__device__ __forceinline__ void draw4(const FusedpathParams& p, int t, int q, float (&z)[4]) {
  const int half_quads = p.n_paths / 8;
  const bool mirror = p.antithetic && q >= half_quads;
  const uint4 ctr = make_uint4(static_cast<uint32_t>(t),
                               static_cast<uint32_t>(mirror ? q - half_quads : q), 1u, 0u);
  philox_normals4_cos_sin(philox4x32_10(ctr, make_uint2(p.key_lo, p.key_hi)), z);
  if (mirror) {
#pragma unroll
    for (int j = 0; j < 4; ++j) z[j] = -z[j];
  }
}

__device__ __forceinline__ bool crosses(const FusedpathParams& p, float s) {
  return p.barrier_down ? s <= p.level : s >= p.level;
}

// Open where the knock state at step t lets the option pay or exercise.
__device__ __forceinline__ bool gate_open(const FusedpathParams& p, float tau_b, float t) {
  const bool knocked = tau_b <= t;
  return p.barrier_in ? knocked : !knocked;
}

__device__ __forceinline__ void load4(const float* plane, int q, float (&v)[4]) {
  const float4 x = reinterpret_cast<const float4*>(plane)[q];
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void store4(float* plane, int q, const float (&v)[4]) {
  reinterpret_cast<float4*>(plane)[q] = make_float4(v[0], v[1], v[2], v[3]);
}

__global__ void __launch_bounds__(kThreads)
maturity_kernel(const FusedpathParams p, float* __restrict__ V, float* __restrict__ W,
                float* __restrict__ TB, float* __restrict__ cf, float* __restrict__ tau) {
  const int n_quads = p.n_paths / 4;
  const float T = static_cast<float>(p.n_steps);
  for (int q = blockIdx.x * kThreads + threadIdx.x; q < n_quads; q += gridDim.x * kThreads) {
    float w[4], s[4], tb[4], z[4];
    if (p.barrier) {
      const float sqrt_dt = sqrtf(p.dt);
      const float never = static_cast<float>(p.n_steps + 1);
      const float tb0 = crosses(p, p.S0) ? 0.0f : never;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[j] = 0.0f;
        tb[j] = tb0;
      }
      for (int step = 1; step <= p.n_steps; ++step) {
        draw4(p, step, q, z);
        const float sf = static_cast<float>(step);
        const float drift = p.drift_dt * sf;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          w[j] = w[j] + sqrt_dt * z[j];
          s[j] = p.S0 * expf(drift + p.sigma * w[j]);
          if (crosses(p, s[j]) && sf < tb[j]) tb[j] = sf;
        }
      }
      store4(TB, q, tb);
    } else {
      draw4(p, p.n_steps, q, z);
      const float wT = sqrtf(p.dt * T);
      const float drift = p.drift_dt * T;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[j] = wT * z[j];
        s[j] = p.S0 * expf(drift + p.sigma * w[j]);
      }
    }
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = fmaxf(p.phi * (s[j] - p.strike), 0.0f);
      if (p.barrier && !gate_open(p, tb[j], T)) v[j] = 0.0f;
    }
    store4(W, q, w);
    store4(V, q, v);
    if (cf != nullptr) {
      const float taus[4] = {T, T, T, T};
      store4(cf, q, v);
      store4(tau, q, taus);
    }
  }
}

// Regenerate S_t into the stage plane and, unless replaying, sum the P
// moments of step t into this block's partial row.
template <int K>
__global__ void __launch_bounds__(kThreads)
regen_moments_kernel(const FusedpathParams p, const float* __restrict__ stats,
                     float* __restrict__ W, const float* __restrict__ V,
                     const float* __restrict__ TB, float* __restrict__ Sp,
                     double* __restrict__ partials, int t, int moments) {
  constexpr int P = Layout<K>::kMoments;
  constexpr int kPairs = Layout<K>::kPairs;
  const int T1 = p.n_steps + 1;
  const float mean = stats[t];
  const float inv_std = stats[T1 + t];
  const float c_t = stats[2 * T1 + t];
  const float tf = static_cast<float>(t);
  const float a = tf / (tf + 1.0f);
  const float bscale = sqrtf(p.dt * a);
  const float sqrt_dt = sqrtf(p.dt);
  const float drift = p.drift_dt * tf;
  const int n_quads = p.n_paths / 4;
  double acc[P];
#pragma unroll
  for (int m = 0; m < P; ++m) acc[m] = 0.0;
  for (int q = blockIdx.x * kThreads + threadIdx.x; q < n_quads; q += gridDim.x * kThreads) {
    float z[4], w[4], s[4];
    draw4(p, p.barrier ? t + 1 : t, q, z);
    load4(W, q, w);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[j] = p.barrier ? w[j] - sqrt_dt * z[j] : a * w[j] + bscale * z[j];
      s[j] = p.S0 * expf(drift + p.sigma * w[j]);
    }
    store4(W, q, w);
    store4(Sp, q, s);
    if (!moments) continue;
    float v[4], tb[4];
    load4(V, q, v);
    if (p.barrier && p.itm_weights) load4(TB, q, tb);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float y = c_t * v[j];
      const float xhat = (s[j] - mean) * inv_std;
      float wgt = 1.0f;
      if (p.itm_weights) {
        wgt = fmaxf(p.phi * (s[j] - p.strike), 0.0f) > 0.0f ? 1.0f : 0.0f;
        if (p.barrier && !gate_open(p, tb[j], tf)) wgt = 0.0f;
      }
      float cols[K];
      basis_cols<K>(xhat, p.basis, cols);
      const float yw = y * wgt;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const float ci = cols[i] * wgt;
#pragma unroll
        for (int b = i; b < K; ++b) acc[pair_index(K, i, b)] += static_cast<double>(ci * cols[b]);
      }
#pragma unroll
      for (int i = 0; i < K; ++i) acc[kPairs + i] += static_cast<double>(cols[i] * yw);
    }
  }
  if (moments) block_reduce_store<P>(acc, partials + static_cast<size_t>(blockIdx.x) * P);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const FusedpathParams p, const float* __restrict__ stats,
             const float* __restrict__ Sp, const float* __restrict__ TB, float* __restrict__ V,
             float* __restrict__ cf, float* __restrict__ tau, const float* __restrict__ coeffs_row,
             int t) {
  const int T1 = p.n_steps + 1;
  const float mean = stats[t];
  const float inv_std = stats[T1 + t];
  const float inv_c_t = stats[3 * T1 + t];
  const float tf = static_cast<float>(t);
  float coef[K];
#pragma unroll
  for (int a = 0; a < K; ++a) coef[a] = coeffs_row[a];
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < p.n_paths; i += gridDim.x * kThreads) {
    const float s = Sp[i];
    const float xhat = (s - mean) * inv_std;
    float cols[K];
    basis_cols<K>(xhat, p.basis, cols);
    float fitted = cols[0] * coef[0];
#pragma unroll
    for (int a = 1; a < K; ++a) fitted = fitted + cols[a] * coef[a];
    // max(fitted, 0) that keeps a NaN fit NaN, as torch.clamp_min does
    const float cont = fitted > 0.0f ? fitted : (fitted != fitted ? fitted : 0.0f);
    const float ex = fmaxf(p.phi * (s - p.strike), 0.0f);
    if (ex > cont && (!p.barrier || gate_open(p, TB[i], tf))) {
      V[i] = ex * inv_c_t;
      if (cf != nullptr) {
        cf[i] = ex;
        tau[i] = tf;
      }
    }
  }
}

// Per-block partials of sum c_0 V and of the squares (of the pair means
// with antithetic paths).
__global__ void __launch_bounds__(kThreads)
final_partials_kernel(const FusedpathParams p, const float* __restrict__ V,
                      const float* __restrict__ stats, double* __restrict__ partials) {
  const float c_0 = stats[2 * (p.n_steps + 1)];
  const int half = p.n_paths / 2;
  double acc[2] = {0.0, 0.0};
  if (p.antithetic) {
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < half; i += gridDim.x * kThreads) {
      const float va = c_0 * V[i];
      const float vb = c_0 * V[i + half];
      const float fold = 0.5f * (va + vb);
      acc[0] += static_cast<double>(va);
      acc[0] += static_cast<double>(vb);
      acc[1] += static_cast<double>(fold * fold);
    }
  } else {
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < p.n_paths; i += gridDim.x * kThreads) {
      const float v = c_0 * V[i];
      acc[0] += static_cast<double>(v);
      acc[1] += static_cast<double>(v * v);
    }
  }
  block_reduce_store<2>(acc, partials + static_cast<size_t>(blockIdx.x) * 2);
}

template <int K>
cudaError_t run_fusedpath(const FusedpathParams& p, const float* stats,
                          const unsigned char* allow, float* V, float* W, float* Sp, float* TB,
                          float* cf, float* tau, double* partials, float* coeffs, float* sums,
                          int replay, cudaStream_t stream) {
  const int nb = p.n_blocks;
  maturity_kernel<<<nb, kThreads, 0, stream>>>(p, V, W, TB, cf, tau);
  AMCX_LAUNCH_CHECK();
  for (int t = p.n_steps - 1; t >= 0; --t) {
    float* coeffs_row = coeffs + static_cast<size_t>(t) * K;
    regen_moments_kernel<K><<<nb, kThreads, 0, stream>>>(p, stats, W, V, TB, Sp, partials, t,
                                                         !replay);
    AMCX_LAUNCH_CHECK();
    if (!replay) {
      solve_kernel<K><<<1, kThreads, 0, stream>>>(partials, nb, K, p.rcond, coeffs_row);
      AMCX_LAUNCH_CHECK();
    }
    // European: the regression still runs (coefficient export) but the
    // carry is never touched; a Bermudan row skips the dates it forbids
    if (p.american && allow[t]) {
      apply_kernel<K><<<nb, kThreads, 0, stream>>>(p, stats, Sp, TB, V, cf, tau, coeffs_row, t);
      AMCX_LAUNCH_CHECK();
    }
  }
  final_partials_kernel<<<nb, kThreads, 0, stream>>>(p, V, stats, partials);
  AMCX_LAUNCH_CHECK();
  sum_partials_kernel<<<1, kThreads, 0, stream>>>(partials, nb, 2, sums);
  return cudaGetLastError();
}

}  // namespace

// params: the pricing (host memory); stats 4 (n_steps+1) f32 rows
// [mean_t, inv_std_t, c_t, 1/c_t]; allow (n_steps+1) host bytes, 1 where a
// date may exercise; V, W, Sp (n_paths) f32 scratch; TB (n_paths) scratch
// with a barrier, else null; cf, tau (n_paths) out, or both null; partials
// (n_blocks, max(P, 2)) f64 scratch; coeffs (n_steps+1, degree+1): out,
// zeroed by the caller, or with replay the frozen rows (maturity row 0);
// sums (2) out. Every plane 16-byte aligned. Returns a cudaError_t.
extern "C" int amcx_lsmc_fusedpath(const amcx::FusedpathParams* params, const float* stats,
                                   const unsigned char* allow, float* V, float* W, float* Sp,
                                   float* TB, float* cf, float* tau, double* partials,
                                   float* coeffs, float* sums, int degree, int replay,
                                   void* stream) {
  const amcx::FusedpathParams& p = *params;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int quantum = p.antithetic ? 8 : 4;
  if (p.n_steps < 1 || p.n_paths < quantum || p.n_paths % quantum != 0 || p.n_blocks < 1 ||
      p.basis < 0 || p.basis > 4 || (cf == nullptr) != (tau == nullptr) ||
      (p.barrier != 0) == (TB == nullptr) || allow == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define AMCX_FUSEDPATH_CASE(KK)                                                           \
  case KK:                                                                                \
    return static_cast<int>(run_fusedpath<KK>(p, stats, allow, V, W, Sp, TB, cf, tau,     \
                                              partials, coeffs, sums, replay, s));
  switch (degree + 1) {
    AMCX_FUSEDPATH_CASE(1)
    AMCX_FUSEDPATH_CASE(2)
    AMCX_FUSEDPATH_CASE(3)
    AMCX_FUSEDPATH_CASE(4)
    AMCX_FUSEDPATH_CASE(5)
    AMCX_FUSEDPATH_CASE(6)
    AMCX_FUSEDPATH_CASE(7)
    AMCX_FUSEDPATH_CASE(8)
    AMCX_FUSEDPATH_CASE(9)
    AMCX_FUSEDPATH_CASE(10)
    AMCX_FUSEDPATH_CASE(11)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef AMCX_FUSEDPATH_CASE
}
