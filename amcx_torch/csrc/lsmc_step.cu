// One backward step of the fused LSMC engine as two passes over the step's
// path rows: the regression moments (amcx_step_moments) and the exercise
// apply (amcx_step_apply). The k x k solve between them stays in torch
// (amcx_torch.regress.pinv_solve), as amcx leaves it to XLA.
//
// Replaces: amcx/ops/lsmc_pallas.py::_moments_kernel (via step_moments) and
// amcx/ops/lsmc_pallas.py::_apply_kernel (via step_apply).
//
// Moments, per path i of row t (time-major, any n_paths):
//   y = cf * expf(-rdt * (tau - t)), x = (S - mean_t) * inv_std_t, the basis
//   by recurrence, w = 1[phi(S-K) > 0] * knocked (forced to 1 where the
//   step's use_w flag is 0; no w at all for all-paths fits), and the
//   P = k(k+1)/2 + k explicit-pair moments sum w B_a B_b (a <= b) and
//   sum w y B_a, accumulated in f64 per thread and rounded once to f32.
// Apply, per path: cont = max(sum c_a B_a(x), 0) (a NaN fit stays NaN);
//   where ex = max(phi(S-K), 0) > cont, the path is knocked and the step is
//   an exercise date, cf <- ex and tau <- t IN PLACE (amcx donates these
//   buffers); with a surface row, cont is written to it.
//
// Bound on the H100: device-memory traffic. Per step the moments read S_t,
// cf and tau (and the 1-byte knocked row); the apply reads S_t (and the
// knocked row) again, never cf or tau, and writes cf and tau only where a
// path exercises, plus the 4-byte surface row when asked: 16-22 B per
// path-step besides the exercised paths' 8 B, ~1.7-2.3 GB per 1M x 100
// induction, ~0.5-0.7 ms at 3.35 TB/s; at 1M paths a step's rows (12-16 MB)
// mostly stay in the 50 MB L2 between the two passes. The per-step Gram is
// a grid-wide dependency and the solve runs on the host's stream between
// the passes, so launches and the solve's small torch ops bound the step,
// not DRAM. Inside the moments the floor is the P = 20 f32 products a path,
// each widened to f64 (16 a clock a SM: ~5 us at 1M paths).
// Moments design (the first one took a 1024-block grid of one path a
// thread and a second one-block launch for the 1024 partial rows, 21 us a
// call):
// one launch on a persistent grid (the wrapper's n_blocks, 2 a SM); a
// thread takes 4 consecutive paths at a time with 16-byte loads of S_t, cf
// and tau and a 4-byte load of the knocked bytes where those rows are so
// aligned (one load a path otherwise; the tail past n_paths is masked); P
// f64 sums in registers; a fixed-order block reduction (warp shuffles,
// then warps in order) into a per-block partial row; then the block that
// takes the last ticket (an integer counter, the rows fenced before it)
// sums the rows in a fixed order into the packed (P,) f32 vector and the
// counter wraps back to 0 for the next call. Loading the next group a loop
// ahead measured no faster: the sums run at ~6 conversions a clock a SM,
// as in the other moments kernels (PERF.md). No float atomics, so two runs
// give identical bits, and with -fmad=false the kernel and its plain
// version (ops/lsmc_pallas.py) agree to the bit on the card.
// Apply design (the first one ran one path a thread with 4-byte loads on a
// 1,024-block grid, the basis switch inside the path loop, and read every
// path on a step with nothing to write: 4.9 us a call at 1M paths against
// its 2.73 us of bytes): a step that is no exercise date (or asks for no
// select) and takes no surface row returns before any path is read; else a
// persistent grid (the wrapper's n_blocks: up to 8 blocks of 256 a SM)
// takes 4 consecutive paths a thread, with a 16-byte load of S_t, a 4-byte
// load of the knocked bytes and a 16-byte store of the surface row where
// those rows are so aligned (one access a path otherwise; the tail past
// n_paths is masked); the basis is a template argument, so no switch runs
// inside the path loop; cf and tau stay masked scalar stores, written only
// where a path exercises. The fit keeps the plain version's order (c_0 B_0,
// then + c_a B_a) and its NaN-keeping clamp, so the same bits. Two C
// entries launch it: amcx_step_apply on one step's rows (the public
// wrapper) and amcx_step_apply_planes on a plan of whole (n_steps+1,
// n_paths) planes that a fused loop validates once, given only t and the
// coefficients each step. The per-step scalars (mean_t, inv_std_t, use_w_t,
// allow_t) come from a device array, so the host loop never reads a value
// back. The TPU's (rows, 512) layout and its n_paths % 4096 rule are
// dropped.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "lsmc_common.cuh"

namespace {

using namespace amcx;

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// The knocked bytes of paths i0 .. i0 + 3: one 4-byte load where vec (the
// row 4-byte aligned) and all four exist, else one load a path (open past
// n_here).
__device__ __forceinline__ void load_flags4(const uint8_t* __restrict__ knocked, int i0,
                                            int n_here, bool vec, bool (&open)[4]) {
  if (vec && n_here == 4) {
    const uchar4 q = *reinterpret_cast<const uchar4*>(knocked + i0);
    open[0] = q.x != 0;
    open[1] = q.y != 0;
    open[2] = q.z != 0;
    open[3] = q.w != 0;
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) open[e] = e >= n_here || knocked[i0 + e] != 0;
}

// x into paths i0 .. i0 + 3 of a row: one 16-byte store where vec and all
// four exist, else one store a path up to n_here.
__device__ __forceinline__ void store_row4(float* __restrict__ row, int i0, int n_here, bool vec,
                                           const float (&x)[4]) {
  if (vec && n_here == 4) {
    *reinterpret_cast<float4*>(row + i0) = make_float4(x[0], x[1], x[2], x[3]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (e < n_here) row[i0 + e] = x[e];
  }
}

// stats: four (n_steps+1) f32 rows [mean_t, inv_std_t, use_w_t, allow_t].
// scratch: the ticket (the first 8 bytes, 0 between calls), then the
// gridDim.x partial rows of P f64.
template <int K>
__global__ void __launch_bounds__(kThreads)
step_moments_kernel(const float* __restrict__ S, const float* __restrict__ cf,
                    const float* __restrict__ tau, const uint8_t* __restrict__ knocked,
                    const float* __restrict__ stats, double* scratch, float* __restrict__ packed,
                    int t, int n_steps, int n_paths, float rdt, float strike, float phi,
                    int basis, int itm_weights, int vec) {
  constexpr int P = Layout<K>::kMoments;
  constexpr int kPairs = Layout<K>::kPairs;
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch);
  double* partials = scratch + 1;
  const int T1 = n_steps + 1;
  const float mean = stats[t];
  const float inv_std = stats[T1 + t];
  const bool use_w = itm_weights && stats[2 * T1 + t] > 0.0f;
  const float tf = static_cast<float>(t);
  double acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = 0.0;
  const int n_groups = (n_paths + 3) / 4;
  for (int g = blockIdx.x * kThreads + threadIdx.x; g < n_groups; g += gridDim.x * kThreads) {
    const int i0 = 4 * g;
    const int n_here = min(4, n_paths - i0);
    float s4[4], cf4[4], tau4[4];
    load_row4(S, i0, n_here, vec, s4);
    load_row4(cf, i0, n_here, vec, cf4);
    load_row4(tau, i0, n_here, vec, tau4);
    bool open[4] = {true, true, true, true};
    if (use_w && knocked != nullptr) load_flags4(knocked, i0, n_here, vec, open);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e >= n_here) break;
      const float s = s4[e];
      const float y = cf4[e] * expf(-rdt * (tau4[e] - tf));
      const float xhat = (s - mean) * inv_std;
      // w is 0 or 1, so multiplying by it is exact: the all-paths fit (w =
      // 1) rounds as the plain version's unweighted products
      float w = 1.0f;
      if (use_w) w = fmaxf(phi * (s - strike), 0.0f) > 0.0f && open[e] ? 1.0f : 0.0f;
      float cols[K];
      basis_cols<K>(xhat, basis, cols);
      const float yw = y * w;
#pragma unroll
      for (int a = 0; a < K; ++a) {
        const float ca = cols[a] * w;
#pragma unroll
        for (int b = a; b < K; ++b) acc[pair_index(K, a, b)] += static_cast<double>(ca * cols[b]);
      }
#pragma unroll
      for (int a = 0; a < K; ++a) acc[kPairs + a] += static_cast<double>(cols[a] * yw);
    }
  }
  block_reduce_store<P>(acc, partials + static_cast<size_t>(blockIdx.x) * P);
  // the block that takes the last ticket sums every row; the ticket wraps to 0
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  sum_partials_coherent(partials, gridDim.x, P, packed);
}

// Step t's exercise and surface row: 4 paths a thread (the header's
// design); vec: S_t and the surface row 16-byte aligned, the knocked row
// 4-byte aligned.
template <int K, int kBasis>
__global__ void __launch_bounds__(kThreads)
step_apply_kernel(const float* __restrict__ S, float* __restrict__ cf, float* __restrict__ tau,
                  const uint8_t* __restrict__ knocked, const float* __restrict__ stats,
                  const float* __restrict__ coeffs, float* __restrict__ surface_row, int t,
                  int n_steps, int n_paths, float strike, float phi, int select, int vec) {
  const int T1 = n_steps + 1;
  const bool exercise = select && stats[3 * T1 + t] > 0.0f;
  if (!exercise && surface_row == nullptr) return;  // nothing to write on this step
  const float mean = stats[t];
  const float inv_std = stats[T1 + t];
  const float tf = static_cast<float>(t);
  float coef[K];
#pragma unroll
  for (int a = 0; a < K; ++a) coef[a] = coeffs[a];
  const int n_groups = (n_paths + 3) / 4;
  for (int g = blockIdx.x * kThreads + threadIdx.x; g < n_groups; g += gridDim.x * kThreads) {
    const int i0 = 4 * g;
    const int n_here = min(4, n_paths - i0);
    float s4[4];
    load_row4(S, i0, n_here, vec, s4);
    bool open[4] = {true, true, true, true};
    if (exercise && knocked != nullptr) load_flags4(knocked, i0, n_here, vec, open);
    float cont[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float cols[K];
      basis_cols<K>((s4[e] - mean) * inv_std, kBasis, cols);
      float fitted = cols[0] * coef[0];
#pragma unroll
      for (int a = 1; a < K; ++a) fitted = fitted + cols[a] * coef[a];
      // max(fitted, 0) that keeps a NaN fit NaN (then no path exercises),
      // as torch.clamp_min and jnp.maximum do; fmaxf would return 0
      cont[e] = fitted > 0.0f ? fitted : (fitted != fitted ? fitted : 0.0f);
    }
    if (surface_row != nullptr) store_row4(surface_row, i0, n_here, vec, cont);
    if (!exercise) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float ex = fmaxf(phi * (s4[e] - strike), 0.0f);
      // ex > cont implies ex > 0 (cont >= 0): the ITM clause is implied
      if (e < n_here && ex > cont[e] && open[e]) {
        cf[i0 + e] = ex;
        tau[i0 + e] = tf;
      }
    }
  }
}

template <int K>
cudaError_t run_moments(const float* S, const float* cf, const float* tau, const uint8_t* knocked,
                        const float* stats, double* scratch, float* packed, int t, int n_steps,
                        int n_paths, int n_blocks, float rdt, float strike, float phi, int basis,
                        int itm_weights, cudaStream_t stream) {
  const int vec = aligned(S, 16) && aligned(cf, 16) && aligned(tau, 16) &&
                  (knocked == nullptr || aligned(knocked, 4));
  step_moments_kernel<K><<<n_blocks, kThreads, 0, stream>>>(
      S, cf, tau, knocked, stats, scratch, packed, t, n_steps, n_paths, rdt, strike, phi, basis,
      itm_weights, vec);
  return cudaGetLastError();
}

template <int K, int kBasis>
cudaError_t launch_apply(const float* S, float* cf, float* tau, const uint8_t* knocked,
                         const float* stats, const float* coeffs, float* surface_row, int t,
                         int n_steps, int n_paths, int n_blocks, float strike, float phi,
                         int select, int vec, cudaStream_t stream) {
  step_apply_kernel<K, kBasis><<<n_blocks, kThreads, 0, stream>>>(
      S, cf, tau, knocked, stats, coeffs, surface_row, t, n_steps, n_paths, strike, phi, select,
      vec);
  return cudaGetLastError();
}

// The vector accesses are decided here from the rows' bases, each launch.
template <int K>
cudaError_t run_apply(const float* S, float* cf, float* tau, const uint8_t* knocked,
                      const float* stats, const float* coeffs, float* surface_row, int t,
                      int n_steps, int n_paths, int n_blocks, float strike, float phi, int basis,
                      int select, cudaStream_t stream) {
  const int vec = aligned(S, 16) && (surface_row == nullptr || aligned(surface_row, 16)) &&
                  (knocked == nullptr || aligned(knocked, 4));
#define AMCX_APPLY_ARGS                                                                       \
  S, cf, tau, knocked, stats, coeffs, surface_row, t, n_steps, n_paths, n_blocks, strike, phi, \
      select, vec, stream
  switch (basis) {
    case kPower:
      return launch_apply<K, kPower>(AMCX_APPLY_ARGS);
    case kChebyshev:
      return launch_apply<K, kChebyshev>(AMCX_APPLY_ARGS);
    case kLegendre:
      return launch_apply<K, kLegendre>(AMCX_APPLY_ARGS);
    case kLaguerre:
      return launch_apply<K, kLaguerre>(AMCX_APPLY_ARGS);
    default:
      return launch_apply<K, kHermite>(AMCX_APPLY_ARGS);
  }
#undef AMCX_APPLY_ARGS
}

bool bad_args(int t, int n_steps, int n_paths, int n_blocks, int basis) {
  return n_steps < 1 || t < 0 || t >= n_steps || n_paths < 1 || n_blocks < 1 || basis < 0 ||
         basis > 4;
}

}  // namespace

#define AMCX_DEGREE_SWITCH(CALL) \
  switch (degree + 1) {          \
    CALL(1)                      \
    CALL(2)                      \
    CALL(3)                      \
    CALL(4)                      \
    CALL(5)                      \
    CALL(6)                      \
    CALL(7)                      \
    CALL(8)                      \
    CALL(9)                      \
    CALL(10)                     \
    CALL(11)                     \
    default:                     \
      return static_cast<int>(cudaErrorInvalidValue); \
  }

// Row t of the paths, cf, tau (n_paths) f32; knocked (n_paths) bytes or
// null; stats 4 (n_steps+1) f32 rows; scratch 1 + n_blocks P f64 whose
// first 8 bytes are zero before the first call (each call leaves them
// zero), used by one stream at a time; packed (P) f32 out. Returns a
// cudaError_t.
extern "C" int amcx_step_moments(const float* S, const float* cf, const float* tau,
                                 const unsigned char* knocked, const float* stats,
                                 double* scratch, float* packed, int t, int n_steps, int n_paths,
                                 int n_blocks, float rdt, float strike, float phi, int basis,
                                 int degree, int itm_weights, void* stream) {
  if (bad_args(t, n_steps, n_paths, n_blocks, basis)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AMCX_MOMENTS_CASE(KK)                                                              \
  case KK:                                                                                 \
    return static_cast<int>(run_moments<KK>(S, cf, tau, knocked, stats, scratch, packed, t,  \
                                            n_steps, n_paths, n_blocks, rdt, strike, phi,  \
                                            basis, itm_weights, s));
  AMCX_DEGREE_SWITCH(AMCX_MOMENTS_CASE)
#undef AMCX_MOMENTS_CASE
}

// A fused loop's apply, validated once (amcx_torch.ops.lsmc_pallas
// step_apply_launcher); mirrors lsmc_pallas._ApplyPlan. Row t of each plane
// is base + t n_paths.
struct StepApplyPlan {
  const float* paths;            // (n_steps+1, n_paths) f32
  float* cf;                     // (n_paths) f32, updated in place
  float* tau;                    // (n_paths) f32, updated in place
  const unsigned char* knocked;  // (n_steps+1, n_paths) bytes or null
  const float* stats;            // 4 (n_steps+1) f32 rows
  float* surface;                // (n_steps+1, n_paths) f32 out or null
  int n_steps, n_paths, n_blocks, basis, degree, select;
  float strike, phi;
};

// Row t of the paths (n_paths) f32; cf, tau (n_paths) f32, updated in place;
// knocked as above; coeffs (degree+1) f32 on the device; surface_row
// (n_paths) f32 out or null; select 0 runs the fit for the surface only
// (European). Returns a cudaError_t.
extern "C" int amcx_step_apply(const float* S, float* cf, float* tau, const unsigned char* knocked,
                               const float* stats, const float* coeffs, float* surface_row, int t,
                               int n_steps, int n_paths, int n_blocks, float strike, float phi,
                               int basis, int degree, int select, void* stream) {
  if (bad_args(t, n_steps, n_paths, n_blocks, basis)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AMCX_APPLY_CASE(KK)                                                                   \
  case KK:                                                                                    \
    return static_cast<int>(run_apply<KK>(S, cf, tau, knocked, stats, coeffs, surface_row, t, \
                                          n_steps, n_paths, n_blocks, strike, phi, basis,     \
                                          select, s));
  AMCX_DEGREE_SWITCH(AMCX_APPLY_CASE)
#undef AMCX_APPLY_CASE
}

// Step t of a fused loop's plan (above) on the device coefficients coeffs
// (degree+1) f32. Returns a cudaError_t.
extern "C" int amcx_step_apply_planes(const StepApplyPlan* plan, int t, const float* coeffs,
                                      void* stream) {
  if (plan == nullptr || t < 0 || t >= plan->n_steps || plan->n_paths < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const StepApplyPlan& q = *plan;
  const size_t row = static_cast<size_t>(t) * static_cast<size_t>(q.n_paths);
  const unsigned char* knocked = q.knocked == nullptr ? nullptr : q.knocked + row;
  float* surface_row = q.surface == nullptr ? nullptr : q.surface + row;
  return amcx_step_apply(q.paths + row, q.cf, q.tau, knocked, q.stats, coeffs, surface_row, t,
                         q.n_steps, q.n_paths, q.n_blocks, q.strike, q.phi, q.basis, q.degree,
                         q.select, stream);
}
