// One backward step of the fused multi-asset LSMC engine as two passes over
// the step's asset planes: the cross-term regression moments
// (amcx_ma_step_moments) and the exercise apply (amcx_ma_step_apply). The
// m x m solve between them stays in torch (amcx_torch.regress.pinv_solve),
// as amcx leaves it to XLA.
//
// Replaces: amcx/ops/maxcall_pallas.py::_ma_moments_kernel (via
// ma_step_moments) and amcx/ops/maxcall_pallas.py::_ma_apply_kernel (via
// ma_step_apply).
//
// Moments, per path i of step t: y = cf * expf(-rdt * (tau - t)) (or y = cf
// with direct_y), the cross-term columns and w = 1[payoff > 0] (ITM fits;
// w = 1 otherwise), then the P = m(m+1)/2 + m packed sums
// sum w c_i c_j (i <= j) and sum c_i w y (ma_common.cuh ma_moments_block),
// f64 per block, summed over blocks in a fixed order and rounded once.
// Apply, per path: cont = max(sum coef_c col_c, 0) (a NaN fit stays NaN);
// where payoff > cont and the step is an exercise date, cf <- payoff and
// tau <- t IN PLACE (amcx donates these buffers).
//
// Bound on the H100, 5 assets and m = 21 at 1M paths: the moments read 5
// planes + cf + tau, 28 MB (8.4 us at 3.35 TB/s), and do 252 f32 products
// and 252 f64 additions per path (3.9 us at 67 TFLOP/s f32, 7.8 us at
// 34 TFLOP/s f64 without the tensor cores): the operations bound it, and
// on top of the arithmetic each term is an f32 -> f64 conversion and two
// shared-memory loads. Design: the column building is per path (one
// thread), the P sums are per thread over a shared-memory tile, so no
// thread keeps P accumulators (252 doubles would spill) and the sums stay
// in a fixed order. The apply reads only the 5 planes (21 MB, 6.3 us at
// 3.35 TB/s) and writes cf/tau (8 B) only where a path exercises; it never
// reads cf or tau. The TPU's (A, rows, 512) blocks and its n_paths % 4096
// rule are dropped.
#include <cuda_runtime.h>

#include <cstddef>

#include "ma_common.cuh"

namespace {

using namespace amcx;

template <int A>
__global__ void __launch_bounds__(kThreads)
ma_step_moments_kernel(const float* __restrict__ planes, const float* __restrict__ cf,
                       const float* __restrict__ tau, const float* __restrict__ stats,
                       double* __restrict__ partials, int t, int n_steps, int n_paths, float rdt,
                       int itm_weights, int direct_y, const __grid_constant__ MaParams p) {
  const float tf = static_cast<float>(t);
  auto y = [&](int i) { return direct_y ? cf[i] : cf[i] * expf(-rdt * (tau[i] - tf)); };
  ma_moments_block<A>(planes, n_paths, stats, n_steps + 1, t, p, itm_weights, y,
                      partials + static_cast<size_t>(blockIdx.x) * pack_dim(p.n_cols));
}

template <int A>
__global__ void __launch_bounds__(kThreads)
ma_step_apply_kernel(const float* __restrict__ planes, float* __restrict__ cf,
                     float* __restrict__ tau, const float* __restrict__ stats,
                     const float* __restrict__ coeffs, int t, int n_steps, int n_paths,
                     const __grid_constant__ MaParams p) {
  __shared__ float coef[kMaxCols];
  if (threadIdx.x < p.n_cols) coef[threadIdx.x] = coeffs[threadIdx.x];
  __syncthreads();
  const int T1 = n_steps + 1;
  if (!(stats[(2 * A + 2) * T1 + t] > 0.0f)) return;  // not an exercise date
  const float tf = static_cast<float>(t);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n_paths; i += gridDim.x * kThreads) {
    float s[A];
    load_assets<A>(planes, static_cast<size_t>(n_paths), i, s);
    float uni[A][kMaxMaDegree + 1];
    ma_features<A>(s, p, stats, T1, t, uni);
    const float cont = ma_continuation<A>(uni, p, coef);
    const float ex = ma_payoff<A>(s, p);
    // ex > cont implies ex > 0 (cont >= 0): amcx's ITM clause is implied
    if (ex > cont) {
      cf[i] = ex;
      tau[i] = tf;
    }
  }
}

template <int A>
cudaError_t run_moments(const float* planes, const float* cf, const float* tau,
                        const float* stats, double* partials, float* packed, int t, int n_steps,
                        int n_paths, int n_blocks, float rdt, int itm_weights, int direct_y,
                        const MaParams& p, cudaStream_t stream) {
  const size_t smem = moments_smem_bytes(p.n_cols, itm_weights);
  const cudaError_t err = allow_smem(ma_step_moments_kernel<A>, smem);
  if (err != cudaSuccess) return err;
  ma_step_moments_kernel<A><<<n_blocks, kThreads, smem, stream>>>(
      planes, cf, tau, stats, partials, t, n_steps, n_paths, rdt, itm_weights, direct_y, p);
  AMCX_LAUNCH_CHECK();
  sum_partials_kernel<<<1, kThreads, 0, stream>>>(partials, n_blocks, pack_dim(p.n_cols),
                                                  packed);
  return cudaGetLastError();
}

template <int A>
cudaError_t run_apply(const float* planes, float* cf, float* tau, const float* stats,
                      const float* coeffs, int t, int n_steps, int n_paths, int n_blocks,
                      const MaParams& p, cudaStream_t stream) {
  ma_step_apply_kernel<A><<<n_blocks, kThreads, 0, stream>>>(planes, cf, tau, stats, coeffs, t,
                                                             n_steps, n_paths, p);
  return cudaGetLastError();
}

bool bad_args(int t, int n_steps, int n_paths, int n_blocks, const MaParams* p) {
  return p == nullptr || bad_params(*p) || n_steps < 1 || t < 0 || t >= n_steps ||
         n_paths < 1 || n_blocks < 1;
}

}  // namespace

// Step t's planes (A, n_paths) f32; cf, tau (n_paths) f32; stats (2A+3,
// n_steps+1) f32; partials (n_blocks, P) f64 scratch; packed (P) f32 out;
// params on the host. Returns a cudaError_t.
extern "C" int amcx_ma_step_moments(const float* planes, const float* cf, const float* tau,
                                    const float* stats, double* partials, float* packed, int t,
                                    int n_steps, int n_paths, int n_blocks, float rdt,
                                    int itm_weights, int direct_y, const MaParams* params,
                                    void* stream) {
  if (bad_args(t, n_steps, n_paths, n_blocks, params)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AMCX_MOMENTS_CASE(AA)                                                                 \
  case AA:                                                                                    \
    return static_cast<int>(run_moments<AA>(planes, cf, tau, stats, partials, packed, t,      \
                                            n_steps, n_paths, n_blocks, rdt, itm_weights,     \
                                            direct_y, *params, s));
  AMCX_ASSETS_SWITCH(params->n_assets, AMCX_MOMENTS_CASE)
#undef AMCX_MOMENTS_CASE
}

// Step t's planes; cf, tau updated in place; stats as above; coeffs (m) f32
// on the device. Returns a cudaError_t.
extern "C" int amcx_ma_step_apply(const float* planes, float* cf, float* tau, const float* stats,
                                  const float* coeffs, int t, int n_steps, int n_paths,
                                  int n_blocks, const MaParams* params, void* stream) {
  if (bad_args(t, n_steps, n_paths, n_blocks, params)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AMCX_APPLY_CASE(AA)                                                                \
  case AA:                                                                                 \
    return static_cast<int>(run_apply<AA>(planes, cf, tau, stats, coeffs, t, n_steps,      \
                                          n_paths, n_blocks, *params, s));
  AMCX_ASSETS_SWITCH(params->n_assets, AMCX_APPLY_CASE)
#undef AMCX_APPLY_CASE
}
