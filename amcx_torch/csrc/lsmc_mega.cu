// Longstaff-Schwartz backward induction for a vanilla put/call, one
// cooperative launch per pricing (amcx_lsmc_mega).
//
// Replaces: amcx/ops/lsmc_megakernel.py::_mega_kernel (via
// lsmc_price_megakernel / _run) with its in-kernel solve
// _factor_equilibrated_ridge + _solve_factored (_solve_equilibrated_ridge).
//
// Per step t = T-1 .. 0, on time-major paths (n_steps+1, n_paths) f32:
//   moments: x = (S_t - mean_t) * inv_std_t, y = c_t * V, w = 1[phi(S-K) > 0]
//            (or 1), and the P = k(k+1)/2 + k explicit-pair moments
//            sum w B_a B_b (a <= b) and sum w y B_a;
//   solve:   column-equilibrate, add the rcond ridge, Cholesky, two
//            refinement steps against the UN-ridged Gram, de-equilibrate;
//   apply:   cont = max(sum c_a B_a(x), 0), ex = max(phi(S-K), 0), and
//            V <- ex / c_t where ex > cont. V is never touched otherwise.
//            With the cf/tau planes (amcx's return_cf_tau) the same select
//            also writes cf <- ex and tau <- t; maturity sets cf = V_T and
//            tau = n_steps (SURVEY Q5/Q7). V's arithmetic is the same with
//            or without them. European: the regression still runs (the
//            coefficient export), with no apply.
// V is carried in time-T units (value * e^{+r dt (T - tau)}): written only
// at exercise, discounted by the scalar c_t, never multiplied per step.
// Finally sum c_0 V and sum (c_0 V)^2.
//
// Bound on the H100: device memory, one read of the (T+1, n) paths (0.13 ms
// at 1M x 100), beside the P f32 products a path-step and their f64 sums;
// the design floor is the P = 20 f32 -> f64 conversions a path-step (~0.50
// ms at 1M x 100, 16 a clock a SM). The per-step Gram is a grid-wide
// dependency.
//
// Design: kernel 6's schedule (lsmc_fusedpath.cu) with its regeneration
// replaced by one read of S_t a step; the protocol is lsmc_coop.cuh's. One
// cooperative launch (cudaLaunchCooperativeKernel) on a grid the wrapper
// sizes from the occupancy query, so every block is co-resident and may
// wait on another; a grid that cannot be co-resident is refused by the
// runtime and the error returned, never run another way.
// - Block 0 solves each step (one thread, the unrolled
//   solve_equilibrated_ridge<K>) while the workers' pass A sums the next
//   step's Gram head, which needs no coefficients.
// - A worker thread owns quads of paths (4 consecutive; the last quad of an
//   n_paths that is no multiple of 4 is masked: x = 0, w = 0, no exercise,
//   no sums) and keeps V, S_t and S_{t+1} in shared-memory slots (past
//   chip_slots in global spill planes: large n_paths, or a degree whose
//   registers leave room for one block an SM).
// - Pass A of step t reads S_t once (a 16-byte load a quad where the row is
//   so aligned; else one load a path) and keeps it, and sums step t's Gram
//   head; at t = T-1 it first sets V from S_T (the maturity). Pass B waits
//   for step t+1's coefficients, applies step t+1 on the kept S_{t+1},
//   writing V and, where asked, cf/tau, then sums step t's right-hand side
//   on the new V. At t = -1 pass B applies step 0 and sums the final two.
// - The basis recurrences run on a quad's four paths with the basis switch
//   hoisted out of them (quad_cols).
// The first design was a host loop of maturity + T x (moments, one-block
// solve, apply) + 2 launches (302 at 100 steps): the moments kernel over a
// 1,024-block grid wrote partial rows that a one-block solve kernel summed
// and solved on one thread, serial after the moments, and every step read
// S_t and V twice (PERF.md: 2.75 ms of device time and ~3.3 ms of
// host enqueue at 1M x 100). Built, timed on the card and dropped: reading
// the next quad's S_t a quad ahead (no faster: the passes, not the loads,
// set a step), and the Gram head posted as a row of its own so that block
// 0 factors it during pass B (lsmc_coop.cuh).
//
// Numerics: the moments (and the final two sums) are accumulated in f64
// from f32 products and rounded once to f32; the solve and every per-path
// operation are f32. In the closed-form GBM frame with ITM weights the
// equilibrated Gram has cond ~3e4, and a 1e-7 relative nudge to the inputs
// moves the 131k x 100 price by ~3e-3 through exercise-decision flips that
// feed back into later fits. The f64 order noise of a 1M-term sum is about
// 1e-6 of an f32 ulp, so the once-rounded f32 sum is the same in any order
// unless it lies that close to a rounding boundary; and the library is
// built with -fmad=false, so each multiply and add rounds as in torch's
// separate elementwise ops. The kernel and its plain version
// (ops/lsmc_megakernel.py, _mega_reference) then give the same bits on the
// card, whatever the grid. No float atomics. The TPU's blocked
// (T+1, N/512, 512) layout and its n_paths % 4096 rule are dropped.
//
// Degenerate t = 0 at S0 == K with ITM weights: every weight is 0, the Gram
// is exactly 0, and the solve returns exactly 0 coefficients (ridge-only
// Cholesky of a zero system). Like the TPU kernel, there is deliberately no
// degenerate-weight fallback. `tiny` = 1e-30 makes d = 1e15 on a zero
// diagonal; that is safe because the zero entries stay exactly zero, so the
// expression order matches amcx's.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "lsmc_coop.cuh"

namespace amcx {

// The pricing's switches and scalars; mirrors
// amcx_torch.ops.lsmc_megakernel.MegaParams. Passed by value.
struct MegaParams {
  int n_steps;
  int n_paths;
  int n_blocks;  // the cooperative grid
  int chip_slots;  // quads a thread keeps in shared memory
  int basis;
  int american;
  int itm_weights;
  float strike;
  float phi;
  float rcond;
};

}  // namespace amcx

namespace {

using namespace amcx;

// The state planes of a quad slot, [V | S even | S odd]: S_t lives in plane
// 1 + (t & 1), so S_{t+1} survives the pass that reads S_t.
constexpr int kV = 0, kS = 1, kPlanes = 3;

// The fit's basis columns and weights of a quad's spots of one step; the
// paths past n_paths (n_here < 4) get x = 0 and weight 0.
template <int K>
__device__ __forceinline__ void fit_quad(const MegaParams& p, const float (&s)[4], int n_here,
                                         float mean, float inv_std, float (&cols)[4][K],
                                         float (&wgt)[4]) {
  float x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = j < n_here ? (s[j] - mean) * inv_std : 0.0f;
  quad_cols<K>(p.basis, x, cols);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wgt[j] = 1.0f;
    if (p.itm_weights) wgt[j] = fmaxf(p.phi * (s[j] - p.strike), 0.0f) > 0.0f ? 1.0f : 0.0f;
    if (j >= n_here) wgt[j] = 0.0f;
  }
}

__device__ __forceinline__ bool aligned16(const float* x) {
  return (reinterpret_cast<uintptr_t>(x) & 15u) == 0;
}

// The pricing (the header's design): block 0 solves, blocks 1.. run the
// passes A and B of each step.
template <int K>
__global__ void __launch_bounds__(kThreads, K <= 6 ? 2 : 1)
mega_kernel(const __grid_constant__ MegaParams p, const float* __restrict__ paths,
            const float* __restrict__ stats, float* spill, float* __restrict__ cf,
            float* __restrict__ tau, double* partials, float* coeffs, float* __restrict__ sums) {
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
    solver_block<K>(arrivals, rows, n_workers, T, true, p.rcond, coeffs, sums, packed, coef);
    return;
  }

  const int n_quads = (p.n_paths + 3) / 4;
  const size_t plane_floats = 4 * static_cast<size_t>(n_quads);
  const int first = (blockIdx.x - 1) * kThreads + threadIdx.x;
  const int stride = n_workers * kThreads;
  double* row = rows + static_cast<size_t>(blockIdx.x - 1) * P;
  const float c_0 = stats[2 * T1];
  const int chip_slots = p.chip_slots;
  auto slot = [&](int plane, int k, int q) {
    return quad_slot(chip, spill, plane, k, q, chip_slots, plane_floats);
  };

  // step t = T-1 .. 0, then t = -1 for the final sums
  for (int t = T - 1; t >= -1; --t) {
    const int a = t + 1;  // the step whose exercise pass B applies
    const bool at_maturity = a == T;
    const bool moments = t >= 0;
    const int tc = t < 0 ? 0 : t;
    const float mean = stats[tc], inv_std = stats[T1 + tc], c_t = stats[2 * T1 + tc];
    double acc[P];
#pragma unroll
    for (int m = 0; m < P; ++m) acc[m] = 0.0;

    // pass A: at t = T-1 the maturity; S_t kept, and the Gram head of step t
    if (moments) {
      const float* row_t = paths + static_cast<size_t>(t) * p.n_paths;
      const float* row_T = paths + static_cast<size_t>(T) * p.n_paths;
      const bool vec_t = aligned16(row_t), vec_T = aligned16(row_T);
      for (int q = first, k = 0; q < n_quads; q += stride, ++k) {
        const int n_here = min(4, p.n_paths - 4 * q);
        if (at_maturity) {
          float sT[4], v[4];
          load_row4(row_T, 4 * q, n_here, vec_T, sT);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            v[j] = j < n_here ? fmaxf(p.phi * (sT[j] - p.strike), 0.0f) : 0.0f;
          }
          store4(slot(kV, k, q), v);
          if (cf != nullptr) {
            const float fT = static_cast<float>(T);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (j >= n_here) break;
              cf[4 * static_cast<size_t>(q) + j] = v[j];
              tau[4 * static_cast<size_t>(q) + j] = fT;
            }
          }
        }
        float s[4], cols[4][K], wgt[4];
        load_row4(row_t, 4 * q, n_here, vec_t, s);
        store4(slot(kS + (t & 1), k, q), s);
        fit_quad<K>(p, s, n_here, mean, inv_std, cols, wgt);
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
    }

    // the coefficients of step a: block 0 has solved it (and so read every
    // row of step a) before this block's row is written again
    const bool apply = !at_maturity && p.american;
    float cf_row[K];
    if (!at_maturity) {
      wait_for(generation, static_cast<unsigned>(T - a));
      if (apply && threadIdx.x < K) coef[threadIdx.x] = __ldcg(coeffs + a * K + threadIdx.x);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < K; ++i) cf_row[i] = apply ? coef[i] : 0.0f;
    const float mean_a = stats[a], inv_std_a = stats[T1 + a], inv_c_a = stats[3 * T1 + a];
    const float fa = static_cast<float>(a);

    // pass B: the exercise of step a on S_a, then the right-hand side of
    // step t on the new V (or, at t = -1, the final sums)
    for (int q = first, k = 0; q < n_quads; q += stride, ++k) {
      const int n_here = min(4, p.n_paths - 4 * q);
      float v[4];
      load4(slot(kV, k, q), v);
      if (apply) {
        float s[4], x[4], cols[4][K];
        load4(slot(kS + (a & 1), k, q), s);
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = j < n_here ? (s[j] - mean_a) * inv_std_a : 0.0f;
        quad_cols<K>(p.basis, x, cols);
        bool exercise[4];
        float ex[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float fitted = cols[j][0] * cf_row[0];
#pragma unroll
          for (int i = 1; i < K; ++i) fitted = fitted + cols[j][i] * cf_row[i];
          // max(fitted, 0) that keeps a NaN fit NaN (then no path exercises),
          // as torch.clamp_min and jnp.maximum do; fmaxf would return 0
          const float cont = fitted > 0.0f ? fitted : (fitted != fitted ? fitted : 0.0f);
          ex[j] = fmaxf(p.phi * (s[j] - p.strike), 0.0f);
          // ex > cont implies ex > 0 (cont >= 0): the ITM clause is implied
          exercise[j] = j < n_here && ex[j] > cont;
          v[j] = exercise[j] ? ex[j] * inv_c_a : v[j];
        }
        store4(slot(kV, k, q), v);
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
        load4(slot(kS + (t & 1), k, q), s);
        fit_quad<K>(p, s, n_here, mean, inv_std, cols, wgt);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float yw = c_t * v[j] * wgt[j];
#pragma unroll
          for (int i = 0; i < K; ++i) acc[kPairs + i] += static_cast<double>(cols[j][i] * yw);
        }
      } else {  // the final sums
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j >= n_here) break;
          const float x = c_0 * v[j];
          acc[0] += static_cast<double>(x);
          acc[1] += static_cast<double>(x * x);
        }
      }
    }

    if (moments) {
      block_reduce_store<P>(acc, row);
    } else {
      double fin[2] = {acc[0], acc[1]};
      block_reduce_store<2>(fin, rows + static_cast<size_t>(blockIdx.x - 1) * 2);
    }
    arrive(arrivals);
  }
}

template <int K>
cudaError_t occupancy(int smem, int* blocks_per_sm) {
  const auto kernel = mega_kernel<K>;
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
cudaError_t launch(const MegaParams& p, const float* paths, const float* stats, float* spill,
                   float* cf, float* tau, double* partials, float* coeffs, float* sums,
                   size_t smem, cudaStream_t stream) {
  const auto kernel = mega_kernel<K>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  void* args[] = {const_cast<MegaParams*>(&p), &paths, &stats, &spill, &cf, &tau, &partials,
                  &coeffs, &sums};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(p.n_blocks),
                                     dim3(kThreads), args, smem, stream);
}

// Quad slots a worker thread needs.
int slots_needed(const MegaParams& p) {
  const long long threads = static_cast<long long>(p.n_blocks - 1) * kThreads;
  const long long quads = (p.n_paths + 3) / 4;
  return static_cast<int>((quads + threads - 1) / threads);
}

}  // namespace

#define AMCX_MEGA_DISPATCH(CALL)                              \
  switch (degree + 1) {                                       \
    case 1: return static_cast<int>(CALL(1));                 \
    case 2: return static_cast<int>(CALL(2));                 \
    case 3: return static_cast<int>(CALL(3));                 \
    case 4: return static_cast<int>(CALL(4));                 \
    case 5: return static_cast<int>(CALL(5));                 \
    case 6: return static_cast<int>(CALL(6));                 \
    case 7: return static_cast<int>(CALL(7));                 \
    case 8: return static_cast<int>(CALL(8));                 \
    case 9: return static_cast<int>(CALL(9));                 \
    case 10: return static_cast<int>(CALL(10));               \
    case 11: return static_cast<int>(CALL(11));               \
    default: return static_cast<int>(cudaErrorInvalidValue);  \
  }

// blocks_per_sm: how many blocks of the degree's kernel with smem bytes of
// dynamic shared memory one SM holds at once (0 when smem exceeds a block's
// limit). Returns a cudaError_t.
extern "C" int amcx_lsmc_mega_occupancy(int degree, int smem, int* blocks_per_sm) {
  if (smem < 0 || blocks_per_sm == nullptr) return static_cast<int>(cudaErrorInvalidValue);
#define AMCX_OCCUPANCY(KK) occupancy<KK>(smem, blocks_per_sm)
  AMCX_MEGA_DISPATCH(AMCX_OCCUPANCY)
#undef AMCX_OCCUPANCY
}

// params: the pricing and its grid (host memory; n_blocks >= 2 blocks of
// kThreads, all co-resident, else the launch is refused); paths
// (n_steps+1, n_paths) f32, any alignment; stats 4 (n_steps+1) f32 rows
// [mean_t, inv_std_t, c_t, 1/c_t]; spill (3 planes of 4 ceil(n_paths / 4)
// f32: V, S even, S odd, 16-byte aligned) scratch for the quads past
// chip_slots, null where every quad stays in shared memory; cf, tau
// (n_paths) out, or both null; partials: the arrival and generation words
// (the first 8 bytes, zeroed by the caller), then (n_blocks - 1, max(P, 2))
// f64 rows of scratch; coeffs (n_steps+1, degree+1) out, zeroed by the
// caller (the maturity row stays 0); sums (2) out. Returns a cudaError_t.
extern "C" int amcx_lsmc_mega(const amcx::MegaParams* params, const float* paths,
                              const float* stats, float* spill, float* cf, float* tau,
                              double* partials, float* coeffs, float* sums, int degree,
                              void* stream) {
  const amcx::MegaParams& p = *params;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.n_steps < 1 || p.n_paths < 1 || p.n_blocks < 2 || p.chip_slots < 0 || p.basis < 0 ||
      p.basis > 4 || (cf == nullptr) != (tau == nullptr) ||
      (slots_needed(p) > p.chip_slots && spill == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(p.chip_slots) * kThreads * sizeof(float4) * kPlanes;
#define AMCX_LAUNCH(KK) launch<KK>(p, paths, stats, spill, cf, tau, partials, coeffs, sums, smem, s)
  AMCX_MEGA_DISPATCH(AMCX_LAUNCH)
#undef AMCX_LAUNCH
}

#undef AMCX_MEGA_DISPATCH
