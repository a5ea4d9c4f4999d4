// Exact-GBM path generation with in-kernel Philox normals.
//
// Replaces: amcx/ops/gbm_pallas.py::_gbm_kernel (via gbm_paths_pallas), the
// TPU kernel that draws hardware-PRNG bits per block, turns them into
// Box-Muller normals, prefix-sums the log increments and exponentiates.
//
// Computes S[0] = S0, S[t] = S0 * exp(sum_{s<t} (drift_dt + vol_sdt * z_s)),
// time-major (n_steps+1, n_paths) f32, with z from philox.cuh's documented
// (seed, path, step) stream.
//
// Bound on the H100: the store of the path array (4 B per path-step, 424 MB
// at 1M x 100, about 0.13 ms at 3.35 TB/s). The normals never touch device
// memory. The work a path-step is the issue floor above that bound: a
// quarter of a Philox4x32-10 call, half of a Box-Muller pair (accurate
// logf, sqrtf, sincospif), the running sum and an accurate expf: ~63 SASS
// instructions (75 at one path a thread), an issue floor of ~0.2 ms at 1M
// x 100 (chip_smoke.py counts them in the build it runs).
// Design: a thread runs kGbmPaths consecutive paths, so its four Philox
// calls and 16 normals of a step quad are independent work in flight, and
// each row t of its paths is one 16-byte store (a warp writes 512
// contiguous bytes of the row). A pointer bumped by a row a step replaces
// the 64-bit index multiply; full quads run without a step test and the
// tail quad (n_steps % 4) on its own. The launch plan (ops/gbm.py,
// _gbm_plan) gives one thread a group of paths: at 1M x 100 its 1,024
// blocks timed 0.2488-0.2537 ms against 0.2529-0.2576 for the persistent
// grid of 528 that the occupancy query allows (amcx_torch/pathgen_probe.py,
// two runs alternating them, NVIDIA H100 80GB HBM3, 700 W). When n_paths %
// 4 != 0 the rows are not 16-byte aligned: the kScalar instance stores each
// path alone and masks the last group. The running log-sum is sequential in a register
// per path (the TPU kernel's Hillis-Steele prefix sum was a Mosaic
// workaround), in the same order as before, so the bits do not change.
// Accurate logf / sqrtf / sincospif / expf, no fast math.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kGbmThreads = 256;
constexpr int kGbmPaths = 4;  // consecutive paths a thread (ops/gbm.py GBM_PATHS)

template <bool kScalar>
__device__ __forceinline__ void store_row(float* dst, const float (&v)[kGbmPaths], int n_here) {
  if (kScalar) {
#pragma unroll
    for (int k = 0; k < kGbmPaths; ++k) {
      if (k < n_here) dst[k] = v[k];
    }
  } else {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// n_used steps of quad j for the thread's paths p0 .. p0 + 3, advancing dst
// (row 4j of the paths on entry) and the running sums.
template <bool kScalar>
__device__ __forceinline__ void quad(float*& dst, float (&cum)[kGbmPaths], uint32_t j, uint32_t p0,
                                     uint2 key, int n_used, size_t row, float S0, float drift_dt,
                                     float vol_sdt, int n_here) {
  float z[kGbmPaths][4];
#pragma unroll
  for (int k = 0; k < kGbmPaths; ++k) {
    amcx::philox_normals4(amcx::philox4x32_10(make_uint4(j, p0 + k, 0u, 0u), key), z[k]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i < n_used) {
      dst += row;
      float v[kGbmPaths];
#pragma unroll
      for (int k = 0; k < kGbmPaths; ++k) {
        cum[k] += drift_dt + vol_sdt * z[k][i];
        v[k] = S0 * expf(cum[k]);
      }
      store_row<kScalar>(dst, v, n_here);
    }
  }
}

// Thread g runs group g (the plan's grid has a thread for each). The loop
// over g + k grid x threads runs once on that grid; without it nvcc
// recomputes the Philox key schedule inside the quad loop in uniform
// registers (1,073 SASS instructions a quad against 994, 40 registers
// against 59; cuobjdump of this file, sm_90a) and the kernel ran ~4%
// slower on an NVIDIA H100 80GB HBM3 (chip_smoke.py, kernel_profile).
template <bool kScalar>
__global__ void __launch_bounds__(kGbmThreads)
gbm_paths_kernel(float* __restrict__ out, uint32_t key_lo, uint32_t key_hi, int n_paths,
                 int n_groups, int full_quads, int tail, float S0, float drift_dt,
                 float vol_sdt) {
  const size_t row = static_cast<size_t>(n_paths);
  const uint2 key = make_uint2(key_lo, key_hi);
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < n_groups;
       g += gridDim.x * blockDim.x) {
    const int p0 = kGbmPaths * g;
    const int n_here = min(kGbmPaths, n_paths - p0);
    float* dst = out + p0;
    float cum[kGbmPaths];
#pragma unroll
    for (int k = 0; k < kGbmPaths; ++k) cum[k] = 0.0f;
    {
      const float s0[kGbmPaths] = {S0, S0, S0, S0};
      store_row<kScalar>(dst, s0, n_here);
    }
    for (int j = 0; j < full_quads; ++j) {
      quad<kScalar>(dst, cum, static_cast<uint32_t>(j), static_cast<uint32_t>(p0), key, 4, row,
                    S0, drift_dt, vol_sdt, n_here);
    }
    if (tail > 0) {
      quad<kScalar>(dst, cum, static_cast<uint32_t>(full_quads), static_cast<uint32_t>(p0), key,
                    tail, row, S0, drift_dt, vol_sdt, n_here);
    }
  }
}

}  // namespace

// out: (4 full_quads + tail + 1, n_paths) f32, 16-byte aligned. The launch
// plan (ops/gbm.py, _gbm_plan): grid blocks of threads (kGbmThreads), thread
// g running the kGbmPaths paths from kGbmPaths g of the n_groups groups (and
// g + grid x threads ... on a smaller grid), their rows in full_quads quads
// of 4 steps and then tail steps; scalar picks the instance that stores each
// path alone (required when n_paths % 4 != 0). A plan that would write
// outside out or leave a path unwritten is refused. Returns a cudaError_t.
extern "C" int amcx_gbm_paths(float* out, unsigned int key_lo, unsigned int key_hi, int n_paths,
                              int n_groups, int full_quads, int tail, int scalar, int threads,
                              int grid, float S0, float drift_dt, float vol_sdt, void* stream) {
  if (n_paths < 1 || n_groups != (n_paths + kGbmPaths - 1) / kGbmPaths || full_quads < 0 ||
      tail < 0 || tail > 3 || full_quads + tail < 1 || (!scalar && n_paths % kGbmPaths != 0) ||
      threads != kGbmThreads || grid < 1 || (reinterpret_cast<uintptr_t>(out) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scalar) {
    gbm_paths_kernel<true><<<grid, threads, 0, s>>>(out, key_lo, key_hi, n_paths, n_groups,
                                                    full_quads, tail, S0, drift_dt, vol_sdt);
  } else {
    gbm_paths_kernel<false><<<grid, threads, 0, s>>>(out, key_lo, key_hi, n_paths, n_groups,
                                                     full_quads, tail, S0, drift_dt, vol_sdt);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* amcx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
