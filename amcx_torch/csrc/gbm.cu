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
// memory. Design: one thread per path with a sequential running log-sum in
// a register (the TPU kernel's Hillis-Steele prefix sum was a Mosaic
// workaround; a thread walking its own path needs none), one store per
// path-step, and neighbouring threads store neighbouring addresses of row t,
// so every warp's store is one coalesced 128-byte line. The TPU's blocked
// (T+1, N/512, 512) layout and its minimax sincos are dropped: accurate
// logf / sqrtf / sincospif / expf (no fast math).
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kGbmThreads = 256;

__global__ void __launch_bounds__(kGbmThreads)
gbm_paths_kernel(float* __restrict__ out, uint32_t key_lo, uint32_t key_hi,
                 int n_steps, int n_paths, float S0, float drift_dt,
                 float vol_sdt) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_paths) return;
  const size_t row = static_cast<size_t>(n_paths);
  const uint2 key = make_uint2(key_lo, key_hi);
  out[p] = S0;
  float cum = 0.0f;
  const int n_quads = (n_steps + 3) / 4;
  for (int j = 0; j < n_quads; ++j) {
    float z[4];
    amcx::philox_normals4(
        amcx::philox4x32_10(make_uint4(static_cast<uint32_t>(j),
                                       static_cast<uint32_t>(p), 0u, 0u),
                            key),
        z);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = 4 * j + i;
      if (s < n_steps) {
        cum += drift_dt + vol_sdt * z[i];
        out[(static_cast<size_t>(s) + 1) * row + p] = S0 * expf(cum);
      }
    }
  }
}

}  // namespace

extern "C" int amcx_gbm_paths(float* out, unsigned int key_lo,
                              unsigned int key_hi, int n_steps, int n_paths,
                              float S0, float drift_dt, float vol_sdt,
                              void* stream) {
  const int grid = (n_paths + kGbmThreads - 1) / kGbmThreads;
  gbm_paths_kernel<<<grid, kGbmThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, key_lo, key_hi, n_steps, n_paths, S0, drift_dt, vol_sdt);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* amcx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
