"""Where the two pathgen kernels spend their time: arithmetic, stores, issue.

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 -m amcx_torch.pathgen_probe [--out DIR]

It builds its own source with nvcc (the port's flags: sm_90a, -O3,
-fmad=false, no fast math) and imports nothing of the port's Python. The
source holds copies of kernel 1 (the Philox pathgen, ``csrc/gbm.cu``) and of
kernel 11's increment order (the Sobol pathgen, ``csrc/sobol_gbm.cu``), in
the design before the H100 redesign (one path a thread, the branchless
inverse CDF) and after it (four paths a thread with 16-byte row stores;
for kernel 11 the tail form evaluated only where selected, on a warp's
compacted list, at several chunk sizes). The after-copies are frozen at the
designs chosen, with the losers beside them; the kernels that the port runs
are this checkout's csrc files, which the probe includes and times through
their C entries too. Each design is timed at 1,048,576 paths x 100 steps in
three modes:

- ``kernel``: the kernel itself;
- ``arith``: its arithmetic with one store a thread (a checksum);
- ``stores``: its loads and store pattern with trivial arithmetic.

Kernel 1 at four paths a thread is also timed on two grids, alternated: a
block for each 256 groups of paths, and the persistent grid that the
occupancy query allows. It checks that every redesigned copy and both csrc
kernels write the same bits as the earlier design, prints ``-Xptxas -v``
(registers, spills) of the probe and of ``csrc/gbm.cu`` and
``csrc/sobol_gbm.cu``, and, where the toolkit has ``cuobjdump``, the SASS
instructions of each loop of those two kernels and the counts that their
issue floors weigh (:func:`issue_model`; the full listing goes to
``--out``). Instructions a path-step over 4 issues a clock a SM at the SM
clock that ``nvidia-smi`` reads while the probe runs give a kernel's issue
floor. One line per measurement.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import statistics
import subprocess
import tempfile
import threading
import time
from pathlib import Path

FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false"]

SOURCE = r"""
#include <cstdint>
#include <cstdio>
#include <vector>
#include <cuda_runtime.h>

// ---- Philox4x32-10 and Box-Muller (csrc/philox.cuh) ----
__device__ __forceinline__ uint4 philox(uint4 ctr, uint2 key) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) { key.x += 0x9E3779B9u; key.y += 0xBB67AE85u; }
    const uint32_t hi0 = __umulhi(0xD2511F53u, ctr.x), lo0 = 0xD2511F53u * ctr.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, ctr.z), lo1 = 0xCD9E8D57u * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
  }
  return ctr;
}
__device__ __forceinline__ float unif(uint32_t x) { return static_cast<float>((x >> 8) + 1u) * 0x1p-24f; }
__device__ __forceinline__ void normals4(uint4 x, float (&z)[4]) {
  const float r0 = sqrtf(-2.0f * logf(unif(x.x)));
  const float r1 = sqrtf(-2.0f * logf(unif(x.z)));
  float s0, c0, s1, c1;
  sincospif(2.0f * unif(x.y), &s0, &c0);
  sincospif(2.0f * unif(x.w), &s1, &c1);
  z[0] = r0 * c0; z[1] = r0 * s0; z[2] = r1 * c1; z[3] = r1 * s1;
}

// ---- Acklam's inverse normal CDF (csrc/sobol_gbm.cu) ----
#define F(x) static_cast<float>(x)
#define ACKLAM_A {F(-3.969683028665376e+01), F(2.209460984245205e+02), F(-2.759285104469687e+02), \
                  F(1.383577518672690e+02), F(-3.066479806614716e+01), F(2.506628277459239e+00)}
#define ACKLAM_B {F(-5.447609879822406e+01), F(1.615858368580409e+02), F(-1.556989798598866e+02), \
                  F(6.680131188771972e+01), F(-1.328068155288572e+01)}
#define ACKLAM_C {F(-7.784894002430293e-03), F(-3.223964580411365e-01), F(-2.400758277161838e+00), \
                  F(-2.549732539343734e+00), F(4.374664141464968e+00), F(2.938163982698783e+00)}
#define ACKLAM_D {F(7.784695709041462e-03), F(3.224671290700398e-01), F(2.445134137142996e+00), \
                  F(3.754408661907416e+00)}
__device__ __forceinline__ float to_unif(uint32_t u) {
  return __uint_as_float(((u >> 7) & 0x007FFFFFu) | 0x3F800000u) - __uint_as_float(0x3F7FFFFFu);
}
__device__ __forceinline__ float central(float p) {
  constexpr float kA[6] = ACKLAM_A;
  constexpr float kB[5] = ACKLAM_B;
  const float half = p - 0.5f, r = half * half;
  float num = kA[0];
#pragma unroll
  for (int i = 1; i < 6; ++i) num = num * r + kA[i];
  float den = kB[0];
#pragma unroll
  for (int i = 1; i < 5; ++i) den = den * r + kB[i];
  den = den * r + 1.0f;
  return num * half / den;
}
__device__ __forceinline__ float tailf(float p) {
  constexpr float kC[6] = ACKLAM_C;
  constexpr float kD[4] = ACKLAM_D;
  const float half = p - 0.5f, pt = fminf(p, 1.0f - p);
  const float qt = sqrtf(-2.0f * logf(fmaxf(pt, static_cast<float>(1e-38))));
  float num = kC[0];
#pragma unroll
  for (int i = 1; i < 6; ++i) num = num * qt + kC[i];
  float den = kD[0];
#pragma unroll
  for (int i = 1; i < 4; ++i) den = den * qt + kD[i];
  den = den * qt + 1.0f;
  const float x_t = num / den;
  return half < 0.0f ? x_t : -x_t;
}
__device__ __forceinline__ bool in_tail(float p) { return !(fabsf(p - 0.5f) <= static_cast<float>(0.5 - 0.02425)); }
__device__ __forceinline__ float ppf(float p) {
  const float c = central(p), t = tailf(p);
  return in_tail(p) ? t : c;
}

// MODE 0: the kernel; 1: its arithmetic, one checksum store a thread; 2: its
// loads and stores with trivial arithmetic.

// ---- kernel 1 before: one path a thread ----
template <int MODE>
__global__ void __launch_bounds__(256) gbm_before(float* out, uint32_t k0, uint32_t k1, int n_steps,
                                                  int n_paths, float S0, float drift, float vol) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_paths) return;
  const size_t row = n_paths;
  if (MODE != 1) out[p] = S0;
  float cum = 0.0f, acc = 0.0f;
  for (int j = 0; j < (n_steps + 3) / 4; ++j) {
    float z[4];
    if (MODE == 2) {
      z[0] = z[1] = z[2] = z[3] = 0.0f;
    } else {
      normals4(philox(make_uint4(j, p, 0u, 0u), make_uint2(k0, k1)), z);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = 4 * j + i;
      if (s < n_steps) {
        cum += drift + vol * z[i];
        const float v = MODE == 2 ? cum : S0 * expf(cum);
        if (MODE == 1) acc += v; else out[(static_cast<size_t>(s) + 1) * row + p] = v;
      }
    }
  }
  if (MODE == 1) out[p] = acc;
}

#ifdef PROBE_AFTER
// ---- kernel 1 after: P consecutive paths a thread, one 8- or 16-byte row store ----
template <int P> struct Vec;
template <> struct Vec<2> {
  using U = uint2; using Fv = float2;
  __device__ static Fv pack(const float (&v)[2]) { return make_float2(v[0], v[1]); }
};
template <> struct Vec<4> {
  using U = uint4; using Fv = float4;
  __device__ static Fv pack(const float (&v)[4]) { return make_float4(v[0], v[1], v[2], v[3]); }
};
template <int MODE, int P>
__device__ __forceinline__ void gbm_quad(float*& dst, float (&cum)[P], float& acc, uint32_t j, uint32_t p0,
                                         uint2 key, int n_used, size_t row, float S0, float drift, float vol) {
  float z[P][4];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (MODE == 2) { z[k][0] = z[k][1] = z[k][2] = z[k][3] = 0.0f; }
    else normals4(philox(make_uint4(j, p0 + k, 0u, 0u), key), z[k]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i < n_used) {
      dst += row;
      float v[P];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        cum[k] += drift + vol * z[k][i];
        v[k] = MODE == 2 ? cum[k] : S0 * expf(cum[k]);
      }
      if (MODE == 1) {
#pragma unroll
        for (int k = 0; k < P; ++k) acc += v[k];
      } else {
        *reinterpret_cast<typename Vec<P>::Fv*>(dst) = Vec<P>::pack(v);
      }
    }
  }
}
template <int MODE, int P>
__global__ void __launch_bounds__(256) gbm_after(float* out, uint32_t k0, uint32_t k1, int n_steps,
                                                 int n_paths, float S0, float drift, float vol) {
  const size_t row = n_paths;
  const uint2 key = make_uint2(k0, k1);
  const int n_groups = n_paths / P, n_full = n_steps / 4, tail = n_steps - 4 * n_full;
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < n_groups; g += gridDim.x * blockDim.x) {
    float* dst = out + P * g;
    float cum[P], acc = 0.0f, s0[P];
#pragma unroll
    for (int k = 0; k < P; ++k) cum[k] = 0.0f, s0[k] = S0;
    if (MODE != 1) *reinterpret_cast<typename Vec<P>::Fv*>(dst) = Vec<P>::pack(s0);
    for (int j = 0; j < n_full; ++j) gbm_quad<MODE, P>(dst, cum, acc, j, P * g, key, 4, row, S0, drift, vol);
    if (tail > 0) gbm_quad<MODE, P>(dst, cum, acc, n_full, P * g, key, tail, row, S0, drift, vol);
    if (MODE == 1) out[g] = acc;
  }
}
#endif

// ---- kernel 11, increment order, before: one path a thread, branchless ----
template <int MODE>
__global__ void __launch_bounds__(256) sobol_before(const uint32_t* u_hi, const uint32_t* u_lo, float* out,
                                                   int n_steps, int n_paths, float S0, float drift, float vol) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_paths) return;
  const size_t row = n_paths;
  const int n_blocks = n_paths / 512;
  if (MODE != 1) out[p] = S0;
  float cum = 0.0f, acc = 0.0f;
  for (int j = 0; j < n_steps; ++j) {
    const uint32_t u = u_hi[static_cast<size_t>(j) * n_blocks + (p >> 9)] ^ u_lo[j * 512 + (p & 511)];
    const float z = MODE == 2 ? to_unif(u) : ppf(to_unif(u));
    cum = cum + (drift + vol * z);
    const float v = MODE == 2 ? cum : S0 * expf(cum);
    if (MODE == 1) acc += v; else out[(static_cast<size_t>(j) + 1) * row + p] = v;
  }
  if (MODE == 1) out[p] = acc;
}

#ifdef PROBE_AFTER
// ---- kernel 11, increment order, after: 4 paths a thread, S steps a chunk;
// the central form into a shared-memory tile, the tail form on the warp's
// compacted list of tile offsets (csrc/sobol_gbm.cu) ----
template <int MODE, int S, bool kFull>
__device__ __forceinline__ void sobol_chunk(const uint32_t*& hi, const uint4*& lo, float*& dst, float* tile,
                                            uint16_t* list, float (&cum)[4], float& acc, int n_used,
                                            int n_blocks, size_t row, float S0, float drift, float vol) {
  const int lane = threadIdx.x & 31;
  float4* mine = reinterpret_cast<float4*>(tile) + threadIdx.x;
  uint32_t tail = 0u;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (kFull || s < n_used) {
      const uint32_t h = __ldg(hi);
      const uint4 l = __ldg(lo);
      hi += n_blocks;
      lo += 128;
      const uint32_t w[4] = {h ^ l.x, h ^ l.y, h ^ l.z, h ^ l.w};
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float p = to_unif(w[k]);
        if (MODE == 2) { v[k] = p; continue; }
        const bool t = in_tail(p);
        const float c = central(p);
        v[k] = t ? p : c;
        tail |= static_cast<uint32_t>(t) << (s * 4 + k);
      }
      mine[s * 128] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  if (MODE != 2) {
    const int n_mine = __popc(tail);
    int incl = n_mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += y;
    }
    const int total = __shfl_sync(0xFFFFFFFFu, incl, 31);
    if (total > 0) {
      for (int pos = incl - n_mine; tail != 0u; tail &= tail - 1u, ++pos) {
        const int b = __ffs(static_cast<int>(tail)) - 1;
        list[pos] = static_cast<uint16_t>((b >> 2) * 512 + 4 * threadIdx.x + (b & 3));
      }
      __syncwarp();
      for (int i = lane; i < total; i += 32) { const int o = list[i]; tile[o] = tailf(tile[o]); }
      __syncwarp();
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (kFull || s < n_used) {
      const float4 z4 = mine[s * 128];
      const float z[4] = {z4.x, z4.y, z4.z, z4.w};
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        cum[k] = cum[k] + (drift + vol * z[k]);
        v[k] = MODE == 2 ? cum[k] : S0 * expf(cum[k]);
      }
      dst += row;
      if (MODE == 1) acc += (v[0] + v[1]) + (v[2] + v[3]);
      else *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}
template <int MODE, int S>
__global__ void __launch_bounds__(128) sobol_after(const uint32_t* u_hi, const uint32_t* u_lo, float* out,
                                                   int n_steps, int n_paths, float S0, float drift, float vol) {
  __shared__ __align__(16) float tile[S * 512];
  __shared__ uint16_t lists[4][32 * S * 4];
  uint16_t* list = lists[threadIdx.x >> 5];
  const int n_blocks = n_paths / 512;
  const size_t row = n_paths;
  float* dst = out + static_cast<size_t>(blockIdx.x) * 512 + 4 * threadIdx.x;
  const uint32_t* hi = u_hi + blockIdx.x;
  const uint4* lo = reinterpret_cast<const uint4*>(u_lo) + threadIdx.x;
  float cum[4] = {0.0f, 0.0f, 0.0f, 0.0f}, acc = 0.0f;
  if (MODE != 1) *reinterpret_cast<float4*>(dst) = make_float4(S0, S0, S0, S0);
  const int n_full = n_steps / S;
  for (int c = 0; c < n_full; ++c)
    sobol_chunk<MODE, S, true>(hi, lo, dst, tile, list, cum, acc, S, n_blocks, row, S0, drift, vol);
  if (n_steps > n_full * S)
    sobol_chunk<MODE, S, false>(hi, lo, dst, tile, list, cum, acc, n_steps - n_full * S, n_blocks, row, S0,
                                drift, vol);
  if (MODE == 1) out[blockIdx.x * 128 + threadIdx.x] = acc;
}
#endif

#ifdef PROBE_AFTER
// ---- the kernels as this checkout's csrc holds them, through their C
// entries (the copies above are frozen: these are what the port runs) ----
#include "gbm.cu"
#include "sobol_gbm.cu"
#endif

__global__ void count_diff(const uint32_t* a, const uint32_t* b, size_t n, unsigned long long* bad) {
  unsigned long long mine = 0;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) mine += a[i] != b[i];
  if (mine) atomicAdd(bad, mine);
}

static float g_ms_sink = 0.0f;

template <typename Launch>
float time_ms(Launch launch, int reps) {
  launch();
  launch();
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  std::vector<float> t;
  for (int r = 0; r < reps; ++r) {
    cudaEventRecord(a);
    launch();
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms;
    cudaEventElapsedTime(&ms, a, b);
    t.push_back(ms);
  }
  for (size_t i = 0; i < t.size(); ++i)
    for (size_t j = i + 1; j < t.size(); ++j)
      if (t[j] < t[i]) { float x = t[i]; t[i] = t[j]; t[j] = x; }
  g_ms_sink += t[0];
  return t[t.size() / 2];
}

unsigned long long diff(const float* a, const float* b, size_t n, unsigned long long* bad) {
  cudaMemset(bad, 0, sizeof(unsigned long long));
  count_diff<<<1024, 256>>>(reinterpret_cast<const uint32_t*>(a), reinterpret_cast<const uint32_t*>(b), n, bad);
  unsigned long long h = 0;
  cudaMemcpy(&h, bad, sizeof(h), cudaMemcpyDeviceToHost);
  return h;
}

int main() {
  const int n_paths = 1 << 20, n_steps = 100, reps = 20;
  const float S0 = 100.0f, dt = 0.01f, drift = (0.01f - 0.5f * 0.2f * 0.2f) * dt, vol = 0.2f * 0.1f;
  const size_t n_out = static_cast<size_t>(n_steps + 1) * n_paths;
  float *out, *ref;
  uint32_t *u_hi, *u_lo;
  unsigned long long* bad;
  cudaMalloc(&out, n_out * 4);
  cudaMalloc(&ref, n_out * 4);
  cudaMalloc(&u_hi, static_cast<size_t>(n_steps) * (n_paths / 512) * 4);
  cudaMalloc(&u_lo, static_cast<size_t>(n_steps) * 512 * 4);
  cudaMalloc(&bad, sizeof(unsigned long long));
  {  // 30-bit pseudo-random table words (xorshift32): uniform points, 4.85% in the tail
    std::vector<uint32_t> h(static_cast<size_t>(n_steps) * (n_paths / 512)), l(static_cast<size_t>(n_steps) * 512);
    uint32_t x = 2463534242u;
    auto next = [&x]() { x ^= x << 13; x ^= x >> 17; x ^= x << 5; return x & 0x3FFFFFFFu; };
    for (auto& w : h) w = next();
    for (auto& w : l) w = next();
    cudaMemcpy(u_hi, h.data(), h.size() * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(u_lo, l.data(), l.size() * 4, cudaMemcpyHostToDevice);
  }
  const uint32_t k0 = 20261016u, k1 = 0u;
  const int g256 = (n_paths + 255) / 256;
  const char* mode_name[3] = {"kernel", "arith", "stores"};
#define RUN(label, mode, ...) \
  printf("probe %-34s %-6s %.4f ms\n", label, mode_name[mode], time_ms([&]() { __VA_ARGS__; }, reps));
  RUN("kernel 1 before (1 path a thread)", 0, gbm_before<0><<<g256, 256>>>(ref, k0, k1, n_steps, n_paths, S0, drift, vol));
  RUN("kernel 1 before (1 path a thread)", 1, gbm_before<1><<<g256, 256>>>(out, k0, k1, n_steps, n_paths, S0, drift, vol));
  RUN("kernel 1 before (1 path a thread)", 2, gbm_before<2><<<g256, 256>>>(out, k0, k1, n_steps, n_paths, S0, drift, vol));
#ifdef PROBE_AFTER
  int n_sm = 0;
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, 0);
#define GBM_AFTER(P)                                                                                          \
  {                                                                                                           \
    int per_sm = 0;                                                                                           \
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gbm_after<0, P>, 256, 0);                          \
    const int need = n_paths / P / 256, grid = per_sm * n_sm < need ? per_sm * n_sm : need;                   \
    printf("probe kernel 1 after P=%d: %d blocks of 256 a SM resident, grid %d\n", P, per_sm, grid);         \
    RUN("kernel 1 after P=" #P, 0, gbm_after<0, P><<<grid, 256>>>(out, k0, k1, n_steps, n_paths, S0, drift, vol)); \
    printf("probe kernel 1 after P=%d equal to before: %llu of %zu words differ\n", P, diff(out, ref, n_out, bad), n_out); \
    RUN("kernel 1 after P=" #P, 1, gbm_after<1, P><<<grid, 256>>>(out, k0, k1, n_steps, n_paths, S0, drift, vol)); \
    RUN("kernel 1 after P=" #P, 2, gbm_after<2, P><<<grid, 256>>>(out, k0, k1, n_steps, n_paths, S0, drift, vol)); \
  }
  GBM_AFTER(4)
  GBM_AFTER(2)
  {  // the launch grid of 4 paths a thread: blocks for every group, against
     // the persistent grid of the occupancy query, alternated
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gbm_after<0, 4>, 256, 0);
    const int plain = (n_paths / 4 + 255) / 256, occ = per_sm * n_sm < plain ? per_sm * n_sm : plain;
    for (int rep = 0; rep < 2; ++rep) {
      RUN("kernel 1 after P=4, occupancy grid", 0, gbm_after<0, 4><<<occ, 256>>>(out, k0, k1, n_steps, n_paths, S0, drift, vol));
      RUN("kernel 1 after P=4, a group a thread", 0, gbm_after<0, 4><<<plain, 256>>>(out, k0, k1, n_steps, n_paths, S0, drift, vol));
    }
    printf("probe kernel 1 grids: occupancy %d blocks, a group a thread %d blocks\n", occ, plain);
    const int n_groups = n_paths / 4;
    const int grid = (n_groups + 255) / 256;
    RUN("kernel 1 csrc/gbm.cu", 0, amcx_gbm_paths(out, k0, k1, n_paths, n_groups, n_steps / 4, n_steps % 4, 0, 256, grid, S0, drift, vol, nullptr));
    printf("probe kernel 1 csrc/gbm.cu equal to before: %llu of %zu words differ\n", diff(out, ref, n_out, bad), n_out);
  }
#endif
  RUN("kernel 11 before (1 path a thread)", 0, sobol_before<0><<<g256, 256>>>(u_hi, u_lo, ref, n_steps, n_paths, S0, drift, vol));
  RUN("kernel 11 before (1 path a thread)", 1, sobol_before<1><<<g256, 256>>>(u_hi, u_lo, out, n_steps, n_paths, S0, drift, vol));
  RUN("kernel 11 before (1 path a thread)", 2, sobol_before<2><<<g256, 256>>>(u_hi, u_lo, out, n_steps, n_paths, S0, drift, vol));
#ifdef PROBE_AFTER
#define SOBOL_AFTER(S)                                                                                    \
  RUN("kernel 11 after S=" #S, 0, sobol_after<0, S><<<n_paths / 512, 128>>>(u_hi, u_lo, out, n_steps, n_paths, S0, drift, vol)); \
  printf("probe kernel 11 after S=%d equal to before: %llu of %zu words differ\n", S, diff(out, ref, n_out, bad), n_out); \
  RUN("kernel 11 after S=" #S, 1, sobol_after<1, S><<<n_paths / 512, 128>>>(u_hi, u_lo, out, n_steps, n_paths, S0, drift, vol)); \
  RUN("kernel 11 after S=" #S, 2, sobol_after<2, S><<<n_paths / 512, 128>>>(u_hi, u_lo, out, n_steps, n_paths, S0, drift, vol));
  SOBOL_AFTER(8)
  SOBOL_AFTER(4)
  RUN("kernel 11 csrc/sobol_gbm.cu", 0, amcx_sobol_gbm_paths(u_hi, u_lo, nullptr, nullptr, out, n_steps, n_paths, S0, drift, vol, 0, nullptr));
  printf("probe kernel 11 csrc/sobol_gbm.cu equal to before: %llu of %zu words differ\n", diff(out, ref, n_out, bad), n_out);
#endif
  const cudaError_t err = cudaGetLastError();
  printf("probe cuda: %s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
"""

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_FUNC = re.compile(r"Function : (\S+)")


def _find_nvcc() -> str:
    for cand in (os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc") if "CUDA_HOME" in os.environ
                 else None, shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise SystemExit("pathgen_probe: nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _compile(nvcc, src, out, extra, cubin=False):
    cmd = [nvcc, *FLAGS, "-Xptxas", "-v", *extra, "-o", out, src]
    if cubin:
        cmd.insert(1, "-cubin")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line or "error" in line or "Compiling entry" in line:
            print(f"ptxas {Path(src).name}: {line.strip()}", flush=True)
    if proc.returncode != 0:
        print(f"pathgen_probe: nvcc failed ({proc.returncode}) on {src}\n{proc.stderr[-4000:]}")
    return proc.returncode == 0


def sass_functions(text: str):
    """Each function of a ``cuobjdump -sass`` listing (of a cubin or of a
    shared library): its (address, instruction) pairs in address order."""
    out, instrs = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            out[m.group(1)] = instrs = []
            continue
        m = _INSTR.search(line)
        if m and instrs is not None:
            instrs.append((int(m.group(1), 16), m.group(2)))
    return out


def _opcode(ins: str) -> str:
    return re.sub(r"^@!?U?P[T0-9]+\s+", "", ins).split()[0]


def _loops(instrs):
    """(start, end) of each loop: a branch back to a lower address."""
    out = []
    for addr, ins in instrs:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", ins)
        if m and int(m.group(1), 16) < addr:
            out.append((int(m.group(1), 16), addr))
    return out


def _real(instrs, lo, hi, opcode=None):
    """Instructions in [lo, hi] other than NOP (or only those of ``opcode``)."""
    return sum(1 for a, i in instrs if lo <= a <= hi and _opcode(i) != "NOP"
               and (opcode is None or _opcode(i) == opcode))


def sass_loops(text: str):
    """Per function of a ``cuobjdump -sass`` listing: its instruction count
    and each loop closed by a backward branch (start, end, instructions,
    and the counts of a few opcode classes inside)."""
    out = {}
    for func, instrs in sass_functions(text).items():
        loops = []
        for lo, addr in _loops(instrs):
            ops = [_opcode(i).split(".")[0] for a, i in instrs if lo <= a <= addr]
            cls = {}
            for op in ops:
                key = ("MUFU" if op == "MUFU" else "mem" if op[:3] in ("LDG", "STG", "LDS", "STS",
                                                                     "LDC", "LDL", "STL")
                       else "branch" if op in ("BRA", "CALL", "RET", "BSSY", "BSYNC", "EXIT")
                       else "fp32" if op in ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX",
                                             "FCHK")
                       else "int" if op[:1] in ("I", "L", "S") or op in ("LEA", "SEL", "SHF",
                                                                         "POPC", "FLO", "PRMT")
                       else "other")
                cls[key] = cls.get(key, 0) + 1
            loops.append((lo, addr, len(ops), sum(1 for o in ops if o != "NOP"), cls))
        out[func] = (len(instrs), loops)
    return out


def issue_model(text: str):
    """The instruction counts that the pathgen kernels' issue floors weigh,
    from a ``cuobjdump -sass`` listing of ``csrc/gbm.cu`` or
    ``csrc/sobol_gbm.cu`` as built. Every instruction of a region counts as
    issued once a pass (a rarely taken slow path too). Keys, where the
    listing holds the kernel and its loops have the expected nesting:

    - ``gbm_paths``: ``quad``, the step-quad loop of the 16-byte-store
      instance (4 paths x 4 steps a pass);
    - ``sobol_gbm`` (increment order): ``chunk``, the chunk loop (4 steps x
      4 paths) without its two inner loops; ``compaction``, the loop that
      lists a thread's tail points (one pass a point of the warp's busiest
      lane); ``tail``, the dense tail-form loop, which evaluates
      ``tail_points`` points a lane a pass (its remainder runs in the chunk's
      straight code);
    - ``sobol_gbm_bridge``: ``row``, the row loop (4 paths) without its
      entry loop; ``born``, the entry loop body on an entry whose Sobol
      dimension is born there (all of it); ``other``, on any other entry (the
      body less the region that a born entry alone runs).
    """
    model = {}
    for name, instrs in sass_functions(text).items():
        loops = _loops(instrs)
        if not loops:
            continue
        outer = max(loops, key=lambda lo_hi: lo_hi[1] - lo_hi[0])
        inside = [lp for lp in loops if lp != outer and outer[0] <= lp[0] and lp[1] <= outer[1]]
        if "gbm_paths_kernelILb0E" in name:
            innermost = [lp for lp in loops if not any(
                o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
            model["gbm_paths"] = {"quad": max(_real(instrs, *lp) for lp in innermost)}
        elif "sobol_increment_kernel" in name:
            tail = [lp for lp in inside if _real(instrs, *lp, "MUFU.RSQ")]
            scan = [lp for lp in inside if not any(_opcode(i).startswith("MUFU")
                                                   for a, i in instrs if lp[0] <= a <= lp[1])]
            if len(tail) == 1 and len(scan) == 1 and len(inside) == 2:
                model["sobol_gbm"] = {
                    "chunk": _real(instrs, *outer) - _real(instrs, *tail[0])
                    - _real(instrs, *scan[0]),
                    "compaction": _real(instrs, *scan[0]), "tail": _real(instrs, *tail[0]),
                    "tail_points": _real(instrs, *tail[0], "MUFU.RSQ")}
        elif "sobol_bridge_kernel" in name and len(inside) == 1:
            lo, hi = inside[0]
            body = _real(instrs, lo, hi)
            # the regions a forward branch inside the entry loop skips; the
            # born entries' own code is the largest that holds a MUFU
            skipped = []
            for addr, ins in instrs:
                m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", ins)
                if lo <= addr <= hi and m and addr < int(m.group(1), 16) <= hi:
                    region = [i for a, i in instrs if addr < a < int(m.group(1), 16)]
                    if any(_opcode(i).startswith("MUFU") for i in region):
                        skipped.append(sum(1 for i in region if _opcode(i) != "NOP"))
            if skipped:
                model["sobol_gbm_bridge"] = {"row": _real(instrs, *outer) - body, "born": body,
                                             "other": body - max(skipped)}
    return model


class _Clock:
    """Samples the SM clock with nvidia-smi while a probe runs."""

    def __init__(self):
        self.mhz, self._stop = [], threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                "--format=csv,noheader,nounits"], capture_output=True, text=True)
            try:
                self.mhz.append(float(r.stdout.split(",")[0]))
            except ValueError:
                pass
            time.sleep(0.1)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="amcx_torch/build/pathgen_probe",
                    help="directory for the SASS listings")
    args = ap.parse_args(argv)
    nvcc = _find_nvcc()
    csrc = Path(__file__).resolve().parent / "csrc"
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"probe card: {smi}", flush=True)
    tmp = tempfile.mkdtemp(prefix="pathgen_probe_")
    try:
        src = os.path.join(tmp, "probe.cu")
        with open(src, "w") as f:
            f.write(SOURCE)
        # the earlier designs alone first: their split stands if the
        # redesigned copies fail to build
        for name, extra in (("before", []), ("both", ["-DPROBE_AFTER", "-I", str(csrc)])):
            exe = os.path.join(tmp, f"probe_{name}")
            if not _compile(nvcc, src, exe, extra):
                continue
            with _Clock() as clock:
                proc = subprocess.run([exe], capture_output=True, text=True)
            print(proc.stdout, end="", flush=True)
            if proc.returncode != 0:
                print(f"pathgen_probe: probe_{name} exit {proc.returncode}\n{proc.stderr[-2000:]}")
            if clock.mhz:
                print(f"probe {name}: SM clock under load {statistics.median(clock.mhz):.0f} MHz "
                      f"median, {min(clock.mhz):.0f}-{max(clock.mhz):.0f} over {len(clock.mhz)} "
                      f"samples", flush=True)
        cuobjdump = Path(nvcc).parent / "cuobjdump"
        for stem in ("gbm", "sobol_gbm"):
            cubin = os.path.join(tmp, f"{stem}.cubin")
            if not _compile(nvcc, str(csrc / f"{stem}.cu"), cubin, ["-I", str(csrc)], cubin=True):
                continue
            if not cuobjdump.is_file():
                print(f"pathgen_probe: no cuobjdump beside {nvcc}: no SASS counts")
                continue
            sass = subprocess.run([str(cuobjdump), "-sass", cubin], capture_output=True,
                                  text=True).stdout
            Path(args.out, f"{stem}.sass").write_text(sass)
            print(f"sass {stem} issue model: {issue_model(sass)}", flush=True)
            for func, (n, loops) in sass_loops(sass).items():
                print(f"sass {stem} {func[:70]}: {n} instructions", flush=True)
                for lo, hi, n_body, n_real, cls in loops:
                    if n_real >= 8:
                        print(f"sass {stem} {func[:40]} loop {lo:#06x}-{hi:#06x}: {n_real} "
                              f"instructions {dict(sorted(cls.items()))}", flush=True)
    finally:
        shutil.rmtree(tmp)


if __name__ == "__main__":
    main()
