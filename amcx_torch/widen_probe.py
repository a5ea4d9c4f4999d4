"""Throughput of widening f32 products to f64 on the card.

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 -m amcx_torch.widen_probe

Kernels 3 and 8 sum f32 products in f64, so each product is widened
(F2F) before its f64 add. This probe times chains of that work in
registers, 16 independent sums a thread, and prints one line each, as
operations a clock a SM at the H100's 1.98 GHz boost clock: f32 product
widened by F2F then added in f64; the same widened on the integer unit
(sign, exponent + 896, mantissa << 29: exact for 0 and normal values);
three of seven by F2F and four on the integer unit; the f32 add alone; and
f64 adds alone. The F2F line is swept over 1 to 8 blocks of 256 threads a
SM. It builds its own source with nvcc into a temporary directory and
imports nothing of the port.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

SOURCE = r"""
#include <cstdio>
#include <cuda_runtime.h>

__device__ __forceinline__ double widen_alu(float x) {
  const unsigned u = __float_as_uint(x);
  const unsigned hi = (static_cast<unsigned>(static_cast<int>(u) >> 3) & 0x8fffffffu) + 0x38000000u;
  return __hiloint2double(static_cast<int>((u << 1) != 0u ? hi : 0u), static_cast<int>(u << 29));
}

template <int MODE>
__global__ void probe(const float* in, double* out, int iters) {
  constexpr int N = 16;
  float x[N];
  const float y = in[threadIdx.x & 31];
  const float s = in[32 + (threadIdx.x & 31)];
  double acc[N], dx[N];
  float accf[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    x[j] = in[j] + threadIdx.x;
    acc[j] = 0.0;
    accf[j] = 0.0f;
    dx[j] = in[j];
  }
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (MODE == 0) acc[j] += static_cast<double>(x[j] * y);
      if (MODE == 1) acc[j] += widen_alu(x[j] * y);
      if (MODE == 2) acc[j] += (j % 7 < 3) ? static_cast<double>(x[j] * y) : widen_alu(x[j] * y);
      if (MODE == 3) accf[j] += x[j] * y;
      if (MODE == 4) acc[j] += dx[j];
      x[j] = x[j] + s;
      if (MODE == 4) dx[j] = dx[j] + 1.0;
    }
  }
  double t = 0.0;
#pragma unroll
  for (int j = 0; j < N; ++j) t += acc[j] + accf[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = t;
}

template <int MODE>
void run(const char* name, const float* in, double* out, int per_sm, int iters, int n_sm) {
  const int blocks = n_sm * per_sm, threads = 256;
  probe<MODE><<<blocks, threads>>>(in, out, iters);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  for (int r = 0; r < 5; ++r) probe<MODE><<<blocks, threads>>>(in, out, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  const double ops = 5.0 * blocks * threads * static_cast<double>(iters) * 16;
  printf("%-34s %d blocks of 256 a SM: %.2f a clock a SM\n", name, per_sm,
         ops / (ms * 1e-3) / 1.98e9 / n_sm);
}

int main() {
  int n_sm = 0;
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, 0);
  float* in;
  double* out;
  float h[64];
  for (int i = 0; i < 64; ++i) h[i] = 1.0f + 0.01f * i;
  cudaMalloc(&in, sizeof(h));
  cudaMemcpy(in, h, sizeof(h), cudaMemcpyHostToDevice);
  cudaMalloc(&out, sizeof(double) * n_sm * 8 * 256);
  for (int per_sm = 1; per_sm <= 8; per_sm *= 2) {
    run<0>("f32 product, F2F, f64 add", in, out, per_sm, 4000, n_sm);
  }
  run<1>("f32 product, integer widening", in, out, 8, 4000, n_sm);
  run<2>("3 of 7 by F2F, 4 on the integer unit", in, out, 8, 4000, n_sm);
  run<3>("f32 product, f32 add", in, out, 8, 4000, n_sm);
  run<4>("f64 add, f64 add", in, out, 8, 4000, n_sm);
  const cudaError_t err = cudaGetLastError();
  printf("cuda: %s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
"""


def main():
    from .ops._build import _nvcc

    tmp = tempfile.mkdtemp(prefix="widen_probe_")
    try:
        src, exe = os.path.join(tmp, "probe.cu"), os.path.join(tmp, "probe")
        with open(src, "w") as f:
            f.write(SOURCE)
        subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-fmad=false", "-o", exe, src], check=True)
        subprocess.run([exe], check=True)
    finally:
        shutil.rmtree(tmp)


if __name__ == "__main__":
    main()
