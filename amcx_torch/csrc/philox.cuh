// Philox4x32-10 counter-based generator (Salmon et al., SC'11, "Parallel
// random numbers: as easy as 1, 2, 3"), written out by hand: no curand.
//
// The pathgen draws are a documented pure function of (seed, path, step):
//   key     = (seed mod 2^32, seed >> 32)
//   counter = (step quad j, path p, 0, 0)
//   u_i     = ((x_i >> 8) + 1) * 2^-24  in (0, 1], exact in f32
//   Box-Muller pairs (u0, u1) and (u2, u3) give the normals of steps
//   4j .. 4j+3; a tail quad past n_steps drops its surplus.
// amcx_torch/ops/gbm.py (`philox4x32_10`) implements the same function in
// torch integer arithmetic; both are checked against Random123's
// known-answer vectors.
#pragma once

#include <cstdint>

namespace amcx {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      key.x += kPhiloxW0;
      key.y += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, ctr.x);
    const uint32_t lo0 = kPhiloxM0 * ctr.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, ctr.z);
    const uint32_t lo1 = kPhiloxM1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
  }
  return ctr;
}

// 24 random bits to a uniform in (0, 1]: never 0, so logf is safe.
__device__ __forceinline__ float philox_uniform(uint32_t x) {
  return static_cast<float>((x >> 8) + 1u) * 0x1p-24f;
}

// The four standard normals of one Philox draw (two Box-Muller pairs).
__device__ __forceinline__ void philox_normals4(uint4 x, float (&z)[4]) {
  const float r0 = sqrtf(-2.0f * logf(philox_uniform(x.x)));
  const float r1 = sqrtf(-2.0f * logf(philox_uniform(x.z)));
  float s0, c0, s1, c1;
  sincospif(2.0f * philox_uniform(x.y), &s0, &c0);
  sincospif(2.0f * philox_uniform(x.w), &s1, &c1);
  z[0] = r0 * c0;
  z[1] = r0 * s0;
  z[2] = r1 * c1;
  z[3] = r1 * s1;
}

// The four standard normals of one Philox draw by exactly the f32
// operations of the plain version of the fusedpath kernel
// (ops/lsmc_fusedpath.py, fusedpath_normals): the angle u * 2pi is one f32
// product, and cosf/sinf/logf/sqrtf are the same library functions as
// torch's CUDA cos/sin/log/sqrt, so the two give the same bits (under
// -fmad=false). philox_normals4 above keeps kernel 1's sincospif.
__device__ __forceinline__ void philox_normals4_cos_sin(uint4 x, float (&z)[4]) {
  constexpr float kTwoPi = 6.28318530717958647692f;
  const float r0 = sqrtf(-2.0f * logf(philox_uniform(x.x)));
  const float r1 = sqrtf(-2.0f * logf(philox_uniform(x.z)));
  const float a0 = philox_uniform(x.y) * kTwoPi;
  const float a1 = philox_uniform(x.w) * kTwoPi;
  z[0] = r0 * cosf(a0);
  z[1] = r0 * sinf(a0);
  z[2] = r1 * cosf(a1);
  z[3] = r1 * sinf(a1);
}

}  // namespace amcx
