// Device helpers of the CEM sampler kernels (cem_mma.cuh rollout_tile,
// the body of cem_sample_rollout.cu and cem_sample_rollout_ens.cu): the
// Philox4x32-10 generator, the bits -> uniform map of the TPU kernels
// (mujoco_mbrl_tpu/ops/cem_rollout.py) and the proposal noise.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cem {

enum Sampler { kTriangular = 0, kNormal = 1, kSpline4 = 2 };

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// bits viewed as int32, times 2^-32, plus 0.5 (cem_rollout.py:392-396)
__device__ __forceinline__ float to_uniform(uint32_t bits) {
  return (float)(int32_t)bits * 2.3283064365386963e-10f + 0.5f;
}

// Unit-variance noise from the uniforms u1 = U[j], u2 = U[ad + j]:
// triangular (u1 + u2 - 1) * sqrt(6), or Box-Muller with u1 >= 1e-7.
__device__ __forceinline__ float noise(float u1, float u2, bool triangular) {
  return triangular ? (u1 + u2 - 1.f) * 2.4494897f
                    : sqrtf(-2.f * logf(fminf(fmaxf(u1, 1e-7f), 1.f))) *
                          cosf(6.2831855f * u2);
}

}  // namespace cem
