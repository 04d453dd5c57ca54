// Device helpers of the CEM kernels: the Philox4x32-10 generator, the
// bits -> uniform map of the TPU kernels and the proposal noise (used by
// the tensor-core sampler body, cem_mma.cuh), and the FP32 rollout body of
// the given-action cost kernel (cem_rollout_costs.cu): the weights staged
// transposed into shared memory and a register-blocked dense layer over
// per-thread shared-memory columns.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cem {

constexpr int kThreads = 64;  // threads per block; column stride in floats
constexpr int kJB = 8;        // output accumulators per dense pass

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

// y = act(W^T [x0; x1] + bias) on per-thread columns (stride kThreads).
// W is [n0 + n1][out_pad] in shared memory, out_pad a multiple of kJB,
// padded with zeros; y receives out_pad rows.
__device__ inline void dense(const float* __restrict__ W,
                             const float* __restrict__ bias, const float* x0,
                             int n0, const float* x1, int n1, int out_pad,
                             float* y, bool relu) {
  for (int j0 = 0; j0 < out_pad; j0 += kJB) {
    float acc[kJB];
#pragma unroll
    for (int q = 0; q < kJB; ++q) acc[q] = bias[j0 + q];
    for (int i = 0; i < n0 + n1; ++i) {
      const float xi = i < n0 ? x0[i * kThreads] : x1[(i - n0) * kThreads];
      const float4 wa = *reinterpret_cast<const float4*>(W + i * out_pad + j0);
      const float4 wb =
          *reinterpret_cast<const float4*>(W + i * out_pad + j0 + 4);
      acc[0] = fmaf(wa.x, xi, acc[0]);
      acc[1] = fmaf(wa.y, xi, acc[1]);
      acc[2] = fmaf(wa.z, xi, acc[2]);
      acc[3] = fmaf(wa.w, xi, acc[3]);
      acc[4] = fmaf(wb.x, xi, acc[4]);
      acc[5] = fmaf(wb.y, xi, acc[5]);
      acc[6] = fmaf(wb.z, xi, acc[6]);
      acc[7] = fmaf(wb.w, xi, acc[7]);
    }
#pragma unroll
    for (int q = 0; q < kJB; ++q)
      y[(j0 + q) * kThreads] = relu ? fmaxf(acc[q], 0.f) : acc[q];
  }
}

__host__ __device__ inline int pad8(int n) { return (n + kJB - 1) / kJB * kJB; }

// Stage one member's folded MLP (global (in, hid), (hid, hid), (hid, sd),
// row-major) transposed-in-place to [in][out_pad] zero-padded layout, plus
// goal and cost weights. Returns the first float past the staged block.
__device__ inline float* stage_mlp(float* sm, const float* __restrict__ w1_g,
                                   const float* __restrict__ b1_g,
                                   const float* __restrict__ w2_g,
                                   const float* __restrict__ b2_g,
                                   const float* __restrict__ w3_g,
                                   const float* __restrict__ b3_g,
                                   const float* __restrict__ goal_g,
                                   const float* __restrict__ wvec_g, int sd,
                                   int ad, int hid, int hp, int sdp) {
  const int in = sd + ad, tid = threadIdx.x;
  float* W1 = sm;                  // [in][hp]
  float* W2 = W1 + in * hp;        // [hid][hp]
  float* W3 = W2 + hid * hp;       // [hid][sdp]
  float* b1 = W3 + hid * sdp;
  float* b2 = b1 + hp;
  float* b3 = b2 + hp;
  float* goal = b3 + sdp;
  float* wvec = goal + sd;
  for (int k = tid; k < in * hp; k += kThreads) {
    const int i = k / hp, j = k - i * hp;
    W1[k] = j < hid ? w1_g[i * hid + j] : 0.f;
  }
  for (int k = tid; k < hid * hp; k += kThreads) {
    const int i = k / hp, j = k - i * hp;
    W2[k] = j < hid ? w2_g[i * hid + j] : 0.f;
  }
  for (int k = tid; k < hid * sdp; k += kThreads) {
    const int i = k / sdp, j = k - i * sdp;
    W3[k] = j < sd ? w3_g[i * sd + j] : 0.f;
  }
  for (int k = tid; k < hp; k += kThreads) {
    b1[k] = k < hid ? b1_g[k] : 0.f;
    b2[k] = k < hid ? b2_g[k] : 0.f;
  }
  for (int k = tid; k < sdp; k += kThreads) b3[k] = k < sd ? b3_g[k] : 0.f;
  for (int k = tid; k < sd; k += kThreads) {
    goal[k] = goal_g[k];
    wvec[k] = wvec_g[k];
  }
  return wvec + sd;
}

__host__ __device__ inline size_t mlp_floats(int sd, int ad, int hid, int hp,
                                             int sdp) {
  return (size_t)(sd + ad) * hp + (size_t)hid * hp + (size_t)hid * sdp +
         2 * (size_t)hp + sdp + 2 * (size_t)sd;
}

// One model step for a candidate: S <- MLP([S; A]) (S: sdp rows, A: ad
// rows, H1 / H2: hp rows each), returning the step's planning cost
//   sum_d sqrt(((s - goal) w)^2 + as^2) - as + aa^2 mean_d (cosh(a/aa) - 1)
// given c_act = sum_d (cosh(a/aa) - 1), which the caller accumulates while
// it writes the actions (summing it here from the A column instead
// measured ~20% slower on the H100 at the walker shapes).
__device__ inline float mlp_step_cost(const float* sm, float* S, float* A,
                                      float* H1, float* H2, int sd, int ad,
                                      int hid, int hp, int sdp, float alpha_s,
                                      float alpha_a, float c_act) {
  const int in = sd + ad;
  const float* W1 = sm;
  const float* W2 = W1 + in * hp;
  const float* W3 = W2 + hid * hp;
  const float* b1 = W3 + hid * sdp;
  const float* b2 = b1 + hp;
  const float* b3 = b2 + hp;
  const float* goal = b3 + sdp;
  const float* wvec = goal + sd;
  dense(W1, b1, S, sd, A, ad, hp, H1, true);
  dense(W2, b2, H1, hid, nullptr, 0, hp, H2, true);
  dense(W3, b3, H2, hid, nullptr, 0, sdp, S, false);
  float c_state = 0.f;
  for (int i = 0; i < sd; ++i) {
    const float dd = (S[i * kThreads] - goal[i]) * wvec[i];
    c_state += sqrtf(dd * dd + alpha_s * alpha_s) - alpha_s;
  }
  return c_state + alpha_a * alpha_a * (c_act / (float)ad);
}

}  // namespace cem
