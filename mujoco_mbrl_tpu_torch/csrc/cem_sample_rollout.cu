// Fused CEM sample + MLP rollout + planning cost for Hopper (sm_90a).
//
// Replaces the TPU kernel mujoco_mbrl_tpu/ops/cem_rollout.py:
// _sample_kernel_multi (launched by _sample_multi from
// mlp_sample_rollout_costs). For every env b and candidate k it samples an
// action sequence from the CEM proposal (mean, std) of shape (H, ad) with
// triangular (Irwin-Hall(2) * sqrt(6)) or normal (Box-Muller) noise,
// antithetic (candidate k + ceil(K/2) gets -z of candidate k), clipped to
// [low, high]; rolls a 3-layer ReLU MLP (normalizers folded into the
// weights) for H steps; and accumulates in float32
//   sum_t [ sum_d sqrt(((s - goal) w)^2 + as^2) - as
//           + aa^2 mean_d (cosh(a / aa) - 1) ].
// Outputs: costs (B, K) and actions (B, H, ad, K), exact K, no padding.
//
// Design: grid (ceil(Kz / 64), B); one thread per antithetic pair. The
// folded weights (transposed to [in][out], out padded to 8), the env's
// mean/std and goal/weights live in shared memory; each thread keeps its
// two candidates' states and its hidden activations in shared-memory
// columns (stride 64 floats: conflict-free; ~72 KB a block at the walker
// shapes, so three blocks fit on an SM). A layer is a register-blocked
// GEMV: 8 output accumulators, weights read as float4 broadcasts. The
// noise is a counter-based Philox4x32-10 keyed by `seed` with counter
// (env, t, pair, draw), so a pair draws z once for both candidates.
//
// Bound: 2 * B * K * H * (in*hid + hid*hid + hid*sd) FLOP (3.2e11 at the
// walker shapes) at the card's non-tensor FP32 rate; the action write
// (B * H * ad * K * 4 bytes) is the only large memory traffic.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kJB = 8;

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

// y = act(W^T [x0; x1] + bias) on per-thread columns (stride kThreads).
// W is [n0 + n1][out_pad] in shared memory, out_pad a multiple of kJB,
// padded with zeros; y receives out_pad rows.
__device__ void dense(const float* __restrict__ W,
                      const float* __restrict__ bias, const float* x0, int n0,
                      const float* x1, int n1, int out_pad, float* y,
                      bool relu) {
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

struct Dims {
  int B, K, Kz, H, sd, ad, hid, hp, sdp, nu;  // nu: uniforms per draw, x4
};

__host__ __device__ inline size_t block_floats(const Dims& d) {
  const size_t weights = (size_t)(d.sd + d.ad) * d.hp + (size_t)d.hid * d.hp +
                         (size_t)d.hid * d.sdp + 2 * d.hp + d.sdp + 2 * d.sd +
                         2 * (size_t)d.H * d.ad;
  const size_t cols = (size_t)kThreads *
                      (2 * d.sdp + d.ad + 2 * d.hp + d.ad + d.nu);
  return (weights + 3) / 4 * 4 + cols;
}

__global__ void cem_sample_rollout_kernel(
    const float* __restrict__ s0_g, const float* __restrict__ mean_g,
    const float* __restrict__ std_g, const float* __restrict__ w1_g,
    const float* __restrict__ b1_g, const float* __restrict__ w2_g,
    const float* __restrict__ b2_g, const float* __restrict__ w3_g,
    const float* __restrict__ b3_g, const float* __restrict__ goal_g,
    const float* __restrict__ wvec_g, uint32_t key0, uint32_t key1, Dims d,
    int sampler, int antithetic, float low, float high, float alpha_s,
    float alpha_a, float* __restrict__ costs_g, float* __restrict__ act_g) {
  extern __shared__ __align__(16) float sm[];
  const int in = d.sd + d.ad;
  float* W1 = sm;                        // [in][hp]
  float* W2 = W1 + in * d.hp;            // [hid][hp]
  float* W3 = W2 + d.hid * d.hp;         // [hid][sdp]
  float* b1 = W3 + d.hid * d.sdp;
  float* b2 = b1 + d.hp;
  float* b3 = b2 + d.hp;
  float* goal = b3 + d.sdp;
  float* wvec = goal + d.sd;
  float* mean = wvec + d.sd;             // [H][ad]
  float* stdv = mean + d.H * d.ad;
  const size_t wfloats = (size_t)(stdv + d.H * d.ad - sm);
  float* cols = sm + (wfloats + 3) / 4 * 4;

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  // ---- stage weights (transposed, zero-padded) and this env's proposal
  for (int k = tid; k < in * d.hp; k += kThreads) {
    const int i = k / d.hp, j = k - i * d.hp;
    W1[k] = j < d.hid ? w1_g[i * d.hid + j] : 0.f;
  }
  for (int k = tid; k < d.hid * d.hp; k += kThreads) {
    const int i = k / d.hp, j = k - i * d.hp;
    W2[k] = j < d.hid ? w2_g[i * d.hid + j] : 0.f;
  }
  for (int k = tid; k < d.hid * d.sdp; k += kThreads) {
    const int i = k / d.sdp, j = k - i * d.sdp;
    W3[k] = j < d.sd ? w3_g[i * d.sd + j] : 0.f;
  }
  for (int k = tid; k < d.hp; k += kThreads) {
    b1[k] = k < d.hid ? b1_g[k] : 0.f;
    b2[k] = k < d.hid ? b2_g[k] : 0.f;
  }
  for (int k = tid; k < d.sdp; k += kThreads) b3[k] = k < d.sd ? b3_g[k] : 0.f;
  for (int k = tid; k < d.sd; k += kThreads) {
    goal[k] = goal_g[k];
    wvec[k] = wvec_g[k];
  }
  for (int k = tid; k < d.H * d.ad; k += kThreads) {
    mean[k] = mean_g[(size_t)b * d.H * d.ad + k];
    stdv[k] = std_g[(size_t)b * d.H * d.ad + k];
  }
  __syncthreads();

  const int p = blockIdx.x * kThreads + tid;
  if (p >= d.Kz) return;                 // no barrier below this point
  float* S = cols + tid;                 // 2 x sdp rows: candidate states
  float* A = S + 2 * d.sdp * kThreads;   // ad rows: current action
  float* H1 = A + d.ad * kThreads;       // hp rows
  float* H2 = H1 + d.hp * kThreads;      // hp rows
  float* Z = H2 + d.hp * kThreads;       // ad rows: this step's noise
  float* U = Z + d.ad * kThreads;        // nu rows: uniforms

  const int ncand = (antithetic && p + d.Kz < d.K) ? 2 : 1;
  for (int c = 0; c < ncand; ++c)
    for (int i = 0; i < d.sd; ++i)
      S[(c * d.sdp + i) * kThreads] = s0_g[(size_t)b * d.sd + i];
  float acc0 = 0.f, acc1 = 0.f;
  const float as2 = alpha_s * alpha_s, aa2 = alpha_a * alpha_a;

  for (int t = 0; t < d.H; ++t) {
    for (int q = 0; q < d.nu / 4; ++q) {
      const uint4 r = philox4x32_10(
          make_uint4((uint32_t)b, (uint32_t)t, (uint32_t)p, (uint32_t)q),
          key0, key1);
      U[(4 * q + 0) * kThreads] = to_uniform(r.x);
      U[(4 * q + 1) * kThreads] = to_uniform(r.y);
      U[(4 * q + 2) * kThreads] = to_uniform(r.z);
      U[(4 * q + 3) * kThreads] = to_uniform(r.w);
    }
    for (int j = 0; j < d.ad; ++j) {
      const float u1 = U[j * kThreads], u2 = U[(d.ad + j) * kThreads];
      Z[j * kThreads] =
          sampler == 0
              ? (u1 + u2 - 1.f) * 2.4494897f
              : sqrtf(-2.f * logf(fminf(fmaxf(u1, 1e-7f), 1.f))) *
                    cosf(6.2831855f * u2);
    }
    for (int c = 0; c < ncand; ++c) {
      const int k = c == 0 ? p : p + d.Kz;
      float* Sc = S + c * d.sdp * kThreads;
      float c_act = 0.f;
      for (int j = 0; j < d.ad; ++j) {
        const float z = c == 0 ? Z[j * kThreads] : -Z[j * kThreads];
        const float a = fminf(fmaxf(mean[t * d.ad + j] + stdv[t * d.ad + j] * z,
                                    low), high);
        A[j * kThreads] = a;
        act_g[(((size_t)b * d.H + t) * d.ad + j) * d.K + k] = a;
        const float e = expf(a / alpha_a);
        c_act += 0.5f * (e + 1.f / e) - 1.f;
      }
      dense(W1, b1, Sc, d.sd, A, d.ad, d.hp, H1, true);
      dense(W2, b2, H1, d.hid, nullptr, 0, d.hp, H2, true);
      dense(W3, b3, H2, d.hid, nullptr, 0, d.sdp, Sc, false);
      float c_state = 0.f;
      for (int i = 0; i < d.sd; ++i) {
        const float dd = (Sc[i * kThreads] - goal[i]) * wvec[i];
        c_state += sqrtf(dd * dd + as2) - alpha_s;
      }
      const float step_cost = c_state + aa2 * (c_act / (float)d.ad);
      if (c == 0) acc0 += step_cost; else acc1 += step_cost;
    }
  }
  costs_g[(size_t)b * d.K + p] = acc0;
  if (ncand == 2) costs_g[(size_t)b * d.K + p + d.Kz] = acc1;
}

Dims make_dims(int B, int K, int H, int sd, int ad, int hid, int antithetic) {
  Dims d;
  d.B = B;
  d.K = K;
  d.Kz = antithetic ? (K + 1) / 2 : K;
  d.H = H;
  d.sd = sd;
  d.ad = ad;
  d.hid = hid;
  d.hp = pad8(hid);
  d.sdp = pad8(sd);
  d.nu = (2 * ad + 3) / 4 * 4;
  return d;
}

}  // namespace

extern "C" size_t cem_smem_bytes(int K, int H, int sd, int ad, int hid,
                                 int antithetic) {
  return sizeof(float) *
         block_floats(make_dims(1, K, H, sd, ad, hid, antithetic));
}

extern "C" int cem_sample_rollout(
    const float* s0, const float* mean, const float* stdv, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* w3,
    const float* b3, const float* goal, const float* wvec,
    unsigned long long seed, int B, int K, int H, int sd, int ad, int hid,
    int sampler, int antithetic, float low, float high, float alpha_s,
    float alpha_a, float* costs, float* actions, void* stream) {
  const Dims d = make_dims(B, K, H, sd, ad, hid, antithetic);
  const size_t smem = sizeof(float) * block_floats(d);
  cudaError_t e = cudaFuncSetAttribute(
      cem_sample_rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((d.Kz + kThreads - 1) / kThreads, B);
  if (B > 0 && K > 0)
    cem_sample_rollout_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        s0, mean, stdv, w1, b1, w2, b2, w3, b3, goal, wvec, (uint32_t)seed,
        (uint32_t)(seed >> 32), d, sampler, antithetic, low, high, alpha_s,
        alpha_a, costs, actions);
  return (int)cudaGetLastError();
}
