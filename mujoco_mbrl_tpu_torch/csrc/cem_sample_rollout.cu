// Fused CEM sample + MLP rollout + planning cost for Hopper (sm_90a).
//
// Replaces two TPU kernels of mujoco_mbrl_tpu/ops/cem_rollout.py, both
// launched from mlp_sample_rollout_costs: _sample_kernel_multi (G envs per
// program, normal / triangular) and _sample_kernel (one env per program,
// and the only one with the spline4 sampler). The G lane grouping is a TPU
// layout choice; here one launch covers every env. For every env b and
// candidate k it samples an action sequence from the CEM proposal (mean,
// std) of shape (H, ad), antithetic (candidate k + ceil(K/2) gets -z of
// candidate k), clipped to [low, high]; rolls a 3-layer ReLU MLP
// (normalizers folded into the weights) for H steps; and accumulates in
// float32
//   sum_t [ sum_d sqrt(((s - goal) w)^2 + as^2) - as
//           + aa^2 mean_d (cosh(a / aa) - 1) ].
// Outputs: costs (B, K) and actions (B, H, ad, K), exact K, no padding.
//
// Noise: a counter-based Philox4x32-10 keyed by `seed`.
//   triangular (Irwin-Hall(2) * sqrt(6)) and normal (Box-Muller): counter
//     (env, t, pair, draw), so a pair draws z once for both candidates;
//   spline4 (iCEM-style low-frequency noise, cem_rollout.py:285-310):
//     triangular knots every 4 steps, n_knots = (H + 3) / 4 + 1, knot i
//     drawn from counter (env, i, pair, draw); step t = 4i + r uses
//     z = knot_i (r = 0) or ((1 - w) knot_i + w knot_{i+1}) / sqrt((1-w)^2
//     + w^2), w = r / 4, in the TPU kernel's float32 operation order. The
//     TPU kernel writes all H steps of actions before its rollout reads
//     them back; here each step's z is formed from the two knots a thread
//     keeps in its columns, which gives the same actions.
//
// Design: grid (ceil(Kz / 64), B); one thread per antithetic pair. The
// folded weights (transposed to [in][out], out padded to 8), the env's
// mean/std and goal/weights live in shared memory; each thread keeps its
// two candidates' states and its hidden activations in shared-memory
// columns (stride 64 floats: conflict-free; ~72 KB a block at the walker
// shapes, so three blocks fit on an SM; spline4 adds 2 * ad rows for the
// knots). A layer is a register-blocked GEMV: 8 output accumulators,
// weights read as float4 broadcasts (cem_common.cuh).
//
// Bound: 2 * B * K * H * (in*hid + hid*hid + hid*sd) FLOP (3.2e11 at the
// walker shapes) at the card's non-tensor FP32 rate; the action write
// (B * H * ad * K * 4 bytes) is the only large memory traffic.

#include "cem_common.cuh"

namespace {

using namespace cem;

struct Dims {
  int B, K, Kz, H, sd, ad, hid, hp, sdp, nu, nk;  // nu: uniforms per draw, x4
};                                                  // nk: knot rows (spline4)

__host__ __device__ inline size_t block_floats(const Dims& d) {
  const size_t weights = mlp_floats(d.sd, d.ad, d.hid, d.hp, d.sdp) +
                         2 * (size_t)d.H * d.ad;
  const size_t cols = (size_t)kThreads *
                      (2 * d.sdp + d.ad + 2 * d.hp + d.ad + d.nu + d.nk);
  return (weights + 3) / 4 * 4 + cols;
}

// spline4: column Z <- the noise of step t from the knot columns K0, K1
// (knot t/4 and t/4 + 1), drawing the next knot at every multiple of 4.
__device__ inline void spline4_step(const Dims& d, int t, uint32_t b,
                                    uint32_t p, uint32_t key0, uint32_t key1,
                                    float* U, float* K0, float* K1,
                                    float* Z) {
  const int r = t & 3;
  if (r == 0) {
    const int i = t >> 2;
    if (i == 0) {
      draw_uniforms(U, d.nu, b, 0u, p, key0, key1);
      for (int j = 0; j < d.ad; ++j)
        K1[j * kThreads] = noise(U[j * kThreads], U[(d.ad + j) * kThreads],
                                 true);
    }
    for (int j = 0; j < d.ad; ++j) K0[j * kThreads] = K1[j * kThreads];
    draw_uniforms(U, d.nu, b, (uint32_t)(i + 1), p, key0, key1);
    for (int j = 0; j < d.ad; ++j)
      K1[j * kThreads] = noise(U[j * kThreads], U[(d.ad + j) * kThreads],
                               true);
    for (int j = 0; j < d.ad; ++j) Z[j * kThreads] = K0[j * kThreads];
    return;
  }
  // (1 - w), w and 1 / sqrt((1 - w)^2 + w^2) for w = r / 4, rounded to
  // float32 once as the TPU kernel's Python doubles are
  const float wa = r == 1 ? 0.75f : (r == 2 ? 0.5f : 0.25f);
  const float wb = 1.f - wa;
  const float c = r == 2 ? 1.4142135623730951f : 1.2649110640673518f;
  for (int j = 0; j < d.ad; ++j)
    Z[j * kThreads] =
        __fmul_rn(__fadd_rn(__fmul_rn(wa, K0[j * kThreads]),
                            __fmul_rn(wb, K1[j * kThreads])),
                  c);
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
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  // ---- stage weights (transposed, zero-padded) and this env's proposal
  float* mean = stage_mlp(sm, w1_g, b1_g, w2_g, b2_g, w3_g, b3_g, goal_g,
                          wvec_g, d.sd, d.ad, d.hid, d.hp, d.sdp);  // [H][ad]
  float* stdv = mean + d.H * d.ad;
  for (int k = tid; k < d.H * d.ad; k += kThreads) {
    mean[k] = mean_g[(size_t)b * d.H * d.ad + k];
    stdv[k] = std_g[(size_t)b * d.H * d.ad + k];
  }
  const size_t wfloats = (size_t)(stdv + d.H * d.ad - sm);
  float* cols = sm + (wfloats + 3) / 4 * 4;
  __syncthreads();

  const int p = blockIdx.x * kThreads + tid;
  if (p >= d.Kz) return;                 // no barrier below this point
  float* S = cols + tid;                 // 2 x sdp rows: candidate states
  float* A = S + 2 * d.sdp * kThreads;   // ad rows: current action
  float* H1 = A + d.ad * kThreads;       // hp rows
  float* H2 = H1 + d.hp * kThreads;      // hp rows
  float* Z = H2 + d.hp * kThreads;       // ad rows: this step's noise
  float* U = Z + d.ad * kThreads;        // nu rows: uniforms
  float* K0 = U + d.nu * kThreads;       // ad rows each: spline4 knots
  float* K1 = K0 + d.ad * kThreads;

  const int ncand = (antithetic && p + d.Kz < d.K) ? 2 : 1;
  for (int c = 0; c < ncand; ++c)
    for (int i = 0; i < d.sd; ++i)
      S[(c * d.sdp + i) * kThreads] = s0_g[(size_t)b * d.sd + i];
  float acc0 = 0.f, acc1 = 0.f;

  for (int t = 0; t < d.H; ++t) {
    if (sampler == kSpline4) {
      spline4_step(d, t, (uint32_t)b, (uint32_t)p, key0, key1, U, K0, K1, Z);
    } else {
      draw_uniforms(U, d.nu, (uint32_t)b, (uint32_t)t, (uint32_t)p, key0,
                    key1);
      for (int j = 0; j < d.ad; ++j)
        Z[j * kThreads] = noise(U[j * kThreads], U[(d.ad + j) * kThreads],
                                sampler == kTriangular);
    }
    for (int c = 0; c < ncand; ++c) {
      const int k = c == 0 ? p : p + d.Kz;
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
      const float step_cost =
          mlp_step_cost(sm, S + c * d.sdp * kThreads, A, H1, H2, d.sd, d.ad,
                        d.hid, d.hp, d.sdp, alpha_s, alpha_a, c_act);
      if (c == 0) acc0 += step_cost; else acc1 += step_cost;
    }
  }
  costs_g[(size_t)b * d.K + p] = acc0;
  if (ncand == 2) costs_g[(size_t)b * d.K + p + d.Kz] = acc1;
}

Dims make_dims(int B, int K, int H, int sd, int ad, int hid, int antithetic,
               int sampler) {
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
  d.nk = sampler == kSpline4 ? 2 * ad : 0;
  return d;
}

}  // namespace

extern "C" size_t cem_smem_bytes(int K, int H, int sd, int ad, int hid,
                                 int antithetic, int sampler) {
  return sizeof(float) *
         block_floats(make_dims(1, K, H, sd, ad, hid, antithetic, sampler));
}

extern "C" int cem_sample_rollout(
    const float* s0, const float* mean, const float* stdv, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* w3,
    const float* b3, const float* goal, const float* wvec,
    unsigned long long seed, int B, int K, int H, int sd, int ad, int hid,
    int sampler, int antithetic, float low, float high, float alpha_s,
    float alpha_a, float* costs, float* actions, void* stream) {
  const Dims d = make_dims(B, K, H, sd, ad, hid, antithetic, sampler);
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
