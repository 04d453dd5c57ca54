// Ensemble TS-infinity CEM sample + MLP rollout + planning cost for Hopper
// (sm_90a).
//
// Replaces two TPU kernels of mujoco_mbrl_tpu/ops/cem_rollout.py, both
// launched from mlp_sample_rollout_costs_ensemble:
// _sample_kernel_ens_grouped (grid (member, env group), the production
// layout) and _sample_kernel_ens (one program per env with every member's
// lanes, the small-B fallback). Their lane grouping, 128-lane padding and
// float32-max masking of padded lanes are TPU layout choices; one launch
// here covers every (env, candidate) at any B. Candidate k of env b is
// rolled for the whole horizon by member k % n (TS-infinity, as
// EnsembleDynamics.forward_ts assigns it); its actions are sampled from the
// CEM proposal (mean, std) of shape (H, ad), triangular or normal,
// antithetic (candidate k + ceil(K/2) gets -z of candidate k), clipped to
// [low, high]; the cost is the same goal-state cost as the single-MLP
// kernel (cem_sample_rollout.cu). Outputs: costs (B, K) and actions
// (B, H, ad, K), exact K, decoded so that member = k % n.
//
// Noise: the Philox4x32-10 of the single-MLP kernel, keyed by `seed` with
// counter (env, t, pair, draw). A pair's two candidates can belong to
// different members (K = 60, n = 4: candidate 0 is member 0, its partner
// 30 is member 2), so every thread regenerates its pair's z and negates it
// for the second half. With n = 1 this gives the single-MLP kernel's
// actions for the same seed.
//
// Design: grid (ceil(B * K / n / 64), n); block (., m) holds member m's
// folded weights in shared memory (transposed to [in][out], out padded to
// 8: ~23 KB at the walker shapes) and its 64 threads take consecutive
// (env, q) of that member, candidate k = q * n + m. Each thread keeps its
// state, action and hidden activations in shared-memory columns (stride
// 64 floats, ~64 KB a block at the walker shapes: three blocks an SM); the
// env's mean / std and s0 are read from global memory (broadcast within a
// warp). A layer is the register-blocked GEMV of cem_common.cuh.
//
// Bound: 2 * B * K * H * (in*hid + hid*hid + hid*sd) FLOP, as for the
// single MLP since each candidate runs one member (3.2e11 at walker_ens
// shapes) at the card's non-tensor FP32 rate; the action write
// (B * H * ad * K * 4 bytes) is the only large memory traffic.

#include "cem_common.cuh"

namespace {

using namespace cem;

struct Dims {
  int B, K, Kz, Kn, n, H, sd, ad, hid, hp, sdp, nu;
};

__host__ __device__ inline size_t block_floats(const Dims& d) {
  const size_t weights = mlp_floats(d.sd, d.ad, d.hid, d.hp, d.sdp);
  const size_t cols = (size_t)kThreads * (d.sdp + d.ad + 2 * d.hp + d.nu);
  return (weights + 3) / 4 * 4 + cols;
}

__global__ void cem_sample_rollout_ens_kernel(
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
  const int m = blockIdx.y;
  const int in = d.sd + d.ad;
  // ---- stage member m's weights (transposed, zero-padded)
  float* end = stage_mlp(
      sm, w1_g + (size_t)m * in * d.hid, b1_g + (size_t)m * d.hid,
      w2_g + (size_t)m * d.hid * d.hid, b2_g + (size_t)m * d.hid,
      w3_g + (size_t)m * d.hid * d.sd, b3_g + (size_t)m * d.sd, goal_g,
      wvec_g, d.sd, d.ad, d.hid, d.hp, d.sdp);
  float* cols = sm + ((size_t)(end - sm) + 3) / 4 * 4;
  __syncthreads();

  const long long g = (long long)blockIdx.x * kThreads + tid;
  if (g >= (long long)d.B * d.Kn) return;  // no barrier below this point
  const int b = (int)(g / d.Kn);
  const int k = (int)(g - (long long)b * d.Kn) * d.n + m;
  const bool second = antithetic && k >= d.Kz;
  const int p = second ? k - d.Kz : k;    // antithetic pair index
  float* S = cols + tid;                  // sdp rows: candidate state
  float* A = S + d.sdp * kThreads;        // ad rows: current action
  float* H1 = A + d.ad * kThreads;        // hp rows
  float* H2 = H1 + d.hp * kThreads;       // hp rows
  float* U = H2 + d.hp * kThreads;        // nu rows: uniforms

  for (int i = 0; i < d.sd; ++i) S[i * kThreads] = s0_g[(size_t)b * d.sd + i];
  const float* mean = mean_g + (size_t)b * d.H * d.ad;
  const float* stdv = std_g + (size_t)b * d.H * d.ad;
  float acc = 0.f;
  for (int t = 0; t < d.H; ++t) {
    draw_uniforms(U, d.nu, (uint32_t)b, (uint32_t)t, (uint32_t)p, key0, key1);
    float c_act = 0.f;
    for (int j = 0; j < d.ad; ++j) {
      const float z = noise(U[j * kThreads], U[(d.ad + j) * kThreads],
                            sampler == kTriangular);
      const float a = fminf(fmaxf(__ldg(mean + t * d.ad + j) +
                                      __ldg(stdv + t * d.ad + j) *
                                          (second ? -z : z),
                                  low), high);
      A[j * kThreads] = a;
      act_g[(((size_t)b * d.H + t) * d.ad + j) * d.K + k] = a;
      const float e = expf(a / alpha_a);
      c_act += 0.5f * (e + 1.f / e) - 1.f;
    }
    acc += mlp_step_cost(sm, S, A, H1, H2, d.sd, d.ad, d.hid, d.hp, d.sdp,
                         alpha_s, alpha_a, c_act);
  }
  costs_g[(size_t)b * d.K + k] = acc;
}

Dims make_dims(int B, int K, int n, int H, int sd, int ad, int hid,
               int antithetic) {
  Dims d;
  d.B = B;
  d.K = K;
  d.Kz = antithetic ? (K + 1) / 2 : K;
  d.n = n;
  d.Kn = K / n;
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

extern "C" size_t cem_ens_smem_bytes(int sd, int ad, int hid) {
  return sizeof(float) * block_floats(make_dims(1, 1, 1, 1, sd, ad, hid, 1));
}

extern "C" int cem_sample_rollout_ens(
    const float* s0, const float* mean, const float* stdv, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* w3,
    const float* b3, const float* goal, const float* wvec,
    unsigned long long seed, int B, int K, int n, int H, int sd, int ad,
    int hid, int sampler, int antithetic, float low, float high,
    float alpha_s, float alpha_a, float* costs, float* actions,
    void* stream) {
  const Dims d = make_dims(B, K, n, H, sd, ad, hid, antithetic);
  const size_t smem = sizeof(float) * block_floats(d);
  cudaError_t e = cudaFuncSetAttribute(
      cem_sample_rollout_ens_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)B * d.Kn;
  const dim3 grid((unsigned)((rows + kThreads - 1) / kThreads), n);
  if (rows > 0)
    cem_sample_rollout_ens_kernel<<<grid, kThreads, smem,
                                    (cudaStream_t)stream>>>(
        s0, mean, stdv, w1, b1, w2, b2, w3, b3, goal, wvec, (uint32_t)seed,
        (uint32_t)(seed >> 32), d, sampler, antithetic, low, high, alpha_s,
        alpha_a, costs, actions);
  return (int)cudaGetLastError();
}
