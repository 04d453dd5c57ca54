// MLP rollout + planning cost of GIVEN action sequences for Hopper (sm_90a).
//
// Replaces the TPU kernel mujoco_mbrl_tpu/ops/cem_rollout.py:_kernel
// (launched by mlp_rollout_costs_t / mlp_rollout_costs, the rollout_costs_fn
// of cem_batched's non-fused branch). For every candidate column n of
// s0T (sd, N) and actionsT (H, ad, N) it rolls a 3-layer ReLU MLP
// (normalizers folded into the weights) for H steps and accumulates in
// float32
//   sum_t [ sum_d sqrt(((s - goal) w)^2 + as^2) - as
//           + aa^2 mean_d (cosh(a / aa) - 1) ],
// with cosh(u) written 0.5 (e^u + 1 / e^u) as the TPU kernel writes it.
// Output: costs (N,), exact N: no padding to a tile, no tile argument.
//
// Design: grid ceil(N / 64), one thread per candidate. The folded weights
// (transposed to [in][out], out padded to 8), goal and cost weights are
// staged in shared memory, and each thread keeps its state, action and
// hidden activations in shared-memory columns of stride 64 floats
// (conflict-free); the rollout body (stage_mlp, the register-blocked dense
// layers, mlp_step_cost) is cem_common.cuh's, the FP32 body the samplers
// used before they moved to the tensor cores (cem_mma.cuh). A
// thread reads its s0 column and its H * ad actions with N as the trailing
// axis, so a warp's loads are coalesced.
//
// Bound: 2 N H (in hid + hid hid + hid sd) FLOP (2.8e11 at N = 1,024,000,
// H = 30, the cheetah widths) at the card's non-tensor FP32 rate; the
// action read (N H ad 4 bytes, 0.74 GB) at HBM bandwidth is the other bound
// and the smaller one.

#include "cem_common.cuh"

namespace {

using namespace cem;

struct Dims {
  int N, H, sd, ad, hid, hp, sdp;
};

__host__ __device__ inline size_t block_floats(const Dims& d) {
  const size_t weights = mlp_floats(d.sd, d.ad, d.hid, d.hp, d.sdp);
  return (weights + 3) / 4 * 4 +
         (size_t)kThreads * (d.sdp + d.ad + 2 * d.hp);
}

__global__ void cem_rollout_costs_kernel(
    const float* __restrict__ s0_g, const float* __restrict__ act_g,
    const float* __restrict__ w1_g, const float* __restrict__ b1_g,
    const float* __restrict__ w2_g, const float* __restrict__ b2_g,
    const float* __restrict__ w3_g, const float* __restrict__ b3_g,
    const float* __restrict__ goal_g, const float* __restrict__ wvec_g,
    Dims d, float alpha_s, float alpha_a, float* __restrict__ costs_g) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const float* end = stage_mlp(sm, w1_g, b1_g, w2_g, b2_g, w3_g, b3_g,
                               goal_g, wvec_g, d.sd, d.ad, d.hid, d.hp,
                               d.sdp);
  const size_t wfloats = (size_t)(end - sm);
  float* cols = sm + (wfloats + 3) / 4 * 4;
  __syncthreads();

  const size_t n = (size_t)blockIdx.x * kThreads + tid;
  if (n >= (size_t)d.N) return;          // no barrier below this point
  float* S = cols + tid;                 // sdp rows: the candidate's state
  float* A = S + d.sdp * kThreads;       // ad rows: this step's action
  float* H1 = A + d.ad * kThreads;       // hp rows
  float* H2 = H1 + d.hp * kThreads;      // hp rows
  for (int i = 0; i < d.sd; ++i) S[i * kThreads] = s0_g[(size_t)i * d.N + n];

  float acc = 0.f;
  for (int t = 0; t < d.H; ++t) {
    float c_act = 0.f;
    for (int j = 0; j < d.ad; ++j) {
      const float a = act_g[((size_t)t * d.ad + j) * d.N + n];
      A[j * kThreads] = a;
      const float e = expf(a / alpha_a);
      c_act += 0.5f * (e + 1.f / e) - 1.f;
    }
    acc += mlp_step_cost(sm, S, A, H1, H2, d.sd, d.ad, d.hid, d.hp, d.sdp,
                         alpha_s, alpha_a, c_act);
  }
  costs_g[n] = acc;
}

Dims make_dims(int N, int H, int sd, int ad, int hid) {
  Dims d;
  d.N = N;
  d.H = H;
  d.sd = sd;
  d.ad = ad;
  d.hid = hid;
  d.hp = pad8(hid);
  d.sdp = pad8(sd);
  return d;
}

}  // namespace

extern "C" size_t cem_rollout_costs_smem_bytes(int sd, int ad, int hid) {
  return sizeof(float) * block_floats(make_dims(1, 1, sd, ad, hid));
}

extern "C" int cem_rollout_costs(const float* s0T, const float* actionsT,
                                 const float* w1, const float* b1,
                                 const float* w2, const float* b2,
                                 const float* w3, const float* b3,
                                 const float* goal, const float* wvec, int N,
                                 int H, int sd, int ad, int hid,
                                 float alpha_s, float alpha_a, float* costs,
                                 void* stream) {
  const Dims d = make_dims(N, H, sd, ad, hid);
  const size_t smem = sizeof(float) * block_floats(d);
  cudaError_t e = cudaFuncSetAttribute(
      cem_rollout_costs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (N > 0)
    cem_rollout_costs_kernel<<<(N + kThreads - 1) / kThreads, kThreads, smem,
                               (cudaStream_t)stream>>>(
        s0T, actionsT, w1, b1, w2, b2, w3, b3, goal, wvec, d, alpha_s,
        alpha_a, costs);
  return (int)cudaGetLastError();
}
