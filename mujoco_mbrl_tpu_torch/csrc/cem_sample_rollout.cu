// Fused CEM sample + MLP rollout + planning cost for Hopper (sm_90a), on
// the tensor cores.
//
// Replaces two TPU kernels of mujoco_mbrl_tpu/ops/cem_rollout.py, both
// launched from mlp_sample_rollout_costs: _sample_kernel_multi (G envs per
// program, normal / triangular) and _sample_kernel (one env per program,
// and the only one with the spline4 sampler). The G lane grouping is a TPU
// layout choice; here one launch covers every env. For every env b and
// candidate k it samples an action sequence from the CEM proposal (mean,
// std) of shape (H, ad), antithetic (candidate k + ceil(K/2) gets -z of
// candidate k), clipped to [low, high]; rolls a 3-layer ReLU MLP
// (normalizers folded into the weights) for H steps; and accumulates
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
//     + w^2), w = r / 4, in the TPU kernel's float32 operation order.
//
// Design (cem_mma.cuh): a persistent grid, about #SMs x blocks per SM;
// each block stages the weights once (hi / lo split, fragment order) and
// its warps walk the (env, tile) work items, a tile being 8 antithetic
// pairs in rows g, g + 8 of an m16 tile (16 candidates without
// antithetic). The three products run on mma.sync TF32 with the 3xTF32
// split; activations stay in registers across layers and steps.
//
// Bound: 2 * B * K * H * (in*hid + hid*hid + hid*sd) FLOP (3.2e11 at the
// walker shapes): 3x that at the TF32 tensor rate for the split, or 1x at
// the non-tensor FP32 rate; the action write (B * H * ad * K * 4 bytes) is
// the only large memory traffic.
//
// bf16 (compute_dtype=bfloat16): cem_sample_rollout_bf16_kernel, the same
// items over cem_mma.cuh's Bf16 model (one m16n8k16 bf16 mma.sync a
// product, weights staged as bf16), actions written as bf16; bound: the
// FLOP at the bf16 tensor rate.

#include "cem_mma.cuh"

namespace {

using namespace cem_mma;

// The block's work: stage the weights (SMEM), then each warp walks the
// (env, tile) items
template <class Net, bool SMEM>
__device__ __forceinline__ void sample_items(
    const Cfg& c, const typename Net::W* __restrict__ packed,
    const float* __restrict__ s0_g, const float* __restrict__ mean_g,
    const float* __restrict__ std_g, float* __restrict__ costs_g,
    typename Net::Act* __restrict__ act_g) {
  extern __shared__ __align__(16) float sm[];
  float* scratch = sm;
  if (SMEM) {
    Net::stage_weights(sm, packed, c.L);
    scratch = sm + weight_floats(c.L);
    __syncthreads();
  }
  const typename Net::W* W =
      SMEM ? reinterpret_cast<const typename Net::W*>(sm) : packed;
  const int warp = threadIdx.x >> 5;
  float* ws = scratch + warp * warp_floats(c.H, c.ad, c.nu);
  const long long items = (long long)c.B * c.T;
  for (long long it = (long long)blockIdx.x * kWarps + warp; it < items;
       it += (long long)gridDim.x * kWarps)
    rollout_tile<Net>(c, W, ws, 0, (int)(it / c.T), (int)(it % c.T), s0_g,
                      mean_g, std_g, costs_g, act_g);
}

template <int NI, int NH, int NSO, bool EXACT, bool SMEM>
__global__ void __launch_bounds__(kBlock, min_blocks(NI, NSO, SMEM))
    cem_sample_rollout_kernel(Cfg c, const float* __restrict__ packed,
                              const float* __restrict__ s0_g,
                              const float* __restrict__ mean_g,
                              const float* __restrict__ std_g,
                              float* __restrict__ costs_g,
                              float* __restrict__ act_g) {
  sample_items<Tf32<NI, NH, NSO, EXACT, !SMEM>, SMEM>(c, packed, s0_g, mean_g,
                                                      std_g, costs_g, act_g);
}

template <int NI, int NH, int NSO, bool EXACT, bool SMEM>
__global__ void __launch_bounds__(kBlock, min_blocks_bf16(NI, SMEM))
    cem_sample_rollout_bf16_kernel(Cfg c,
                                   const __nv_bfloat16* __restrict__ packed,
                                   const float* __restrict__ s0_g,
                                   const float* __restrict__ mean_g,
                                   const float* __restrict__ std_g,
                                   float* __restrict__ costs_g,
                                   __nv_bfloat16* __restrict__ act_g) {
  sample_items<Bf16<NI, NH, NSO, EXACT>, SMEM>(c, packed, s0_g, mean_g,
                                               std_g, costs_g, act_g);
}

struct Launch {
  Cfg c;
  const void* packed;
  const float *s0, *mean, *stdv;
  float* costs;
  void* actions;
  cudaStream_t stream;
  template <typename Wt, typename At, typename Kern>
  int go(Kern kern) const {
    const size_t smem = smem_bytes(c);
    int grid = 0;
    const long long work = ((long long)c.B * c.T + kWarps - 1) / kWarps;
    cudaError_t e = grid_size(kern, smem, work, &grid);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, kBlock, smem, stream>>>(c, (const Wt*)packed, s0, mean, stdv,
                                         costs, (At*)actions);
    return (int)cudaGetLastError();
  }
  template <int NI, int NH, int NSO, bool EXACT, bool SMEM>
  int run() const {
    return go<float, float>(
        cem_sample_rollout_kernel<NI, NH, NSO, EXACT, SMEM>);
  }
  template <int NI, int NH, int NSO, bool EXACT, bool SMEM>
  int run_bf16() const {
    return go<__nv_bfloat16, __nv_bfloat16>(
        cem_sample_rollout_bf16_kernel<NI, NH, NSO, EXACT, SMEM>);
  }
};

}  // namespace

// Shared memory of a launch in bytes; 0 when the shapes are not taken
// (more than 16 k-tiles of [s; a] or hidden tiles; bf16: 8 k16 tiles).
extern "C" size_t cem_sample_smem_bytes(int K, int H, int sd, int ad,
                                        int hid, int antithetic, int bf16) {
  const Cfg c = make_cfg(1, K, 1, H, sd, ad, hid, 0, antithetic, 0.f, 0.f,
                         0.f, 1.f, 0ull, bf16);
  return is_large(c.L) ? smem_bytes(c) : 0;
}

// The instantiation a launch of these sizes takes: NI, NH, NSO, EXACT and
// SMEM into out[0..4] (dispatch, nothing launched); non-zero when the
// shapes are not taken.
extern "C" int cem_sample_instantiation(int K, int H, int sd, int ad,
                                        int hid, int antithetic, int bf16,
                                        int* out) {
  const Cfg c = make_cfg(1, K, 1, H, sd, ad, hid, 0, antithetic, 0.f, 0.f,
                         0.f, 1.f, 0ull, bf16);
  if (!is_large(c.L)) return (int)cudaErrorInvalidValue;
  return dispatch(c.L, scratch_floats(c), Which{out});
}

// packed: float32 (ops/cem_mma.py pack_weights) or, with bf16, bf16
// (pack_weights_bf16); actions: float32 or bf16 likewise
extern "C" int cem_sample_rollout(
    const float* s0, const float* mean, const float* stdv,
    const void* packed, unsigned long long seed, int B, int K, int H, int sd,
    int ad, int hid, int sampler, int antithetic, int bf16, float low,
    float high, float alpha_s, float alpha_a, float* costs, void* actions,
    void* stream) {
  const Cfg c = make_cfg(B, K, 1, H, sd, ad, hid, sampler, antithetic, low,
                         high, alpha_s, alpha_a, seed, bf16);
  if (!is_large(c.L) || smem_bytes(c) > (size_t)kMaxSharedBytes)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || K <= 0) return 0;
  const Launch l{c, packed, s0, mean, stdv, costs, actions,
                 (cudaStream_t)stream};
  return dispatch(c.L, scratch_floats(c), l);
}
