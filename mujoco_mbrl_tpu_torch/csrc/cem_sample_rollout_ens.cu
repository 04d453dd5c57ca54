// Ensemble TS-infinity CEM sample + MLP rollout + planning cost for Hopper
// (sm_90a), on the tensor cores.
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
// counter (env, t, pair, draw). When ceil(K/2) is a multiple of n a pair's
// two candidates belong to one member and share rows g, g + 8 of a tile,
// drawing z once; otherwise (K = 60, n = 4: candidate 0 is member 0, its
// partner 30 is member 2) each row regenerates its pair's z and negates it
// for the second half. With n = 1 this gives the single-MLP kernel's
// actions for the same seed.
//
// Design (cem_mma.cuh): a persistent grid walks work items ordered
// member-major, (member, env, tile), each member's items rounded up to
// whole blocks, so a block holds one member at a time and restages its
// weights (50 KB at the walker shapes) only when the member changes: about
// n times a launch. The tile body runs the three products on mma.sync TF32
// with the 3xTF32 split, activations in registers. A tile's candidates are
// k = q n + m, so its action stores are strided by n floats.
//
// Bound: 2 * B * K * H * (in*hid + hid*hid + hid*sd) FLOP, as for the
// single MLP since each candidate runs one member (3.2e11 at walker_ens
// shapes): 3x that at the TF32 tensor rate, or 1x at the FP32 rate; the
// action write (B * H * ad * K * 4 bytes) is the only large memory traffic.
//
// bf16 (compute_dtype=bfloat16): cem_sample_rollout_ens_bf16_kernel, the
// same items over cem_mma.cuh's Bf16 model, each member's weights staged
// as bf16, actions written as bf16; bound: the FLOP at the bf16 tensor
// rate.

#include "cem_mma.cuh"

namespace {

using namespace cem_mma;

// The block's work: member-major items, restaging the weights (SMEM) when
// the member changes
template <class Net, bool SMEM>
__device__ __forceinline__ void ens_items(
    const Cfg& c, const typename Net::W* __restrict__ packed,
    const float* __restrict__ s0_g, const float* __restrict__ mean_g,
    const float* __restrict__ std_g, float* __restrict__ costs_g,
    typename Net::Act* __restrict__ act_g) {
  extern __shared__ __align__(16) float sm[];
  float* scratch = SMEM ? sm + weight_floats(c.L) : sm;
  const int warp = threadIdx.x >> 5;
  float* ws = scratch + warp * warp_floats(c.H, c.ad, c.nu);
  int staged = -1;
  // The loop is block-uniform (P is a multiple of the block's warps): every
  // warp takes part in each restaging barrier.
  for (long long base = (long long)blockIdx.x * kWarps;
       base < (long long)c.n * c.P; base += (long long)gridDim.x * kWarps) {
    const int m = (int)(base / c.P);
    if (SMEM && m != staged) {
      __syncthreads();
      Net::stage_weights(sm, packed + (size_t)m * c.L.total, c.L);
      __syncthreads();
      staged = m;
    }
    const typename Net::W* W =
        SMEM ? reinterpret_cast<const typename Net::W*>(sm)
             : packed + (size_t)m * c.L.total;
    const int j = (int)(base - (long long)m * c.P) + warp;
    if (j < c.B * c.T)
      rollout_tile<Net>(c, W, ws, m, j / c.T, j % c.T, s0_g, mean_g, std_g,
                        costs_g, act_g);
  }
}

template <int NI, int NH, int NSO, bool EXACT, bool SMEM>
__global__ void __launch_bounds__(kBlock, min_blocks(NI, NSO, SMEM))
    cem_sample_rollout_ens_kernel(Cfg c, const float* __restrict__ packed,
                                  const float* __restrict__ s0_g,
                                  const float* __restrict__ mean_g,
                                  const float* __restrict__ std_g,
                                  float* __restrict__ costs_g,
                                  float* __restrict__ act_g) {
  ens_items<Tf32<NI, NH, NSO, EXACT, !SMEM>, SMEM>(c, packed, s0_g, mean_g,
                                                   std_g, costs_g, act_g);
}

template <int NI, int NH, int NSO, bool EXACT, bool SMEM>
__global__ void __launch_bounds__(kBlock, min_blocks_bf16(NI, SMEM))
    cem_sample_rollout_ens_bf16_kernel(
        Cfg c, const __nv_bfloat16* __restrict__ packed,
        const float* __restrict__ s0_g, const float* __restrict__ mean_g,
        const float* __restrict__ std_g, float* __restrict__ costs_g,
        __nv_bfloat16* __restrict__ act_g) {
  ens_items<Bf16<NI, NH, NSO, EXACT>, SMEM>(c, packed, s0_g, mean_g, std_g,
                                            costs_g, act_g);
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
    cudaError_t e = grid_size(kern, smem, (long long)c.n * c.P / kWarps,
                              &grid);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, kBlock, smem, stream>>>(c, (const Wt*)packed, s0, mean, stdv,
                                         costs, (At*)actions);
    return (int)cudaGetLastError();
  }
  template <int NI, int NH, int NSO, bool EXACT, bool SMEM>
  int run() const {
    return go<float, float>(
        cem_sample_rollout_ens_kernel<NI, NH, NSO, EXACT, SMEM>);
  }
  template <int NI, int NH, int NSO, bool EXACT, bool SMEM>
  int run_bf16() const {
    return go<__nv_bfloat16, __nv_bfloat16>(
        cem_sample_rollout_ens_bf16_kernel<NI, NH, NSO, EXACT, SMEM>);
  }
};

}  // namespace

// Shared memory of a launch in bytes; 0 when the shapes are not taken
// (more than 16 k-tiles of [s; a] or hidden tiles).
extern "C" size_t cem_ens_smem_bytes(int K, int n, int H, int sd, int ad,
                                     int hid, int antithetic, int bf16) {
  const Cfg c = make_cfg(1, K, n, H, sd, ad, hid, 0, antithetic, 0.f, 0.f,
                         0.f, 1.f, 0ull, bf16);
  return is_large(c.L) ? smem_bytes(c) : 0;
}

// packed: n members of float32 (ops/cem_mma.py pack_weights) or, with
// bf16, bf16 (pack_weights_bf16); actions: float32 or bf16 likewise
extern "C" int cem_sample_rollout_ens(
    const float* s0, const float* mean, const float* stdv,
    const void* packed, unsigned long long seed, int B, int K, int n, int H,
    int sd, int ad, int hid, int sampler, int antithetic, int bf16,
    float low, float high, float alpha_s, float alpha_a, float* costs,
    void* actions, void* stream) {
  const Cfg c = make_cfg(B, K, n, H, sd, ad, hid, sampler, antithetic, low,
                         high, alpha_s, alpha_a, seed, bf16);
  if (!is_large(c.L) || smem_bytes(c) > (size_t)kMaxSharedBytes ||
      n <= 0 || K % n)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || K <= 0) return 0;
  const Launch l{c, packed, s0, mean, stdv, costs, actions,
                 (cudaStream_t)stream};
  return dispatch(c.L, scratch_floats(c), l);
}
