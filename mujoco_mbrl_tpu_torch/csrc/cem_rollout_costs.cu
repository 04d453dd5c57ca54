// MLP rollout + planning cost of GIVEN action sequences for Hopper (sm_90a),
// on the tensor cores.
//
// Replaces the TPU kernel mujoco_mbrl_tpu/ops/cem_rollout.py:_kernel
// (launched by mlp_rollout_costs_t / mlp_rollout_costs, the rollout_costs_fn
// of cem_batched's non-fused branch). For every candidate column n of
// s0T (sd, N) and actionsT (H, ad, N) it rolls a 3-layer ReLU MLP
// (normalizers folded into the weights) for H steps and accumulates in
// float32
//   sum_t [ sum_d sqrt(((s - goal) w)^2 + as^2) - as
//           + aa^2 mean_d (cosh(a / aa) - 1) ],
// with cosh(u) - 1 written 0.5 (e^u + 1 / e^u) - 1 as the TPU kernel
// writes cosh. Output: costs (N,), exact N: no padding, no tile argument.
//
// Design: the samplers' body (cem_mma.cuh: mma.sync TF32 with the 3xTF32
// split, activations in registers, the products and state cost of a step
// in model_step), with given actions in place of drawn ones. A tile is 16
// consecutive candidates n0 .. n0 + 15 (rows g, g + 8 of the m16 tile are
// candidates n0 + g, n0 + g + 8; rows past N compute on zeros and store
// nothing). Each row starts from its own column of s0T, centred at the
// replay's state mean mu as it is loaded (the weights are folded in those
// coordinates, ops/cem_mma.py fold_centred). Step t's actions are the runs
// actionsT[t, j, n0 .. n0 + 15], 64 bytes per j: each warp copies them with
// cp.async into a double-buffered shared-memory stage one step ahead, so
// the copy of step t + 1 overlaps the products of step t, and each thread
// reads its own action columns sd .. sd + ad - 1 from there. A persistent
// grid (about #SMs x blocks per SM) stages the weights once per block
// (hi / lo split, fragment order; exact instantiations for the walker and
// cheetah models, a guarded one reading global memory for other shapes)
// and its warps walk the tiles.
//
// Bound: 2 N H (in hid + hid hid + hid sd) FLOP (2.8e11 at N = 1,024,000,
// H = 30, the cheetah widths), 3x that at the TF32 tensor rate for the
// split (1.68 ms) or 1x at the non-tensor FP32 rate (4.13 ms); the action
// read (N H ad 4 bytes, 0.74 GB, 0.22 ms at HBM bandwidth) is below both.
//
// bf16 (compute_dtype=bfloat16): cem_rollout_costs_bf16_kernel, the same
// tiles over cem_mma.cuh's Bf16 model; the float32 start states and
// actions are rounded to bf16 as they are loaded (the weights are the
// uncentred fold, mu = 0); bound: the FLOP at the bf16 tensor rate.

#include "cem_mma.cuh"

namespace {

using namespace cem_mma;

constexpr int kAS = 20;  // stage row stride (floats): the quad's reads of
                         // rows j, j + 2, j + 4, j + 6 hit distinct banks

struct Given {
  long long N;
  int H, sd, ad;
  float alpha_s, alpha_a;
  Layout L;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Step tt's actions of tile n0 -> stage buffer tt & 1 ([ad][kAS]; rows
// past N filled with zeros), one cp.async group
__device__ __forceinline__ void stage_actions(const Given& c, float* ws,
                                              long long n0, int tt,
                                              const float* __restrict__ act_g,
                                              int lane) {
  float* buf = ws + (tt & 1) * c.ad * kAS;
  const float* src = act_g + (size_t)tt * c.ad * c.N + n0;
  for (int e = lane; e < 16 * c.ad; e += 32) {
    const int j = e >> 4, r = e & 15;
    const bool ok = n0 + r < c.N;
    cp_async4(buf + j * kAS + r, ok ? src + (size_t)j * c.N + r : act_g, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <class Net>
__device__ void given_tile(const Given& c, const typename Net::W* W,
                           float* ws, long long n0,
                           const float* __restrict__ s0_g,
                           const float* __restrict__ mu_g,
                           const float* __restrict__ act_g,
                           float* __restrict__ costs_g) {
  constexpr int NI = Net::kX;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int sd = c.sd, ad = c.ad, H = c.H;
  const int ni = Net::x_tiles(c.L);
  const long long N = c.N;
  const bool v0 = n0 + g < N, v1 = n0 + g + 8 < N;
  const float inv_aa = 1.f / Net::round(c.alpha_a);

  __syncwarp();  // the previous tile's readers of the stage are done
  if (H > 0) stage_actions(c, ws, n0, 0, act_g, lane);
  // the start states, centred at the state mean as they are loaded
  float x[NI][4];
#pragma unroll
  for (int k = 0; k < NI; ++k)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * k + 2 * t + e;
      const bool st = col < sd;
      const float* s = s0_g + (size_t)(st ? col : 0) * N + n0 + g;
      const float m = st ? mu_g[col] : 0.f;
      x[k][e] = st && v0 ? Net::round(s[0] - m) : 0.f;
      x[k][2 + e] = st && v1 ? Net::round(s[8] - m) : 0.f;
    }
  float cs0 = 0.f, cs1 = 0.f, ca0 = 0.f, ca1 = 0.f;

  for (int tt = 0; tt < H; ++tt) {
    if (tt + 1 < H) {
      stage_actions(c, ws, n0, tt + 1, act_g, lane);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncwarp();  // every lane's copies of step tt have landed
    // ---- actions into this thread's input columns sd .. sd + ad - 1
    const float* buf = ws + (tt & 1) * ad * kAS;
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      if (k < ni && 8 * k + 8 > sd) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * k + 2 * t + e - sd;
          if (j >= 0 && j < ad) {
            const float a0 = Net::round(buf[j * kAS + g]);
            const float a1 = Net::round(buf[j * kAS + 8 + g]);
            x[k][e] = a0;
            x[k][2 + e] = a1;
            ca0 += cosh_m1(a0, inv_aa);
            ca1 += cosh_m1(a1, inv_aa);
          }
        }
      }
    }
    __syncwarp();  // buffer tt & 1 is read; step tt + 2 may refill it
    Net::step(c.L, W, sd, c.alpha_s, x, cs0, cs1, lane);
  }
  float c0, c1;
  row_costs(cs0, cs1, ca0, ca1, c.alpha_a, ad, &c0, &c1);
  if (t == 0) {
    if (v0) costs_g[n0 + g] = c0;
    if (v1) costs_g[n0 + g + 8] = c1;
  }
}

template <class Net, bool SMEM>
__device__ __forceinline__ void given_items(
    const Given& c, const typename Net::W* __restrict__ packed,
    const float* __restrict__ s0_g, const float* __restrict__ mu_g,
    const float* __restrict__ act_g, float* __restrict__ costs_g) {
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
  float* ws = scratch + warp * 2 * c.ad * kAS;
  const long long tiles = (c.N + 15) / 16;
  for (long long it = (long long)blockIdx.x * kWarps + warp; it < tiles;
       it += (long long)gridDim.x * kWarps)
    given_tile<Net>(c, W, ws, 16 * it, s0_g, mu_g, act_g, costs_g);
}

template <int NI, int NH, int NSO, bool EXACT, bool SMEM>
__global__ void __launch_bounds__(kBlock, min_blocks(NI, NSO, SMEM))
    cem_rollout_costs_kernel(Given c, const float* __restrict__ packed,
                             const float* __restrict__ s0_g,
                             const float* __restrict__ mu_g,
                             const float* __restrict__ act_g,
                             float* __restrict__ costs_g) {
  given_items<Tf32<NI, NH, NSO, EXACT, !SMEM>, SMEM>(c, packed, s0_g, mu_g,
                                                     act_g, costs_g);
}

template <int NI, int NH, int NSO, bool EXACT, bool SMEM>
__global__ void __launch_bounds__(kBlock, min_blocks_bf16(NI, SMEM))
    cem_rollout_costs_bf16_kernel(Given c,
                                  const __nv_bfloat16* __restrict__ packed,
                                  const float* __restrict__ s0_g,
                                  const float* __restrict__ mu_g,
                                  const float* __restrict__ act_g,
                                  float* __restrict__ costs_g) {
  given_items<Bf16<NI, NH, NSO, EXACT>, SMEM>(c, packed, s0_g, mu_g, act_g,
                                              costs_g);
}

inline size_t given_scratch_floats(const Given& c) {
  return (size_t)kWarps * 2 * c.ad * kAS;
}

inline size_t given_smem_bytes(const Given& c) {
  const size_t scratch = given_scratch_floats(c);
  return sizeof(float) *
         ((is_staged(c.L, scratch) ? weight_floats(c.L) : 0) + scratch);
}

struct Launch {
  Given c;
  const void* packed;
  const float *s0, *mu, *actions;
  float* costs;
  cudaStream_t stream;
  template <typename Wt, typename Kern>
  int go(Kern kern) const {
    const size_t smem = given_smem_bytes(c);
    int grid = 0;
    const long long work = ((c.N + 15) / 16 + kWarps - 1) / kWarps;
    cudaError_t e = grid_size(kern, smem, work, &grid);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, kBlock, smem, stream>>>(c, (const Wt*)packed, s0, mu, actions,
                                         costs);
    return (int)cudaGetLastError();
  }
  template <int NI, int NH, int NSO, bool EXACT, bool SMEM>
  int run() const {
    return go<float>(cem_rollout_costs_kernel<NI, NH, NSO, EXACT, SMEM>);
  }
  template <int NI, int NH, int NSO, bool EXACT, bool SMEM>
  int run_bf16() const {
    return go<__nv_bfloat16>(
        cem_rollout_costs_bf16_kernel<NI, NH, NSO, EXACT, SMEM>);
  }
};

}  // namespace

// s0T (sd, N), mu (sd,) the state mean the weights are centred at,
// actionsT (H, ad, N), packed (ops/cem_mma.py pack_weights; with bf16,
// pack_weights_bf16) -> costs (N,). Returns a cudaError_t;
// cudaErrorInvalidValue for shapes no instantiation takes (sd + ad or
// hidden past 128).
extern "C" int cem_rollout_costs(const float* s0T, const float* mu,
                                 const float* actionsT, const void* packed,
                                 long long N, int H, int sd, int ad, int hid,
                                 int bf16, float alpha_s, float alpha_a,
                                 float* costs, void* stream) {
  Given c;
  c.N = N;
  c.H = H;
  c.sd = sd;
  c.ad = ad;
  c.alpha_s = alpha_s;
  c.alpha_a = alpha_a;
  c.L = bf16 ? make_layout_bf16(sd, ad, hid) : make_layout(sd, ad, hid);
  if (!is_large(c.L) || given_smem_bytes(c) > (size_t)kMaxSharedBytes)
    return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  const Launch l{c, packed, s0T, mu, actionsT, costs, (cudaStream_t)stream};
  return dispatch(c.L, given_scratch_floats(c), l);
}
