// Tensor-core rollout body of the CEM kernels for Hopper (sm_90a):
// rollout_tile (sample, roll, cost) is the body of the sampler kernels
// cem_sample_rollout.cu (TPU kernels #2 _sample_kernel_multi and #3
// _sample_kernel of mujoco_mbrl_tpu/ops/cem_rollout.py) and
// cem_sample_rollout_ens.cu (#5 _sample_kernel_ens_grouped, #6
// _sample_kernel_ens); model_step (the products of one step and its state
// cost) and row_costs are shared with the given-action kernel
// cem_rollout_costs.cu (#4 _kernel), which reads its actions instead of
// drawing them. Bound of all of them: 3 x the rollout's 2 (in hid + hid
// hid + hid sd) FLOP per candidate-step at the TF32 tensor rate (the
// 3xTF32 split); their one large memory stream, the actions written (the
// samplers) or read (#4), is below it.
//
// One warp rolls one tile of 16 candidates (the M dimension of
// mma.sync.m16n8k8 TF32) through the three products of a model step,
//   [16 x (sd+ad)] [(sd+ad) x hid], [16 x hid] [hid x hid],
//   [16 x hid] [hid x sd],
// every dimension zero-padded to a multiple of 8, for all H steps. The
// state is rolled in coordinates centred at the replay's state mean
// (ops/cem_mma.py fold_centred folds the normalizers that way), which
// keeps the folded first layer free of cancellation.
//
// Precision (3xTF32): each product is hi*hi + hi*lo + lo*hi with
// hi = tf32(v) and lo = tf32(v - hi) (cvt.rna), accumulated in float32.
// The weights arrive in fragment order (ops/cem_mma.py pack_weights) and
// are split once, when a block stages them into shared memory (or as they
// are loaded, in the instantiation that reads them from global memory);
// the activations are split in registers, one k-tile at a time. The two
// correction products accumulate in the tensor core (their truncation is
// 2^-11 below the result); each k-tile's hi*hi product is added to the
// float32 sum by a rounded FADD, because the tensor core's accumulation
// truncates (letting it accumulate failed the fitted-model check of
// chip_smoke.py). The two sums are added once per layer.
//
// Register-resident activations: the accumulator (C) fragment of a layer
// holds columns 8j + 2t, 8j + 2t + 1 of rows g and g + 8 (g = lane / 4,
// t = lane % 4); the next layer's A fragment wants columns t, t + 4. The
// packer permutes each weight matrix's rows within every 8-block (row
// 8j + p holds input 8j + 2p for p < 4, 8j + 2(p - 4) + 1 for p >= 4), so
// C feeds A with no shuffle and no shared-memory round trip. The layer-1
// input is [s; a] as the model concatenates it: a thread owns the same
// input columns as the state columns it receives from layer 3, and writes
// its own actions into the columns sd .. sd + ad - 1.
//
// Rows: in the shared-pair mode (antithetic, pairs inside one member) row
// g and row g + 8 are an antithetic pair, so z is drawn once for both;
// otherwise each row draws its own z (ops/cem_mma.py tile_rows is the same
// map). Noise keeps the Philox4x32-10 counters of the earlier kernels:
// (env, t, pair, draw), and for spline4 (env, knot, pair, draw); the quad's
// draws and the Box-Muller / triangular transforms are spread over the
// warp's lanes through a per-warp shared-memory scratch.
//
// Per warp and step the actions go to a shared-memory stage [ad][16] and
// leave as runs of consecutive candidates (strided by n in the ensemble,
// whose tile holds one member's candidates k = q n + m); the stores are
// not waited on, so they overlap the step's products.
//
// bf16 (compute_dtype=bfloat16 of the TPU kernels): the same tile, rows,
// noise and action stage (rollout_tile and the given-action tile take the
// model as a type: Tf32 or Bf16), with each product one
// mma.sync.m16n8k16 of bf16 operands accumulated in float32, no split.
// The weights are the uncentred fold of the TPU kernels
// (ops/cem_rollout.py _fold_normalizers) rounded to bf16 and packed by
// ops/cem_mma.py pack_weights_bf16 (k padded to 16: [s; a] 30 -> 32,
// hidden 50 -> 64; staged as bf16, half the float32 staging). The C
// fragment of n-tiles 2k, 2k + 1 (columns 2t, 2t + 1 of rows g, g + 8)
// is the A fragment of k16 tile k, so activations need no row
// permutation. Rounding follows the TPU kernel body as the reference runs
// it: start states and actions (after the clip) to bf16; each layer's
// bias added in float32 to the float32 product, then ReLU and bf16; the
// state to bf16; d = bf16(s - goal) * w, a / bf16(alpha_a) (JAX's
// scalar takes the array's type) and the costs in float32 (XLA drops the
// bf16 rounding of the product and the quotient before they are
// widened). The actions leave as bf16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cem_common.cuh"

namespace cem_mma {

constexpr int kTileFloats = 128;          // floats per fragment tile
constexpr int kWarps = 8;                 // warps per block
constexpr int kMinBlocks = 2;             // per SM: 128 registers a thread
                                          // (the narrow exact tiles)
constexpr int kBlock = 32 * kWarps;
constexpr int kMaxSharedBytes = 232448;

// Packed weights of one member, offsets in floats (ops/cem_mma.py layout)
// or, with bf16, in bf16 values (layout_bf16)
struct Layout {
  int ni, nh, nso;        // k-tiles of [s; a], hidden tiles, state tiles
  int l1, l2, l3;         // fragment tiles: [k][n][lane] x float4
  int b1, b2, b3, goal, wvec, total;
  int bf16;               // 1: bf16 values, ni / nh in k16 tiles
};

__host__ __device__ inline Layout make_layout(int sd, int ad, int hid) {
  Layout L;
  L.ni = (sd + ad + 7) / 8;
  L.nh = (hid + 7) / 8;
  L.nso = (sd + 7) / 8;
  L.l1 = 0;
  L.l2 = L.l1 + kTileFloats * L.ni * L.nh;
  L.l3 = L.l2 + kTileFloats * L.nh * L.nh;
  L.b1 = L.l3 + kTileFloats * L.nh * L.nso;
  L.b2 = L.b1 + 8 * L.nh;
  L.b3 = L.b2 + 8 * L.nh;
  L.goal = L.b3 + 8 * L.ni;
  L.wvec = L.goal + 8 * L.ni;
  L.total = (L.wvec + 8 * L.ni + 3) / 4 * 4;
  L.bf16 = 0;
  return L;
}

// bf16 layout: ni, nh k16 tiles of [s; a] and hidden (hidden as n: 2 nh
// tiles of 8), nso n-tiles of the state; a fragment tile is 16 x 8 = 128
// values, a lane's four (b0, b1) at [k][n][lane]; biases, goal and cost
// weights padded to 16 ni / 16 nh
__host__ __device__ inline Layout make_layout_bf16(int sd, int ad, int hid) {
  Layout L;
  L.ni = (sd + ad + 15) / 16;
  L.nh = (hid + 15) / 16;
  L.nso = (sd + 7) / 8;
  L.l1 = 0;
  L.l2 = L.l1 + kTileFloats * L.ni * 2 * L.nh;
  L.l3 = L.l2 + kTileFloats * L.nh * 2 * L.nh;
  L.b1 = L.l3 + kTileFloats * L.nh * L.nso;
  L.b2 = L.b1 + 16 * L.nh;
  L.b3 = L.b2 + 16 * L.nh;
  L.goal = L.b3 + 16 * L.ni;
  L.wvec = L.goal + 16 * L.ni;
  L.total = (L.wvec + 16 * L.ni + 7) / 8 * 8;
  L.bf16 = 1;
  return L;
}

// floats of shared memory the staged weights of layout L take
__host__ __device__ inline int weight_floats(const Layout& L) {
  return L.bf16 ? L.total / 2 : L.total;
}

struct Cfg {
  int B, K, Kz, n, H, sd, ad, nu, T;  // T: tiles per (member, env)
  int Kzn, Kn;                         // Kz / n, K / n
  int P;                               // work items per member, rounded
                                       // up to whole blocks (ensemble)
  int shared;                          // rows g, g + 8 are one pair
  int antithetic, sampler;
  float low, high, alpha_s, alpha_a;
  uint32_t key0, key1;
  Layout L;
};

// tiles per (member, env) and the row mode (ops/cem_mma.py tiles_per_env)
__host__ __device__ inline void tiling(int K, int n, int antithetic,
                                       int* T, int* shared) {
  const int Kz = antithetic ? (K + 1) / 2 : K;
  *shared = antithetic && Kz % n == 0;
  *T = *shared ? (Kz / n + 7) / 8 : (K / n + 15) / 16;
}

// Per-warp scratch, floats: uniforms (16 x nu, first: float4 stores),
// mean, std (H x ad), noise, two spline4 knot rows and the action stage
// (16 x ad each).
__host__ __device__ inline int warp_floats(int H, int ad, int nu) {
  return (2 * H * ad + 16 * nu + 64 * ad + 3) / 4 * 4;
}

struct Row {
  int k, p;       // candidate, Philox pair index
  float sign;     // -1 for the antithetic half
  bool valid;
};

// Row r (0..15) of tile i of member m (n = 1: the single MLP)
__device__ __forceinline__ Row row_of(const Cfg& c, int m, int i, int r) {
  Row o;
  if (c.shared) {
    const int q = 8 * i + (r & 7);
    const int k0 = q * c.n + m;
    o.p = k0;
    o.k = r < 8 ? k0 : k0 + c.Kz;
    o.sign = r < 8 ? 1.f : -1.f;
    o.valid = q < c.Kzn && o.k < c.K;
  } else {
    const int q = 16 * i + r;
    o.k = q * c.n + m;
    o.valid = q < c.Kn;
    const bool second = c.antithetic && o.k >= c.Kz;
    o.p = second ? o.k - c.Kz : o.k;
    o.sign = second ? -1.f : 1.f;
  }
  return o;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
        "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// C fragment (c0 = (g, 2t), c1 = (g, 2t+1), c2 = (g+8, 2t), c3 = (g+8,
// 2t+1)) -> A fragment hi / lo (a0 = (g, t), a1 = (g+8, t), a2 = (g, t+4),
// a3 = (g+8, t+4)) under the row permutation of the weights
__device__ __forceinline__ void split(const float (&c)[4], uint32_t (&hi)[4],
                                      uint32_t (&lo)[4]) {
  const float v[4] = {c[0], c[2], c[1], c[3]};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    hi[q] = tf32(v[q]);
    lo[q] = tf32(v[q] - __uint_as_float(hi[q]));
  }
}

// d = a b (a fresh accumulator)
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4],
                                     float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
        "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)), "f"(0.f));
}

// (b0, b1, ., .) -> (hi(b0), hi(b1), lo(b0), lo(b1))
__device__ __forceinline__ float4 split_b(float4 v) {
  const uint32_t h0 = tf32(v.x), h1 = tf32(v.y);
  return make_float4(__uint_as_float(h0), __uint_as_float(h1),
                     __uint_as_float(tf32(v.x - __uint_as_float(h0))),
                     __uint_as_float(tf32(v.y - __uint_as_float(h1))));
}

// 3xTF32 product of one k-tile; b = (hi(b0), hi(b1), lo(b0), lo(b1)).
// The correction products accumulate in the tensor core; the hi*hi
// product goes to a fresh accumulator and is added to the float32 sum
// with a rounded FADD (the tensor core's own accumulation truncates).
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const uint32_t (&hi)[4],
                                     const uint32_t (&lo)[4], float4 b) {
  mma(small, lo, b.x, b.y);
  mma(small, hi, b.z, b.w);
  float d[4];
  mma0(d, hi, b.x, b.y);
#pragma unroll
  for (int q = 0; q < 4; ++q) big[q] += d[q];
}

template <int NT>
__device__ __forceinline__ void init_acc(float (&big)[NT][4],
                                         float (&small)[NT][4],
                                         const float* __restrict__ bias,
                                         int nt, int t) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    float2 b = make_float2(0.f, 0.f);
    if (n < nt) b = *reinterpret_cast<const float2*>(bias + 8 * n + 2 * t);
    big[n][0] = big[n][2] = b.x;
    big[n][1] = big[n][3] = b.y;
#pragma unroll
    for (int q = 0; q < 4; ++q) small[n][q] = 0.f;
  }
}

// acc[n] += sum_k x[k] W[k][n] over k < kt, n < nt (fragment tiles
// frag[(k * nt + n) * 32 + lane]; SPLIT_B: not yet split into hi / lo)
template <int KT, int NT, bool SPLIT_B>
__device__ __forceinline__ void product(const float4* frag,
                                        const float (&x)[KT][4], int kt,
                                        int nt, float (&big)[NT][4],
                                        float (&small)[NT][4], int lane) {
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    if (k < kt) {
      uint32_t hi[4], lo[4];
      split(x[k], hi, lo);
#pragma unroll
      for (int n = 0; n < NT; ++n)
        if (n < nt) {
          const float4 b = frag[(k * nt + n) * 32 + lane];
          mma3(big[n], small[n], hi, lo, SPLIT_B ? split_b(b) : b);
        }
    }
  }
}

// cosh(a / aa) - 1 from one exp (inv_aa = 1 / aa)
__device__ __forceinline__ float cosh_m1(float a, float inv_aa) {
  const float e = expf(a * inv_aa);
  return 0.5f * (e + __frcp_rn(e)) - 1.f;
}

// One model step of a tile, from the [s; a] columns of x (the actions
// already written into columns sd .. sd + ad - 1): the three products,
// the new state into the state columns of x (every other column cleared),
// and the state cost of rows g, g + 8 added to cs0, cs1. Shared by the
// samplers' rollout_tile and the given-action kernel (cem_rollout_costs.cu).
template <int NI, int NH, int NSO, bool EXACT, bool SPLIT_B>
__device__ __forceinline__ void model_step(const Layout& L, const float* W,
                                           int sd, float as,
                                           float (&x)[NI][4], float& cs0,
                                           float& cs1, int lane) {
  const int t = lane & 3;
  const int ni = EXACT ? NI : L.ni, nh = EXACT ? NH : L.nh;
  const int nso = EXACT ? NSO : L.nso;
  const float4* frag = reinterpret_cast<const float4*>(W);
  // ---- layer 1: h = relu([s; a] W1 + b1)
  float big[NH][4], small[NH][4], h[NH][4];
  init_acc<NH>(big, small, W + L.b1, nh, t);
  product<NI, NH, SPLIT_B>(frag + L.l1 / 4, x, ni, nh, big, small, lane);
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) h[n][q] = fmaxf(big[n][q] + small[n][q], 0.f);
  // ---- layer 2: h = relu(h W2 + b2)
  init_acc<NH>(big, small, W + L.b2, nh, t);
  product<NH, NH, SPLIT_B>(frag + L.l2 / 4, h, nh, nh, big, small, lane);
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) h[n][q] = fmaxf(big[n][q] + small[n][q], 0.f);
  // ---- layer 3: s = h W3 + b3, into the state columns of x
  float sbig[NSO][4], ssmall[NSO][4];
  init_acc<NSO>(sbig, ssmall, W + L.b3, nso, t);
  product<NH, NSO, SPLIT_B>(frag + L.l3 / 4, h, nh, nso, sbig, ssmall, lane);
  const float* goal = W + L.goal;
  const float* wv = W + L.wvec;
#pragma unroll
  for (int n = 0; n < NI; ++n) {
    const bool st = n < NSO && n < nso;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      x[n][q] = st ? sbig[n < NSO ? n : 0][q] + ssmall[n < NSO ? n : 0][q]
                   : 0.f;
    if (st) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * t + e;
        if (col < sd) {
          const float d0 = (x[n][e] - goal[col]) * wv[col];
          const float d1 = (x[n][2 + e] - goal[col]) * wv[col];
          cs0 += sqrtf(d0 * d0 + as * as) - as;
          cs1 += sqrtf(d1 * d1 + as * as) - as;
        }
      }
    }
  }
}

// The quad's partial sums (state cost cs, action cost ca = sum of
// cosh_m1) -> the costs of rows g and g + 8, in every lane of the quad:
//   cs + aa^2 ca / ad
__device__ __forceinline__ void row_costs(float cs0, float cs1, float ca0,
                                          float ca1, float alpha_a, int ad,
                                          float* c0, float* c1) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    cs0 += __shfl_xor_sync(0xffffffffu, cs0, off);
    cs1 += __shfl_xor_sync(0xffffffffu, cs1, off);
    ca0 += __shfl_xor_sync(0xffffffffu, ca0, off);
    ca1 += __shfl_xor_sync(0xffffffffu, ca1, off);
  }
  const float aa2 = alpha_a * alpha_a;
  *c0 = cs0 + aa2 * (ca0 / (float)ad);
  *c1 = cs1 + aa2 * (ca1 / (float)ad);
}

// ---- bf16 products (mma.sync.m16n8k16, float32 accumulation)

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// two values in one register, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a b; b = (b0, b1) of one lane: rows (2t, 2t + 1) and (2t + 8,
// 2t + 9) of column g
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// acc[n] = bias of n-tile n (bf16, widened) in C fragment order
template <int NT>
__device__ __forceinline__ void init_acc_bf16(
    float (&acc)[NT][4], const __nv_bfloat16* __restrict__ bias, int nt,
    int t) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    float2 b = make_float2(0.f, 0.f);
    if (n < nt)
      b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(bias + 8 * n + 2 * t));
    acc[n][0] = acc[n][2] = b.x;
    acc[n][1] = acc[n][3] = b.y;
  }
}

// acc[n] += sum_k x[k] W[k][n] over k16 tiles k < kt and n-tiles n < nt;
// x holds bf16 values in C fragment order, 8-column tiles 2k and 2k + 1
// making k16 tile k's A fragment (frag[(k * nt + n) * 32 + lane])
template <int KT, int NT>
__device__ __forceinline__ void product_bf16(const uint2* frag,
                                             const float (&x)[2 * KT][4],
                                             int kt, int nt,
                                             float (&acc)[NT][4], int lane) {
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    if (k < kt) {
      const uint32_t a[4] = {
          pack_bf16(x[2 * k][0], x[2 * k][1]),
          pack_bf16(x[2 * k][2], x[2 * k][3]),
          pack_bf16(x[2 * k + 1][0], x[2 * k + 1][1]),
          pack_bf16(x[2 * k + 1][2], x[2 * k + 1][3])};
#pragma unroll
      for (int n = 0; n < NT; ++n)
        if (n < nt) mma_bf16(acc[n], a, frag[(k * nt + n) * 32 + lane]);
    }
  }
}

// model_step in bf16: NI, NH k16 tiles of [s; a] and hidden, NSO state
// n-tiles; x holds 2 NI 8-column tiles
template <int NI, int NH, int NSO, bool EXACT>
__device__ __forceinline__ void model_step_bf16(const Layout& L,
                                                const __nv_bfloat16* W,
                                                int sd, float as,
                                                float (&x)[2 * NI][4],
                                                float& cs0, float& cs1,
                                                int lane) {
  const int t = lane & 3;
  const int ni = EXACT ? NI : L.ni, nh = EXACT ? NH : L.nh;
  const int nso = EXACT ? NSO : L.nso;
  const uint2* frag = reinterpret_cast<const uint2*>(W);
  float acc[2 * NH][4], h[2 * NH][4];
  // ---- layer 1: h = bf16(relu([s; a] W1 + b1))
  init_acc_bf16<2 * NH>(acc, W + L.b1, 2 * nh, t);
  product_bf16<NI, 2 * NH>(frag + L.l1 / 4, x, ni, 2 * nh, acc, lane);
#pragma unroll
  for (int n = 0; n < 2 * NH; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) h[n][q] = bf16r(fmaxf(acc[n][q], 0.f));
  // ---- layer 2: h = bf16(relu(h W2 + b2))
  init_acc_bf16<2 * NH>(acc, W + L.b2, 2 * nh, t);
  product_bf16<NH, 2 * NH>(frag + L.l2 / 4, h, nh, 2 * nh, acc, lane);
#pragma unroll
  for (int n = 0; n < 2 * NH; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) h[n][q] = bf16r(fmaxf(acc[n][q], 0.f));
  // ---- layer 3: s = bf16(h W3 + b3), into the state columns of x
  float s[NSO][4];
  init_acc_bf16<NSO>(s, W + L.b3, nso, t);
  product_bf16<NH, NSO>(frag + L.l3 / 4, h, nh, nso, s, lane);
  const __nv_bfloat16* goal = W + L.goal;
  const __nv_bfloat16* wv = W + L.wvec;
#pragma unroll
  for (int n = 0; n < 2 * NI; ++n) {
    const bool st = n < NSO && n < nso;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      x[n][q] = st ? bf16r(s[n < NSO ? n : 0][q]) : 0.f;
    if (st) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * t + e;
        if (col < sd) {
          const float gc = __bfloat162float(goal[col]);
          const float wc = __bfloat162float(wv[col]);
          const float d0 = bf16r(x[n][e] - gc) * wc;
          const float d1 = bf16r(x[n][2 + e] - gc) * wc;
          cs0 += sqrtf(d0 * d0 + as * as) - as;
          cs1 += sqrtf(d1 * d1 + as * as) - as;
        }
      }
    }
  }
}

// ---- the model of a tile, as a type: packed weight and action types,
// the rounding of what the model reads, one step, the staging

// Copy one member's packed weights into shared memory (whole block),
// splitting the fragment tiles into hi / lo on the way
__device__ inline void stage(float* dst, const float* __restrict__ src,
                             const Layout& L) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int e = threadIdx.x; e < L.total / 4; e += blockDim.x) {
    const float4 v = __ldg(s4 + e);
    d4[e] = e < L.b1 / 4 ? split_b(v) : v;
  }
}

// 3xTF32 (NI, NH, NSO: 8-wide tiles)
template <int NI, int NH, int NSO, bool EXACT, bool SPLIT_B>
struct Tf32 {
  using W = float;
  using Act = float;
  static constexpr int kX = NI;  // 8-column tiles of x
  __device__ static int x_tiles(const Layout& L) { return EXACT ? NI : L.ni; }
  __device__ static float round(float v) { return v; }
  __device__ static float out(float a) { return a; }
  __device__ static void step(const Layout& L, const float* w, int sd,
                              float as, float (&x)[NI][4], float& cs0,
                              float& cs1, int lane) {
    model_step<NI, NH, NSO, EXACT, SPLIT_B>(L, w, sd, as, x, cs0, cs1, lane);
  }
  __device__ static void stage_weights(float* dst, const float* src,
                                       const Layout& L) {
    stage(dst, src, L);
  }
};

// bf16 (NI, NH: k16 tiles; NSO: 8-wide state tiles)
template <int NI, int NH, int NSO, bool EXACT>
struct Bf16 {
  using W = __nv_bfloat16;
  using Act = __nv_bfloat16;
  static constexpr int kX = 2 * NI;
  __device__ static int x_tiles(const Layout& L) {
    return 2 * (EXACT ? NI : L.ni);
  }
  __device__ static float round(float v) { return bf16r(v); }
  __device__ static __nv_bfloat16 out(float a) {
    return __float2bfloat16_rn(a);
  }
  __device__ static void step(const Layout& L, const __nv_bfloat16* w,
                              int sd, float as, float (&x)[2 * NI][4],
                              float& cs0, float& cs1, int lane) {
    model_step_bf16<NI, NH, NSO, EXACT>(L, w, sd, as, x, cs0, cs1, lane);
  }
  __device__ static void stage_weights(float* dst,
                                       const __nv_bfloat16* src,
                                       const Layout& L) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int e = threadIdx.x; e < L.total / 8; e += blockDim.x)
      d4[e] = __ldg(s4 + e);
  }
};

// (row, column) of item e = lane + 32 s of an R x cols array, stepped
// without an integer division per item
struct Walk {
  int r, j, dr, dj, cols;
  __device__ __forceinline__ Walk(int lane, int ncols)
      : r(lane / ncols), j(lane % ncols), dr(32 / ncols), dj(32 % ncols),
        cols(ncols) {}
  __device__ __forceinline__ void next() {
    r += dr;
    j += dj;
    if (j >= cols) {
      j -= cols;
      ++r;
    }
  }
};

// Philox draws for R rows (counter (b, ctr, pair of row r, q)) into the
// uniforms, then unit-variance noise dest[r][j] for j < ad
__device__ inline void draw_round(const Cfg& c, int m, int i, int b,
                                  uint32_t ctr, int R, bool triangular,
                                  float* ubuf, float* dest, int lane) {
  const int nq = c.nu / 4;
  for (Walk w(lane, nq); w.r < R; w.next()) {
    const uint4 v = cem::philox4x32_10(
        make_uint4((uint32_t)b, ctr, (uint32_t)row_of(c, m, i, w.r).p,
                   (uint32_t)w.j), c.key0, c.key1);
    *reinterpret_cast<float4*>(ubuf + w.r * c.nu + 4 * w.j) = make_float4(
        cem::to_uniform(v.x), cem::to_uniform(v.y), cem::to_uniform(v.z),
        cem::to_uniform(v.w));
  }
  __syncwarp();
  for (Walk w(lane, c.ad); w.r < R; w.next())
    dest[w.r * c.ad + w.j] = cem::noise(ubuf[w.r * c.nu + w.j],
                                        ubuf[w.r * c.nu + c.ad + w.j],
                                        triangular);
  __syncwarp();
}

// One tile: 16 candidates of member m and env b, rolled for H steps.
// W: this member's packed weights (shared or global memory); ws: this
// warp's scratch. Net is the model (Tf32 or Bf16): its tile bounds; with
// EXACT they are the layout's, so the unrolled loops carry no run-time
// guard. Tf32's SPLIT_B: W is the packed buffer itself (global memory),
// split as it is loaded.
template <class Net>
__device__ void rollout_tile(const Cfg& c, const typename Net::W* W,
                             float* ws, int m, int b, int i,
                             const float* __restrict__ s0_g,
                             const float* __restrict__ mean_g,
                             const float* __restrict__ std_g,
                             float* __restrict__ costs_g,
                             typename Net::Act* __restrict__ act_g) {
  constexpr int NI = Net::kX;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const Layout& L = c.L;
  const int sd = c.sd, ad = c.ad, H = c.H;
  const int ni = Net::x_tiles(L);
  float* ubuf = ws;
  float* mean = ubuf + 16 * c.nu;
  float* stdv = mean + H * ad;
  float* zbuf = stdv + H * ad;
  float* k0buf = zbuf + 16 * ad;
  float* k1buf = k0buf + 16 * ad;
  float* abuf = k1buf + 16 * ad;

  __syncwarp();  // the previous tile's readers of the scratch are done
  for (int e = lane; e < H * ad; e += 32) {
    mean[e] = mean_g[(size_t)b * H * ad + e];
    stdv[e] = std_g[(size_t)b * H * ad + e];
  }
  const Row r0 = row_of(c, m, i, g), r1 = row_of(c, m, i, g + 8);
  const int z1row = c.shared ? g : g + 8;
  const Row rs = row_of(c, m, i, lane & 15);  // this lane's store row
  const int R = c.shared ? 8 : 16;
  const float inv_aa = 1.f / Net::round(c.alpha_a);

  float x[NI][4];
#pragma unroll
  for (int k = 0; k < NI; ++k)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * k + 2 * t + e;
      const float v = col < sd ? s0_g[(size_t)b * sd + col] : 0.f;
      x[k][e] = x[k][2 + e] = Net::round(v);
    }
  float cs0 = 0.f, cs1 = 0.f, ca0 = 0.f, ca1 = 0.f;

  for (int tt = 0; tt < H; ++tt) {
    __syncwarp();  // the previous step's readers of the scratch are done
    // ---- noise z[row][j] for this step
    const float* z = zbuf;
    if (c.sampler == cem::kSpline4) {
      const int rr = tt & 3;
      if (rr == 0) {
        if (tt == 0)
          draw_round(c, m, i, b, 0u, R, true, ubuf, k1buf, lane);
        for (int e = lane; e < R * ad; e += 32) k0buf[e] = k1buf[e];
        draw_round(c, m, i, b, (uint32_t)(tt / 4 + 1), R, true, ubuf,
                   k1buf, lane);
        z = k0buf;
      } else {
        // (1 - w), w and 1 / sqrt((1 - w)^2 + w^2) for w = rr / 4, in
        // the TPU kernel's float32 operation order
        const float wa = rr == 1 ? 0.75f : (rr == 2 ? 0.5f : 0.25f);
        const float wb = 1.f - wa;
        const float cc = rr == 2 ? 1.4142135623730951f : 1.2649110640673518f;
        for (int e = lane; e < R * ad; e += 32)
          zbuf[e] = __fmul_rn(__fadd_rn(__fmul_rn(wa, k0buf[e]),
                                        __fmul_rn(wb, k1buf[e])), cc);
        __syncwarp();
      }
    } else {
      draw_round(c, m, i, b, (uint32_t)tt, R, c.sampler == cem::kTriangular,
                 ubuf, zbuf, lane);
    }
    // ---- actions into this thread's input columns sd .. sd + ad - 1
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      if (k < ni && 8 * k + 8 > sd) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * k + 2 * t + e - sd;
          if (j >= 0 && j < ad) {
            const float mu = mean[tt * ad + j], sg = stdv[tt * ad + j];
            const float a0 = Net::round(fminf(
                fmaxf(fmaf(sg, r0.sign * z[g * ad + j], mu), c.low), c.high));
            const float a1 = Net::round(fminf(
                fmaxf(fmaf(sg, r1.sign * z[z1row * ad + j], mu), c.low),
                c.high));
            x[k][e] = a0;
            x[k][2 + e] = a1;
            abuf[j * 16 + g] = a0;
            abuf[j * 16 + 8 + g] = a1;
            ca0 += cosh_m1(a0, inv_aa);
            ca1 += cosh_m1(a1, inv_aa);
          }
        }
      }
    }
    __syncwarp();
    // ---- the step's actions: runs of consecutive candidates, no wait
    if (rs.valid) {
      typename Net::Act* dst = act_g + ((size_t)b * H + tt) * ad * c.K + rs.k;
      for (int j = lane >> 4; j < ad; j += 2)
        dst[(size_t)j * c.K] = Net::out(abuf[j * 16 + (lane & 15)]);
    }
    Net::step(L, W, sd, c.alpha_s, x, cs0, cs1, lane);
  }
  float c0, c1;
  row_costs(cs0, cs1, ca0, ca1, c.alpha_a, ad, &c0, &c1);
  if (t == 0) {
    if (r0.valid) costs_g[(size_t)b * c.K + r0.k] = c0;
    if (r1.valid) costs_g[(size_t)b * c.K + r1.k] = c1;
  }
}

// Host: the configuration of a launch
inline Cfg make_cfg(int B, int K, int n, int H, int sd, int ad, int hid,
                    int sampler, int antithetic, float low, float high,
                    float alpha_s, float alpha_a, unsigned long long seed,
                    int bf16) {
  Cfg c;
  c.B = B;
  c.K = K;
  c.Kz = antithetic ? (K + 1) / 2 : K;
  c.n = n;
  c.Kzn = c.Kz / n;
  c.Kn = K / n;
  c.H = H;
  c.sd = sd;
  c.ad = ad;
  c.nu = (2 * ad + 3) / 4 * 4;
  tiling(K, n, antithetic, &c.T, &c.shared);
  c.P = (B * c.T + kWarps - 1) / kWarps * kWarps;
  c.antithetic = antithetic;
  c.sampler = sampler;
  c.low = low;
  c.high = high;
  c.alpha_s = alpha_s;
  c.alpha_a = alpha_a;
  c.key0 = (uint32_t)seed;
  c.key1 = (uint32_t)(seed >> 32);
  c.L = bf16 ? make_layout_bf16(sd, ad, hid) : make_layout(sd, ad, hid);
  return c;
}

// Instantiations sized to a model's tile counts, the weights staged in
// shared memory beside the warps' scratch where they fit: with exact tile
// counts (no run-time guard in the unrolled loops) for the walker (sd
// 19-24, ad 6), cheetah (sd 17), hopper (the featured state's 17 + 4, the
// observation's 15 + 4: two state tiles) and swimmer (18 + 5) models
// and the small models of the contact-free domains (sd + ad <= 8: reacher
// 6 + 2, point_mass 4 + 2, pendulum 3 + 1, cartpole 5 + 1); with run-time
// loop bounds for the humanoid's (sd + ad 81..88: the bench's 67-dim
// observation, 9 state tiles; the CLI's 60-dim featured state, 8) and the
// manipulator's (the featured state's 29 + 5: five [s; a] tiles, four
// state tiles), whose exact unrolled loops spill at 255 registers (the
// manipulator's at one block an SM or two) where these spill none; hidden
// 50 in all. Any other
// shape: the guarded instantiation (up to 16 / 16 tiles), weights read
// from global memory.
// bf16: sized for the tile counts of the bench's presets and the walker
// CLI: [s; a] in two k16 tiles with three state tiles (walker's 24- and
// 20-dim, cheetah's 17-dim state and 6 actions), exact; the humanoid
// bench's 67 + 21 (six k16 tiles, nine state tiles), run-time loop
// bounds; hidden 49..64. Any other shape: the guarded bf16 instantiation
// (up to 8 / 8 k16 tiles).
inline bool sized_tiles(const Layout& L) {
  if (L.bf16)
    return L.nh == 4 && ((L.ni == 2 && L.nso == 3) ||
                         (L.ni == 6 && L.nso == 9));
  return L.nh == 7 && (((L.ni == 4 || L.ni == 3) && L.nso == 3) ||
                       (L.ni == 3 && L.nso == 2) ||
                       (L.ni == 5 && L.nso == 4) ||
                       (L.ni == 1 && L.nso == 1) ||
                       (L.ni == 11 && (L.nso == 9 || L.nso == 8)));
}
inline bool is_staged(const Layout& L, size_t scratch) {
  return sized_tiles(L) &&
         sizeof(float) * (weight_floats(L) + scratch) <=
             (size_t)kMaxSharedBytes;
}
inline bool is_large(const Layout& L) {
  return L.bf16 ? L.ni <= 8 && L.nh <= 8 : L.ni <= 16 && L.nh <= 16;
}

// Blocks an SM must hold (__launch_bounds__): two for the narrow exact
// tiles (128 registers a thread); one for the hopper observation's
// (3, 7, 2) tiles, which spill at 128 registers and take none at one block
// an SM, and for the manipulator's (5, 7, 4), which spill at two; one for
// the humanoid's wide tiles, whose weights and scratch fill
// an SM's shared memory, and for the guarded instantiation (up to 255
// registers).
constexpr int min_blocks(int ni, int nso, bool smem) {
  return smem && ni <= 4 && !(ni == 3 && nso == 2) ? kMinBlocks : 1;
}
// bf16: two for the walker / cheetah tiles, one for the humanoid's and the
// guarded instantiation
constexpr int min_blocks_bf16(int ni, bool smem) {
  return smem && ni <= 2 ? kMinBlocks : 1;
}

// The instantiation that takes layout L with `scratch` floats of per-warp
// scratch: f.run<NI, NH, NSO, EXACT, SMEM>() for float32 (3xTF32),
// f.run_bf16<...>() for bf16
template <typename F>
inline int dispatch(const Layout& L, size_t scratch, const F& f) {
  if (L.bf16) {
    if (!is_staged(L, scratch))
      return f.template run_bf16<8, 8, 16, false, false>();
    if (L.ni == 2) return f.template run_bf16<2, 4, 3, true, true>();
    return f.template run_bf16<6, 4, 9, false, true>();
  }
  if (!is_staged(L, scratch))
    return f.template run<16, 16, 16, false, false>();
  if (L.ni == 4) return f.template run<4, 7, 3, true, true>();
  if (L.ni == 3 && L.nso == 2) return f.template run<3, 7, 2, true, true>();
  if (L.ni == 3) return f.template run<3, 7, 3, true, true>();
  if (L.ni == 5) return f.template run<5, 7, 4, false, true>();
  if (L.ni == 1) return f.template run<1, 7, 1, true, true>();
  if (L.nso == 9) return f.template run<11, 7, 9, false, true>();
  return f.template run<11, 7, 8, false, true>();
}

// dispatch's choice, launching nothing: NI, NH, NSO, EXACT, SMEM of the
// instantiation into out[0..4]
struct Which {
  int* out;
  template <int NI, int NH, int NSO, bool EXACT, bool SMEM>
  int run() const {
    out[0] = NI;
    out[1] = NH;
    out[2] = NSO;
    out[3] = EXACT;
    out[4] = SMEM;
    return 0;
  }
  template <int NI, int NH, int NSO, bool EXACT, bool SMEM>
  int run_bf16() const {
    return run<NI, NH, NSO, EXACT, SMEM>();
  }
};

inline size_t scratch_floats(const Cfg& c) {
  return (size_t)kWarps * warp_floats(c.H, c.ad, c.nu);
}

inline size_t smem_bytes(const Cfg& c) {
  const size_t scratch = scratch_floats(c);
  return sizeof(float) *
         ((is_staged(c.L, scratch) ? weight_floats(c.L) : 0) + scratch);
}

// grid: every SM filled at the kernel's occupancy, no more blocks than
// block-rounds of work. The queries are made once per (device, kernel,
// shared memory) and remembered; the kernel's dynamic shared-memory limit
// is raised to the card's maximum (it only bounds what a launch may ask
// for), so a smaller launch never lowers it under a larger one.
template <typename Kern>
inline cudaError_t grid_size(Kern kern, size_t smem, long long work_blocks,
                             int* grid) {
  struct Entry {
    int dev;
    const void* kern;
    size_t smem;
    int blocks;  // SMs x blocks per SM
  };
  static Entry seen[32];
  static int n_seen = 0;
  int dev = 0, blocks = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  for (int k = 0; k < n_seen; ++k)
    if (seen[k].dev == dev && seen[k].kern == (const void*)kern &&
        seen[k].smem == smem)
      blocks = seen[k].blocks;
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSharedBytes);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kBlock,
                                                        smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    blocks = sms * per_sm;
    if (n_seen < 32)
      seen[n_seen++] = Entry{dev, (const void*)kern, smem, blocks};
  }
  const long long gsz = work_blocks < blocks ? work_blocks : blocks;
  *grid = (int)(gsz < 1 ? 1 : gsz);
  return cudaSuccess;
}

}  // namespace cem_mma
