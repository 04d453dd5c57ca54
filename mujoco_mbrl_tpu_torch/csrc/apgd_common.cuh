// Device helpers shared by the APGD kernels (apgd_solve.cu, the dense
// iterate; apgd_factored.cu, the factored one): row types, warp and
// block-wide reductions, and the projection onto the non-negative, box and
// friction-cone rows, in two forms: one thread per constraint row (the
// block kernels) and R rows a lane, row i in lane i % 32, slot i / 32 (the
// warp kernels, one env per warp).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace apgd {

constexpr int kNonneg = 1;
constexpr int kBox = 2;
constexpr int kConeNormal = 4;
constexpr int kRedSlots = 96;  // shared floats a reduction needs
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Block-wide sums of up to three values with one barrier; every thread
// receives the totals. red holds 2 * kRedSlots floats whose halves
// alternate (parity, one int a block, starting at 0): a call's writes
// cannot race the previous call's reads, which end before that call's
// barrier.
__device__ inline void block_sums(float& a, float& b, float& c, float* red,
                                  int& parity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  c = warp_sum(c);
  float* r = red + parity * kRedSlots;
  parity ^= 1;
  if (lane == 0) {
    r[warp] = a;
    r[32 + warp] = b;
    r[64 + warp] = c;
  }
  __syncthreads();
  a = b = c = 0.f;
  for (int w = 0; w < nw; ++w) {
    a += r[w];
    b += r[32 + w];
    c += r[64 + w];
  }
}

__device__ inline float block_sum(float a, float* red, int& parity) {
  float b = 0.f, c = 0.f;
  block_sums(a, b, c, red, parity);
  return a;
}

// Block-wide maximum in red's first kRedSlots floats: its leading barrier
// orders it after earlier readers of them; a barrier must follow it
// before the next block_sums.
__device__ inline float block_max(float a, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  a = warp_max(a);
  __syncthreads();
  if (lane == 0) red[warp] = a;
  __syncthreads();
  a = red[0];
  for (int w = 1; w < nw; ++w) a = fmaxf(a, red[w]);
  return a;
}

// What the projection knows of the calling thread's row i.
struct Row {
  int i, nr, type;
  bool valid;  // i < nr
  float mu, bnd, act;
};

// Non-negative, then box, then friction cone (a normal row reads its
// tangents i + 1, i + 2 through a wrapping shift, as jnp.roll does; rows
// i - 1, i - 2 of a normal take its tangent scale without wrapping, as
// physics/solver.py masks them by con0 + 1, con0 + 2), then the active
// mask. With has_cone
// every thread of the block must call it (it synchronises); ps and ts are
// nr shared floats each, types the nr row types in shared memory.
__device__ inline float project(float x, const Row& r, bool has_cone,
                                float* ps, float* ts, const int* types) {
  if (r.type & kNonneg) x = fmaxf(x, 0.f);
  if (r.type & kBox) x = fminf(fmaxf(x, -r.bnd), r.bnd);
  if (has_cone) {
    const int i = r.i, nr = r.nr;
    __syncthreads();
    if (r.valid) ps[i] = x;
    __syncthreads();
    float tsc = 1.f;
    if (r.type & kConeNormal) {
      const float ft1 = ps[(i + 1) % nr], ft2 = ps[(i + 2) % nr];
      const float t = sqrtf(ft1 * ft1 + ft2 * ft2);
      const float mu = r.mu;
      const bool inside = t <= mu * x;
      const bool apex = mu * t + x <= 0.f;
      const float fn = inside ? x
                       : (apex ? 0.f : (x + mu * t) / (1.f + mu * mu));
      tsc = inside ? 1.f : (apex ? 0.f : mu * fn / fmaxf(t, 1e-12f));
      x = fn;
    }
    if (r.valid) ts[i] = tsc;
    __syncthreads();
    if (r.valid) {
      if (i >= 1 && (types[i - 1] & kConeNormal)) x *= ts[i - 1];
      if (i >= 2 && (types[i - 2] & kConeNormal)) x *= ts[i - 2];
    }
  }
  return x * r.act;
}

// Row src's entry of a vector held as x[slot] in lane src % 32, slot
// src / 32, for every lane (all lanes must call it; R shuffles)
template <int R>
__device__ __forceinline__ float fetch(const float (&x)[R], int src) {
  float v = __shfl_sync(kFull, x[0], src & 31);
#pragma unroll
  for (int s = 1; s < R; ++s) {
    const float w = __shfl_sync(kFull, x[s], src & 31);
    v = (src >> 5) == s ? w : v;
  }
  return v;
}

// What the warp projection knows of a lane's R rows i = lane + 32 s.
template <int R>
struct LaneRows {
  int type[R];
  bool cp1[R], cp2[R];  // row i - 1 / i - 2 is a cone normal (no wrap)
  float mu[R], bnd[R], act[R];
};

template <int R>
__device__ inline void load_lane_rows(LaneRows<R>& r, int lane, int nr,
                                      const float* act_b,
                                      const float* __restrict__ mu_g,
                                      const float* __restrict__ bnd_g,
                                      const int* __restrict__ rowtype_g) {
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int i = lane + 32 * s;
    const bool valid = i < nr;
    r.type[s] = valid ? rowtype_g[i] : 0;
    r.mu[s] = valid ? mu_g[i] : 0.f;
    r.bnd[s] = valid ? bnd_g[i] : 0.f;
    r.act[s] = valid ? act_b[i] : 0.f;
    r.cp1[s] = valid && i >= 1 && (rowtype_g[i - 1] & kConeNormal);
    r.cp2[s] = valid && i >= 2 && (rowtype_g[i - 2] & kConeNormal);
  }
}

// project() for the R rows of every lane of a warp, in registers: the
// cone's neighbour rows (a normal's tangents i + 1, i + 2, wrapping as
// jnp.roll does; the tangents' normals i - 1, i - 2, without wrapping)
// come by shuffles. All lanes must call it.
template <int R>
__device__ inline void project_lanes(float (&x)[R], const LaneRows<R>& r,
                                     int lane, int nr, bool has_cone) {
#pragma unroll
  for (int s = 0; s < R; ++s) {
    if (r.type[s] & kNonneg) x[s] = fmaxf(x[s], 0.f);
    if (r.type[s] & kBox) x[s] = fminf(fmaxf(x[s], -r.bnd[s]), r.bnd[s]);
  }
  if (has_cone) {
    float xn[R], tsc[R];
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int i = lane + 32 * s;
      const float ft1 = fetch<R>(x, (i + 1) % nr);
      const float ft2 = fetch<R>(x, (i + 2) % nr);
      xn[s] = x[s];
      tsc[s] = 1.f;
      if (r.type[s] & kConeNormal) {
        const float t = sqrtf(ft1 * ft1 + ft2 * ft2), m = r.mu[s];
        const bool inside = t <= m * x[s];
        const bool apex = m * t + x[s] <= 0.f;
        const float fn = inside ? x[s]
                         : (apex ? 0.f : (x[s] + m * t) / (1.f + m * m));
        tsc[s] = inside ? 1.f : (apex ? 0.f : m * fn / fmaxf(t, 1e-12f));
        xn[s] = fn;
      }
    }
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int i = lane + 32 * s;
      const float s1 = fetch<R>(tsc, i >= 1 ? i - 1 : 0);
      const float s2 = fetch<R>(tsc, i >= 2 ? i - 2 : 0);
      x[s] = xn[s];
      if (r.cp1[s]) x[s] *= s1;
      if (r.cp2[s]) x[s] *= s2;
    }
  }
#pragma unroll
  for (int s = 0; s < R; ++s) x[s] *= r.act[s];
}

}  // namespace apgd
