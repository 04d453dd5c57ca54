// Device helpers shared by the APGD kernels (apgd_solve.cu, the dense
// iterate; apgd_factored.cu, the factored one): row types, block-wide
// reductions over one thread per constraint row, and the projection onto
// the non-negative, box and friction-cone rows.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace apgd {

constexpr int kNonneg = 1;
constexpr int kBox = 2;
constexpr int kConeNormal = 4;
constexpr int kRedSlots = 96;  // shared floats a reduction needs

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Block-wide sums of three values; every thread receives the totals.
__device__ inline void block_sum3(float& a, float& b, float& c, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  c = warp_sum(c);
  __syncthreads();
  if (lane == 0) {
    red[warp] = a;
    red[32 + warp] = b;
    red[64 + warp] = c;
  }
  __syncthreads();
  a = b = c = 0.f;
  for (int w = 0; w < nw; ++w) {
    a += red[w];
    b += red[32 + w];
    c += red[64 + w];
  }
}

__device__ inline float block_sum(float a, float* red) {
  float b = 0.f, c = 0.f;
  block_sum3(a, b, c, red);
  return a;
}

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

}  // namespace apgd
