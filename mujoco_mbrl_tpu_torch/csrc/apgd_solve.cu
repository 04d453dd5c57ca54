// Batched APGD constraint solve for Hopper (sm_90a).
//
// Replaces the TPU kernel mujoco_mbrl_tpu/ops/apgd_solve.py:_apgd_kernel
// (launched by apgd_iterate_batched). Per env it runs the whole iterate of
// physics/solver.py's _apgd_dispatch.impl: the power-iteration step size
// (24 cold steps, or 6 + 2 warm steps with the Rayleigh staleness guard and
// the inf-norm row-sum fallback; L = 1.5 * max(r, 1)), then Nesterov APGD
// with adaptive restart, projecting onto non-negative, box and friction-cone
// rows, a Gauss-Seidel polish on equality rows, and a per-env exit once
// converged (|df|^2 <= tol2 * (1e-12 + |f|^2)) or at the iteration cap.
//
// Design: one thread block per env, one thread per constraint row. The
// env's preconditioned matrix Ad is read from device memory once into
// shared memory (row stride nr|1, odd, so a warp reading one column of
// consecutive rows hits 32 distinct banks) and every matvec is a row dot
// product from there. Norms, the restart test and the convergence test
// are block reductions. The loop is a real per-env loop that leaves as
// soon as its env converges (the TPU's 128-env lanes, 8-row padding and
// chunked early exit were layout artefacts and are gone).
//
// Bound: the work is a chain of ~70 dependent matvecs of nr^2 FMAs
// (walker: nr = 62) per env; device memory sees Ad once (B * nr^2 * 4 B,
// 16 MB at B = 1024), so the kernel is latency-bound by that serial chain,
// far above both the bytes bound and the FP32 operations bound.

#include "apgd_common.cuh"

namespace {

using namespace apgd;

__global__ void apgd_kernel(const float* __restrict__ Ad_g,
                            const float* __restrict__ rhs_g,
                            const float* __restrict__ f0_g,
                            const float* __restrict__ v0_g,
                            const float* __restrict__ act_g,
                            const float* __restrict__ mu_g,
                            const float* __restrict__ bnd_g,
                            const int* __restrict__ rowtype_g,
                            const int* __restrict__ eq_g, int n_eq, int nr,
                            int ld, int iterations, int cold, int has_cone,
                            float tol2, float* __restrict__ f_out,
                            float* __restrict__ v_out) {
  extern __shared__ float sm[];
  float* Ad = sm;                  // nr * ld
  float* xs = Ad + nr * ld;        // matvec operand
  float* ps = xs + nr;             // pre-projection values / polish buffer
  float* ts = ps + nr;             // cone tangent scales
  float* red = ts + nr;            // kRedSlots reduction slots
  int* types = reinterpret_cast<int*>(red + kRedSlots);   // nr row types

  const int b = blockIdx.x;
  const int i = threadIdx.x;
  const bool row = i < nr;
  const size_t off = (size_t)b * nr;
  const float* Adb = Ad_g + (size_t)b * nr * nr;
  for (int k = threadIdx.x; k < nr * nr; k += blockDim.x) {
    const int r = k / nr;
    Ad[r * ld + (k - r * nr)] = Adb[k];
  }
  for (int k = threadIdx.x; k < nr; k += blockDim.x) types[k] = rowtype_g[k];
  const float rhs_i = row ? rhs_g[off + i] : 0.f;
  const float act_i = row ? act_g[off + i] : 0.f;
  const float mu_i = row ? mu_g[i] : 0.f;
  const float bnd_i = row ? bnd_g[i] : 0.f;
  const int type_i = row ? rowtype_g[i] : 0;
  __syncthreads();

  // (Ad x)_i for the block-wide vector whose row-i entry is x_i.
  auto matvec = [&](float x_i) -> float {
    __syncthreads();
    if (row) xs[i] = x_i;
    __syncthreads();
    float acc = 0.f;
    if (row) {
      const float* a = Ad + i * ld;
      for (int j = 0; j < nr; ++j) acc = fmaf(a[j], xs[j], acc);
    }
    return acc;
  };
  auto power_step = [&](float v) -> float {
    const float w = matvec(v);
    const float n2 = block_sum(w * w, red);
    return w / fmaxf(sqrtf(n2), 1e-12f);
  };

  // ---- step size from the preconditioned spectral radius -------------
  const float flat = row ? 1.f / sqrtf((float)nr) : 0.f;
  float v, L;
  if (cold) {
    v = flat;
    for (int k = 0; k < 24; ++k) v = power_step(v);
    const float mv = matvec(v);
    const float r = block_sum(v * mv, red);
    L = 1.5f * fmaxf(r, 1.f);
  } else {
    const float v0 = row ? v0_g[off + i] : 0.f;
    const float nrm = sqrtf(block_sum(v0 * v0, red));
    v = nrm > 1e-12f ? v0 / fmaxf(nrm, 1e-12f) : flat;
    for (int k = 0; k < 6; ++k) v = power_step(v);
    float mv = matvec(v);
    const float r6 = block_sum(v * mv, red);
    for (int k = 0; k < 2; ++k) v = power_step(v);
    mv = matvec(v);
    const float r8 = block_sum(v * mv, red);
    float rowabs = 0.f;
    if (row) {
      const float* a = Ad + i * ld;
      for (int j = 0; j < nr; ++j) rowabs += fabsf(a[j]);
    }
    const float safe_L = fmaxf(block_max(rowabs, red), 1.f);
    const bool stale = (r8 - r6) > 0.02f * fmaxf(r8, 1e-12f);
    L = stale ? safe_L : 1.5f * fmaxf(r8, 1.f);
  }

  // ---- projection: non-negative, then box, then friction cone -------
  const Row rw{i, nr, type_i, row, mu_i, bnd_i, act_i};
  auto proj = [&](float x) -> float {
    return project(x, rw, has_cone, ps, ts, types);
  };

  // ---- Nesterov APGD with adaptive restart, per-env exit ------------
  float f = proj(row ? f0_g[off + i] : 0.f);
  float y = f, theta = 1.f;
  for (int it = 0; it < iterations; ++it) {
    const float g = matvec(y) - rhs_i;
    float fn = proj(y - g / L);
    if (n_eq) {
      // exact Gauss-Seidel update of each equality row, in order,
      // masked by the row's `active` entry
      __syncthreads();
      if (row) ps[i] = fn;
      __syncthreads();
      for (int q = 0; q < n_eq; ++q) {
        const int e = eq_g[q];
        if (i == e) {
          float r = 0.f;
          const float* a = Ad + e * ld;
          for (int j = 0; j < nr; ++j) r = fmaf(a[j], ps[j], r);
          ps[e] = ps[e] - act_i * (r - rhs_i);
        }
        __syncthreads();
      }
      if (row) fn = ps[i];
    }
    const float th_new = 0.5f * (1.f + sqrtf(1.f + 4.f * theta * theta));
    float beta = (theta - 1.f) / th_new;
    float dir = (y - fn) * (fn - f), d2 = (fn - f) * (fn - f), n2 = fn * fn;
    block_sum3(dir, d2, n2, red);
    const bool restart = dir > 0.f;
    if (restart) beta = 0.f;
    y = fn + beta * (fn - f);
    f = fn;
    theta = restart ? 1.f : th_new;
    if (d2 <= tol2 * (1e-12f + n2)) break;   // block-uniform
  }
  if (row) {
    f_out[off + i] = f;
    v_out[off + i] = v;
  }
}

}  // namespace

extern "C" size_t apgd_smem_bytes(int nr) {
  const int ld = nr | 1;
  return sizeof(float) * ((size_t)nr * ld + 3 * nr + apgd::kRedSlots) +
         sizeof(int) * nr;
}

extern "C" int apgd_iterate_batched(
    const float* Ad, const float* rhs, const float* f0, const float* v0,
    const float* active, const float* mu, const float* bounds,
    const int* rowtype, const int* eq_rows, int n_eq, int B, int nr,
    int iterations, int cold, int has_cone, float tol2, float* f_out,
    float* v_out, void* stream) {
  const int threads = nr <= 32 ? 32 : ((nr + 31) / 32) * 32;
  const size_t smem = apgd_smem_bytes(nr);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        apgd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (B > 0)
    apgd_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        Ad, rhs, f0, v0, active, mu, bounds, rowtype, eq_rows, n_eq, nr,
        nr | 1, iterations, cold, has_cone, tol2, f_out, v_out);
  return (int)cudaGetLastError();
}
