// Batched factored APGD constraint solve for Hopper (sm_90a).
//
// Replaces the TPU kernel mujoco_mbrl_tpu/ops/apgd_solve.py:
// _apgd_factored_kernel (launched by apgd_iterate_factored), the solve of
// models whose constraint set is past the dense kernel's 96-row wall
// (cheetah: nr = 146, nv = 9; humanoid: nr = 303, nv = 27). The dual
// matrix Ad = J~ M^-1 J~' + diag(Rs) is never formed: J~ (nr x nv, the
// row-scaled and active-masked Jacobian) and M^-1 (nv x nv) are what the
// kernel holds. Per env it runs the iterate of physics/solver.py's
// _apgd_dispatch_factored.impl_f: the power-iteration step size (24 cold
// steps, or 6 + 2 warm steps with the Rayleigh staleness guard whose
// fallback is the trace bound max(sum diag_s, 1)), normalised by an exact
// sqrt and divide; then Nesterov APGD with adaptive restart, projecting
// onto non-negative, box and friction-cone rows; a per-env exit once
// converged (|df|^2 <= tol2 * (1e-12 + |f|^2)) or at the iteration cap;
// the APGD iterations each env ran go to its_out where it is given.
// There is no equality polish (no model in this regime has equality rows;
// the wrapper's caller never sends them).
//
// Design: one thread block per env, one thread per constraint row (nr
// rounded up to a warp: 160 threads for cheetah, 320 for humanoid). J~ is
// read from device memory once into shared memory (row stride nv|1, odd,
// so a warp reading one column of consecutive rows hits 32 distinct
// banks), M^-1 beside it (cheetah 5.3 + 0.3 KB, humanoid 32.7 + 2.9 KB);
// the per-row vectors live in registers. A matvec is three stages:
//   1. t = J~' y: nv column sums, each a warp shuffle reduction, then a
//      shared-memory combine across warps by nv threads;
//   2. u = M^-1 t: nv threads;
//   3. z_r = J~[r,:] . u + Rs_r y_r: every row thread on its own.
// Norms, the restart test and the convergence test are block reductions
// (apgd_common.cuh, shared with the dense kernel).
//
// Bound: device memory sees J~, M^-1 and seven row vectors once (cheetah
// at B = 1024: 6.6 MB, 2 us at 3.35 TB/s); each matvec is 4 nr nv + 2 nv^2
// FLOP, ~70 of them per env, 0.4 GFLOP at B = 1024 (6 us at the FP32
// peak). The chain of ~70 dependent matvecs, each with three block
// barriers, makes the kernel latency-bound far above both bounds.

#include "apgd_common.cuh"

namespace {

using namespace apgd;

struct Layout {
  int ldj;              // row stride of J~ in shared memory (odd)
  size_t floats, ints;  // shared memory
};

__host__ __device__ inline Layout layout(int nr, int nv) {
  Layout l;
  l.ldj = nv | 1;
  l.floats = (size_t)nr * l.ldj + (size_t)nv * nv + 32 * (size_t)nv +
             2 * (size_t)nv + 2 * (size_t)nr + kRedSlots;
  l.ints = nr;
  return l;
}

__global__ void apgd_factored_kernel(
    const float* __restrict__ J_g, const float* __restrict__ Minv_g,
    const float* __restrict__ Rs_g, const float* __restrict__ diag_g,
    const float* __restrict__ rhs_g, const float* __restrict__ f0_g,
    const float* __restrict__ v0_g, const float* __restrict__ act_g,
    const float* __restrict__ mu_g, const float* __restrict__ bnd_g,
    const int* __restrict__ rowtype_g, int nr, int nv, int iterations,
    int cold, int has_cone, float tol2, float* __restrict__ f_out,
    float* __restrict__ v_out, int* __restrict__ its_out) {
  extern __shared__ float sm[];
  const Layout lay = layout(nr, nv);
  const int ldj = lay.ldj;
  float* Js = sm;                  // nr * ldj
  float* Mi = Js + nr * ldj;       // nv * nv
  float* part = Mi + nv * nv;      // 32 warps * nv partial column sums
  float* tv = part + 32 * nv;      // t = J~' y
  float* uv = tv + nv;             // u = M^-1 t
  float* ps = uv + nv;             // projection buffers
  float* ts = ps + nr;
  float* red = ts + nr;            // kRedSlots reduction slots
  int* types = reinterpret_cast<int*>(red + kRedSlots);

  const int b = blockIdx.x;
  const int i = threadIdx.x;
  const int lane = i & 31, warp = i >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  const bool row = i < nr;
  const size_t off = (size_t)b * nr;
  const float* Jb = J_g + (size_t)b * nr * nv;
  for (int k = i; k < nr * nv; k += blockDim.x) {
    const int r = k / nv;
    Js[r * ldj + (k - r * nv)] = Jb[k];
  }
  const float* Mb = Minv_g + (size_t)b * nv * nv;
  for (int k = i; k < nv * nv; k += blockDim.x) Mi[k] = Mb[k];
  for (int k = i; k < nr; k += blockDim.x) types[k] = rowtype_g[k];
  const float rhs_i = row ? rhs_g[off + i] : 0.f;
  const float rs_i = row ? Rs_g[off + i] : 0.f;
  const Row rw{i, nr, row ? rowtype_g[i] : 0, row, row ? mu_g[i] : 0.f,
               row ? bnd_g[i] : 0.f, row ? act_g[off + i] : 0.f};
  const float* jr = Js + (row ? i : 0) * ldj;
  __syncthreads();

  // (Ad y)_i = J~[i,:] M^-1 J~' y + Rs_i y_i for the block-wide vector
  // whose row-i entry is y_i.
  auto matvec = [&](float y_i) -> float {
    __syncthreads();               // the last matvec's readers are done
    for (int v = 0; v < nv; ++v) {
      const float p = warp_sum(row ? jr[v] * y_i : 0.f);
      if (lane == 0) part[warp * nv + v] = p;
    }
    __syncthreads();
    if (i < nv) {
      float t = 0.f;
      for (int w = 0; w < nw; ++w) t += part[w * nv + i];
      tv[i] = t;
    }
    __syncthreads();
    if (i < nv) {
      float u = 0.f;
      for (int w = 0; w < nv; ++w) u = fmaf(Mi[i * nv + w], tv[w], u);
      uv[i] = u;
    }
    __syncthreads();
    float z = 0.f;
    if (row) {
      for (int v = 0; v < nv; ++v) z = fmaf(jr[v], uv[v], z);
      z += rs_i * y_i;
    }
    return z;
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
    const float r = block_sum(v * matvec(v), red);
    L = 1.5f * fmaxf(r, 1.f);
  } else {
    const float v0 = row ? v0_g[off + i] : 0.f;
    const float nrm = sqrtf(block_sum(v0 * v0, red));
    v = nrm > 1e-12f ? v0 / fmaxf(nrm, 1e-12f) : flat;
    for (int k = 0; k < 6; ++k) v = power_step(v);
    const float r6 = block_sum(v * matvec(v), red);
    for (int k = 0; k < 2; ++k) v = power_step(v);
    const float r8 = block_sum(v * matvec(v), red);
    // trace bound: lambda_max <= trace for a PSD matrix
    const float safe_L =
        fmaxf(block_sum(row ? diag_g[off + i] : 0.f, red), 1.f);
    const bool stale = (r8 - r6) > 0.02f * fmaxf(r8, 1e-12f);
    L = stale ? safe_L : 1.5f * fmaxf(r8, 1.f);
  }

  // ---- Nesterov APGD with adaptive restart, per-env exit ------------
  float f = project(row ? f0_g[off + i] : 0.f, rw, has_cone, ps, ts, types);
  float y = f, theta = 1.f;
  int n_it = 0;
  for (int it = 0; it < iterations; ++it) {
    const float g = matvec(y) - rhs_i;
    const float fn = project(y - g / L, rw, has_cone, ps, ts, types);
    const float th_new = 0.5f * (1.f + sqrtf(1.f + 4.f * theta * theta));
    float beta = (theta - 1.f) / th_new;
    float dir = (y - fn) * (fn - f), d2 = (fn - f) * (fn - f), n2 = fn * fn;
    block_sum3(dir, d2, n2, red);
    const bool restart = dir > 0.f;
    if (restart) beta = 0.f;
    y = fn + beta * (fn - f);
    f = fn;
    theta = restart ? 1.f : th_new;
    ++n_it;
    if (d2 <= tol2 * (1e-12f + n2)) break;   // block-uniform
  }
  if (row) {
    f_out[off + i] = f;
    v_out[off + i] = v;
  }
  if (its_out != nullptr && i == 0) its_out[b] = n_it;
}

}  // namespace

extern "C" size_t apgd_factored_smem_bytes(int nr, int nv) {
  const Layout l = layout(nr, nv);
  return sizeof(float) * l.floats + sizeof(int) * l.ints;
}

extern "C" int apgd_iterate_factored(
    const float* J, const float* Minv, const float* Rs, const float* diag,
    const float* rhs, const float* f0, const float* v0, const float* active,
    const float* mu, const float* bounds, const int* rowtype, int B, int nr,
    int nv, int iterations, int cold, int has_cone, float tol2,
    float* f_out, float* v_out, int* its_out, void* stream) {
  const int n = nr > nv ? nr : nv;
  const int threads = n <= 32 ? 32 : ((n + 31) / 32) * 32;
  if (threads > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = apgd_factored_smem_bytes(nr, nv);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        apgd_factored_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (B > 0)
    apgd_factored_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        J, Minv, Rs, diag, rhs, f0, v0, active, mu, bounds, rowtype, nr, nv,
        iterations, cold, has_cone, tol2, f_out, v_out, its_out);
  return (int)cudaGetLastError();
}
