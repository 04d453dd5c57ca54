// Batched factored APGD constraint solve for Hopper (sm_90a).
//
// Replaces the TPU kernel mujoco_mbrl_tpu/ops/apgd_solve.py:
// _apgd_factored_kernel (launched by apgd_iterate_factored), the solve of
// models whose constraint set is past the dense kernel's 96-row wall
// (cheetah: nr = 146, nv = 9; humanoid: nr = 303, nv = 27). The dual
// matrix Ad = J~ M^-1 J~' + diag(Rs) is never formed: J~ (nr x nv, the
// row-scaled and active-masked Jacobian) and M^-1 (nv x nv) are what the
// kernel reads. Per env it runs the iterate of physics/solver.py's
// _apgd_dispatch_factored.impl_f: the power-iteration step size (24 cold
// steps, or 6 + 2 warm steps with the Rayleigh staleness guard whose
// fallback is the trace bound max(sum diag_s, 1)); then Nesterov APGD with
// adaptive restart, projecting onto non-negative, box and friction-cone
// rows; a per-env exit once converged (|df|^2 <= tol2 * (1e-12 + |f|^2))
// or at the iteration cap; the APGD iterations each env ran go to its_out
// where it is given. There is no equality polish (no model in this regime
// has equality rows; the wrapper's caller never sends them). The box rows'
// bounds are (nr,), shared by the envs (bnd_ld = 0), or (B, nr), each
// env's own (bnd_ld = nr): friction-loss rows, whose bounds each env's row
// scale divides, as under JAX's vmap.
//
// Bound: device memory sees J~, M^-1 and seven row vectors once (cheetah
// at B = 1024: 6.6 MB, 2 us at 3.35 TB/s); each matvec is 4 nr nv + 2 nv^2
// FLOP, ~70 of them per env (0.4 GFLOP at B = 1024, 6 us at the FP32
// peak). Each env is a chain of ~85 dependent matvecs (24 power steps, a
// Rayleigh quotient, up to 60 iterations) and the slowest env sets the
// launch's time, so the time of one dependent step sets the kernel's, far
// above both bounds. Both paths shorten that step.
//
// Warp path (apgd_factored_warp_kernel<NV, EXACT>; nr <= 160, nv <= 16):
// one env per warp, two envs per block, row i in lane i % 32, slot i / 32
// (R = 5 slots). A lane holds its rows of J~ and of P = J~ M^-1 (computed
// once at the start) in registers, so the matvec has two stages and no
// barrier:
//   1. t = J~' y: each lane's nv partial column sums over its rows, then
//      nv interleaved xor butterflies, after which every lane holds t (a
//      reduce-scatter with a third of the shuffles ran an iteration half
//      as fast: its per-lane selects and moves cost more than the
//      shuffles it saved);
//   2. z_r = P[r,:] . t + Rs_r y_r, in registers.
// This removes the nv x nv stage u = M^-1 t that nv threads ran while the
// block waited. Norms, Rayleigh quotients, the trace bound and the
// restart and convergence tests are xor-shuffle warp sums (identical in
// every lane, so the per-env exit is warp-uniform). The gradient step and
// the power step's normalisation multiply by a reciprocal taken once (an
// IEEE division is a branch around a slow path; within 1.5 ulp of the
// division). The projection is the dense warp kernel's (project_lanes,
// the cone's neighbour rows by shuffles). The cheetah's nv = 9 has an
// exact instantiation; nv <= 16 a guarded one (J~ and P padded with zero
// columns; at the register ceiling, it spills).
//
// Block path (apgd_factored_block_kernel; nr up to 1024, any nv that fits
// shared memory): one block per env, one thread per row, J~ and M^-1 in
// shared memory (row strides nv | 1, odd, so a warp reading one column
// of consecutive rows hits 32 distinct banks; humanoid 32.7 + 2.9 KB). A
// matvec: each warp's column sums of its rows (butterflies) into shared
// memory; one barrier; warp 0 sums the warps' partials (t) and forms u =
// M^-1 t; one barrier; each row thread takes z_r = J~[r,:] . u + Rs_r y_r.
// Block sums take one barrier each (double-buffered slots), so an
// iteration without cones has three barriers, down from six. Blocks of up
// to 320 threads are held to 48 registers so that four fit an SM (the
// humanoid's B = 512 envs in one wave); larger blocks to 64, so that 1024
// threads can launch. P = J~ M^-1 in shared memory would remove the u
// stage but double the block's shared memory (~70 KB at the humanoid's
// size, three blocks an SM: two waves at B = 512).

// Dense iterate on factors (apgd_dense_factors_kernel; launched by
// ops/apgd_solve.py apgd_iterate_dense_factors). It replaces the same TPU
// kernel's semantics, mujoco_mbrl_tpu/ops/apgd_solve.py:_apgd_kernel,
// where JAX runs its XLA twin instead: a dense-regime solve past the 1024
// rows that apgd_solve.cu's one-thread-a-row paths take, with no
// equality row (humanoid_cmu: nr = 4,352, nv = 62; factored_fits is False,
// so JAX forms Ad, 76 MB an env). It computes JAX's dense iterate
// (_apgd_dispatch.impl: the flat power start over all nr rows, 24 cold or
// 6 + 2 warm power steps, the Rayleigh guard and its ROW-SUM fallback
// max(max_i sum_j |Ad_ij|, 1), Nesterov APGD with restart, the per-env exit
// and the cap) on Ad = J~ M^-1 J~' + diag(Rs), never formed. Every row is
// non-negative (joint limits, pyramid facets; the wrapper refuses others).
// solve_apgd masks Ad to the active rows and columns (J~ and Rs are zero
// elsewhere) and an inactive row's force stays 0, so the kernel lists the
// env's k active rows once (the ballot compaction of apgd_solve.cu's
// global path, over chunks of the block) and works on them alone; f and v
// are written with zeros on the inactive rows.
// One block of 512 threads per env, with a block's whole shared memory:
// M^-1, then the k active rows' index and six vectors (f, y, v, the
// matvec's result, rhs, Rs), then as many of J~'s active rows (stride
// nv | 1) as fit (747 at nv 62 when all are staged, 346 at k = 4,352);
// the rest are read from device memory in the same kernel, so a
// contact-rich env still runs. A matvec is the block path's three stages
// over the active rows: t = J~_a' y (a thread a column and row group, then
// the groups' sum), u = M^-1 t (a thread a row of M^-1), z = J~_a u + Rs y
// (a thread an active row); four barriers. The row-sum bound is formed
// only when the guard finds the start stale: a warp an active row i takes
// P_i = J~_i M^-1, then its lanes sum |P_i . J~_j + delta_ij Rs_i| over the
// active j (k^2 nv FMAs).
// Bound: the active rows of J~, M^-1 and rhs, Rs and f0 on the active
// rows are read once, `active` (and a warm v0) over all nr rows, and f and
// v are written over all nr rows (k nv + nv^2 + 3 k + 3 nr floats an env,
// + nr warm); a matvec is 4 k nv + 2 nv^2 FLOP.
// Like the other paths it is a chain of ~85 dependent matvecs per env,
// latency-bound far above both; one block an SM (the shared memory is
// sized for the worst k), eight waves at 1024 envs.

#include "apgd_common.cuh"

namespace {

using namespace apgd;

constexpr int kWarpRows = 5;   // row slots a lane: nr <= 160
constexpr int kWarpEnvs = 2;   // envs (warps) per block of the warp path
constexpr int kWarpMaxNV = 16;
constexpr int kCheetahNV = 9;
constexpr int kSmallBlock = 320;  // held to 48 registers: 4 blocks an SM

template <int NV, bool EXACT>
__global__ void __launch_bounds__(32 * kWarpEnvs)
    apgd_factored_warp_kernel(
        const float* __restrict__ J_g, const float* __restrict__ Minv_g,
        const float* __restrict__ Rs_g, const float* __restrict__ diag_g,
        const float* __restrict__ rhs_g, const float* __restrict__ f0_g,
        const float* __restrict__ v0_g, const float* __restrict__ act_g,
        const float* __restrict__ mu_g, const float* __restrict__ bnd_g,
        const int* __restrict__ rowtype_g, int B, int nr, int nv_arg,
        int bnd_ld, int iterations, int cold, int has_cone, float tol2,
        float* __restrict__ f_out, float* __restrict__ v_out,
        int* __restrict__ its_out) {
  constexpr int R = kWarpRows;
  const int nv = EXACT ? NV : nv_arg;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpEnvs + (threadIdx.x >> 5);
  if (b >= B) return;  // the warp's env; no block barrier below
  const size_t off = (size_t)b * nr;

  // ---- this lane's rows of J~, then P = J~ M^-1, in registers --------
  float J[R][NV], P[R][NV];
  const float* Jb = J_g + (size_t)b * nr * nv;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int i = lane + 32 * s;
#pragma unroll
    for (int v = 0; v < NV; ++v)
      J[s][v] = i < nr && v < nv ? Jb[(size_t)i * nv + v] : 0.f;
  }
  const float* Mb = Minv_g + (size_t)b * nv * nv;
#pragma unroll
  for (int s = 0; s < R; ++s)
#pragma unroll
    for (int c = 0; c < NV; ++c) P[s][c] = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const float m = k < nv && c < nv ? Mb[k * nv + c] : 0.f;
#pragma unroll
      for (int s = 0; s < R; ++s) P[s][c] = fmaf(J[s][k], m, P[s][c]);
    }

  bool valid[R];
  float rhs[R], rs[R];
  LaneRows<R> rows;
  load_lane_rows<R>(rows, lane, nr, act_g + off, mu_g,
                    bnd_g + (size_t)b * bnd_ld, rowtype_g);
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int i = lane + 32 * s;
    valid[s] = i < nr;
    rhs[s] = valid[s] ? rhs_g[off + i] : 0.f;
    rs[s] = valid[s] ? Rs_g[off + i] : 0.f;
  }

  // z = Ad y (rows of this lane) = P (J~' y) + Rs y
  auto matvec = [&](const float (&y)[R], float (&z)[R]) {
    float tb[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      tb[v] = 0.f;
#pragma unroll
      for (int s = 0; s < R; ++s) tb[v] = fmaf(J[s][v], y[s], tb[v]);
    }
    // nv interleaved xor butterflies: every lane receives all of t
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int v = 0; v < NV; ++v) tb[v] += __shfl_xor_sync(kFull, tb[v], o);
#pragma unroll
    for (int s = 0; s < R; ++s) {
      float a0 = rs[s] * y[s], a1 = 0.f;
#pragma unroll
      for (int v = 0; v < NV; v += 2) {
        a0 = fmaf(P[s][v], tb[v], a0);
        if (v + 1 < NV) a1 = fmaf(P[s][v + 1], tb[v + 1], a1);
      }
      z[s] = a0 + a1;
    }
  };
  // x' y over the env (every lane receives it)
  auto dot = [&](const float (&x)[R], const float (&y)[R]) -> float {
    float d = 0.f;
#pragma unroll
    for (int s = 0; s < R; ++s) d = fmaf(x[s], y[s], d);
    return warp_sum(d);
  };
  auto power_step = [&](float (&v)[R]) {
    float w[R];
    matvec(v, w);
    const float inv = 1.f / fmaxf(sqrtf(dot(w, w)), 1e-12f);
#pragma unroll
    for (int s = 0; s < R; ++s) v[s] = w[s] * inv;
  };
  auto rayleigh = [&](const float (&v)[R]) -> float {
    float mv[R];
    matvec(v, mv);
    return dot(v, mv);
  };

  // ---- step size from the preconditioned spectral radius -------------
  const float flat = 1.f / sqrtf((float)nr);
  float v[R], L;
  if (cold) {
#pragma unroll
    for (int s = 0; s < R; ++s) v[s] = valid[s] ? flat : 0.f;
    for (int k = 0; k < 24; ++k) power_step(v);
    L = 1.5f * fmaxf(rayleigh(v), 1.f);
  } else {
#pragma unroll
    for (int s = 0; s < R; ++s)
      v[s] = valid[s] ? v0_g[off + lane + 32 * s] : 0.f;
    const float nrm = sqrtf(dot(v, v));
#pragma unroll
    for (int s = 0; s < R; ++s)
      v[s] = nrm > 1e-12f ? v[s] / fmaxf(nrm, 1e-12f)
                          : (valid[s] ? flat : 0.f);
    for (int k = 0; k < 6; ++k) power_step(v);
    const float r6 = rayleigh(v);
    for (int k = 0; k < 2; ++k) power_step(v);
    const float r8 = rayleigh(v);
    // trace bound: lambda_max <= trace for a PSD matrix
    float tr = 0.f;
#pragma unroll
    for (int s = 0; s < R; ++s)
      tr += valid[s] ? diag_g[off + lane + 32 * s] : 0.f;
    const float safe_L = fmaxf(warp_sum(tr), 1.f);
    const bool stale = (r8 - r6) > 0.02f * fmaxf(r8, 1e-12f);
    L = stale ? safe_L : 1.5f * fmaxf(r8, 1.f);
  }

  // ---- Nesterov APGD with adaptive restart, per-env exit ------------
  float f[R], y[R];
#pragma unroll
  for (int s = 0; s < R; ++s)
    f[s] = valid[s] ? f0_g[off + lane + 32 * s] : 0.f;
  project_lanes<R>(f, rows, lane, nr, has_cone);
#pragma unroll
  for (int s = 0; s < R; ++s) y[s] = f[s];
  float theta = 1.f;
  const float inv_L = 1.f / L;
  int n_it = 0;
  for (int it = 0; it < iterations; ++it) {
    float fn[R];
    matvec(y, fn);
#pragma unroll
    for (int s = 0; s < R; ++s) fn[s] = y[s] - (fn[s] - rhs[s]) * inv_L;
    project_lanes<R>(fn, rows, lane, nr, has_cone);
    const float th_new = 0.5f * (1.f + sqrtf(1.f + 4.f * theta * theta));
    float beta = (theta - 1.f) / th_new;
    float dir = 0.f, d2 = 0.f, n2 = 0.f;
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const float df = fn[s] - f[s];
      dir = fmaf(y[s] - fn[s], df, dir);
      d2 = fmaf(df, df, d2);
      n2 = fmaf(fn[s], fn[s], n2);
    }
    dir = warp_sum(dir);
    d2 = warp_sum(d2);
    n2 = warp_sum(n2);
    const bool restart = dir > 0.f;
    if (restart) beta = 0.f;
#pragma unroll
    for (int s = 0; s < R; ++s) {
      y[s] = fn[s] + beta * (fn[s] - f[s]);
      f[s] = fn[s];
    }
    theta = restart ? 1.f : th_new;
    ++n_it;
    if (d2 <= tol2 * (1e-12f + n2)) break;  // warp-uniform
  }
#pragma unroll
  for (int s = 0; s < R; ++s)
    if (valid[s]) {
      f_out[off + lane + 32 * s] = f[s];
      v_out[off + lane + 32 * s] = v[s];
    }
  if (its_out != nullptr && lane == 0) its_out[b] = n_it;
}

struct Layout {
  int ldj, ldm;         // row strides of J~ and M^-1 in shared memory (odd)
  size_t floats, ints;  // shared memory
};

__host__ __device__ inline Layout layout(int nr, int nv) {
  Layout l;
  l.ldj = nv | 1;
  l.ldm = nv | 1;
  l.floats = (size_t)nr * l.ldj + (size_t)nv * l.ldm + 32 * (size_t)nv +
             2 * (size_t)nv + 2 * (size_t)nr + 2 * kRedSlots;
  l.ints = nr;
  return l;
}

size_t smem_bytes(int nr, int nv) {
  const Layout l = layout(nr, nv);
  return sizeof(float) * l.floats + sizeof(int) * l.ints;
}

template <int MAX_THREADS, int MIN_BLOCKS>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
    apgd_factored_block_kernel(
    const float* __restrict__ J_g, const float* __restrict__ Minv_g,
    const float* __restrict__ Rs_g, const float* __restrict__ diag_g,
    const float* __restrict__ rhs_g, const float* __restrict__ f0_g,
    const float* __restrict__ v0_g, const float* __restrict__ act_g,
    const float* __restrict__ mu_g, const float* __restrict__ bnd_g,
    const int* __restrict__ rowtype_g, int nr, int nv, int bnd_ld,
    int iterations, int cold, int has_cone, float tol2,
    float* __restrict__ f_out,
    float* __restrict__ v_out, int* __restrict__ its_out) {
  extern __shared__ float sm[];
  const Layout lay = layout(nr, nv);
  const int ldj = lay.ldj, ldm = lay.ldm;
  float* Js = sm;                  // nr * ldj
  float* Mi = Js + nr * ldj;       // nv * ldm
  float* part = Mi + nv * ldm;     // 32 warps * nv partial column sums
  float* tv = part + 32 * nv;      // t = J~' y
  float* uv = tv + nv;             // u = M^-1 t
  float* ps = uv + nv;             // projection buffers
  float* ts = ps + nr;
  float* red = ts + nr;            // 2 * kRedSlots reduction slots
  int* types = reinterpret_cast<int*>(red + 2 * kRedSlots);

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
  for (int k = i; k < nv * nv; k += blockDim.x) {
    const int r = k / nv;
    Mi[r * ldm + (k - r * nv)] = Mb[k];
  }
  for (int k = i; k < nr; k += blockDim.x) types[k] = rowtype_g[k];
  const float rhs_i = row ? rhs_g[off + i] : 0.f;
  const float rs_i = row ? Rs_g[off + i] : 0.f;
  const Row rw{i, nr, row ? rowtype_g[i] : 0, row, row ? mu_g[i] : 0.f,
               row ? bnd_g[(size_t)b * bnd_ld + i] : 0.f,
               row ? act_g[off + i] : 0.f};
  const float* jr = Js + (row ? i : 0) * ldj;
  int parity = 0;
  __syncthreads();

  // (Ad y)_i = J~[i,:] M^-1 J~' y + Rs_i y_i for the block-wide vector
  // whose row-i entry is y_i. part, tv and uv need no leading barrier:
  // their readers of the previous call finished before its last barrier.
  auto matvec = [&](float y_i) -> float {
    for (int v = 0; v < nv; ++v) {
      const float p = warp_sum(row ? jr[v] * y_i : 0.f);
      if (lane == 0) part[warp * nv + v] = p;
    }
    __syncthreads();
    if (warp == 0) {
      for (int v = lane; v < nv; v += 32) {
        float t = 0.f;
        for (int w = 0; w < nw; ++w) t += part[w * nv + v];
        tv[v] = t;
      }
      __syncwarp();
      for (int v = lane; v < nv; v += 32) {
        float u = 0.f;
        for (int w = 0; w < nv; ++w) u = fmaf(Mi[v * ldm + w], tv[w], u);
        uv[v] = u;
      }
    }
    __syncthreads();
    float z = 0.f;
    if (row) {
      for (int v = 0; v < nv; ++v) z = fmaf(jr[v], uv[v], z);
      z += rs_i * y_i;
    }
    return z;
  };
  auto sum1 = [&](float a) -> float { return block_sum(a, red, parity); };
  auto power_step = [&](float v) -> float {
    const float w = matvec(v);
    return w * (1.f / fmaxf(sqrtf(sum1(w * w)), 1e-12f));
  };

  // ---- step size from the preconditioned spectral radius -------------
  const float flat = row ? 1.f / sqrtf((float)nr) : 0.f;
  float v, L;
  if (cold) {
    v = flat;
    for (int k = 0; k < 24; ++k) v = power_step(v);
    const float r = sum1(v * matvec(v));
    L = 1.5f * fmaxf(r, 1.f);
  } else {
    const float v0 = row ? v0_g[off + i] : 0.f;
    const float nrm = sqrtf(sum1(v0 * v0));
    v = nrm > 1e-12f ? v0 / fmaxf(nrm, 1e-12f) : flat;
    for (int k = 0; k < 6; ++k) v = power_step(v);
    const float r6 = sum1(v * matvec(v));
    for (int k = 0; k < 2; ++k) v = power_step(v);
    const float r8 = sum1(v * matvec(v));
    // trace bound: lambda_max <= trace for a PSD matrix
    const float safe_L = fmaxf(sum1(row ? diag_g[off + i] : 0.f), 1.f);
    const bool stale = (r8 - r6) > 0.02f * fmaxf(r8, 1e-12f);
    L = stale ? safe_L : 1.5f * fmaxf(r8, 1.f);
  }

  // ---- Nesterov APGD with adaptive restart, per-env exit ------------
  float f = project(row ? f0_g[off + i] : 0.f, rw, has_cone, ps, ts, types);
  float y = f, theta = 1.f;
  const float inv_L = 1.f / L;
  int n_it = 0;
  for (int it = 0; it < iterations; ++it) {
    const float g = matvec(y) - rhs_i;
    const float fn = project(y - g * inv_L, rw, has_cone, ps, ts, types);
    const float th_new = 0.5f * (1.f + sqrtf(1.f + 4.f * theta * theta));
    float beta = (theta - 1.f) / th_new;
    float dir = (y - fn) * (fn - f), d2 = (fn - f) * (fn - f), n2 = fn * fn;
    block_sums(dir, d2, n2, red, parity);
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


constexpr int kDFThreads = 512;
constexpr int kDFWarps = kDFThreads / 32;

// The fixed part of the dense-on-factors block's shared memory, in
// words: M^-1 (stride nv | 1), the matvec's partial column sums (groups
// x ncol), t and u (ncol each), the reduction slots, a row of P a warp
// (ncol each) and the compaction's 32 counts (ints).
struct DFLayout {
  int ldm, ncol, groups;
  size_t fixed;
};

__host__ __device__ inline DFLayout df_layout(int nv) {
  DFLayout l;
  l.ldm = nv | 1;
  l.ncol = (nv + 31) / 32 * 32;
  l.groups = kDFThreads / l.ncol;
  l.fixed = (size_t)nv * l.ldm + (size_t)(l.groups + 2 + kDFWarps) * l.ncol +
            2 * kRedSlots + 32;
  return l;
}

__global__ void __launch_bounds__(kDFThreads, 1)
    apgd_dense_factors_kernel(
        const float* __restrict__ J_g, const float* __restrict__ Minv_g,
        const float* __restrict__ Rs_g, const float* __restrict__ rhs_g,
        const float* __restrict__ f0_g, const float* __restrict__ v0_g,
        const float* __restrict__ act_g, int nr, int nv, int iterations,
        int cold, float tol2, int smem_words, float* __restrict__ f_out,
        float* __restrict__ v_out, int* __restrict__ its_out) {
  extern __shared__ float sm[];
  const DFLayout lay = df_layout(nv);
  const int ldm = lay.ldm, ldj = nv | 1, ncol = lay.ncol;
  const int groups = lay.groups;
  float* Mi = sm;                          // nv * ldm
  float* part = Mi + nv * ldm;             // groups * ncol
  float* tv = part + groups * ncol;        // t = J~_a' y
  float* uv = tv + ncol;                   // u = M^-1 t
  float* red = uv + ncol;                  // 2 * kRedSlots
  float* Pw = red + 2 * kRedSlots;         // kDFWarps * ncol
  int* cnt = reinterpret_cast<int*>(Pw + kDFWarps * ncol);  // 32
  int* idx = cnt + 32;                     // the k active rows, ascending

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t off = (size_t)b * nr;
  const float* Jb = J_g + off * nv;
  const float* act_b = act_g + off;
  int parity = 0;

  // ---- the active rows, compacted in row order, a chunk at a time -----
  int k = 0;
  for (int c0 = 0; c0 < nr; c0 += kDFThreads) {
    const int i = c0 + tid;
    const bool live = i < nr && act_b[i] != 0.f;
    const unsigned ballot = __ballot_sync(kFull, live);
    if (lane == 0) cnt[warp] = __popc(ballot);
    __syncthreads();
    int pos = k + __popc(ballot & ((1u << lane) - 1u)), total = 0;
    for (int w = 0; w < kDFWarps; ++w) {
      if (w < warp) pos += cnt[w];
      total += cnt[w];
    }
    if (live) idx[pos] = i;
    k += total;
    __syncthreads();  // cnt is rewritten by the next chunk
  }
  float* f = reinterpret_cast<float*>(idx + k);
  float* y = f + k;
  float* v = y + k;
  float* w = v + k;                        // the matvec's result
  float* rhs = w + k;
  float* rs = rhs + k;
  float* Js = rs + k;                      // staged rows of J~_a
  const long long room = (long long)smem_words - (long long)lay.fixed -
                        7LL * k;
  const int staged = room <= 0 ? 0 : (room / ldj < k ? (int)(room / ldj) : k);
  auto jrow = [&](int q) -> const float* {
    return q < staged ? Js + (size_t)q * ldj : Jb + (size_t)idx[q] * nv;
  };

  // ---- stage M^-1, the active rows of J~ and the row vectors ---------
  const float* Mb = Minv_g + (size_t)b * nv * nv;
  for (int e = tid; e < nv * nv; e += kDFThreads) {
    const int r = e / nv;
    Mi[r * ldm + (e - r * nv)] = Mb[e];
  }
  for (int e = tid; e < staged * nv; e += kDFThreads) {
    const int q = e / nv;
    Js[q * ldj + (e - q * nv)] = Jb[(size_t)idx[q] * nv + (e - q * nv)];
  }
  // a warm v0 is normalised over all nr rows, inactive ones included
  float nrm = 0.f;
  if (!cold) {
    float s2 = 0.f;
    for (int i = tid; i < nr; i += kDFThreads) {
      const float x = v0_g[off + i];
      s2 = fmaf(x, x, s2);
    }
    nrm = sqrtf(block_sum(s2, red, parity));
  }
  const float flat = 1.f / sqrtf((float)nr);
  for (int q = tid; q < k; q += kDFThreads) {
    const int i = idx[q];
    rhs[q] = rhs_g[off + i];
    rs[q] = Rs_g[off + i];
    f[q] = fmaxf(f0_g[off + i], 0.f);  // the projection (act = 1 here)
    y[q] = f[q];
    v[q] = cold || !(nrm > 1e-12f) ? flat : v0_g[off + i] / fmaxf(nrm,
                                                                  1e-12f);
  }

  // z = Ad x on the active rows (by active position)
  auto matvec = [&](const float* x, float* z) {
    __syncthreads();  // x written, the previous call's readers done
    {
      const int c = tid % ncol, g = tid / ncol;
      if (c < nv && g < groups) {
        float a = 0.f;
        for (int q = g; q < k; q += groups) a = fmaf(jrow(q)[c], x[q], a);
        part[g * ncol + c] = a;
      }
    }
    __syncthreads();
    if (tid < nv) {
      float t = 0.f;
      for (int g = 0; g < groups; ++g) t += part[g * ncol + tid];
      tv[tid] = t;
    }
    __syncthreads();
    if (tid < nv) {
      float u = 0.f;
      for (int c = 0; c < nv; ++c) u = fmaf(Mi[tid * ldm + c], tv[c], u);
      uv[tid] = u;
    }
    __syncthreads();
    for (int q = tid; q < k; q += kDFThreads) {
      const float* jr = jrow(q);
      float a0 = rs[q] * x[q], a1 = 0.f;
      int c = 0;
      for (; c + 1 < nv; c += 2) {
        a0 = fmaf(jr[c], uv[c], a0);
        a1 = fmaf(jr[c + 1], uv[c + 1], a1);
      }
      if (c < nv) a0 = fmaf(jr[c], uv[c], a0);
      z[q] = a0 + a1;
    }
  };
  auto power_step = [&]() {
    matvec(v, w);
    float s2 = 0.f;
    for (int q = tid; q < k; q += kDFThreads) s2 = fmaf(w[q], w[q], s2);
    const float inv = 1.f / fmaxf(sqrtf(block_sum(s2, red, parity)), 1e-12f);
    for (int q = tid; q < k; q += kDFThreads) v[q] = w[q] * inv;
  };
  auto rayleigh = [&]() -> float {
    matvec(v, w);
    float r = 0.f;
    for (int q = tid; q < k; q += kDFThreads) r = fmaf(v[q], w[q], r);
    return block_sum(r, red, parity);
  };

  // ---- step size from the preconditioned spectral radius -------------
  float L;
  if (cold) {
    for (int s = 0; s < 24; ++s) power_step();
    L = 1.5f * fmaxf(rayleigh(), 1.f);
  } else {
    for (int s = 0; s < 6; ++s) power_step();
    const float r6 = rayleigh();
    for (int s = 0; s < 2; ++s) power_step();
    const float r8 = rayleigh();
    const bool stale = (r8 - r6) > 0.02f * fmaxf(r8, 1e-12f);
    if (stale) {  // block-uniform
      // max_i sum_j |Ad_ij| over the active submatrix: a warp a row i
      float rowabs = 0.f;
      float* P = Pw + warp * ncol;
      for (int qi = warp; qi < k; qi += kDFWarps) {
        const float* ji = jrow(qi);
        for (int c = lane; c < nv; c += 32) {
          float p = 0.f;
          for (int r = 0; r < nv; ++r) p = fmaf(ji[r], Mi[r * ldm + c], p);
          P[c] = p;
        }
        __syncwarp();
        float sum = 0.f;
        for (int qj = lane; qj < k; qj += 32) {
          const float* jj = jrow(qj);
          float a = qj == qi ? rs[qi] : 0.f;
          for (int c = 0; c < nv; ++c) a = fmaf(P[c], jj[c], a);
          sum += fabsf(a);
        }
        rowabs = fmaxf(rowabs, warp_sum(sum));
        __syncwarp();  // P is rewritten for the next row
      }
      L = fmaxf(block_max(rowabs, red), 1.f);
      __syncthreads();  // block_max's slots before the next block_sums
    } else {
      L = 1.5f * fmaxf(r8, 1.f);
    }
  }

  // ---- Nesterov APGD with adaptive restart, per-env exit ------------
  float theta = 1.f;
  const float inv_L = 1.f / L;
  int n_it = 0;
  for (int it = 0; it < iterations; ++it) {
    matvec(y, w);
    float dir = 0.f, d2 = 0.f, n2 = 0.f;
    for (int q = tid; q < k; q += kDFThreads) {
      const float fn = fmaxf(y[q] - (w[q] - rhs[q]) * inv_L, 0.f);
      const float df = fn - f[q];
      dir = fmaf(y[q] - fn, df, dir);
      d2 = fmaf(df, df, d2);
      n2 = fmaf(fn, fn, n2);
      w[q] = fn;
    }
    block_sums(dir, d2, n2, red, parity);
    const float th_new = 0.5f * (1.f + sqrtf(1.f + 4.f * theta * theta));
    const bool restart = dir > 0.f;
    const float beta = restart ? 0.f : (theta - 1.f) / th_new;
    for (int q = tid; q < k; q += kDFThreads) {
      const float fn = w[q];
      y[q] = fn + beta * (fn - f[q]);
      f[q] = fn;
    }
    theta = restart ? 1.f : th_new;
    ++n_it;
    if (d2 <= tol2 * (1e-12f + n2)) break;  // block-uniform
  }
  for (int i = tid; i < nr; i += kDFThreads)
    if (act_b[i] == 0.f) {
      f_out[off + i] = 0.f;
      v_out[off + i] = 0.f;
    }
  for (int q = tid; q < k; q += kDFThreads) {
    f_out[off + idx[q]] = f[q];
    v_out[off + idx[q]] = v[q];
  }
  if (its_out != nullptr && tid == 0) its_out[b] = n_it;
}

template <int NV, bool EXACT>
int launch_warp(const float* J, const float* Minv, const float* Rs,
                const float* diag, const float* rhs, const float* f0,
                const float* v0, const float* active, const float* mu,
                const float* bounds, const int* rowtype, int B, int nr,
                int nv, int bnd_ld, int iterations, int cold, int has_cone,
                float tol2, float* f_out, float* v_out, int* its_out,
                cudaStream_t stream) {
  apgd_factored_warp_kernel<NV, EXACT>
      <<<(B + kWarpEnvs - 1) / kWarpEnvs, 32 * kWarpEnvs, 0, stream>>>(
          J, Minv, Rs, diag, rhs, f0, v0, active, mu, bounds, rowtype, B,
          nr, nv, bnd_ld, iterations, cold, has_cone, tol2, f_out, v_out,
          its_out);
  return (int)cudaGetLastError();
}

template <int MAX_THREADS, int MIN_BLOCKS>
int launch_block(const float* J, const float* Minv, const float* Rs,
                 const float* diag, const float* rhs, const float* f0,
                 const float* v0, const float* active, const float* mu,
                 const float* bounds, const int* rowtype, int B, int nr,
                 int nv, int bnd_ld, int threads, int iterations, int cold,
                 int has_cone, float tol2, float* f_out, float* v_out,
                 int* its_out, cudaStream_t stream) {
  const size_t smem = smem_bytes(nr, nv);
  auto kernel = apgd_factored_block_kernel<MAX_THREADS, MIN_BLOCKS>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (B > 0)
    kernel<<<B, threads, smem, stream>>>(
        J, Minv, Rs, diag, rhs, f0, v0, active, mu, bounds, rowtype, nr, nv,
        bnd_ld, iterations, cold, has_cone, tol2, f_out, v_out, its_out);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory of a block of the block path.
extern "C" size_t apgd_factored_smem_bytes(int nr, int nv) {
  return smem_bytes(nr, nv);
}

// route: 0 the warp path, 1 the block path (ops/apgd_solve.py
// factored_route picks it; a path that does not take the shape is refused).
// bounds: (nr,) shared by the envs with bnd_ld = 0, or (B, nr) per env
// with bnd_ld = nr.
extern "C" int apgd_iterate_factored(
    const float* J, const float* Minv, const float* Rs, const float* diag,
    const float* rhs, const float* f0, const float* v0, const float* active,
    const float* mu, const float* bounds, const int* rowtype, int B, int nr,
    int nv, int route, int bnd_ld, int iterations, int cold, int has_cone,
    float tol2, float* f_out, float* v_out, int* its_out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (nr < 1 || nv < 1 || (bnd_ld != 0 && bnd_ld != nr))
    return (int)cudaErrorInvalidValue;
  if (route == 0) {
    if (nr > 32 * kWarpRows || nv > kWarpMaxNV)
      return (int)cudaErrorInvalidValue;
    if (B <= 0) return 0;
    if (nv == kCheetahNV)
      return launch_warp<kCheetahNV, true>(
          J, Minv, Rs, diag, rhs, f0, v0, active, mu, bounds, rowtype, B, nr,
          nv, bnd_ld, iterations, cold, has_cone, tol2, f_out, v_out,
          its_out, st);
    return launch_warp<kWarpMaxNV, false>(
        J, Minv, Rs, diag, rhs, f0, v0, active, mu, bounds, rowtype, B, nr,
        nv, bnd_ld, iterations, cold, has_cone, tol2, f_out, v_out, its_out,
        st);
  }
  if (route != 1) return (int)cudaErrorInvalidValue;
  const int n = nr > nv ? nr : nv;
  const int threads = n <= 32 ? 32 : ((n + 31) / 32) * 32;
  if (threads > 1024) return (int)cudaErrorInvalidValue;
  if (threads <= kSmallBlock)
    return launch_block<kSmallBlock, 4>(
        J, Minv, Rs, diag, rhs, f0, v0, active, mu, bounds, rowtype, B, nr,
        nv, bnd_ld, threads, iterations, cold, has_cone, tol2, f_out, v_out,
        its_out, st);
  return launch_block<1024, 1>(
      J, Minv, Rs, diag, rhs, f0, v0, active, mu, bounds, rowtype, B, nr,
      nv, bnd_ld, threads, iterations, cold, has_cone, tol2, f_out, v_out,
      its_out, st);
}


// Shared memory of the dense-on-factors block that does not grow with the
// active rows (ops/apgd_solve.py dense_factors_stage_rows reads it).
extern "C" size_t apgd_dense_factors_fixed_bytes(int nv) {
  return sizeof(float) * df_layout(nv).fixed;
}

// The dense iterate on factors, one block per env with the whole of a
// block's shared memory; refused where M^-1 and 7 words a row do not fit
// (the worst case, every row active).
extern "C" int apgd_iterate_dense_factors(
    const float* J, const float* Minv, const float* Rs, const float* rhs,
    const float* f0, const float* v0, const float* active, int B, int nr,
    int nv, int iterations, int cold, float tol2, float* f_out,
    float* v_out, int* its_out, void* stream) {
  constexpr int kMaxShared = 232448;
  if (nr < 1 || nv < 1 || nv > kDFThreads ||
      sizeof(float) * (df_layout(nv).fixed + 7 * (size_t)nr) > kMaxShared)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      apgd_dense_factors_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxShared);
  if (e != cudaSuccess) return (int)e;
  if (B <= 0) return 0;
  apgd_dense_factors_kernel<<<B, kDFThreads, kMaxShared,
                              (cudaStream_t)stream>>>(
      J, Minv, Rs, rhs, f0, v0, active, nr, nv, iterations, cold, tol2,
      kMaxShared / (int)sizeof(float), f_out, v_out, its_out);
  return (int)cudaGetLastError();
}
