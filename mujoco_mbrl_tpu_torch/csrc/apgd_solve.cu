// Batched APGD constraint solve for Hopper (sm_90a).
//
// Replaces the TPU kernel mujoco_mbrl_tpu/ops/apgd_solve.py:_apgd_kernel
// (launched by apgd_iterate_batched). Per env it runs the whole iterate of
// physics/solver.py's _apgd_dispatch.impl: the power-iteration step size
// (24 cold steps, or 6 + 2 warm steps with the Rayleigh staleness guard and
// the inf-norm row-sum fallback; L = 1.5 * max(r, 1)), then Nesterov APGD
// with adaptive restart, projecting onto non-negative, box and friction-cone
// rows (box bounds shared or per env: JAX divides them by each env's row
// scale), a Gauss-Seidel polish on equality rows, and a per-env exit once
// converged (|df|^2 <= tol2 * (1e-12 + |f|^2)) or at the iteration cap.
//
// Design. The kernel is latency-bound: each env is a chain of ~70
// dependent matvecs of nr^2 FMAs (walker: nr 56-62; 10 power steps and up
// to 60 APGD iterations), and the slowest env sets the launch's time, so
// the design shortens each dependent step.
//   nr <= 64 (apgd_warp_kernel<R>, R = 1 for nr <= 32, else 2): one env
//   per warp, two envs per block, row i in lane i % 32, slot i / 32. The
//   env's Ad, zero-padded to 32R x 32R, passes through shared memory once
//   (coalesced from device memory, row stride 32R + 1) into registers: a
//   lane holds its R rows, 64 or 32 floats each. A matvec writes the
//   operand to a per-warp shared vector (__syncwarp, no block barrier),
//   reads it back as float4 broadcasts and runs each row's dot product on
//   four independent accumulators (chains of 8R FMAs instead of nr).
//   Norms and the restart and convergence tests are xor-shuffle warp sums
//   (identical in every lane, so the per-env exit is warp-uniform). The
//   gradient step and the power step's normalisation multiply by a
//   reciprocal taken once (y - g (1 / L), w (1 / |w|); within 1.5 ulp of
//   the divisions): an IEEE division is a branch around a slow path, and a
//   lane's two per step ran in turn, a third of an iteration's latency.
//   The cone projection (apgd_common.cuh project_lanes, shared with the
//   factored kernel's warp path) reads its neighbour rows (i + 1, i + 2;
//   the tangents' normals i - 1, i - 2) with shuffles; the Gauss-Seidel polish
//   of each equality row is a warp dot product of its shared-memory row.
//   nr > 64 while Ad fits in shared memory (apgd_block_kernel, to 238
//   rows; the hopper's 88): one block per env, one thread per row, Ad in
//   shared memory (row stride nr | 1, odd, conflict-free column reads),
//   block reductions and the projection of apgd_common.cuh.
//   Past that, to 1024 rows (apgd_global_kernel; a model with an equality
//   row stays dense at any row count: the manipulator's 452 to 833, the
//   stacker's 641 and 977): one block per env, one thread per row, Ad read
//   from device memory at each matvec. solve_apgd masks Ad to the active
//   rows and columns (exactly zero elsewhere), and an inactive row's force
//   stays 0, so the kernel lists the env's active rows once (a ballot
//   compaction, in row order) and each matvec, row-sum and polish visits
//   only the active submatrix: a warp a row, its lanes gathering the
//   row's active columns (contact triples are contiguous) and a shuffle
//   sum. A contact-rich env has tens of active rows of its hundreds, so
//   the submatrix a matvec reads is kilobytes, which stay in L2.
// All run a real per-env loop that leaves as soon as its env converges
// (the TPU's 128-env lanes, 8-row padding and chunked early exit were
// layout artefacts and are gone); the APGD iterations each env ran go to
// its_out where it is given.
//
// Bound: device memory sees Ad once (B * nr^2 * 4 B, 16 MB at B = 1024);
// the FLOP are ~70 matvecs of 2 nr^2 per env; the serial chain of
// dependent steps keeps the kernel far above both bounds. The global
// path's bound counts the active submatrix each env reads, once.

#include "apgd_common.cuh"

namespace {

using namespace apgd;

__global__ void apgd_block_kernel(const float* __restrict__ Ad_g,
                            const float* __restrict__ rhs_g,
                            const float* __restrict__ f0_g,
                            const float* __restrict__ v0_g,
                            const float* __restrict__ act_g,
                            const float* __restrict__ mu_g,
                            const float* __restrict__ bnd_g,
                            const int* __restrict__ rowtype_g,
                            const int* __restrict__ eq_g, int n_eq, int nr,
                            int ld, int bnd_ld, int iterations, int cold,
                            int has_cone,
                            float tol2, float* __restrict__ f_out,
                            float* __restrict__ v_out,
                            int* __restrict__ its_out) {
  extern __shared__ float sm[];
  float* Ad = sm;                  // nr * ld
  float* xs = Ad + nr * ld;        // matvec operand
  float* ps = xs + nr;             // pre-projection values / polish buffer
  float* ts = ps + nr;             // cone tangent scales
  float* red = ts + nr;            // 2 * kRedSlots reduction slots
  int* types = reinterpret_cast<int*>(red + 2 * kRedSlots);  // row types

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
  const float bnd_i = row ? bnd_g[(size_t)b * bnd_ld + i] : 0.f;
  const int type_i = row ? rowtype_g[i] : 0;
  int parity = 0;
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
    const float n2 = block_sum(w * w, red, parity);
    return w / fmaxf(sqrtf(n2), 1e-12f);
  };

  // ---- step size from the preconditioned spectral radius -------------
  const float flat = row ? 1.f / sqrtf((float)nr) : 0.f;
  float v, L;
  if (cold) {
    v = flat;
    for (int k = 0; k < 24; ++k) v = power_step(v);
    const float mv = matvec(v);
    const float r = block_sum(v * mv, red, parity);
    L = 1.5f * fmaxf(r, 1.f);
  } else {
    const float v0 = row ? v0_g[off + i] : 0.f;
    const float nrm = sqrtf(block_sum(v0 * v0, red, parity));
    v = nrm > 1e-12f ? v0 / fmaxf(nrm, 1e-12f) : flat;
    for (int k = 0; k < 6; ++k) v = power_step(v);
    float mv = matvec(v);
    const float r6 = block_sum(v * mv, red, parity);
    for (int k = 0; k < 2; ++k) v = power_step(v);
    mv = matvec(v);
    const float r8 = block_sum(v * mv, red, parity);
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
  int n_it = 0;
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

// One block per env, one thread per row, Ad in device memory: each matvec
// reads the active submatrix (see the header). Requires Ad zero in every
// inactive row and column, as solve_apgd masks it.
__global__ void __launch_bounds__(1024)
    apgd_global_kernel(const float* __restrict__ Ad_g,
                       const float* __restrict__ rhs_g,
                       const float* __restrict__ f0_g,
                       const float* __restrict__ v0_g,
                       const float* __restrict__ act_g,
                       const float* __restrict__ mu_g,
                       const float* __restrict__ bnd_g,
                       const int* __restrict__ rowtype_g,
                       const int* __restrict__ eq_g, int n_eq, int nr,
                       int bnd_ld, int iterations, int cold, int has_cone,
                       float tol2, float* __restrict__ f_out,
                       float* __restrict__ v_out, int* __restrict__ its_out) {
  extern __shared__ float sm[];
  float* xs = sm;                  // matvec operand, by active position
  float* ws = xs + nr;             // matvec result, by active position
  float* ps = ws + nr;             // pre-projection values / polish buffer
  float* ts = ps + nr;             // cone tangent scales
  float* red = ts + nr;            // 2 * kRedSlots reduction slots
  int* types = reinterpret_cast<int*>(red + 2 * kRedSlots);  // row types
  int* idx = types + nr;           // the active rows, ascending
  int* cnt = idx + nr;             // active rows of each warp

  const int b = blockIdx.x;
  const int i = threadIdx.x, lane = i & 31, warp = i >> 5;
  const int nw = blockDim.x >> 5;
  const bool row = i < nr;
  const size_t off = (size_t)b * nr;
  const float* Adb = Ad_g + (size_t)b * nr * nr;
  for (int k = threadIdx.x; k < nr; k += blockDim.x) types[k] = rowtype_g[k];
  const float rhs_i = row ? rhs_g[off + i] : 0.f;
  const float act_i = row ? act_g[off + i] : 0.f;
  const float mu_i = row ? mu_g[i] : 0.f;
  const float bnd_i = row ? bnd_g[(size_t)b * bnd_ld + i] : 0.f;
  const int type_i = row ? rowtype_g[i] : 0;
  int parity = 0;

  // ---- the active rows, compacted in row order -----------------------
  const bool live = row && act_i != 0.f;
  const unsigned ballot = __ballot_sync(kFull, live);
  if (lane == 0) cnt[warp] = __popc(ballot);
  __syncthreads();
  int pos = __popc(ballot & ((1u << lane) - 1u)), na = 0;
  for (int w = 0; w < nw; ++w) {
    if (w < warp) pos += cnt[w];
    na += cnt[w];
  }
  if (live) idx[pos] = i;
  __syncthreads();

  // (Ad x)_i for the block-wide vector whose row-i entry is x_i: a warp
  // an active row, its lanes over the active columns
  auto matvec = [&](float x_i) -> float {
    __syncthreads();
    if (live) xs[pos] = x_i;
    __syncthreads();
    for (int q = warp; q < na; q += nw) {
      const float* a = Adb + (size_t)idx[q] * nr;
      float acc = 0.f;
      for (int k = lane; k < na; k += 32)
        acc = fmaf(__ldg(a + idx[k]), xs[k], acc);
      acc = warp_sum(acc);
      if (lane == 0) ws[q] = acc;
    }
    __syncthreads();
    return live ? ws[pos] : 0.f;
  };
  auto power_step = [&](float v) -> float {
    const float w = matvec(v);
    const float n2 = block_sum(w * w, red, parity);
    return w / fmaxf(sqrtf(n2), 1e-12f);
  };

  // ---- step size from the preconditioned spectral radius -------------
  const float flat = row ? 1.f / sqrtf((float)nr) : 0.f;
  float v, L;
  if (cold) {
    v = flat;
    for (int k = 0; k < 24; ++k) v = power_step(v);
    const float mv = matvec(v);
    const float r = block_sum(v * mv, red, parity);
    L = 1.5f * fmaxf(r, 1.f);
  } else {
    const float v0 = row ? v0_g[off + i] : 0.f;
    const float nrm = sqrtf(block_sum(v0 * v0, red, parity));
    v = nrm > 1e-12f ? v0 / fmaxf(nrm, 1e-12f) : flat;
    for (int k = 0; k < 6; ++k) v = power_step(v);
    float mv = matvec(v);
    const float r6 = block_sum(v * mv, red, parity);
    for (int k = 0; k < 2; ++k) v = power_step(v);
    mv = matvec(v);
    const float r8 = block_sum(v * mv, red, parity);
    float rowabs = 0.f;
    for (int q = warp; q < na; q += nw) {
      const float* a = Adb + (size_t)idx[q] * nr;
      float sum = 0.f;
      for (int k = lane; k < na; k += 32) sum += fabsf(__ldg(a + idx[k]));
      rowabs = fmaxf(rowabs, warp_sum(sum));
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
  int n_it = 0;
  for (int it = 0; it < iterations; ++it) {
    const float g = matvec(y) - rhs_i;
    float fn = proj(y - g / L);
    if (n_eq) {
      // exact Gauss-Seidel update of each equality row, in order, masked
      // by the row's `active` entry (an inactive row's force is 0)
      __syncthreads();
      if (row) ps[i] = fn;
      __syncthreads();
      for (int q = 0; q < n_eq; ++q) {
        const int e = eq_g[q];
        if (warp == 0) {
          const float* a = Adb + (size_t)e * nr;
          float r = 0.f;
          for (int k = lane; k < na; k += 32)
            r = fmaf(__ldg(a + idx[k]), ps[idx[k]], r);
          r = warp_sum(r);
          if (lane == 0)
            ps[e] = ps[e] - act_g[off + e] * (r - rhs_g[off + e]);
        }
        __syncthreads();
      }
      if (row) fn = ps[i];
    }
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

constexpr int kWarpEnvs = 2;  // envs (warps) per block of the warp kernel

// Shared floats of one warp: Ad zero-padded to NC x (NC + 1), then the
// matvec operand (NC floats, 16-byte aligned)
template <int R>
__host__ __device__ constexpr int warp_floats() {
  return 32 * R * (32 * R + 1) + 32 * R;
}

template <int R>
__global__ void __launch_bounds__(32 * kWarpEnvs)
    apgd_warp_kernel(const float* __restrict__ Ad_g,
                     const float* __restrict__ rhs_g,
                     const float* __restrict__ f0_g,
                     const float* __restrict__ v0_g,
                     const float* __restrict__ act_g,
                     const float* __restrict__ mu_g,
                     const float* __restrict__ bnd_g,
                     const int* __restrict__ rowtype_g,
                     const int* __restrict__ eq_g, int n_eq, int B, int nr,
                     int bnd_ld, int iterations, int cold, int has_cone,
                     float tol2,
                     float* __restrict__ f_out, float* __restrict__ v_out,
                     int* __restrict__ its_out) {
  constexpr int NC = 32 * R, LD = NC + 1;
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarpEnvs + w;
  if (b >= B) return;  // the warp's env; no block barrier below
  float* As = sm + w * warp_floats<R>();
  float* ys = As + NC * LD;

  // ---- Ad: device memory -> shared (zero-padded) -> registers ---------
  const float* Adb = Ad_g + (size_t)b * nr * nr;
  for (int k = lane; k < NC * NC; k += 32) {
    const int r = k / NC, c = k % NC;
    As[r * LD + c] = r < nr && c < nr ? Adb[r * nr + c] : 0.f;
  }
  __syncwarp();
  float a[R][NC];
#pragma unroll
  for (int s = 0; s < R; ++s)
#pragma unroll
    for (int j = 0; j < NC; ++j) a[s][j] = As[(lane + 32 * s) * LD + j];

  // ---- this lane's rows i = lane + 32 s ------------------------------
  const size_t off = (size_t)b * nr;
  bool valid[R];
  float rhs[R];
  LaneRows<R> rows;
  load_lane_rows<R>(rows, lane, nr, act_g + off, mu_g,
                    bnd_g + (size_t)b * bnd_ld, rowtype_g);
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int i = lane + 32 * s;
    valid[s] = i < nr;
    rhs[s] = valid[s] ? rhs_g[off + i] : 0.f;
  }

  // out = Ad x (rows of this lane)
  auto matvec = [&](const float (&x)[R], float (&out)[R]) {
    __syncwarp();  // the previous operand's readers are done
#pragma unroll
    for (int s = 0; s < R; ++s) ys[lane + 32 * s] = x[s];
    __syncwarp();
    float acc[R][4];
#pragma unroll
    for (int s = 0; s < R; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[s][q] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; j += 4) {
      const float4 y4 = *reinterpret_cast<const float4*>(ys + j);
#pragma unroll
      for (int s = 0; s < R; ++s) {
        acc[s][0] = fmaf(a[s][j], y4.x, acc[s][0]);
        acc[s][1] = fmaf(a[s][j + 1], y4.y, acc[s][1]);
        acc[s][2] = fmaf(a[s][j + 2], y4.z, acc[s][2]);
        acc[s][3] = fmaf(a[s][j + 3], y4.w, acc[s][3]);
      }
    }
#pragma unroll
    for (int s = 0; s < R; ++s)
      out[s] = (acc[s][0] + acc[s][1]) + (acc[s][2] + acc[s][3]);
  };
  // x' y over the env (every lane receives it)
  auto dot = [&](const float (&x)[R], const float (&y)[R]) -> float {
    float d = 0.f;
#pragma unroll
    for (int s = 0; s < R; ++s) d = fmaf(x[s], y[s], d);
    return warp_sum(d);
  };
  auto power_step = [&](float (&v)[R]) {
    float wv[R];
    matvec(v, wv);
    const float inv = 1.f / fmaxf(sqrtf(dot(wv, wv)), 1e-12f);
#pragma unroll
    for (int s = 0; s < R; ++s) v[s] = wv[s] * inv;
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
    float rowabs = 0.f;
#pragma unroll
    for (int s = 0; s < R; ++s) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) sum += fabsf(a[s][j]);
      rowabs = fmaxf(rowabs, sum);
    }
    const float safe_L = fmaxf(warp_max(rowabs), 1.f);
    const bool stale = (r8 - r6) > 0.02f * fmaxf(r8, 1e-12f);
    L = stale ? safe_L : 1.5f * fmaxf(r8, 1.f);
  }

  // ---- projection: non-negative, then box, then friction cone, then
  // the active mask (apgd_common.cuh project_lanes) ---------------------
  auto proj = [&](float (&x)[R]) {
    project_lanes<R>(x, rows, lane, nr, has_cone);
  };

  // ---- Nesterov APGD with adaptive restart, per-env exit ------------
  float f[R], y[R];
#pragma unroll
  for (int s = 0; s < R; ++s)
    f[s] = valid[s] ? f0_g[off + lane + 32 * s] : 0.f;
  proj(f);
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
    proj(fn);
    // exact Gauss-Seidel update of each equality row, in order, masked by
    // the row's `active` entry
    for (int q = 0; q < n_eq; ++q) {
      const int e = eq_g[q];
      float part = 0.f;
#pragma unroll
      for (int s = 0; s < R; ++s)
        part = fmaf(As[e * LD + lane + 32 * s], fn[s], part);
      const float r = warp_sum(part);
#pragma unroll
      for (int s = 0; s < R; ++s)
        if (lane + 32 * s == e) fn[s] = fn[s] - rows.act[s] * (r - rhs[s]);
    }
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

template <int R>
int launch_warp(const float* Ad, const float* rhs, const float* f0,
                const float* v0, const float* active, const float* mu,
                const float* bounds, const int* rowtype, const int* eq_rows,
                int n_eq, int B, int nr, int bnd_ld, int iterations, int cold,
                int has_cone, float tol2, float* f_out, float* v_out,
                int* its_out, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kWarpEnvs * warp_floats<R>();
  apgd_warp_kernel<R><<<(B + kWarpEnvs - 1) / kWarpEnvs, 32 * kWarpEnvs,
                        smem, stream>>>(
      Ad, rhs, f0, v0, active, mu, bounds, rowtype, eq_rows, n_eq, B, nr,
      bnd_ld, iterations, cold, has_cone, tol2, f_out, v_out, its_out);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory of the block path's block (Ad, its operand and buffers).
extern "C" size_t apgd_smem_bytes(int nr) {
  const int ld = nr | 1;
  return sizeof(float) * ((size_t)nr * ld + 3 * nr + 2 * apgd::kRedSlots) +
         sizeof(int) * nr;
}

// Shared memory of the global path's block.
static size_t global_smem_bytes(int nr) {
  return sizeof(float) * (4 * (size_t)nr + 2 * apgd::kRedSlots) +
         sizeof(int) * (2 * (size_t)nr + 32);
}

// path: 0 one env per warp (nr <= 64), 1 one block per env with Ad in
// shared memory, 2 one block per env with Ad in device memory (nr <=
// 1024), as ops/apgd_solve.py dense_route picks it; a path that does not
// take nr is refused. bounds holds the box rows' bounds: (nr,) shared by
// the envs with bnd_ld = 0, or (B, nr) per env with bnd_ld = nr.
extern "C" int apgd_iterate_batched(
    const float* Ad, const float* rhs, const float* f0, const float* v0,
    const float* active, const float* mu, const float* bounds,
    const int* rowtype, const int* eq_rows, int n_eq, int B, int nr,
    int path, int bnd_ld, int iterations, int cold, int has_cone,
    float tol2, float* f_out, float* v_out, int* its_out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (nr <= 0 || nr > 1024 || (path == 0) != (nr <= 64) || path < 0 ||
      path > 2)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  if (path == 0)
    return nr <= 32
               ? launch_warp<1>(Ad, rhs, f0, v0, active, mu, bounds, rowtype,
                                eq_rows, n_eq, B, nr, bnd_ld, iterations,
                                cold, has_cone, tol2, f_out, v_out, its_out,
                                st)
               : launch_warp<2>(Ad, rhs, f0, v0, active, mu, bounds, rowtype,
                                eq_rows, n_eq, B, nr, bnd_ld, iterations,
                                cold, has_cone, tol2, f_out, v_out, its_out,
                                st);
  const int threads = ((nr + 31) / 32) * 32;
  if (path == 2) {
    apgd_global_kernel<<<B, threads, global_smem_bytes(nr), st>>>(
        Ad, rhs, f0, v0, active, mu, bounds, rowtype, eq_rows, n_eq, nr,
        bnd_ld, iterations, cold, has_cone, tol2, f_out, v_out, its_out);
    return (int)cudaGetLastError();
  }
  const size_t smem = apgd_smem_bytes(nr);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        apgd_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  apgd_block_kernel<<<B, threads, smem, st>>>(
      Ad, rhs, f0, v0, active, mu, bounds, rowtype, eq_rows, n_eq, nr,
      nr | 1, bnd_ld, iterations, cold, has_cone, tol2, f_out, v_out,
      its_out);
  return (int)cudaGetLastError();
}
