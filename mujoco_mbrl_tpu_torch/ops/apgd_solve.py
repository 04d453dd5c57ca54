"""Batched APGD constraint-solve iterates: CUDA kernels and plain versions.

``apgd_iterate_batched`` replaces the TPU kernel
mujoco_mbrl_tpu/ops/apgd_solve.py:_apgd_kernel. For CUDA tensors it
launches ``csrc/apgd_solve.cu`` on the path ``dense_route`` picks by
shared-memory need: one warp per env up to 64 rows with Ad in registers,
one thread block per env with Ad in shared memory while it fits (238
rows), then one block per env reading the active submatrix of Ad from
device memory (to 1024 rows: the manipulator's and stacker's dense
solves, kept dense by their equality row); a real per-env early exit; box
bounds shared (nr,) or per env (B, nr), as JAX's vmapped iterate takes
them once each env's row scale divides them, finger's friction-loss row.
It raises on inputs the kernel does not take; for CPU tensors it runs
``apgd_iterate_plain``, the batched PyTorch form of physics/solver.py's
``_apgd_dispatch.impl``.

``apgd_iterate_factored`` replaces ``_apgd_factored_kernel``, the regime
past 96 rows where Ad = J~ M^-1 J~' + diag(Rs) is never materialized,
with box bounds shared (nr,) or per env (B, nr). For
CUDA tensors it launches ``csrc/apgd_factored.cu`` on the path that
``factored_route`` picks: up to 160 rows and nv 16 (the cheetah's 146 x
9) one env per warp, the lane's rows of J~ and of P = J~ M^-1 in
registers, so a matvec is a reduce-scatter of J~' y and P t with no
barrier; past that, up to 1024 rows (the humanoid's 303 x 27), one block
per env with J~ and M^-1 in shared memory, two barriers a matvec. Each
env is a chain of ~85 dependent matvecs, so the kernel is latency-bound
far above its bytes and FP32 bound. For CPU tensors it runs
``apgd_iterate_factored_plain``, the plain iterate with the trace
staleness bound on Ad applied in its factors and in float64.

``apgd_iterate_dense_factors`` takes what JAX keeps dense past the 1024
rows that ``apgd_iterate_batched``'s one-thread-a-row paths take
(humanoid_cmu's 4,352 x 62, where a (B, nr, nr) Ad would be 76 MB an
env): it runs the dense iterate of ``_apgd_dispatch.impl``, with its
row-sum staleness bound, on Ad = J~ M^-1 J~' + diag(Rs) applied through
its factors and never formed. For CUDA tensors it launches
``csrc/apgd_factored.cu``'s ``apgd_dense_factors_kernel`` (one block per
env over its active rows, J~'s active rows staged in shared memory as far
as they fit); for CPU tensors it runs
``apgd_iterate_dense_factors_plain``. There is no fallback from a kernel
to its plain version.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from . import _build, launch_counts

# shared memory a block may use on Hopper (bytes)
MAX_SHARED_BYTES = 232448
# the factored kernel's paths (csrc/apgd_factored.cu): one env per warp
# with 5 rows a lane, then one block per env with a thread a row
FACTORED_WARP_MAX_NR, FACTORED_WARP_MAX_NV = 160, 16
FACTORED_MAX_NR = 1024
# the dense kernel's paths (csrc/apgd_solve.cu): one env per warp, then
# one block per env with Ad in shared memory, then with Ad in device memory
DENSE_WARP_MAX_NR, DENSE_MAX_NR = 64, 1024
DENSE_PATHS = ('warp', 'block', 'global')
# the dense iterate on factors (csrc/apgd_factored.cu): a block of 512
# threads per env, any row count whose vectors fit in shared memory
DENSE_FACTORS_THREADS = 512
_RED_SLOTS = 96             # apgd_common.cuh kRedSlots
_NONNEG, _BOX, _CONE = 1, 2, 4
_SIGNATURES = {
    'apgd_smem_bytes': (ctypes.c_size_t, [ctypes.c_int]),
    'apgd_iterate_batched': (ctypes.c_int, [ctypes.c_void_p] * 9
                             + [ctypes.c_int] * 8 + [ctypes.c_float]
                             + [ctypes.c_void_p] * 4),
}


def block_smem_bytes(nr: int) -> int:
    """Shared memory of the dense block path's block at nr rows: Ad at row
    stride nr | 1, three nr-float buffers, the reduction slots and the row
    types (``apgd_smem_bytes`` in csrc/apgd_solve.cu)."""
    return 4 * (nr * (nr | 1) + 3 * nr + 2 * _RED_SLOTS) + 4 * nr


def dense_route(nr: int) -> str:
    """The path of the dense kernel that takes an nr-row solve: 'warp'
    (one env per warp) up to 64 rows, 'block' (one block per env, Ad in
    shared memory) while ``block_smem_bytes(nr)`` fits in a block's
    shared memory (to 238 rows), else 'global' (one block per env, Ad read
    from device memory) up to 1024 rows, a thread a row."""
    if nr > DENSE_MAX_NR:
        raise ValueError(f'apgd_iterate_batched: nr={nr} is past the '
                         f'{DENSE_MAX_NR} rows a block takes (a thread a '
                         'row)')
    if nr <= DENSE_WARP_MAX_NR:
        return 'warp'
    return 'block' if block_smem_bytes(nr) <= MAX_SHARED_BYTES else 'global'

_FACTORED_SIGNATURES = {
    'apgd_factored_smem_bytes': (ctypes.c_size_t, [ctypes.c_int] * 2),
    'apgd_iterate_factored': (ctypes.c_int, [ctypes.c_void_p] * 11
                              + [ctypes.c_int] * 8 + [ctypes.c_float]
                              + [ctypes.c_void_p] * 4),
    'apgd_dense_factors_fixed_bytes': (ctypes.c_size_t, [ctypes.c_int]),
    'apgd_iterate_dense_factors': (ctypes.c_int, [ctypes.c_void_p] * 7
                                   + [ctypes.c_int] * 5 + [ctypes.c_float]
                                   + [ctypes.c_void_p] * 4),
}


def _masks(nr: int, nonneg, box_rows, con0, device):
    r = np.arange(nr)
    m = lambda rows: torch.as_tensor(np.isin(r, np.asarray(rows, np.int64)),
                                     device=device)
    return m(nonneg), m(box_rows), m(con0), m(np.asarray(con0) + 1), m(
        np.asarray(con0) + 2)


def apgd_iterate_plain(Ad, rhs, f0, v0, active, mu_full, bounds_full, *,
                       nonneg, box_rows, con0, iterations: int, cold: bool,
                       tol2: float = 1e-12, eq_rows: tuple = (),
                       return_iterations: bool = False):
    """Plain PyTorch iterate over the env batch (leading dim B).

    Same contract as the JAX ``apgd_iterate_batched``: Ad (B, nr, nr),
    rhs / f0 (scaled warm start) / v0 (power vector) / active (B, nr),
    mu_full (nr,), bounds_full (nr,) or, per env as JAX's vmapped iterate
    takes them, (B, nr). Returns (f, v), each (B, nr), and with
    ``return_iterations`` also the APGD iterations each env ran (B,).
    The warm staleness fallback is Ad's largest absolute row sum.
    """
    return _iterate(lambda x: (Ad @ x[..., None])[..., 0],
                    lambda: Ad.abs().sum(2).max(1).values, Ad, rhs,
                    f0, v0, active, mu_full, bounds_full, nonneg=nonneg,
                    box_rows=box_rows, con0=con0, iterations=iterations,
                    cold=cold, tol2=tol2, eq_rows=eq_rows,
                    return_iterations=return_iterations)


def _power(matvec, v):
    w = matvec(v)
    nrm = torch.linalg.vector_norm(w, dim=1, keepdim=True)
    return w / torch.clamp(nrm, min=1e-12)


def _warm_guard(matvec, v0):
    """The warm power start and its Rayleigh guard: v0 normalised over all
    its rows (the flat start 1/sqrt(nr) where it is 0), 6 power steps and
    the Rayleigh quotient r6, 2 more and r8. Returns (v, r8, stale), stale
    (B,) where r8 - r6 > 0.02 r8: the start was not near the top
    eigenvector, so the staleness bound replaces 1.5 r8."""
    nr = v0.shape[1]
    nrm = torch.linalg.vector_norm(v0, dim=1, keepdim=True)
    v = torch.where(nrm > 1e-12, v0 / torch.clamp(nrm, min=1e-12),
                    torch.full_like(v0, 1.0 / nr ** 0.5))
    for _ in range(6):
        v = _power(matvec, v)
    r6 = (v * matvec(v)).sum(1)
    for _ in range(2):
        v = _power(matvec, v)
    r8 = (v * matvec(v)).sum(1)
    return v, r8, (r8 - r6) > 0.02 * torch.clamp(r8, min=1e-12)


def _iterate(matvec, safe_l, Ad, rhs, f0, v0, active, mu_full, bounds_full,
             *, nonneg, box_rows, con0, iterations, cold, tol2, eq_rows,
             return_iterations):
    """The plain iterate on the operator ``matvec`` (x (B, nr) -> Ad x),
    with ``safe_l()`` (B,) the warm staleness fallback before its clamp at
    1; ``Ad`` is read only by the equality polish of ``eq_rows``."""
    B, nr = rhs.shape
    dt = rhs.dtype
    if cold:
        v = torch.full((B, nr), 1.0 / nr ** 0.5, dtype=dt,
                       device=rhs.device)
        for _ in range(24):
            v = _power(matvec, v)
        L = 1.5 * torch.clamp((v * matvec(v)).sum(1), min=1.0)
    else:
        v, r8, stale = _warm_guard(matvec, v0)
        safe_L = torch.clamp(safe_l(), min=1.0)
        L = torch.where(stale, safe_L, 1.5 * torch.clamp(r8, min=1.0))
    L = L[:, None]

    m_nonneg, m_box, m_n, m_t1, m_t2 = _masks(nr, nonneg, box_rows, con0,
                                              rhs.device)

    def proj(f):
        f = torch.where(m_nonneg, torch.clamp(f, min=0.0), f)
        f = torch.where(m_box, torch.minimum(torch.maximum(
            f, -bounds_full), bounds_full), f)
        if len(con0):
            ft1 = torch.roll(f, -1, dims=1)
            ft2 = torch.roll(f, -2, dims=1)
            t = torch.sqrt(ft1 * ft1 + ft2 * ft2)
            inside = t <= mu_full * f
            apex = mu_full * t + f <= 0.0
            fn_s = torch.where(inside, f, torch.where(
                apex, 0.0, (f + mu_full * t) / (1.0 + mu_full * mu_full)))
            tscale = torch.where(inside, 1.0, torch.where(
                apex, 0.0, mu_full * fn_s / torch.clamp(t, min=1e-12)))
            tscale = torch.where(m_n, tscale, 1.0)
            f = torch.where(m_n, fn_s, f)
            f = f * torch.where(m_t1, torch.roll(tscale, 1, dims=1), 1.0)
            f = f * torch.where(m_t2, torch.roll(tscale, 2, dims=1), 1.0)
        return f * active

    f = proj(f0)
    y = f
    theta = torch.ones((B,), dtype=dt, device=rhs.device)
    done = torch.zeros((B,), dtype=torch.bool, device=rhs.device)
    its = torch.zeros((B,), dtype=torch.int64, device=rhs.device)
    for _ in range(iterations):
        if bool(done.all()):
            break
        g = matvec(y) - rhs
        f_new = proj(y - g / L)
        for e in eq_rows:
            resid = (Ad[:, e] * f_new).sum(1) - rhs[:, e]
            f_new = f_new.clone()
            f_new[:, e] = f_new[:, e] - active[:, e] * resid
        theta_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * theta * theta))
        restart = ((y - f_new) * (f_new - f)).sum(1) > 0.0
        beta = torch.where(restart, 0.0, (theta - 1.0) / theta_new)
        y_new = f_new + beta[:, None] * (f_new - f)
        d2 = ((f_new - f) ** 2).sum(1)
        conv = d2 <= tol2 * (1e-12 + (f_new * f_new).sum(1))
        live = ~done
        its = its + live
        f = torch.where(live[:, None], f_new, f)
        y = torch.where(live[:, None], y_new, y)
        theta = torch.where(live, torch.where(restart, 1.0, theta_new), theta)
        done = done | conv
    return (f, v, its) if return_iterations else (f, v)


_ROW_TABLES: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _row_tables(nr, nonneg, box_rows, con0, eq_rows, device):
    key = (nr, nonneg, box_rows, con0, eq_rows, str(device))
    if key not in _ROW_TABLES:
        types = np.zeros(nr, np.int32)
        types[list(nonneg)] |= _NONNEG
        types[list(box_rows)] |= _BOX
        types[list(con0)] |= _CONE
        eq = np.asarray(eq_rows if eq_rows else [0], np.int32)
        _ROW_TABLES[key] = (torch.as_tensor(types, device=device),
                            torch.as_tensor(eq, device=device))
    return _ROW_TABLES[key]


def apgd_iterate_batched(Ad, rhs, f0, v0, active, mu_full, bounds_full, *,
                         nonneg, box_rows, con0, iterations: int, cold: bool,
                         tol2: float = 1e-12, eq_rows: tuple = (),
                         return_iterations: bool = False):
    """Batched APGD iterate (contract of the JAX ``apgd_iterate_batched``).
    Returns (f, v), and with ``return_iterations`` also the APGD
    iterations each env ran (B,), as the plain version does.

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream (no synchronisation, outputs allocated here), on
    the path ``dense_route`` picks. The global path reads only the active
    rows and columns of Ad: it takes Ad zero in every inactive row and
    column, as ``physics.solver.solve_apgd`` masks it.
    """
    if not Ad.is_cuda:
        return apgd_iterate_plain(
            Ad, rhs, f0, v0, active, mu_full, bounds_full, nonneg=nonneg,
            box_rows=box_rows, con0=con0, iterations=iterations, cold=cold,
            tol2=tol2, eq_rows=eq_rows, return_iterations=return_iterations)
    B, nr = rhs.shape
    tensors = (Ad, rhs, f0, v0, active, mu_full, bounds_full)
    for t in tensors:
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError('apgd_iterate_batched kernel takes contiguous '
                             'float32 CUDA tensors')
    if Ad.shape != (B, nr, nr) or mu_full.shape != (nr,) or \
            bounds_full.shape not in ((nr,), (B, nr)) or any(
                t.shape != (B, nr) for t in (f0, v0, active)):
        raise ValueError('apgd_iterate_batched: inconsistent shapes')
    path = DENSE_PATHS.index(dense_route(nr))
    lib = _build.library('apgd_solve', _SIGNATURES)
    types, eq = _row_tables(nr, tuple(nonneg), tuple(box_rows), tuple(con0),
                            tuple(eq_rows), Ad.device)
    f = torch.empty_like(rhs)
    v = torch.empty_like(rhs)
    its = (torch.empty((B,), dtype=torch.int32, device=rhs.device)
           if return_iterations else None)
    rc = lib.apgd_iterate_batched(
        Ad.data_ptr(), rhs.data_ptr(), f0.data_ptr(), v0.data_ptr(),
        active.data_ptr(), mu_full.data_ptr(), bounds_full.data_ptr(),
        types.data_ptr(), eq.data_ptr(), len(eq_rows), B, nr, path,
        nr if bounds_full.dim() == 2 else 0, int(iterations),
        int(bool(cold)), int(bool(len(con0))),
        float(tol2), f.data_ptr(), v.data_ptr(),
        its.data_ptr() if its is not None else 0,
        torch.cuda.current_stream(Ad.device).cuda_stream)
    _build.check(rc, 'apgd_iterate_batched')
    launch_counts['apgd_solve'] += 1
    return (f, v, its) if return_iterations else (f, v)


def apgd_iterate_factored_plain(J_s, Minv, Rs, diag_s, rhs, f0, v0, active,
                                mu_full, bounds_full, *, nonneg, box_rows,
                                con0, iterations: int, cold: bool,
                                tol2: float = 1e-12,
                                return_iterations: bool = False):
    """Plain factored iterate: the batched form of physics/solver.py's
    ``_apgd_dispatch_factored.impl_f`` (``apgd_iterate_plain`` with the
    trace staleness bound), the operator Ad = J~ M^-1 J~' + diag(Rs)
    applied in its factors and in float64, its result rounded to the
    iterate's dtype. In float32 that operator's rounding, with Ad formed
    as ``impl_f`` forms it or factored, takes some of the humanoid's
    unconverged envs (303 rows over 27 dofs, forces up to 1e4) beyond
    rtol = atol = 2e-4 of the float64 iterate, where the kernel's float32
    tree sums keep them within it. The trace is that of the factors;
    ``diag_s`` (the kernel's trace input) is not read, as ``impl_f`` does
    not read it."""
    J64 = J_s.double()
    JMinv = J64 @ Minv.double()
    R64 = Rs.double()

    def matvec(x):
        ax = (JMinv @ (J64.transpose(1, 2) @ x.double()[..., None]))[..., 0]
        return (ax + R64 * x).to(x.dtype)

    trace = lambda: ((JMinv * J64).sum((1, 2)) + R64.sum(1)).to(rhs.dtype)
    return _iterate(matvec, trace, None, rhs, f0, v0, active, mu_full,
                    bounds_full, nonneg=nonneg, box_rows=box_rows, con0=con0,
                    iterations=iterations, cold=cold, tol2=tol2, eq_rows=(),
                    return_iterations=return_iterations)


def factored_route(nr: int, nv: int) -> str:
    """The path of the factored kernel that takes an (nr, nv) solve:
    'warp' (one env per warp) up to 160 rows and nv 16, else 'block' (one
    block per env) up to 1024 rows. Past 1024 rows no path takes it."""
    if nr > FACTORED_MAX_NR:
        raise ValueError(f'apgd_iterate_factored: nr={nr} is past the '
                         f'{FACTORED_MAX_NR} rows a block takes (a thread '
                         'a row, J~ in shared memory)')
    if nr <= FACTORED_WARP_MAX_NR and nv <= FACTORED_WARP_MAX_NV:
        return 'warp'
    return 'block'


def apgd_iterate_factored(J_s, Minv, Rs, diag_s, rhs, f0, v0, active,
                          mu_full, bounds_full, *, nonneg, box_rows, con0,
                          iterations: int, cold: bool, tol2: float = 1e-12,
                          return_iterations: bool = False):
    """Batched factored APGD iterate (contract of the JAX
    ``apgd_iterate_factored``): J_s (B, nr, nv) scaled and active-masked
    Jacobian, Minv (B, nv, nv), Rs / diag_s / rhs / f0 / v0 / active
    (B, nr), mu_full (nr,), bounds_full (nr,) or, per env as JAX's
    vmapped iterate takes them once each env's row scale divides them
    (friction-loss rows), (B, nr). Returns (f, v), each (B, nr),
    and with ``return_iterations`` also the APGD iterations each env ran
    (B,), as the plain version does.

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream (no synchronisation, outputs allocated here), on
    the path ``factored_route`` picks. The kernel has no equality polish,
    as the JAX kernel has none.
    """
    if not J_s.is_cuda:
        return apgd_iterate_factored_plain(
            J_s, Minv, Rs, diag_s, rhs, f0, v0, active, mu_full, bounds_full,
            nonneg=nonneg, box_rows=box_rows, con0=con0,
            iterations=iterations, cold=cold, tol2=tol2,
            return_iterations=return_iterations)
    B, nr, nv = J_s.shape
    tensors = (J_s, Minv, Rs, diag_s, rhs, f0, v0, active, mu_full,
               bounds_full)
    for t in tensors:
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError('apgd_iterate_factored kernel takes contiguous '
                             'float32 CUDA tensors')
    if Minv.shape != (B, nv, nv) or mu_full.shape != (nr,) or \
            bounds_full.shape not in ((nr,), (B, nr)) or any(
                t.shape != (B, nr) for t in tensors[2:8]):
        raise ValueError('apgd_iterate_factored: inconsistent shapes')
    route = factored_route(nr, nv)
    lib = _build.library('apgd_factored', _FACTORED_SIGNATURES)
    if route == 'block' and \
            lib.apgd_factored_smem_bytes(nr, nv) > MAX_SHARED_BYTES:
        raise ValueError(f'apgd_iterate_factored: nr={nr}, nv={nv} does not '
                         'fit in shared memory')
    types, _ = _row_tables(nr, tuple(nonneg), tuple(box_rows), tuple(con0),
                           (), J_s.device)
    f = torch.empty_like(rhs)
    v = torch.empty_like(rhs)
    its = (torch.empty((B,), dtype=torch.int32, device=rhs.device)
           if return_iterations else None)
    rc = lib.apgd_iterate_factored(
        *(t.data_ptr() for t in tensors), types.data_ptr(), B, nr, nv,
        ('warp', 'block').index(route), nr if bounds_full.dim() == 2 else 0,
        int(iterations), int(bool(cold)),
        int(bool(len(con0))), float(tol2), f.data_ptr(), v.data_ptr(),
        its.data_ptr() if its is not None else 0,
        torch.cuda.current_stream(J_s.device).cuda_stream)
    _build.check(rc, 'apgd_iterate_factored')
    launch_counts['apgd_factored'] += 1
    return (f, v, its) if return_iterations else (f, v)


def _dense_factors_fixed_bytes(nv: int) -> int:
    """The part of ``apgd_dense_factors_kernel``'s shared memory that does
    not grow with the active rows, from the built library (its
    ``df_layout``). Needs nvcc and the card."""
    lib = _build.library('apgd_factored', _FACTORED_SIGNATURES)
    return int(lib.apgd_dense_factors_fixed_bytes(nv))


def dense_factors_stage_rows(k: int, nv: int) -> int:
    """Active rows of J~ that ``apgd_dense_factors_kernel`` stages in
    shared memory for an env with k active rows: what is left of a block's
    shared memory after the fixed part and 7 words an active row (its
    index and six vectors), at row stride nv | 1; it reads the others
    from device memory. Needs nvcc and the card."""
    words = (MAX_SHARED_BYTES - _dense_factors_fixed_bytes(nv)) // 4 - 7 * k
    return max(0, min(k, words // (nv | 1)))


def _active_row_sum_bound(J64, JMinv, R64, active):
    """(B,) max_i sum_j |Ad_ij| over each env's active rows and columns,
    Ad = J~ M^-1 J~' + diag(Rs), formed a few envs at a time on the
    active rows only (J~ and Rs are zero on the others)."""
    B = J64.shape[0]
    k = active.ne(0).sum(1)
    kmax = int(k.max()) if B else 0
    out = torch.zeros((B,), dtype=J64.dtype, device=J64.device)
    if kmax == 0:
        return out
    # each env's active rows first, in row order
    order = torch.argsort(active.eq(0).to(torch.int8), dim=1,
                          stable=True)[:, :kmax]
    chunk = max(1, (1 << 25) // (kmax * kmax))
    for b0 in range(0, B, chunk):
        o = order[b0:b0 + chunk]
        take = lambda X: torch.gather(
            X[b0:b0 + chunk], 1, o[..., None].expand(-1, -1, X.shape[2]))
        A = take(JMinv) @ take(J64).transpose(1, 2)
        A.diagonal(dim1=1, dim2=2).add_(torch.gather(R64[b0:b0 + chunk],
                                                     1, o))
        out[b0:b0 + chunk] = A.abs().sum(2).max(1).values
    return out


def _factor_matvec(J_s, Minv, Rs):
    """x (B, nr) -> Ad x for Ad = J~ M^-1 J~' + diag(Rs), applied in its
    factors and in float64 and rounded to x's dtype; and the float64
    factors (J~, J~ M^-1, Rs)."""
    J64 = J_s.double()
    JMinv = J64 @ Minv.double()
    R64 = Rs.double()

    def matvec(x):
        ax = (JMinv @ (J64.transpose(1, 2) @ x.double()[..., None]))[..., 0]
        return (ax + R64 * x).to(x.dtype)
    return matvec, (J64, JMinv, R64)


def dense_factors_warm_stale(J_s, Minv, Rs, v0):
    """(B,) bool: the envs whose warm start v0 the plain dense iterate on
    factors finds stale (its Rayleigh guard), so that it takes the
    row-sum bound. For tests and measurements that must know which path
    a warm solve takes."""
    return _warm_guard(_factor_matvec(J_s, Minv, Rs)[0], v0)[2]


def _check_nonneg_only(nr: int, nonneg) -> None:
    if len(nonneg) != nr or set(int(i) for i in nonneg) != set(range(nr)):
        raise ValueError(
            'apgd_iterate_dense_factors takes non-negative rows only (joint '
            'limits and pyramid facets): cone, box and equality rows are '
            'not ported past 1024 rows, and no model there has them')


def apgd_iterate_dense_factors_plain(J_s, Minv, Rs, rhs, f0, v0, active, *,
                                     nonneg, iterations: int, cold: bool,
                                     tol2: float = 1e-12,
                                     return_iterations: bool = False):
    """Plain dense iterate on factors: physics/solver.py's
    ``_apgd_dispatch(nonneg, (), (), iterations, cold).impl``, batched, on
    Ad = J~ M^-1 J~' + diag(Rs), which it never forms: the operator is
    applied in its factors and in float64, its result rounded to the
    iterate's dtype (as ``apgd_iterate_factored_plain`` applies it), and
    the warm staleness fallback is JAX's row-sum bound max(max_i sum_j
    |Ad_ij|, 1) over the active submatrix, formed only on the active rows.
    The flat power start is 1/sqrt(nr) over all nr rows and a warm v0 is
    normalised over all of them, as in JAX."""
    _check_nonneg_only(rhs.shape[1], nonneg)
    matvec, (J64, JMinv, R64) = _factor_matvec(J_s, Minv, Rs)
    row_sums = lambda: _active_row_sum_bound(J64, JMinv, R64,
                                             active).to(rhs.dtype)
    zeros_nr = torch.zeros((rhs.shape[1],), dtype=rhs.dtype,
                           device=rhs.device)
    return _iterate(matvec, row_sums, None, rhs, f0, v0, active, zeros_nr,
                    zeros_nr, nonneg=tuple(nonneg), box_rows=(), con0=(),
                    iterations=iterations, cold=cold, tol2=tol2, eq_rows=(),
                    return_iterations=return_iterations)


def apgd_iterate_dense_factors(J_s, Minv, Rs, rhs, f0, v0, active, *,
                               nonneg, iterations: int, cold: bool,
                               tol2: float = 1e-12,
                               return_iterations: bool = False):
    """Batched dense APGD iterate on factors (the output contract of
    ``apgd_iterate_batched``): J_s (B, nr, nv) scaled and active-masked
    Jacobian, Minv (B, nv, nv), Rs / rhs / f0 / v0 (B, nr), active (B, nr)
    0/1. Every row must be non-negative (``ValueError`` otherwise).
    Returns (f, v), each (B, nr) and zero on inactive rows, and with
    ``return_iterations`` also the APGD iterations each env ran (B,).

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream (no synchronisation, outputs allocated here).
    """
    if not J_s.is_cuda:
        return apgd_iterate_dense_factors_plain(
            J_s, Minv, Rs, rhs, f0, v0, active, nonneg=nonneg,
            iterations=iterations, cold=cold, tol2=tol2,
            return_iterations=return_iterations)
    B, nr, nv = J_s.shape
    _check_nonneg_only(nr, nonneg)
    tensors = (J_s, Minv, Rs, rhs, f0, v0, active)
    for t in tensors:
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError('apgd_iterate_dense_factors kernel takes '
                             'contiguous float32 CUDA tensors')
    if Minv.shape != (B, nv, nv) or any(t.shape != (B, nr)
                                        for t in tensors[2:]):
        raise ValueError('apgd_iterate_dense_factors: inconsistent shapes')
    if nv > DENSE_FACTORS_THREADS or \
            _dense_factors_fixed_bytes(nv) + 28 * nr > MAX_SHARED_BYTES:
        raise ValueError(f'apgd_iterate_dense_factors: nr={nr}, nv={nv}: '
                         'M^-1 and 7 words a row do not fit in a block\'s '
                         'shared memory')
    lib = _build.library('apgd_factored', _FACTORED_SIGNATURES)
    f = torch.empty_like(rhs)
    v = torch.empty_like(rhs)
    its = (torch.empty((B,), dtype=torch.int32, device=rhs.device)
           if return_iterations else None)
    rc = lib.apgd_iterate_dense_factors(
        *(t.data_ptr() for t in tensors), B, nr, nv, int(iterations),
        int(bool(cold)), float(tol2), f.data_ptr(), v.data_ptr(),
        its.data_ptr() if its is not None else 0,
        torch.cuda.current_stream(J_s.device).cuda_stream)
    _build.check(rc, 'apgd_iterate_dense_factors')
    launch_counts['apgd_dense_factors'] += 1
    return (f, v, its) if return_iterations else (f, v)
