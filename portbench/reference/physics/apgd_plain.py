"""Plain APGD iterates of the reference physics: a frozen copy of the
plain versions in ``mujoco_mbrl_tpu_torch/ops/apgd_solve.py`` (the dense
iterate, the factored iterate and the dense iterate on factors), with the
names the solver calls bound to them. No kernel runs here."""

from __future__ import annotations

import numpy as np
import torch

# the dense kernel's row limit, which picks the solver's regime
DENSE_MAX_NR = 1024



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


# the solver's call sites take the plain iterates
apgd_iterate_batched = apgd_iterate_plain
apgd_iterate_factored = apgd_iterate_factored_plain
apgd_iterate_dense_factors = apgd_iterate_dense_factors_plain
