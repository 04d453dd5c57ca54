"""Soft-constraint assembly and the APGD dual solve (batched over envs).

Port of mujoco_mbrl_tpu/physics/solver.py for dof friction loss (a box
row a dof), tendon equality (a free row holding a fixed tendon's length
at 0, the manipulator's and stacker's finger coupling), spatial-tendon
length limits, joint limits and frictional contacts, pyramidal of condim
1 (one non-negative row a point, the humanoid's geom-geom pairs), 2-3
(four facet rows), 4-5 (six: the torsional direction on the rotational
Jacobian) or 6 and past (ten: torsion and two rolling directions,
quadruped fetch's ball), grouped by condim, or elliptic (a normal and two
tangent rows a point at any condim, the tangents' friction zero below
condim 3), in JAX's row order: friction loss, tendon equality, tendon
limits, joint limits, contacts. Each row has
impedance d(pos) from solimp, reference acceleration aref = -b*vel - k*pos
from solref, and regularizer R = (1-d)/d * invweight0; the dual
min 1/2 f'(A+R)f - f'rhs is solved by ``solve_apgd`` through the batched
iterate of ``ops.apgd_solve`` (CUDA kernel on the card, plain PyTorch on
the CPU): the dense iterate up to 96 rows (walker: 62; finger: 39), and
at any row count once an equality row is present, since its Gauss-Seidel
polish reads rows of Ad (manipulator bring_ball: 452 rows; stacker
stack_4: 977), the factored one past 96 rows otherwise (cheetah: 146;
humanoid: 303), as the JAX solver selects them (the quadruped's 240, 356
and 914 rows stay dense: it has four equality rows). Past 1024 rows
without an equality row, where JAX's dense regime holds but the dense
kernel takes no solve (humanoid_cmu: 4,352 x 62, outside JAX's
``factored_fits``), the dense iterate runs on Ad applied through J~ and
M^-1 (``apgd_iterate_dense_factors``), which is never formed. Friction-
loss rows in the factored regime take the factored iterate too, with
per-env bounds (B, nr): each env's row scale divides them, as under JAX's
vmap (JAX then runs its XLA iterate). ``solve`` is JAX's
projected Gauss-Seidel (``m.opt.solver`` 'pgs'): a sweep over the blocks
in row order, each block's update one set of (B,) ops over all envs.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from . import model as M
from .collision import Contact

MAX_NR = 96      # JAX switches to its factored kernel past this row count


def impedance(solimp: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """solimp impedance d(pos); solimp indexed along axis 0."""
    dmin, dmax, width, mid, power = (solimp[0], solimp[1], solimp[2],
                                     solimp[3], solimp[4])
    x = torch.clamp(pos.abs() / torch.clamp(width, min=1e-10), 0.0, 1.0)
    lo = mid * (x / torch.clamp(mid, min=1e-10)) ** power
    hi = 1.0 - (1.0 - mid) * ((1.0 - x) / torch.clamp(1.0 - mid, min=1e-10)
                              ) ** power
    d = dmin + torch.where(x < mid, lo, hi) * (dmax - dmin)
    return torch.clamp(d, 1e-4, 0.9999)


def kbi(solref, solimp, pos, timestep):
    """Stiffness k, damping b, impedance d (mj_makeImpedance)."""
    d = impedance(solimp, pos)
    dmax = solimp[1]
    timeconst = torch.maximum(solref[0], 2.0 * timestep)
    dampratio = solref[1]
    b_std = 2.0 / torch.clamp(dmax * timeconst, min=1e-10)
    k_std = d / torch.clamp(dmax * dmax * timeconst * timeconst
                            * dampratio * dampratio, min=1e-10)
    b_dir = -solref[1] / torch.clamp(dmax, min=1e-10)
    k_dir = -solref[0] * d / torch.clamp(dmax * dmax, min=1e-10)
    direct = torch.logical_or(solref[0] <= 0, solref[1] <= 0)
    return (torch.where(direct, k_dir, k_std),
            torch.where(direct, b_dir, b_std), d)


class ConstraintSet:
    """Assembled rows, batched: J (B, nr, nv), aref/R/active (B, nr).

    ``blocks`` (static) lists (kind, row); ``mu`` holds each pyramid's
    (or, elliptic, each contact's) slide friction; ``friction_bounds``
    each 'friction' row's box bound; ``pyramids`` (contact, first_row,
    n_dirs)."""

    def __init__(self, J, aref, R, active, blocks, mu, pyramids=(),
                 friction_bounds=None):
        self.J = J
        self.aref = aref
        self.R = R
        self.active = active
        self.blocks = blocks
        self.mu = mu
        self.pyramids = pyramids
        self.friction_bounds = friction_bounds


def _limited_joints(m: M.Model) -> Tuple[int, ...]:
    if m.opt.disableflags & M.DSBL_LIMIT:
        return ()
    return tuple(j for j in range(m.njnt)
                 if m.jnt_limited[j] and m.jnt_type[j] in (M.SLIDE, M.HINGE))


def ancestor_dof_mask(m: M.Model, meta) -> np.ndarray:
    """Static (nbody, nv) 0/1 mask: dof k on the root->body chain."""
    mask = np.zeros((m.nbody, m.nv), np.float32)
    for b in range(m.nbody):
        for k in meta.ancestor_dofs[b]:
            mask[b, k] = 1.0
    return mask


def _pair_condim(m: M.Model, g1: int, g2: int) -> int:
    p1, p2 = m.geom_priority[g1], m.geom_priority[g2]
    if p1 > p2:
        return m.geom_condim[g1]
    if p2 > p1:
        return m.geom_condim[g2]
    return max(m.geom_condim[g1], m.geom_condim[g2])


def _default_kbi(m: M.Model, pos):
    """kbi at MuJoCo's default solref [.02, 1] and solimp [.9, .95, .001,
    .5, 2], the parameters of friction-loss and tendon-limit rows."""
    like = dict(dtype=pos.dtype, device=pos.device)
    return kbi(torch.tensor([0.02, 1.0], **like),
               torch.tensor([0.9, 0.95, 0.001, 0.5, 2.0], **like), pos,
               m.opt.timestep)


def _site_jacobian(cdof, body: int, point, amask):
    """(B, nv, 3) translational Jacobian of `point` (B, 3) on `body`."""
    Jt = cdof[..., 3:] + torch.linalg.cross(
        cdof[..., :3], point[:, None].expand_as(cdof[..., 3:]))
    return Jt * amask[body][:, None]


def assemble(m: M.Model, meta, qpos, qvel, cdof,
             contact: Optional[Contact],
             site_xpos: Optional[torch.Tensor] = None
             ) -> Optional[ConstraintSet]:
    """Friction-loss, tendon-equality, tendon-limit, joint-limit and
    contact rows, in the JAX row order."""
    B, nv, dt, dev = qpos.shape[0], m.nv, qpos.dtype, qpos.device
    h = m.opt.timestep
    rows_J: List[torch.Tensor] = []
    rows_aref, rows_R, rows_active = [], [], []
    blocks, mus, pyramids = [], [], []
    nrows = 0
    dof_iw = m.dof_invweight0
    body_iw = m.body_invweight0[:, 0]
    amask_t = lambda: M.cached(m, 'ancestor_mask', lambda: torch.as_tensor(
        ancestor_dof_mask(m, meta), dtype=dt, device=dev))

    # ---- dof friction loss: a box row a dof (finger's spinner) ----------
    fl = M.cached(m, 'frictionloss_dofs', lambda: tuple(
        int(k) for k in np.nonzero(m.dof_frictionloss.cpu().numpy())[0]))
    friction_bounds = None
    if fl:
        _, bb, dd = _default_kbi(m, torch.zeros((), dtype=dt, device=dev))
        blocks += [('friction', nrows + i) for i in range(len(fl))]
        nrows += len(fl)
        rows_J.append(M.cached(m, 'frictionloss_rows', lambda: torch.eye(
            nv, dtype=dt, device=dev)[list(fl)]).expand(B, len(fl), nv))
        rows_aref.append(-bb * qvel[:, list(fl)])
        rows_R.append(((1.0 - dd) / dd * dof_iw[list(fl)]).expand(
            B, len(fl)))
        rows_active.append(torch.ones((B, len(fl)), dtype=dt, device=dev))
        friction_bounds = m.dof_frictionloss[list(fl)]

    # ---- tendon equality: the fixed tendon's length held at 0 ------------
    if m.eq_tendon:
        from .smooth import fixed_tendon_length
        eq_params = M.cached(m, 'eq_tendon_params', lambda: [
            (t, torch.tensor(ref, dtype=dt, device=dev),
             torch.tensor(imp, dtype=dt, device=dev))
            for t, ref, imp in m.eq_tendon])
        for t, solref, solimp in eq_params:
            length = fixed_tendon_length(m, qpos, t)
            Jrow = m.tendon_moment[..., t, :].expand(B, nv)
            kk, bb, dd = kbi(solref, solimp, length, h)
            blocks.append(('equality', nrows))
            nrows += 1
            rows_J.append(Jrow[:, None])
            rows_aref.append((-bb * (Jrow * qvel).sum(1) - kk * length
                              )[:, None])
            rows_R.append(((1.0 - dd) / dd * m.tendon_invweight0[t]
                           )[:, None])
            rows_active.append(torch.ones((B, 1), dtype=dt, device=dev))

    # ---- spatial-tendon length limits (ball_in_cup's string) ------------
    for s1, s2, limited, lo, hi, iw in m.spatial_tendons:
        if not limited or site_xpos is None:
            continue
        p1, p2 = site_xpos[:, s1], site_xpos[:, s2]
        diff = p1 - p2
        length = torch.linalg.vector_norm(diff, dim=-1)
        u = diff / torch.clamp(length, min=1e-9)[:, None]
        J1 = _site_jacobian(cdof, m.site_body[s1], p1, amask_t())
        J2 = _site_jacobian(cdof, m.site_body[s2], p2, amask_t())
        # J = -dL/dq: a positive force shortens the tendon
        Jrow = -torch.einsum('bj,bvj->bv', u, J1 - J2)
        pos = hi - length              # negative when over-stretched
        posc = torch.clamp(pos, max=0.0)
        kk, bb, dd = _default_kbi(m, posc)
        blocks.append(('limit', nrows))
        nrows += 1
        rows_J.append(Jrow[:, None])
        rows_aref.append((-bb * (Jrow * qvel).sum(1) - kk * posc)[:, None])
        rows_R.append(((1.0 - dd) / dd * iw)[:, None])
        rows_active.append((pos < 0.0).to(dt)[:, None])

    # ---- joint limits (batched over all limited joints) -----------------
    lim = _limited_joints(m)
    if lim:
        qadr = [m.jnt_qposadr[j] for j in lim]
        dadr = [m.jnt_dofadr[j] for j in lim]
        q = qpos[:, qadr]
        lo, hi = m.jnt_range[list(lim), 0], m.jnt_range[list(lim), 1]
        dist_lo, dist_hi = q - lo, hi - q
        use_lo = dist_lo < dist_hi
        sign = torch.where(use_lo, 1.0, -1.0).to(dt)
        pos = torch.where(use_lo, dist_lo, dist_hi) - m.jnt_margin[list(lim)]
        posc = torch.clamp(pos, max=0.0)
        eye = M.cached(m, 'limit_rows', lambda: torch.eye(
            nv, dtype=dt, device=dev)[dadr])               # (nlim, nv)
        k, b, d = kbi(m.jnt_solref[list(lim)].T[:, None],
                      m.jnt_solimp[list(lim)].T[:, None], posc, h)
        blocks += [('limit', nrows + i) for i in range(len(lim))]
        nrows += len(lim)
        rows_J.append(sign[..., None] * eye)
        rows_aref.append(-b * (sign * qvel[:, dadr]) - k * posc)
        rows_R.append((1.0 - d) / d * dof_iw[dadr])
        rows_active.append((pos < 0.0).to(dt))

    # ---- contacts (elliptic triples or pyramidal facets, batched over
    # contact points) -----------------------------------------------------
    if contact is not None and len(contact.geom1):
        C = len(contact.geom1)
        body1 = [m.geom_body[g] for g in contact.geom1]
        body2 = [m.geom_body[g] for g in contact.geom2]

        def build_dmask():
            amask = amask_t()
            return (amask[body2] - amask[body1])[:, :, None]   # (C, nv, 1)

        dmask = M.cached(m, ('contact_dmask', contact.geom1, contact.geom2),
                         build_dmask)
        # J[c, k, :] = cdof[k, 3:] + cross(cdof[k, :3], point[c])
        ang = cdof[:, None, :, :3].expand(B, C, nv, 3)
        Jt = cdof[:, None, :, 3:] + torch.linalg.cross(
            ang, contact.pos[:, :, None, :].expand(B, C, nv, 3))
        Jc = torch.einsum('ncij,ncvj->nciv', contact.frame, Jt * dmask)
        pos = torch.clamp(contact.dist, max=0.0)
        k, b, d = kbi(contact.solref.T[:, None], contact.solimp.T[:, None],
                      pos, h)                              # (B, C)
        vel = torch.einsum('nciv,nv->nci', Jc, qvel)       # (B, C, 3)
        active = (contact.dist < 0.0).to(dt)
        cdim = np.array([_pair_condim(m, g1, g2)
                         for g1, g2 in zip(contact.geom1, contact.geom2)])
        iw_pair = body_iw[body1] + body_iw[body2]          # (C,)
        mu1 = contact.friction[:, 0]
        if m.opt.cone == 'elliptic':
            # a (normal, t1, t2) triple a contact at any condim, in contact
            # order, the tangents free of friction below condim 3; their
            # regulariser is the normal's over impratio
            blocks += [('contact', nrows + 3 * c) for c in range(C)]
            mus.append(mu1 * torch.as_tensor(cdim >= 3, dtype=dt,
                                             device=dev))
            aref_con = torch.stack([-b * vel[..., 0] - k * pos,
                                    -b * vel[..., 1], -b * vel[..., 2]], -1)
            R_n = (1.0 - d) / d * iw_pair
            R_t = R_n / m.opt.impratio
            rows_J.append(Jc.reshape(B, 3 * C, nv))
            rows_aref.append(aref_con.reshape(B, 3 * C))
            rows_R.append(torch.stack([R_n, R_t, R_t], -1).reshape(B, 3 * C))
            rows_active.append(active.repeat_interleave(3, dim=1))
            nrows += 3 * C
        else:
            if (cdim > 3).any():
                # the rotational Jacobian in the contact frame, (B, C, 3, nv)
                Jr = torch.einsum('ncij,ncvj->nciv', contact.frame,
                                  cdof[:, None, :, :3] * dmask)
            R_con = ((1.0 - d) / d * iw_pair * 2.0 * mu1 * mu1
                     * (1.0 + mu1 * mu1))
            fr = contact.friction
            for grp_dim in sorted(set(cdim.tolist())):
                idx = np.nonzero(cdim == grp_dim)[0]
                G = len(idx)
                Jn = Jc[:, idx, 0]                         # (B, G, nv)
                aref_n = (-b[:, idx] * vel[:, idx, 0]
                          - k[:, idx] * pos[:, idx])
                if grp_dim == 1:
                    for gi, c in enumerate(idx):
                        blocks.append(('limit', nrows + gi))
                        pyramids.append((int(c), nrows + gi, 0))
                    rows_J.append(Jn)
                    rows_aref.append(aref_n)
                    rows_R.append((1.0 - d[:, idx]) / d[:, idx]
                                  * iw_pair[idx])
                    rows_active.append(active[:, idx])
                    mus.append(mu1[idx] * 0)
                    nrows += G
                    continue
                # friction directions: the two tangents (slide), then the
                # normal's torsion (condim 4) and the tangents' rolling
                # (condim 6), each with its own coefficient
                dirs = [(Jc[:, idx, t], mu1[idx], vel[:, idx, t])
                        for t in (1, 2)]
                rot = ([(0, 1)] if grp_dim >= 4 else []) + (
                    [(1, 2), (2, 2)] if grp_dim >= 6 else [])
                for t, f_col in rot:
                    Jd = Jr[:, idx, t]
                    dirs.append((Jd, fr[idx, f_col],
                                 (Jd * qvel[:, None]).sum(-1)))
                nf = 2 * len(dirs)
                facet_J, facet_aref = [], []
                for Jd, mu_d, vd in dirs:   # (d0+, d0-, d1+, ...) a contact
                    facet_J += [Jn + mu_d[:, None] * Jd,
                                Jn - mu_d[:, None] * Jd]
                    facet_aref += [aref_n - b[:, idx] * mu_d * vd,
                                   aref_n + b[:, idx] * mu_d * vd]
                for gi, c in enumerate(idx):
                    pyramids.append((int(c), nrows + nf * gi, len(dirs)))
                    blocks += [('facet', nrows + nf * gi + r_)
                               for r_ in range(nf)]
                rows_J.append(torch.stack(facet_J, 2).reshape(B, nf * G, nv))
                rows_aref.append(
                    torch.stack(facet_aref, 2).reshape(B, nf * G))
                rows_R.append(R_con[:, idx].repeat_interleave(nf, dim=1))
                rows_active.append(
                    active[:, idx].repeat_interleave(nf, dim=1))
                mus.append(mu1[idx])
                nrows += nf * G

    if not rows_J:
        return None
    mu = torch.cat(mus) if mus else torch.zeros((0,), dtype=dt, device=dev)
    return ConstraintSet(torch.cat(rows_J, 1), torch.cat(rows_aref, 1),
                         torch.cat(rows_R, 1), torch.cat(rows_active, 1),
                         blocks, mu, tuple(pyramids), friction_bounds)


def _row_structure(cs: ConstraintSet):
    """Static row-type index arrays derived from the block list."""
    nonneg, box_rows, con0 = [], [], []
    for kind, i0 in cs.blocks:
        if kind in ('limit', 'facet'):
            nonneg.append(i0)
        elif kind == 'friction':
            box_rows.append(i0)
        elif kind == 'contact':
            con0.append(i0)
    return (np.array(nonneg, np.int64), np.array(box_rows, np.int64),
            np.array(con0, np.int64))


def factored_fits(nr: int, nv: int) -> bool:
    """The JAX rule (ops/apgd_solve.py factored_fits): the TPU kernel's
    VMEM need for 128 envs, (nv nr8 + nv nv8 + 14 nr8) 128 * 4 bytes, at
    most 10 MiB. It is a TPU budget, kept because it decides which math
    (and which staleness bound) a model's solve runs."""
    nr8 = -(-nr // 8) * 8
    nv8 = -(-nv // 8) * 8
    return (nv * nr8 + nv * nv8 + 14 * nr8) * 128 * 4 <= 10 * 1024 * 1024


def solve_apgd(m: M.Model, cs: Optional[ConstraintSet], qM_chol,
               qacc_smooth: torch.Tensor,
               iterations: Optional[int] = None,
               f0: Optional[torch.Tensor] = None,
               power_v0: Optional[torch.Tensor] = None):
    """Accelerated projected gradient on the dual QP, batched over envs.

    ``qM_chol`` is the lower Cholesky factor of the mass matrix. Jacobi
    scaling, degenerate-row dropping, active-set masking of Ad and the
    objective-certificate divergence fallback follow the JAX
    ``solve_apgd`` line for line. Returns
    ``(qfrc_constraint (B, nv), row forces f (B, nr), power_v (B, nr))``.
    """
    from . import apgd_plain as _ker

    if cs is None:
        return torch.zeros_like(qacc_smooth), None, None
    iterations = iterations or 2 * m.opt.solver_iterations
    nr, nv = cs.J.shape[1], cs.J.shape[2]
    eq_rows = tuple(int(i0) for kind, i0 in cs.blocks if kind == 'equality')
    # the factored regime (JAX solver.py:505-513): Ad is never formed
    use_factored = nr > MAX_NR and factored_fits(nr, nv) and not eq_rows
    # JAX's dense regime past the dense kernel's rows (humanoid_cmu's
    # 4,352): its dense iterate, Ad applied through J~ and M^-1
    on_factors = use_factored or (nr > _ker.DENSE_MAX_NR and not eq_rows)

    JT = cs.J.transpose(1, 2)
    MinvJT = torch.cholesky_solve(JT, qM_chol)             # (B, nv, nr)
    if on_factors:
        d_all0 = torch.einsum('brv,bvr->br', cs.J, MinvJT) + cs.R
    else:
        # in place where it can be: at stack_4's 977 rows a (B, nr, nr)
        # batch is 3.9 GB at 1024 envs
        Ad = cs.J @ MinvJT
        Ad.diagonal(dim1=1, dim2=2).add_(cs.R)
        d_all0 = torch.diagonal(Ad, dim1=1, dim2=2).clone()
    rhs = (cs.aref - (cs.J @ qacc_smooth[..., None])[..., 0]) * cs.active

    nonneg, box_rows, con0 = _row_structure(cs)
    # Jacobi preconditioning; a cone's tangents take their normal row's
    # scale, so the cone projection stays exact in the scaled variables;
    # rows with a vanishing diagonal are dropped
    d_all = d_all0
    if len(con0):
        d_all = d_all0.clone()
        d_all[:, con0 + 1] = d_all0[:, con0]
        d_all[:, con0 + 2] = d_all0[:, con0]
    degenerate = d_all < 1e-9 * d_all.max(dim=1, keepdim=True).values
    s_inv = torch.where(degenerate, 0.0, 1.0 / torch.sqrt(
        torch.where(degenerate, 1.0, d_all)))
    act_m = cs.active
    sa = s_inv * act_m
    if not on_factors:
        # scale, then mask Ad to the active submatrix so the step size is
        # the ACTIVE set's spectral radius (JAX solver.py:543-555)
        Ad.mul_(sa[:, :, None]).mul_(sa[:, None, :])
    rhs = rhs * s_inv

    dt, dev = qacc_smooth.dtype, qacc_smooth.device
    zeros_nr = torch.zeros((nr,), dtype=dt, device=dev)
    # the cone rows' friction (nr,), and the box rows' bounds over their
    # per-env scale (B, nr): the bounds are batched, as under JAX's vmap
    mu_full = zeros_nr
    if len(con0):
        mu_full = zeros_nr.clone()
        mu_full[con0] = cs.mu.to(dt)
    bounds_full = zeros_nr
    if len(box_rows):
        s_box = s_inv[:, box_rows]
        bounds_full = torch.zeros_like(rhs)
        bounds_full[:, box_rows] = cs.friction_bounds.to(dt) / torch.where(
            s_box > 0, s_box, 1.0)
    if f0 is None:
        f0s = torch.zeros_like(rhs)
    else:
        f0s = torch.where(s_inv > 0, f0 * cs.active /
                          torch.where(s_inv > 0, s_inv, 1.0), 0.0)
    cold = power_v0 is None
    v0 = torch.zeros_like(rhs) if cold else power_v0
    rows = dict(nonneg=tuple(int(i) for i in nonneg),
                box_rows=tuple(int(i) for i in box_rows),
                con0=tuple(int(i) for i in con0),
                iterations=int(iterations), cold=cold)
    if on_factors:
        # Ad = J~ M^-1 J~' + diag(Rs), the row scale and active mask folded
        # into J~ (JAX solver.py:583-597)
        J_s = (cs.J * sa[..., None]).contiguous()
        eye = torch.eye(nv, dtype=dt, device=dev).expand(J_s.shape[0], nv,
                                                        nv)
        Minv = torch.cholesky_solve(eye, qM_chol).contiguous()
        Rs = s_inv * s_inv * cs.R * act_m
        if use_factored:
            diag_s = s_inv * s_inv * d_all0 * act_m
            f, v = _ker.apgd_iterate_factored(
                J_s, Minv, Rs, diag_s, rhs, f0s, v0, act_m, mu_full,
                bounds_full, **rows)
        else:
            f, v = _ker.apgd_iterate_dense_factors(
                J_s, Minv, Rs, rhs, f0s, v0, act_m, nonneg=rows['nonneg'],
                iterations=rows['iterations'], cold=cold)
        Adf = (J_s @ (Minv @ (J_s.transpose(1, 2) @ f[..., None])))[
            ..., 0] + Rs * f
    else:
        f, v = _ker.apgd_iterate_batched(
            Ad, rhs, f0s, v0, act_m, mu_full, bounds_full, eq_rows=eq_rows,
            **rows)
        Adf = (Ad @ f[..., None])[..., 0]
    # divergence certificate: phi(f) = 1/2 f'Ad f - f'rhs <= phi(0) = 0
    phi = 0.5 * (f * Adf).sum(1) - (f * rhs).sum(1)
    bad = ~((phi <= 0.0) & torch.isfinite(f).all(1))
    f = torch.where(bad[:, None], 0.0, f)
    v = torch.where(bad[:, None], 0.0, v)
    f = f * s_inv
    return (JT @ f[..., None])[..., 0], f, v


def solve(m: M.Model, cs: Optional[ConstraintSet], qM_chol,
          qacc_smooth: torch.Tensor, iterations: Optional[int] = None,
          f0: Optional[torch.Tensor] = None):
    """Projected Gauss-Seidel on the dual, batched over envs (JAX
    ``solve``). Returns ``(qfrc_constraint (B, nv), row forces (B, nr))``.

    ``m.opt.solver_iterations`` sweeps visit ``cs.blocks`` in order: limit
    and facet rows clamp at zero, friction-loss rows are boxed by their
    bound, equality rows are free, and an elliptic contact updates its
    normal, then its two tangents from the updated normal, and scales
    them onto the cone mu f_n. Inactive rows are masked; ``f0`` (the prior
    substep's forces) warm starts the sweep, masked to this step's active
    rows. Each row's update is a few (B,) ops over all envs: the solve is
    launch-bound, not arithmetic-bound.
    """
    if cs is None:
        return torch.zeros_like(qacc_smooth), None
    iterations = iterations or m.opt.solver_iterations
    JT = cs.J.transpose(1, 2)
    Ad = cs.J @ torch.cholesky_solve(JT, qM_chol)
    Ad.diagonal(dim1=1, dim2=2).add_(cs.R)
    diag = torch.clamp(torch.diagonal(Ad, dim1=1, dim2=2), min=1e-10)
    rhs = (cs.aref - (cs.J @ qacc_smooth[..., None])[..., 0]) * cs.active
    f = (torch.zeros_like(rhs) if f0 is None
         else (f0 * cs.active).contiguous())
    act = cs.active
    bounds = (cs.friction_bounds.to(rhs.dtype).unbind(0)
              if cs.friction_bounds is not None else ())
    mus = cs.mu.to(rhs.dtype).unbind(0) if len(cs.mu) else ()
    plan, ci, fi = [], 0, 0
    for kind, i0 in cs.blocks:
        if kind == 'contact':
            plan.append((kind, i0, mus[ci]))
            ci += 1
        elif kind == 'friction':
            plan.append((kind, i0, bounds[fi]))
            fi += 1
        else:
            plan.append((kind, i0, None))

    def step(i):
        """Row i's unprojected Gauss-Seidel value f_i - (Ad_i f - rhs_i)
        / d_i, and the column it lands in."""
        res = torch.linalg.vecdot(Ad[:, i], f) - rhs[:, i]
        col = f[:, i]
        return torch.addcdiv(col, res, diag[:, i], value=-1.0), col

    for _ in range(iterations):
        for kind, i0, p in plan:
            if kind in ('limit', 'facet'):
                x, col = step(i0)
                col.copy_(torch.clamp(x, min=0.0) * act[:, i0])
            elif kind == 'friction':
                x, col = step(i0)
                col.copy_(torch.clamp(x, -p, p) * act[:, i0])
            elif kind == 'equality':
                x, col = step(i0)
                col.copy_(x)
            else:
                x, col = step(i0)
                col.copy_(torch.clamp(x, min=0.0) * act[:, i0])
                ft1, c1 = step(i0 + 1)
                ft2, c2 = step(i0 + 2)
                tnorm = torch.sqrt(ft1 * ft1 + ft2 * ft2)
                limit = p * col
                scale = torch.where(tnorm > limit, limit / torch.clamp(
                    tnorm, min=1e-12), 1.0)
                c1.copy_(ft1 * scale * act[:, i0 + 1])
                c2.copy_(ft2 * scale * act[:, i0 + 2])
    return (JT @ f[..., None])[..., 0], f


_PYRAMID_INDEX = {}


def contact_forces(cs: Optional[ConstraintSet], f: Optional[torch.Tensor],
                   n_contacts: int, B: int, dtype, device) -> torch.Tensor:
    """Per-contact (normal, t1, t2) forces (B, C, 3): elliptic rows carry
    them directly; pyramidal contacts rebuild them from their facets of
    any number of directions, fn = sum(facets), ft_i = mu * (f_i+ - f_i-)
    for the two slide tangents (JAX solver.py:936-946)."""
    out = torch.zeros((B, n_contacts, 3), dtype=dtype, device=device)
    if cs is None or f is None:
        return out
    i0 = [i for kind, i in cs.blocks if kind == 'contact']
    if i0:
        # the elliptic triples, one a contact in contact order
        return f[:, i0[0]:i0[0] + 3 * len(i0)].reshape(B, len(i0), 3)
    if not cs.pyramids:
        return out
    key = (cs.pyramids, str(device))
    if key not in _PYRAMID_INDEX:
        # per pyramid size: (pyramid positions, contacts, facet rows)
        t = lambda a: torch.as_tensor(a, dtype=torch.long, device=device)
        groups = {}
        for k, (c, i0, ndir) in enumerate(cs.pyramids):
            groups.setdefault(ndir, []).append((k, c, i0))
        _PYRAMID_INDEX[key] = [
            (ndir, t([k for k, _, _ in g]), t([c for _, c, _ in g]),
             t([[i0 + r for r in range(max(2 * ndir, 1))]
                for _, _, i0 in g]))
            for ndir, g in sorted(groups.items())]
    for ndir, ks, cs_, rows in _PYRAMID_INDEX[key]:
        facets = f[:, rows]                       # (B, P, max(2 ndir, 1))
        if ndir == 0:
            out[:, cs_, 0] = facets[..., 0]
            continue
        # fn = the sum of all facets; a slide tangent's force is mu times
        # its two facets' difference
        mu = cs.mu[ks]
        out[:, cs_] = torch.stack([facets.sum(-1),
                                   mu * (facets[..., 0] - facets[..., 1]),
                                   mu * (facets[..., 2] - facets[..., 3])],
                                  -1)
    return out
