"""Smooth articulated-body dynamics in world-frame spatial algebra.

Port of mujoco_mbrl_tpu/physics/smooth.py for hinge, slide, ball and free
joints (a free joint: 7 qpos, 6 dofs, world translations then body-local
rotations; a ball joint: a unit quaternion, 3 dofs, rotations about the
body's local axes through its anchor). Every function takes the env batch
as the leading dimension; the loops over bodies are static Python loops
over the model's tree, as in the JAX package. Fixed tendons (their passive
force and tendon-driven motors), site positions, the inertia-box fluid
force, the affine bias of servos and activation dynamics are ported. A
model from
``model.with_env_fields`` carries per-env ``geom_pos``, ``site_pos``,
``tendon_moment``, ``body_pos`` and ``body_quat`` with the env batch
leading; ``kinematics`` and ``actuation`` broadcast over it.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from . import math as pm
from . import model as M


class TreeMeta(NamedTuple):
    """Static tree addressing plus host-side fast-path predicates."""
    body_joints: Tuple[Tuple[int, ...], ...]
    body_dofs: Tuple[Tuple[int, ...], ...]
    ancestor_dofs: Tuple[Tuple[int, ...], ...]
    dof_body: Tuple[int, ...]
    identity_body_quat: Tuple[bool, ...]
    zero_body_pos: Tuple[bool, ...]
    zero_jnt_pos: Tuple[bool, ...]
    body_order: Tuple[int, ...]      # topological (== index order)


DOF_WIDTH = M.DOF_WIDTH


def tree_meta(m: M.Model) -> TreeMeta:
    """Static tree tables, built once per model (host copies only here)
    from the shared model's body and joint poses: a per-env pose never
    decides a fast path."""
    return M.cached(m, 'tree_meta', lambda: _tree_meta(M.shared(m)))


def _tree_meta(m: M.Model) -> TreeMeta:
    body_joints: List[List[int]] = [[] for _ in range(m.nbody)]
    for j in range(m.njnt):
        body_joints[m.jnt_body[j]].append(j)
    body_dofs = [[m.jnt_dofadr[j] + k for j in js
                  for k in range(DOF_WIDTH[m.jnt_type[j]])]
                 for js in body_joints]
    ancestor_dofs: List[List[int]] = [[] for _ in range(m.nbody)]
    for b in range(1, m.nbody):
        ancestor_dofs[b] = list(ancestor_dofs[m.body_parent[b]]) + body_dofs[b]
    dof_body = [0] * m.nv
    for b in range(m.nbody):
        for k in body_dofs[b]:
            dof_body[k] = b
    bq, bp, jp = (m.body_quat.cpu().numpy(), m.body_pos.cpu().numpy(),
                  m.jnt_pos.cpu().numpy())
    return TreeMeta(tuple(tuple(x) for x in body_joints),
                    tuple(tuple(x) for x in body_dofs),
                    tuple(tuple(x) for x in ancestor_dofs),
                    tuple(dof_body),
                    tuple(bool(np.allclose(q, [1, 0, 0, 0])) for q in bq),
                    tuple(bool(np.allclose(p, 0)) for p in bp),
                    tuple(bool(np.allclose(p, 0)) for p in jp),
                    tuple(range(m.nbody)))


def kinematics(m: M.Model, qpos: torch.Tensor, meta: TreeMeta):
    """Body/geom/site poses and world joint anchors/axes, batched (B, ...).

    mj_kinematics semantics: joints apply in declaration order within a
    body, displacing relative to qpos0; a body with a free joint takes its
    world pose from qpos (position, normalized quaternion) directly; a
    ball joint turns its body by its normalized quaternion about its
    anchor, as a hinge does by its axis-angle one.
    """
    B = qpos.shape[0]
    dev, dt = qpos.device, qpos.dtype

    # all hinge local rotations at once
    hq = None
    hinges = [j for j in range(m.njnt) if m.jnt_type[j] == M.HINGE]
    hq_index = {j: i for i, j in enumerate(hinges)}
    if hinges:
        h_adr = [m.jnt_qposadr[j] for j in hinges]
        half = 0.5 * (qpos[:, h_adr] - m.qpos0[h_adr])
        hq = torch.cat([torch.cos(half)[..., None],
                        m.jnt_axis[hinges] * torch.sin(half)[..., None]], -1)

    xpos = [torch.zeros((B, 3), dtype=dt, device=dev)]
    xquat = [torch.tensor([1.0, 0, 0, 0], dtype=dt, device=dev).expand(B, 4)]
    xanchor = [None] * m.njnt
    xaxis = [None] * m.njnt
    # a body pose set per env takes the general path for every body: the
    # fast-path predicates are the shared model's (JAX takes it when the
    # pose is traced, tests/test_stacker.py)
    env_pose = m.body_pos.dim() == 3 or m.body_quat.dim() == 3
    for b in range(1, m.nbody):
        p = m.body_parent[b]
        joints = meta.body_joints[b]
        if joints and m.jnt_type[joints[0]] == M.FREE:
            j, adr = joints[0], m.jnt_qposadr[joints[0]]
            pos = qpos[:, adr:adr + 3]
            quat = pm.quat_normalize(qpos[:, adr + 3:adr + 7])
            xanchor[j] = pos
            xaxis[j] = pm.quat_rot(quat, m.jnt_axis[j])
            xpos.append(pos)
            xquat.append(quat)
            continue
        quat = (xquat[p] if meta.identity_body_quat[b] and not env_pose
                else pm.quat_mul(xquat[p], m.body_quat[..., b, :]))
        pos = (xpos[p] if meta.zero_body_pos[b] and not env_pose
               else xpos[p] + pm.quat_rot(xquat[p], m.body_pos[..., b, :]))
        for j in meta.body_joints[b]:
            adr = m.jnt_qposadr[j]
            zero_anchor = meta.zero_jnt_pos[j]
            if m.jnt_type[j] == M.SLIDE:
                axis_w = pm.quat_rot(quat, m.jnt_axis[j])
                pos = pos + axis_w * (qpos[:, adr:adr + 1] - m.qpos0[adr])
                anchor = (pos if zero_anchor
                          else pos + pm.quat_rot(quat, m.jnt_pos[j]))
                xaxis[j] = axis_w
            else:
                qloc = (hq[:, hq_index[j]] if m.jnt_type[j] == M.HINGE
                        else pm.quat_normalize(qpos[:, adr:adr + 4]))
                if zero_anchor:
                    anchor = pos
                    quat = pm.quat_mul(quat, qloc)
                else:
                    anchor = pos + pm.quat_rot(quat, m.jnt_pos[j])
                    quat = pm.quat_mul(quat, qloc)
                    pos = anchor - pm.quat_rot(quat, m.jnt_pos[j])
                xaxis[j] = pm.quat_rot(quat, m.jnt_axis[j])
            xanchor[j] = anchor
        xpos.append(pos)
        xquat.append(quat)

    xpos = torch.stack(xpos, 1)                        # (B, nbody, 3)
    xquat = torch.stack(xquat, 1)
    xmat = pm.quat_to_mat(xquat)
    gb = list(m.geom_body)
    geom_xpos = xpos[:, gb] + pm.quat_rot(xquat[:, gb], m.geom_pos)
    geom_xmat = pm.quat_to_mat(pm.quat_mul(xquat[:, gb], m.geom_quat))
    sb = list(m.site_body)
    site_xpos = (xpos[:, sb] + pm.quat_rot(xquat[:, sb], m.site_pos) if sb
                 else torch.zeros((B, 0, 3), dtype=dt, device=dev))
    if not m.njnt:                   # a jointless scene (cameras, props)
        return (xpos, xquat, xmat, geom_xpos, geom_xmat, site_xpos,
                xpos[:, :0], xpos[:, :0])
    return (xpos, xquat, xmat, geom_xpos, geom_xmat, site_xpos,
            torch.stack(xanchor, 1), torch.stack(xaxis, 1))


def com_positions(m: M.Model, xpos, xquat):
    """World CoM of each body (xipos)."""
    return xpos + pm.quat_rot(xquat, m.body_ipos)


def motion_subspace(m: M.Model, xquat, xanchor, xaxis, meta: TreeMeta):
    """cdof (B, nv, 6): per-dof spatial motion vectors (world, origin).
    A free joint's dofs are translations along the world axes, then
    rotations about the body's local axes through its anchor; a ball
    joint's are those rotations alone."""
    if not m.nv:
        return xquat.new_zeros((xquat.shape[0], 0, 6))
    cdof = [None] * m.nv
    for j in range(m.njnt):
        adr = m.jnt_dofadr[j]
        ax = xaxis[:, j]
        if m.jnt_type[j] == M.FREE:
            eye = torch.eye(3, dtype=ax.dtype, device=ax.device)
            for k in range(3):
                cdof[adr + k] = torch.cat([torch.zeros_like(ax),
                                           eye[k].expand_as(ax)], -1)
            R = pm.quat_to_mat(xquat[:, m.jnt_body[j]])
            for k in range(3):
                axk = R[..., :, k]
                cdof[adr + 3 + k] = torch.cat(
                    [axk, torch.linalg.cross(xanchor[:, j], axk)], -1)
        elif m.jnt_type[j] == M.BALL:
            R = pm.quat_to_mat(xquat[:, m.jnt_body[j]])
            for k in range(3):
                axk = R[..., :, k]
                cdof[adr + k] = torch.cat(
                    [axk, torch.linalg.cross(xanchor[:, j], axk)], -1)
        elif m.jnt_type[j] == M.SLIDE:
            cdof[adr] = torch.cat([torch.zeros_like(ax), ax], -1)
        else:
            cdof[adr] = torch.cat([ax, torch.linalg.cross(xanchor[:, j], ax)],
                                  -1)
    return torch.stack(cdof, 1)


def body_spatial_inertia(m: M.Model, xquat, xipos):
    """(B, nbody, 6, 6) spatial inertia about the world origin (cinert)."""
    R = pm.quat_to_mat(xquat)
    I_world = torch.einsum('nbij,bjk,nblk->nbil', R, m.body_inertia, R)
    return pm.spatial_inertia(m.body_mass.expand(xquat.shape[:2]), I_world,
                              xipos)


def crba(m: M.Model, cdof, cinert, meta: TreeMeta) -> torch.Tensor:
    """Joint-space inertia (B, nv, nv), composite rigid body algorithm."""
    crb = list(cinert.unbind(1))
    for b in range(m.nbody - 1, 0, -1):
        p = m.body_parent[b]
        crb[p] = crb[p] + crb[b]
    crb = torch.stack(crb, 1)                          # (B, nbody, 6, 6)

    def build_lower():
        lower = np.zeros((m.nv, m.nv), np.float32)
        for b in range(1, m.nbody):
            for i in meta.body_dofs[b]:
                for j in meta.ancestor_dofs[b]:
                    if j <= i:
                        lower[i, j] = 1.0
        return torch.as_tensor(lower, dtype=cdof.dtype, device=cdof.device)

    lower = M.cached(m, 'crba_lower', build_lower)
    F = torch.einsum('nkij,nkj->nki', crb[:, list(meta.dof_body)], cdof)
    Mfull = F @ cdof.transpose(1, 2)
    Mlow = Mfull * lower
    return Mlow + torch.tril(Mlow, -1).transpose(1, 2) + torch.diag(
        m.dof_armature)


def velocities(m: M.Model, qvel, cdof, meta: TreeMeta):
    """Body spatial velocities cvel (B, nbody, 6) and cdof_dot (B, nv, 6).

    mj_comVel's order: a free joint's translations add to the velocity
    first (their cdof_dot is zero), then its three rotation dofs (and a
    ball joint's three) take cdof_dot from the velocity before any of them
    is added; a hinge or slide uses the velocity before its own dof."""
    cvel = [cdof.new_zeros((cdof.shape[0], 6))]
    cdof_dot = [None] * m.nv
    for b in range(1, m.nbody):
        v = cvel[m.body_parent[b]]
        for j in meta.body_joints[b]:
            adr = m.jnt_dofadr[j]
            if m.jnt_type[j] == M.FREE:
                for k in range(adr, adr + 3):
                    cdof_dot[k] = torch.zeros_like(v)
                v = v + (cdof[:, adr:adr + 3]
                         * qvel[:, adr:adr + 3, None]).sum(1)
                rot = cdof[:, adr + 3:adr + 6]
                for k in range(3):
                    cdof_dot[adr + 3 + k] = pm.motion_cross(v, rot[:, k])
                v = v + (rot * qvel[:, adr + 3:adr + 6, None]).sum(1)
                continue
            if m.jnt_type[j] == M.BALL:
                rot = cdof[:, adr:adr + 3]
                for k in range(3):
                    cdof_dot[adr + k] = pm.motion_cross(v, rot[:, k])
                v = v + (rot * qvel[:, adr:adr + 3, None]).sum(1)
                continue
            cdof_dot[adr] = pm.motion_cross(v, cdof[:, adr])
            v = v + cdof[:, adr] * qvel[:, adr:adr + 1]
        cvel.append(v)
    return torch.stack(cvel, 1), (torch.stack(cdof_dot, 1) if m.nv
                                  else cdof.new_zeros(cdof.shape))


def rnea_bias(m: M.Model, qvel, cdof, cdof_dot, cvel, cinert,
              meta: TreeMeta, gravity_on: bool) -> torch.Tensor:
    """qfrc_bias (B, nv): Coriolis/centrifugal + gravity (RNEA)."""
    g = m.opt.gravity if gravity_on else torch.zeros_like(m.opt.gravity)
    a0 = torch.cat([torch.zeros_like(g), -g]).expand(qvel.shape[0], 6)
    a_bias = [a0]
    for b in range(1, m.nbody):
        a = a_bias[m.body_parent[b]]
        for k in meta.body_dofs[b]:
            a = a + cdof_dot[:, k] * qvel[:, k:k + 1]
        a_bias.append(a)
    a_stack = torch.stack(a_bias, 1)
    Iv = torch.einsum('nbij,nbj->nbi', cinert, cvel)
    f_stack = (torch.einsum('nbij,nbj->nbi', cinert, a_stack)
               + pm.force_cross(cvel, Iv))
    f = list(f_stack.unbind(1))
    for b in range(m.nbody - 1, 0, -1):
        p = m.body_parent[b]
        f[p] = f[p] + f[b]
    f = torch.stack(f, 1)
    return torch.einsum('nkj,nkj->nk', cdof, f[:, list(meta.dof_body)])


def spring_force(m: M.Model, qpos: torch.Tensor) -> torch.Tensor:
    """Joint springs: -stiffness * (qpos - qpos_spring) on scalar joints
    and on a free joint's translation (its rotation and a ball joint have
    no spring, as in the JAX function)."""
    qfrc = torch.zeros((qpos.shape[0], m.nv), dtype=qpos.dtype,
                       device=qpos.device)
    free = [j for j in range(m.njnt) if m.jnt_type[j] == M.FREE]
    sj = [j for j in range(m.njnt) if m.jnt_type[j] in (M.SLIDE, M.HINGE)]
    stiff = (m.jnt_stiffness if len(sj) == m.njnt else M.cached(
        m, 'scalar_stiffness', lambda: m.jnt_stiffness[sj]))
    if sj:
        qadr = [m.jnt_qposadr[j] for j in sj]
        qfrc[:, [m.jnt_dofadr[j] for j in sj]] = -stiff * (
            qpos[:, qadr] - m.qpos_spring[qadr])
    for j in free:
        qadr, dadr = m.jnt_qposadr[j], m.jnt_dofadr[j]
        qfrc[:, dadr:dadr + 3] = -m.jnt_stiffness[j] * (
            qpos[:, qadr:qadr + 3] - m.qpos_spring[qadr:qadr + 3])
    return qfrc


def damping_force(m: M.Model, qvel: torch.Tensor) -> torch.Tensor:
    return -m.dof_damping * qvel


def fixed_tendon_length(m: M.Model, qpos: torch.Tensor,
                        t: int) -> torch.Tensor:
    """(B,) length of fixed tendon t: sum of coef * qpos over its joints
    (the static couplings of the model, as the JAX function reads them)."""
    length = torch.zeros_like(qpos[:, 0])
    for ji, coef in m.tendon_jnt[t]:
        length = length + coef * qpos[:, m.jnt_qposadr[ji]]
    return length


def _tendon_row(m: M.Model, t: int) -> torch.Tensor:
    """Moment row of tendon t: (nv,), or (B, nv) when set per env."""
    return m.tendon_moment[..., t, :]


def tendon_passive_force(m: M.Model, qpos, qvel) -> torch.Tensor:
    """(B, nv) fixed-tendon spring and damper forces."""
    qfrc = torch.zeros_like(qvel)
    springs = M.cached(m, 'tendon_springs', lambda: [
        t for t, (k, d) in enumerate(zip(m.tendon_stiffness.tolist(),
                                         m.tendon_damping.tolist()))
        if k != 0.0 or d != 0.0])
    for t in springs:
        row = _tendon_row(m, t)
        force = (-m.tendon_stiffness[t] * fixed_tendon_length(m, qpos, t)
                 - m.tendon_damping[t] * (row * qvel).sum(-1))
        qfrc = qfrc + row * force[:, None]
    return qfrc


def fluid_on(m: M.Model) -> bool:
    """Whether the model has a medium (density or viscosity > 0): read
    once per model, not on every forward."""
    return M.cached(m, 'fluid_on', lambda: float(m.opt.density) > 0
                    or float(m.opt.viscosity) > 0)


def fluid_force(m: M.Model, xipos, xquat, cvel, cdof,
                meta: TreeMeta) -> torch.Tensor:
    """(B, nv) viscous + density fluid forces of the inertia-box model.

    Per massive body, in its principal frame with equivalent box
    half-sizes (b0, b1, b2) and d = 2 (b0 + b1 + b2) / 3:
      viscosity eta: f = -3 pi eta d v,  tau = -pi eta d^3 w;
      density rho:   f_i = -2 rho b_j b_k |v_i| v_i,
                     tau_i = -rho b_i (b_j^4 + b_k^4) |w_i| w_i / 2,
    with v the CoM velocity less the wind. The spatial forces about the
    world origin sum over each subtree (a static loop over bodies) and
    project onto the dofs (J' f), as the JAX function does."""
    dt = cvel.dtype
    live = M.cached(m, 'fluid_live', lambda: (m.body_mass > 1e-12).to(dt))
    R = pm.quat_to_mat(xquat) @ m.body_principal_mat        # (B, nb, 3, 3)
    w_world = cvel[..., :3]
    v_world = (cvel[..., 3:] + torch.linalg.cross(w_world, xipos)
               - m.opt.wind)
    v = torch.einsum('nbji,nbj->nbi', R, v_world)            # R' v
    w = torch.einsum('nbji,nbj->nbi', R, w_world)
    box = m.body_fluid_box                                   # (nb, 3)
    d_eq = 2.0 * box.sum(1, keepdim=True) / 3.0
    eta, rho = m.opt.viscosity, m.opt.density
    f_loc = -3.0 * np.pi * eta * d_eq * v
    t_loc = -np.pi * eta * d_eq ** 3 * w
    b0, b1, b2 = box.unbind(1)
    areas = torch.stack([b1 * b2, b0 * b2, b0 * b1], 1)
    f_loc = f_loc - 2.0 * rho * areas * v.abs() * v
    moments = torch.stack([b0 * (b1 ** 4 + b2 ** 4), b1 * (b0 ** 4 + b2 ** 4),
                           b2 * (b0 ** 4 + b1 ** 4)], 1)
    t_loc = t_loc - 0.5 * rho * moments * w.abs() * w
    f_world = torch.einsum('nbij,nbj->nbi', R, f_loc)
    t_world = torch.einsum('nbij,nbj->nbi', R, t_loc)
    f_spatial = live[:, None] * torch.cat(
        [t_world + torch.linalg.cross(xipos, f_world), f_world], -1)
    f = list(f_spatial.unbind(1))
    for b in range(m.nbody - 1, 0, -1):
        p = m.body_parent[b]
        f[p] = f[p] + f[b]
    f = torch.stack(f, 1)
    return torch.einsum('nkj,nkj->nk', cdof, f[:, list(meta.dof_body)])


def actuation(m: M.Model, qpos, qvel, ctrl, act=None):
    """(actuator_force, qfrc_actuator, act_dot): motors, position servos
    and general actuators on joints and on fixed tendons (qfrc +=
    tendon_moment' gear force).

    A servo's affine bias is biasprm0 + biasprm1 * length + biasprm2 *
    velocity, with the transmission's length and velocity (gear times the
    joint's qpos and qvel, or the tendon's length and moment . qvel; JAX
    smooth.py:547-552). A stateful actuator's gain reads its activation
    ``act`` (B, na) in place of the ctrl, and ``act_dot`` is (ctrl -
    act) / tau for a filter, the ctrl for an integrator (JAX
    smooth.py:530-545); it is None for a model with no activation state
    or when ``act`` is None (RK4's stage passes, as in JAX).
    """
    B, dt, dev = qpos.shape[0], qpos.dtype, qpos.device
    if m.nu == 0 or (m.opt.disableflags & M.DSBL_ACTUATION):
        return (torch.zeros((B, m.nu), dtype=dt, device=dev),
                torch.zeros((B, m.nv), dtype=dt, device=dev), None)

    def clip_where(x, key, limited, rng):
        if not any(limited):
            return x
        lim = M.cached(m, key, lambda: torch.as_tensor(limited, device=dev))
        return torch.where(lim, torch.minimum(torch.maximum(
            x, rng[:, 0]), rng[:, 1]), x)

    c = clip_where(ctrl, 'ctrl_limited', m.actuator_ctrllimited,
                   m.actuator_ctrlrange)
    joint_us = [u for u in range(m.nu)
                if m.actuator_trntype[u] == M.TRN_JOINT]
    tendon_us = [u for u in range(m.nu) if u not in joint_us]
    if joint_us:
        uj, dadr = M.cached(m, 'actuator_dofadr', lambda: (
            torch.as_tensor(joint_us, device=dev),
            torch.as_tensor([m.jnt_dofadr[m.actuator_trnid[u]]
                             for u in joint_us], device=dev)))
    gain_in, act_dot = c, None
    if m.na and act is not None:
        # the slot of each stateful actuator, and the actuator of each slot
        stateful, slot_of, slot_u, is_filter = M.cached(
            m, 'activation_slots', lambda: (
                torch.as_tensor([t != M.DYN_NONE
                                 for t in m.actuator_dyntype], device=dev),
                torch.as_tensor([max(a, 0) for a in m.actuator_actadr],
                                device=dev),
                [u for u in range(m.nu) if m.actuator_dyntype[u]
                 != M.DYN_NONE],
                torch.as_tensor([t == M.DYN_FILTER for t in
                                 m.actuator_dyntype if t != M.DYN_NONE],
                                device=dev)))
        gain_in = torch.where(stateful, act[:, slot_of], c)
        tau = torch.clamp(m.actuator_dynprm[slot_u, 0], min=1e-8)
        c_slot = c[:, slot_u]
        act_dot = torch.where(is_filter, (c_slot - act) / tau, c_slot)
    force = m.actuator_gainprm[:, 0] * gain_in
    if any(bt == M.BIAS_AFFINE for bt in m.actuator_biastype):
        length, velocity = [None] * m.nu, [None] * m.nu
        for u in joint_us:
            j = m.actuator_trnid[u]
            length[u] = qpos[:, m.jnt_qposadr[j]]
            velocity[u] = qvel[:, m.jnt_dofadr[j]]
        for u in tendon_us:
            t = m.actuator_trnid[u]
            length[u] = fixed_tendon_length(m, qpos, t)
            velocity[u] = (_tendon_row(m, t) * qvel).sum(-1)
        affine = M.cached(m, 'bias_affine', lambda: torch.as_tensor(
            [bt == M.BIAS_AFFINE for bt in m.actuator_biastype],
            dtype=dt, device=dev))
        force = force + affine * (
            m.actuator_biasprm[:, 0]
            + m.actuator_biasprm[:, 1] * (m.actuator_gear
                                          * torch.stack(length, 1))
            + m.actuator_biasprm[:, 2] * (m.actuator_gear
                                          * torch.stack(velocity, 1)))
    force = clip_where(force, 'force_limited', m.actuator_forcelimited,
                       m.actuator_forcerange)
    qfrc = torch.zeros((B, m.nv), dtype=dt, device=dev)
    if joint_us:
        gf = m.actuator_gear * force
        qfrc.index_add_(1, dadr, gf if len(joint_us) == m.nu else gf[:, uj])
    for u in tendon_us:
        qfrc = qfrc + _tendon_row(m, m.actuator_trnid[u]) * (
            m.actuator_gear[u] * force[:, u:u + 1])
    return force, qfrc, act_dot
