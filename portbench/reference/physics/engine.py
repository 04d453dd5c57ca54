"""Forward dynamics, constraint solve and semi-implicit Euler, batched.

Port of mujoco_mbrl_tpu/physics/engine.py: ``forward`` (with the
``acc_stage=False`` position/velocity-only pass; the fluid force in
``qfrc_passive`` where the model has a medium; the constraint solve by
APGD or, where ``m.opt.solver`` is 'pgs', by projected Gauss-Seidel,
whose forces warm start the next substep but which carries no power
vector), ``_euler`` with implicit
joint damping, ``_rk4`` (four forward passes, each with a cold constraint
solve), ``integrate_pos``, ``step``, ``step_warm`` and ``substep`` (with
Euler, the constraint row forces and the APGD power vector carried from
one substep's solve into the next), ``n_substeps``, ``diverged`` and
its host-side check ``check_divergence`` (``PhysicsError``).
Stateful actuators' activations advance by forward Euler, h * act_dot,
under both integrators. Every function takes the env batch as the
leading dimension.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import collision
from . import math as pm
from . import model as M
from . import smooth
from . import solver as solver_mod


def forward(m: M.Model, state: M.State, ctrl: torch.Tensor,
            acc_stage: bool = True) -> M.Data:
    """Kinematics -> forces -> constrained qacc (mj_forward), batched.

    ``acc_stage=False`` stops after the position/velocity stages and
    contact geometry (mj_step1's scope) and returns zeros for qacc, the
    actuator and constraint forces and contact_force.
    """
    return _forward(m, state, ctrl, acc_stage=acc_stage)


def _forward(m: M.Model, state: M.State, ctrl: torch.Tensor,
             acc_stage: bool = True, need_qacc: bool = True,
             warm_f=None, warm_v=None) -> M.Data:
    meta = smooth.tree_meta(m)
    qpos, qvel = state.qpos, state.qvel
    B, dt, dev = qpos.shape[0], qpos.dtype, qpos.device

    (xpos, xquat, xmat, geom_xpos, geom_xmat, site_xpos,
     xanchor, xaxis) = smooth.kinematics(m, qpos, meta)
    xipos = smooth.com_positions(m, xpos, xquat)
    cdof = smooth.motion_subspace(m, xquat, xanchor, xaxis, meta)
    cinert = smooth.body_spatial_inertia(m, xquat, xipos)
    qM = smooth.crba(m, cdof, cinert, meta)
    cvel, cdof_dot = smooth.velocities(m, qvel, cdof, meta)
    gravity_on = not (m.opt.disableflags & M.DSBL_GRAVITY)
    qfrc_bias = smooth.rnea_bias(m, qvel, cdof, cdof_dot, cvel, cinert,
                                 meta, gravity_on)
    qfrc_passive = (smooth.spring_force(m, qpos)
                    + smooth.damping_force(m, qvel))
    if m.ntendon:
        qfrc_passive = qfrc_passive + smooth.tendon_passive_force(
            m, qpos, qvel)
    if smooth.fluid_on(m):
        qfrc_passive = qfrc_passive + smooth.fluid_force(
            m, xipos, xquat, cvel, cdof, meta)
    contact = None
    if not (m.opt.disableflags & M.DSBL_CONTACT):
        pairs = M.cached(m, 'candidate_pairs', lambda: (
            collision.candidate_pairs(
                m, include_geom_geom=m.opt.enable_geom_geom_contacts)))
        if pairs:
            contact = collision.detect(m, geom_xpos, geom_xmat, pairs)
    n_con = len(contact.geom1) if contact is not None else 0
    zeros = lambda *s: torch.zeros((B,) + s, dtype=dt, device=dev)
    common = dict(
        xpos=xpos, xquat=xquat, xipos=xipos, ximat=xmat,
        geom_xpos=geom_xpos, geom_xmat=geom_xmat, site_xpos=site_xpos,
        xanchor=xanchor, xaxis=xaxis, cdof=cdof, cvel=cvel, qM=qM,
        qfrc_bias=qfrc_bias, qfrc_passive=qfrc_passive,
        contact_dist=contact.dist if contact is not None else zeros(0),
        contact_pos=contact.pos if contact is not None else zeros(0, 3),
        cdof_dot=cdof_dot,
        contact_frame=(contact.frame if contact is not None
                       else zeros(0, 3, 3)))
    if not acc_stage:
        z = torch.zeros_like(qvel)
        return M.Data(qfrc_actuator=z, qfrc_constraint=z, qacc=z,
                      actuator_force=zeros(m.nu),
                      contact_force=zeros(n_con, 3), act_dot=zeros(m.na),
                      **common)

    actuator_force, qfrc_actuator, act_dot = smooth.actuation(
        m, qpos, qvel, ctrl, state.act)
    qfrc_smooth = qfrc_passive + qfrc_actuator - qfrc_bias
    # cholesky_ex: a diverged env's NaN factor flows on to a NaN state
    # (engine.diverged's test, as JAX's cho_factor), where cholesky would
    # raise for the whole batch and sync with the host to find out
    qM_chol = torch.linalg.cholesky_ex(qM).L
    qacc_smooth = torch.cholesky_solve(qfrc_smooth[..., None], qM_chol)[..., 0]
    cs = solver_mod.assemble(m, meta, qpos, qvel, cdof, contact,
                             site_xpos=site_xpos)
    if m.opt.solver == 'apgd':
        qfrc_constraint, f_rows, power_v = solver_mod.solve_apgd(
            m, cs, qM_chol, qacc_smooth, f0=warm_f, power_v0=warm_v)
    else:
        # any other name is the PGS sweep, as JAX dispatches it
        qfrc_constraint, f_rows = solver_mod.solve(m, cs, qM_chol,
                                                   qacc_smooth, f0=warm_f)
        power_v = None
    if need_qacc:
        qacc = qacc_smooth + torch.cholesky_solve(
            qfrc_constraint[..., None], qM_chol)[..., 0]
    else:
        qacc = qacc_smooth     # _euler recomputes the velocity update
    return M.Data(
        qfrc_actuator=qfrc_actuator, qfrc_constraint=qfrc_constraint,
        qacc=qacc, actuator_force=actuator_force, act_dot=act_dot,
        contact_force=solver_mod.contact_forces(cs, f_rows, n_con, B, dt,
                                                dev),
        efc_force=f_rows, efc_power_v=power_v, **common)


def integrate_pos(m: M.Model, qpos: torch.Tensor, qvel: torch.Tensor,
                  dt) -> torch.Tensor:
    """qpos += dt * qvel on hinge and slide joints; a free joint's
    position adds dt times its linear velocity, and its quaternion, as a
    ball joint's, turns by its local angular velocity
    (``math.quat_integrate``)."""
    quat = [j for j in range(m.njnt) if m.jnt_type[j] in (M.FREE, M.BALL)]
    qadr, dadr = list(m.jnt_qposadr), list(m.jnt_dofadr)
    if not quat and qadr == list(range(m.nq)) and dadr == list(range(m.nv)):
        return qpos + dt * qvel
    out = qpos.clone()
    sq = [m.jnt_qposadr[j] for j in range(m.njnt) if j not in quat]
    sd = [m.jnt_dofadr[j] for j in range(m.njnt) if j not in quat]
    if sq:
        out[:, sq] = out[:, sq] + dt * qvel[:, sd]
    for j in quat:
        qa, da = m.jnt_qposadr[j], m.jnt_dofadr[j]
        if m.jnt_type[j] == M.BALL:
            out[:, qa:qa + 4] = pm.quat_integrate(
                qpos[:, qa:qa + 4], qvel[:, da:da + 3], dt)
            continue
        out[:, qa:qa + 3] = qpos[:, qa:qa + 3] + dt * qvel[:, da:da + 3]
        out[:, qa + 3:qa + 7] = pm.quat_integrate(
            qpos[:, qa + 3:qa + 7], qvel[:, da + 3:da + 6], dt)
    return out


def _euler(m: M.Model, state: M.State, ctrl, warm_f=None, warm_v=None
           ) -> Tuple[M.State, Optional[torch.Tensor],
                      Optional[torch.Tensor]]:
    """One semi-implicit Euler step with implicit damping (mj_Euler):
    v' = v + h (M + h diag(B))^-1 f_explicit. Also returns the row forces
    and the APGD power vector for the next substep's warm start."""
    h = m.opt.timestep.to(state.qpos.dtype)
    d = _forward(m, state, ctrl, need_qacc=False, warm_f=warm_f,
                 warm_v=warm_v)
    f_total = (d.qfrc_passive + d.qfrc_actuator - d.qfrc_bias
               + d.qfrc_constraint)
    MhB = d.qM + h * torch.diag(m.dof_damping)
    qacc = torch.cholesky_solve(f_total[..., None],
                                torch.linalg.cholesky_ex(MhB).L)[..., 0]
    qvel = state.qvel + h * qacc
    qpos = integrate_pos(m, state.qpos, qvel, h)
    return (M.State(qpos=qpos, qvel=qvel, time=state.time + h,
                    act=_advance_act(m, state, d.act_dot, h)),
            d.efc_force, d.efc_power_v)


def _advance_act(m: M.Model, state: M.State, act_dot, h):
    """act + h act_dot for stateful actuators (JAX engine.py:223-224)."""
    if m.na and state.act is not None:
        return state.act + h * act_dot
    return state.act


_RK4_A = ((0.5,), (0.0, 0.5), (0.0, 0.0, 1.0))
_RK4_B = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)


def _rk4(m: M.Model, state: M.State, ctrl) -> M.State:
    """Classic Runge-Kutta on (qpos, qvel) with JAX's tableau: four full
    forward passes (each a cold constraint solve), positions advanced by
    ``integrate_pos`` at each stage (JAX engine.py:229-258)."""
    h = m.opt.timestep.to(state.qpos.dtype)
    q0, v0 = state.qpos, state.qvel
    vels = [v0]
    d0 = _forward(m, state, ctrl)
    accs = [d0.qacc]
    for arow in _RK4_A:
        dv = sum(a * acc for a, acc in zip(arow, accs) if a != 0.0)
        dq_vel = sum(a * vel for a, vel in zip(arow, vels) if a != 0.0)
        qi = integrate_pos(m, q0, dq_vel, h)
        vi = v0 + h * dv
        vels.append(vi)
        accs.append(_forward(m, M.State(qpos=qi, qvel=vi, time=state.time),
                             ctrl).qacc)
    vel_w = sum(bw * vel for bw, vel in zip(_RK4_B, vels))
    acc_w = sum(bw * acc for bw, acc in zip(_RK4_B, accs))
    # the stages carry no activation (their gain reads the ctrl, as in
    # JAX); the activation advances by Euler from the first pass's rate
    return M.State(qpos=integrate_pos(m, q0, vel_w, h), qvel=v0 + h * acc_w,
                   time=state.time + h,
                   act=_advance_act(m, state, d0.act_dot, h))


def step(m: M.Model, state: M.State, ctrl: torch.Tensor) -> M.State:
    """Advance physics by one timestep (cold constraint solves)."""
    if m.opt.integrator == M.RK4:
        return _rk4(m, state, ctrl)
    return _euler(m, state, ctrl)[0]


def step_warm(m: M.Model, state: M.State, ctrl: torch.Tensor,
              warm_f=None, warm_v=None):
    """`step` threading row forces and the power vector for warm starts.
    RK4's four stage solves see different configurations and never warm
    start: it returns ``(state, None, None)``."""
    if m.opt.integrator == M.RK4:
        return _rk4(m, state, ctrl), None, None
    return _euler(m, state, ctrl, warm_f=warm_f, warm_v=warm_v)


def diverged(state: M.State, qpos_limit: float = 1e6,
             qvel_limit: float = 1e6) -> torch.Tensor:
    """(B,) bool: NaN/Inf or exploding state per env."""
    bad_pos = (~torch.isfinite(state.qpos)
               | (state.qpos.abs() > qpos_limit)).any(1)
    bad_vel = (~torch.isfinite(state.qvel)
               | (state.qvel.abs() > qvel_limit)).any(1)
    return bad_pos | bad_vel


class PhysicsError(RuntimeError):
    """Raised by `check_divergence` when the simulation diverged (the role
    of MuJoCo's bad-qpos / bad-qvel warnings)."""


def check_divergence(state: M.State) -> None:
    """Raise PhysicsError where any env's state is NaN/Inf or exploding
    (`diverged`); reads one flag back to the host."""
    bad = diverged(state)
    if bool(bad.any()):
        raise PhysicsError(
            f'Physics state is invalid (NaN/Inf or exploding qpos/qvel) in '
            f'{int(bad.sum())} of {bad.shape[0]} envs.')


def n_substeps(m: M.Model, control_timestep: float) -> int:
    """Number of physics substeps per control step."""
    ts = float(m.opt.timestep)
    n = int(round(control_timestep / ts))
    if abs(n * ts - control_timestep) > 1e-6:
        raise ValueError(
            f'control_timestep {control_timestep} not an integer multiple '
            f'of physics timestep {ts}')
    return n


def substep(m: M.Model, state: M.State, ctrl: torch.Tensor,
            n: int) -> M.State:
    """n physics steps under constant ctrl; with ``solver_warmstart`` (and
    Euler: RK4 never warm starts) the first solve runs cold and each later
    one starts from the previous substep's row forces and power vector
    (JAX engine.py:336-346)."""
    if n == 1 or not m.opt.solver_warmstart or m.opt.integrator == M.RK4:
        for _ in range(n):
            state = step(m, state, ctrl)
        return state
    state, f, v = step_warm(m, state, ctrl)
    for _ in range(n - 1):
        state, f, v = step_warm(m, state, ctrl, warm_f=f, warm_v=v)
    return state
