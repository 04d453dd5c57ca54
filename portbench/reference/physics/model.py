"""Model / Option / State / Data as dataclasses of tensors.

Port of mujoco_mbrl_tpu/physics/model.py. ``Model`` is shared by the whole
env batch (unbatched tensors plus static Python tuples that drive the
unrolled tree loops), except for the fields a task sets per env
(``with_env_fields``); ``State`` and ``Data`` carry the env batch as their
leading dimension. Enum values follow the MuJoCo ABI, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import torch

# Joint types (mjtJoint order).
FREE, BALL, SLIDE, HINGE = 0, 1, 2, 3
# Geom types (mjtGeom order).
PLANE, HFIELD, SPHERE, CAPSULE, ELLIPSOID, CYLINDER, BOX = 0, 1, 2, 3, 4, 5, 6
# Integrators.
EULER, RK4 = 0, 1
# Actuator transmission.
TRN_JOINT, TRN_TENDON = 0, 3
# Actuator gain/bias types.
GAIN_FIXED, BIAS_NONE, BIAS_AFFINE = 0, 0, 1
# Actuator activation dynamics (mjtDyn order).
DYN_NONE, DYN_INTEGRATOR, DYN_FILTER = 0, 1, 2
# qpos and qvel widths of each joint type.
QPOS_WIDTH = {FREE: 7, BALL: 4, SLIDE: 1, HINGE: 1}
DOF_WIDTH = {FREE: 6, BALL: 3, SLIDE: 1, HINGE: 1}
# Disable flags (bitmask).
DSBL_CONTACT = 1 << 0
DSBL_GRAVITY = 1 << 1
DSBL_LIMIT = 1 << 2
DSBL_ACTUATION = 1 << 3


def _to(obj, device):
    """dataclasses.replace with every tensor field moved to `device`."""
    updates = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            updates[f.name] = v.to(device)
        elif dataclasses.is_dataclass(v):
            updates[f.name] = _to(v, device)
    return dataclasses.replace(obj, **updates)


_CONSTS: 'weakref.WeakKeyDictionary' = weakref.WeakKeyDictionary()


def shared(m: 'Model') -> 'Model':
    """The model that `m` was made from by ``with_env_fields`` (else `m`):
    the one whose shared fields a memo entry may be built from."""
    return getattr(m, '_memo_owner', m)


def cached(m: 'Model', key: str, build: Callable[[], Any]) -> Any:
    """Per-model memo for static derived data (tree tables, index and mask
    tensors on the model's device): built once, not on every forward. A
    model with per-env fields (``with_env_fields``) shares the memo of the
    model it was made from, so a ``build`` that reads a per-env field
    reads it from ``shared(m)``."""
    d = _CONSTS.setdefault(shared(m), {})
    if key not in d:
        d[key] = build()
    return d[key]


@dataclasses.dataclass(frozen=True)
class Option:
    """Simulation options (subset of mjOption); defaults as the JAX port."""
    timestep: torch.Tensor
    gravity: torch.Tensor           # (3,)
    viscosity: torch.Tensor
    density: torch.Tensor
    wind: torch.Tensor              # (3,)
    integrator: int = EULER
    disableflags: int = 0
    solver_iterations: int = 30
    solver: str = 'apgd'
    cone: str = 'pyramidal'
    impratio: float = 1.0
    enable_geom_geom_contacts: bool = True
    solver_warmstart: bool = True


@dataclasses.dataclass(frozen=True, eq=False)
class Model:
    """Static physics model (fields and meaning as the JAX ``Model``)."""
    opt: Option
    nq: int
    nv: int
    nu: int
    nbody: int
    njnt: int
    ngeom: int
    nsite: int
    ntendon: int
    body_parent: Tuple[int, ...]
    jnt_type: Tuple[int, ...]
    jnt_body: Tuple[int, ...]
    jnt_qposadr: Tuple[int, ...]
    jnt_dofadr: Tuple[int, ...]
    jnt_limited: Tuple[bool, ...]
    dof_jnt: Tuple[int, ...]
    geom_type: Tuple[int, ...]
    geom_body: Tuple[int, ...]
    site_body: Tuple[int, ...]
    actuator_trntype: Tuple[int, ...]
    actuator_trnid: Tuple[int, ...]
    actuator_ctrllimited: Tuple[bool, ...]
    names: Dict[str, Dict[str, int]]
    body_pos: torch.Tensor          # (nbody, 3)
    body_quat: torch.Tensor         # (nbody, 4)
    body_mass: torch.Tensor         # (nbody,)
    body_ipos: torch.Tensor         # (nbody, 3)
    body_inertia: torch.Tensor      # (nbody, 3, 3)
    jnt_pos: torch.Tensor           # (njnt, 3)
    jnt_axis: torch.Tensor          # (njnt, 3)
    jnt_range: torch.Tensor         # (njnt, 2)
    jnt_solref: torch.Tensor        # (njnt, 2)
    jnt_solimp: torch.Tensor        # (njnt, 5)
    jnt_stiffness: torch.Tensor     # (njnt,)
    jnt_margin: torch.Tensor        # (njnt,)
    dof_damping: torch.Tensor       # (nv,)
    dof_armature: torch.Tensor      # (nv,)
    dof_frictionloss: torch.Tensor  # (nv,)
    geom_pos: torch.Tensor          # (ngeom, 3)
    geom_quat: torch.Tensor         # (ngeom, 4)
    geom_size: torch.Tensor         # (ngeom, 3)
    geom_friction: torch.Tensor     # (ngeom, 3)
    geom_solref: torch.Tensor       # (ngeom, 2)
    geom_solimp: torch.Tensor       # (ngeom, 5)
    geom_margin: torch.Tensor       # (ngeom,)
    geom_contype: Tuple[int, ...]
    geom_conaffinity: Tuple[int, ...]
    geom_condim: Tuple[int, ...]
    geom_priority: Tuple[int, ...]
    geom_solmix: torch.Tensor       # (ngeom,)
    site_pos: torch.Tensor          # (nsite, 3)
    site_quat: torch.Tensor         # (nsite, 4)
    site_size: torch.Tensor         # (nsite, 3) touch-zone volumes
    actuator_gear: torch.Tensor     # (nu,)
    actuator_ctrlrange: torch.Tensor  # (nu, 2)
    actuator_gainprm: torch.Tensor  # (nu, 3)
    actuator_biasprm: torch.Tensor  # (nu, 3)
    actuator_forcerange: torch.Tensor  # (nu, 2)
    actuator_forcelimited: Tuple[bool, ...]
    actuator_biastype: Tuple[int, ...]
    body_fluid_box: torch.Tensor    # (nbody, 3) equivalent-box half-sizes
    body_principal_mat: torch.Tensor  # (nbody, 3, 3) body -> principal
    qpos0: torch.Tensor             # (nq,)
    qpos_spring: torch.Tensor       # (nq,)
    site_type: Tuple[int, ...] = ()   # geom type codes of the site shapes
    # activation state: na slots, actuator_actadr[u] the slot of a
    # stateful actuator (filter, integrator) or -1; dynprm[:, 0] is tau
    na: int = 0
    actuator_dyntype: Tuple[int, ...] = ()
    actuator_actadr: Tuple[int, ...] = ()
    actuator_dynprm: Optional[torch.Tensor] = None   # (nu, 3)
    contact_excludes: Tuple[Tuple[int, int], ...] = ()
    # fixed tendons: linear couplings over scalar joints
    tendon_moment: Optional[torch.Tensor] = None     # (ntendon, nv)
    tendon_stiffness: Optional[torch.Tensor] = None  # (ntendon,)
    tendon_damping: Optional[torch.Tensor] = None    # (ntendon,)
    # static (joint, coef) pairs per fixed tendon, for its length
    tendon_jnt: Tuple[Tuple[Tuple[int, float], ...], ...] = ()
    # spatial tendons (site-to-site strings): (site1, site2, limited,
    # range_lo, range_hi, invweight0), the last at qpos0; they give
    # length-limit rows only
    spatial_tendons: Tuple[Tuple, ...] = ()
    # tendon equality constraints: (tendon, solref (2,), solimp (5,)), a
    # soft row holding the fixed tendon's length at 0
    eq_tendon: Tuple[Tuple, ...] = ()
    # mj_setConst reference weights (constraint regularizers)
    dof_invweight0: Optional[torch.Tensor] = None   # (nv,)
    body_invweight0: Optional[torch.Tensor] = None  # (nbody, 2)
    tendon_invweight0: Optional[torch.Tensor] = None  # (ntendon,)
    # one heightfield (quadruped escape): heights in [0, 1] scaled by
    # hfield_size[2] (rx, ry, z_top, z_base) about the geom's position;
    # a task writes its data per env
    hfield_nrow: int = 0
    hfield_ncol: int = 0
    hfield_data: Optional[torch.Tensor] = None   # (nrow, ncol) or (B, ...)
    hfield_size: Optional[torch.Tensor] = None   # (4,)
    hfield_pos: Optional[torch.Tensor] = None    # (3,)
    # cameras (visual only; posed and rendered by utils.raycast)
    ncam: int = 0
    cam_body: Tuple[int, ...] = ()
    cam_mode: Tuple[str, ...] = ()       # 'fixed', 'trackcom', ...
    cam_fovy: Tuple[float, ...] = ()     # vertical field of view, degrees
    cam_pos: Optional[torch.Tensor] = None    # (ncam, 3) in the body frame
    cam_quat: Optional[torch.Tensor] = None   # (ncam, 4)

    def name2id(self, kind: str, name: str) -> int:
        return self.names[kind][name]

    def jnt_qpos_slice(self, name: str) -> slice:
        """The joint's span of qpos (a free joint's 7, a hinge's 1)."""
        j = self.names['joint'][name]
        adr = self.jnt_qposadr[j]
        return slice(adr, adr + QPOS_WIDTH[self.jnt_type[j]])

    def jnt_dof_slice(self, name: str) -> slice:
        """The joint's span of qvel (a free joint's 6, a hinge's 1)."""
        j = self.names['joint'][name]
        adr = self.jnt_dofadr[j]
        return slice(adr, adr + DOF_WIDTH[self.jnt_type[j]])

    def to(self, device) -> 'Model':
        return _to(self, device)

    def replace(self, **kw) -> 'Model':
        return dataclasses.replace(self, **kw)

    @property
    def device(self) -> torch.device:
        return self.qpos0.device

    @property
    def dtype(self) -> torch.dtype:
        return self.qpos0.dtype


# Fields a task may set per env (JAX ``Task.apply_params`` under ``vmap``);
# none of them is read by anything ``cached`` derives, but the body pose:
# ``smooth.kinematics`` skips the identity-quaternion and zero-position
# fast paths of the shared model when it is set per env.
ENV_FIELDS = ('geom_pos', 'site_pos', 'tendon_moment', 'body_pos',
              'body_quat', 'hfield_data')


def with_env_fields(m: Model, **fields: torch.Tensor) -> Model:
    """`m` with per-env values of some fields, each with the env batch as
    its leading dimension (geom_pos (B, ngeom, 3), site_pos (B, nsite, 3),
    tendon_moment (B, ntendon, nv), body_pos (B, nbody, 3), body_quat
    (B, nbody, 4), hfield_data (B, nrow, ncol)); the functions that read
    them broadcast over it. The result shares `m`'s ``cached`` memo: one
    model per batch, not one per env."""
    bad = set(fields) - set(ENV_FIELDS)
    if bad:
        raise ValueError(f'no per-env override for {sorted(bad)}')
    out = m.replace(**fields)
    object.__setattr__(out, '_memo_owner', shared(m))
    return out


@dataclasses.dataclass(frozen=True)
class State:
    """Batched dynamic state: qpos (B, nq), qvel (B, nv), time (B,) and,
    for a model with stateful actuators, act (B, na)."""
    qpos: torch.Tensor
    qvel: torch.Tensor
    time: torch.Tensor
    act: Optional[torch.Tensor] = None   # (B, na); None when na == 0

    def replace(self, **kw) -> 'State':
        return dataclasses.replace(self, **kw)

    def flatten(self) -> torch.Tensor:
        """(B, nq + nv [+ na]): each env's [qpos, qvel, act], the flat
        state vector of JAX's ``State.flatten``."""
        parts = [self.qpos, self.qvel]
        if self.act is not None:
            parts.append(self.act)
        return torch.cat(parts, 1)


@dataclasses.dataclass(frozen=True)
class Data:
    """Batched forward-dynamics products (cf. mjData); leading dim B."""
    xpos: torch.Tensor        # (B, nbody, 3)
    xquat: torch.Tensor       # (B, nbody, 4)
    xipos: torch.Tensor       # (B, nbody, 3)
    ximat: torch.Tensor       # (B, nbody, 3, 3)
    geom_xpos: torch.Tensor   # (B, ngeom, 3)
    geom_xmat: torch.Tensor   # (B, ngeom, 3, 3)
    site_xpos: torch.Tensor   # (B, nsite, 3)
    xanchor: torch.Tensor     # (B, njnt, 3)
    xaxis: torch.Tensor       # (B, njnt, 3)
    cdof: torch.Tensor        # (B, nv, 6)
    cvel: torch.Tensor        # (B, nbody, 6)
    qM: torch.Tensor          # (B, nv, nv)
    qfrc_bias: torch.Tensor   # (B, nv)
    qfrc_passive: torch.Tensor
    qfrc_actuator: torch.Tensor
    qfrc_constraint: torch.Tensor
    qacc: torch.Tensor
    actuator_force: torch.Tensor  # (B, nu)
    contact_dist: torch.Tensor    # (B, C)
    contact_pos: torch.Tensor     # (B, C, 3)
    contact_force: torch.Tensor   # (B, C, 3)
    act_dot: Optional[torch.Tensor] = None        # (B, na)
    cdof_dot: Optional[torch.Tensor] = None
    contact_frame: Optional[torch.Tensor] = None  # (B, C, 3, 3)
    efc_force: Optional[torch.Tensor] = None      # (B, nr)
    efc_power_v: Optional[torch.Tensor] = None    # (B, nr)


def xmat_of(data: Data, model: Model) -> torch.Tensor:
    """Body rotation matrices (B, nbody, 3, 3)."""
    return data.ximat


def make_state(model: Model, qpos: Optional[torch.Tensor] = None,
               qvel: Optional[torch.Tensor] = None,
               time: Optional[torch.Tensor] = None,
               batch: Optional[int] = None,
               act: Optional[torch.Tensor] = None, dtype=None) -> State:
    """Batched State, defaulting to qpos0 / zero velocity / time 0 and,
    where the model has stateful actuators, zero activations; in `dtype`
    (default: the model's)."""
    dev, dt = model.device, dtype or model.dtype
    if qpos is None:
        qpos = model.qpos0.expand(batch or 1, model.nq).clone()
    B = qpos.shape[0]
    if qvel is None:
        qvel = torch.zeros((B, model.nv), dtype=dt, device=dev)
    if time is None:
        time = torch.zeros((B,), dtype=dt, device=dev)
    if act is None and model.na:
        act = torch.zeros((B, model.na), dtype=dt, device=dev)
    return State(qpos=qpos.to(dt), qvel=qvel.to(dt), time=time.to(dt),
                 act=act.to(dt) if act is not None else None)
