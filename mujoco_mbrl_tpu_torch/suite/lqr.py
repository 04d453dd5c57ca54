"""LQR domain: lqr_2_1 / lqr_6_2, procedurally generated linear systems.

Port of mujoco_mbrl_tpu/suite/lqr.py: a chain of spring-coupled sliding
masses whose stiffnesses ``_make_model_xml`` draws from
``np.random.RandomState(seed)`` (the same model as JAX's for a seed),
the quadratic reward 1 - (0.5 |x|^2 + 0.5 c |u|^2), no time limit and
early termination once |(qpos, qvel)| < 1e-6 (discount 0). Contacts and
limits are disabled, so a step solves no constraint. ``lqr_solver`` gives
the analytic optimal policy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..physics import make_state, mjcf
from . import base, control
from .registry import TaggedTasks

SUITE = TaggedTasks()
_DEFAULT_TIME_LIMIT = float('inf')
_CONTROL_COST_COEF = 0.1


def _make_model_xml(n_bodies: int, n_actuators: int,
                    random: np.random.RandomState,
                    stiffness_range=(15, 25), damping_range=(0, 0)) -> str:
    """Chain of sliding masses with random joint stiffness
    (lqr.py _make_model)."""
    if n_bodies < 1 or n_actuators < 1:
        raise ValueError('At least 1 body and 1 actuator required.')
    if n_actuators > n_bodies:
        raise ValueError('At most 1 actuator per body.')

    bodies = ''
    motors = ''
    for i in range(n_bodies):
        stiff = random.uniform(*stiffness_range)
        damp = random.uniform(*damping_range)
        pos = '.25 0 .1' if i == 0 else '.25 0 0'
        bodies += (f"<body name='body_{i}' pos='{pos}'>"
                   f"<joint name='joint_{i}' stiffness='{stiff}'"
                   f" damping='{damp}'/>"
                   f"<geom name='geom_{i}'/>")
        if i < n_actuators:
            motors += f"<motor name='motor_{i}' joint='joint_{i}'/>"
    bodies += '</body>' * n_bodies

    return f"""
<mujoco model='LQR'>
  <option timestep='.03'>
    <flag contact='disable' limit='disable'/>
  </option>
  <default>
    <joint type='slide' axis='0 1 0'/>
    <geom type='sphere' size='.1'/>
  </default>
  <worldbody>{bodies}</worldbody>
  <actuator>{motors}</actuator>
</mujoco>
"""


class LQRLevel(base.Task):
    """Quadratic state and control cost on a linear system (JAX lqr.py
    LQRLevel)."""
    # observation and reward read only position/velocity-stage Data
    OBSERVES_ACC = False

    _TERMINAL_TOL = 1e-6

    def __init__(self, control_cost_coef: float):
        if control_cost_coef <= 0:
            raise ValueError('control_cost_coef must be positive.')
        self._control_cost_coef = control_cost_coef

    @property
    def control_cost_coef(self):
        return self._control_cost_coef

    def initialize_episode(self, model, batch, generator):
        """qpos on the sphere of radius sqrt(2), uniformly."""
        unit = torch.randn((batch, model.nq), generator=generator,
                           dtype=model.dtype,
                           device=generator.device).to(model.device)
        qpos = math.sqrt(2) * unit / torch.linalg.vector_norm(
            unit, dim=1, keepdim=True)
        return make_state(model, qpos=qpos), ()

    def get_observation(self, model, phys, data):
        return {'position': phys.qpos, 'velocity': phys.qvel}

    def get_reward(self, model, phys, data, ctrl):
        state_cost = 0.5 * (phys.qpos * phys.qpos).sum(1)
        control_cost = 0.5 * (ctrl * ctrl).sum(1)
        return 1 - (state_cost + control_cost * self._control_cost_coef)

    def get_termination(self, model, phys, data):
        """(terminated (B,) bool, discount (B,)): the state's norm below
        1e-6 ends the episode with discount 0."""
        norm = torch.sqrt((phys.qpos * phys.qpos).sum(1)
                          + (phys.qvel * phys.qvel).sum(1))
        return norm < self._TERMINAL_TOL, torch.zeros_like(norm)


def _make_lqr(n_bodies, n_actuators, time_limit, seed, device,
              environment_kwargs):
    random = np.random.RandomState(seed)
    model = mjcf.parse(_make_model_xml(n_bodies, n_actuators, random))
    return control.Environment(model.to(device),
                               LQRLevel(_CONTROL_COST_COEF),
                               time_limit=time_limit,
                               **(environment_kwargs or {}))


@SUITE.add()
def lqr_2_1(time_limit=_DEFAULT_TIME_LIMIT, seed=None, device='cuda',
            environment_kwargs=None):
    return _make_lqr(2, 1, time_limit, seed, device, environment_kwargs)


@SUITE.add()
def lqr_6_2(time_limit=_DEFAULT_TIME_LIMIT, seed=None, device='cuda',
            environment_kwargs=None):
    return _make_lqr(6, 2, time_limit, seed, device, environment_kwargs)
