"""Cartpole domain: balance / balance_sparse / swingup / swingup_sparse /
two_poles / three_poles.

Port of mujoco_mbrl_tpu/suite/cartpole.py. ``_make_model_xml`` is this
package's own copy of the JAX module's (a test checks the two give the
same XML). The model steps with RK4 (four forward passes a step, each
solving the slider's one limit row cold) and has contacts disabled.
"""

from __future__ import annotations

import numpy as np
import torch

from ..physics import make_state, mjcf
from . import base, control, rewards
from .registry import TaggedTasks

SUITE = TaggedTasks()
_DEFAULT_TIME_LIMIT = 10


def _make_model_xml(n_poles: int = 1) -> str:
    pole_bodies = ''
    inner = ''
    for i in range(1, n_poles + 1):
        inner += (f"<body name='pole_{i}' pos='0 0 {1 if i > 1 else 0}'>"
                  f"<joint name='hinge_{i}' type='hinge' axis='0 1 0'"
                  f" damping='2e-6'/>"
                  f"<geom name='pole_{i}' type='capsule'"
                  f" fromto='0 0 0 0 0 1' size='0.045' mass='.1'/>")
    pole_bodies = inner + '</body>' * n_poles
    return f"""
<mujoco model='cart-pole'>
  <option timestep='0.01' integrator='RK4'>
    <flag contact='disable'/>
  </option>
  <worldbody>
    <camera name='fixed' pos='0 -4 1' zaxis='0 -1 0'/>
    <body name='cart' pos='0 0 1'>
      <joint name='slider' type='slide' limited='true' axis='1 0 0'
             range='-1.8 1.8' solreflimit='.08 1' damping='5e-4'/>
      <geom name='cart' type='box' size='0.2 0.15 0.1' mass='1'/>
      {pole_bodies}
    </body>
  </worldbody>
  <actuator>
    <motor name='slide' joint='slider' gear='10' ctrllimited='true'
           ctrlrange='-1 1'/>
  </actuator>
</mujoco>
"""


def _normal(generator, shape, dtype, device):
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device).to(device)


def _uniform(generator, shape, lo, hi, dtype, device):
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    return (lo + (hi - lo) * u).to(device)


class Balance(base.Task):
    """Balance or swing up the pole(s); smooth or sparse reward."""
    # observation and reward read only position/velocity-stage Data
    OBSERVES_ACC = False

    _CART_RANGE = (-.25, .25)
    _ANGLE_COSINE_RANGE = (.995, 1)

    def __init__(self, swing_up: bool, sparse: bool, n_poles: int = 1):
        self._swing_up = swing_up
        self._sparse = sparse
        self._n_poles = n_poles

    def initialize_episode(self, model, batch, generator):
        nv, dt, dev = model.nv, model.dtype, model.device
        qpos = torch.zeros((batch, model.nq), dtype=dt, device=dev)
        if self._swing_up:
            qpos[:, 0] = .01 * _normal(generator, (batch,), dt, dev)
            qpos[:, 1] = np.pi + .01 * _normal(generator, (batch,), dt, dev)
            if nv > 2:
                qpos[:, 2:] = .1 * _normal(generator, (batch, nv - 2), dt,
                                           dev)
        else:
            qpos[:, 0] = _uniform(generator, (batch,), -.1, .1, dt, dev)
            qpos[:, 1:] = _uniform(generator, (batch, nv - 1), -.034, .034,
                                   dt, dev)
        qvel = .01 * _normal(generator, (batch, nv), dt, dev)
        return make_state(model, qpos=qpos, qvel=qvel), ()

    def _pole_angle_cosine(self, data):
        # zz of the pole bodies' rotations (bodies 2:)
        return data.ximat[:, 2:, 2, 2]

    def _bounded_position(self, phys, data):
        zz_xz = data.ximat[:, 2:, (2, 0), 2]    # [zz, xz] per pole
        return torch.cat([phys.qpos[:, 0:1],
                          zz_xz.reshape(zz_xz.shape[0], -1)], 1)

    def get_observation(self, model, phys, data):
        return {'position': self._bounded_position(phys, data),
                'velocity': phys.qvel}

    def get_reward(self, model, phys, data, ctrl):
        cart_position = phys.qpos[:, 0]
        if self._sparse:
            cart_in_bounds = rewards.tolerance(cart_position,
                                               self._CART_RANGE)
            angle_in_bounds = rewards.tolerance(
                self._pole_angle_cosine(data),
                self._ANGLE_COSINE_RANGE).prod(1)
            return cart_in_bounds * angle_in_bounds
        upright = (self._pole_angle_cosine(data) + 1) / 2
        centered = (1 + rewards.tolerance(cart_position, margin=2)) / 2
        small_control = rewards.tolerance(ctrl, margin=1, value_at_margin=0,
                                          sigmoid='quadratic')[:, 0]
        small_control = (4 + small_control) / 5
        small_velocity = rewards.tolerance(phys.qvel[:, 1:],
                                           margin=5).min(1).values
        small_velocity = (1 + small_velocity) / 2
        return upright.mean(1) * small_control * small_velocity * centered


def _env(swing_up, sparse, n_poles, time_limit, device, environment_kwargs):
    model = mjcf.parse(_make_model_xml(n_poles)).to(device)
    task = Balance(swing_up=swing_up, sparse=sparse, n_poles=n_poles)
    return control.Environment(model, task, time_limit=time_limit,
                               **(environment_kwargs or {}))


@SUITE.add('benchmarking')
def balance(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
            environment_kwargs=None):
    return _env(False, False, 1, time_limit, device, environment_kwargs)


@SUITE.add('benchmarking')
def balance_sparse(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
                   environment_kwargs=None):
    return _env(False, True, 1, time_limit, device, environment_kwargs)


@SUITE.add('benchmarking')
def swingup(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
            environment_kwargs=None):
    return _env(True, False, 1, time_limit, device, environment_kwargs)


@SUITE.add('benchmarking')
def swingup_sparse(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
                   environment_kwargs=None):
    return _env(True, True, 1, time_limit, device, environment_kwargs)


@SUITE.add()
def two_poles(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
              environment_kwargs=None):
    return _env(True, False, 2, time_limit, device, environment_kwargs)


@SUITE.add()
def three_poles(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
                environment_kwargs=None):
    return _env(True, False, 3, time_limit, device, environment_kwargs)
