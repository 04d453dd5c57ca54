"""Acrobot domain: swingup / swingup_sparse.

Port of mujoco_mbrl_tpu/suite/acrobot.py. The model XML is this package's
own copy of the JAX module's ``_XML`` (a test checks the two are equal):
RK4, contacts and limits disabled (no constraint row), the sites
``target`` and ``tip`` that the reward reads.
"""

from __future__ import annotations

import numpy as np
import torch

from ..physics import make_state, mjcf
from . import base, control, rewards
from .registry import TaggedTasks

SUITE = TaggedTasks()
_DEFAULT_TIME_LIMIT = 10

# constraint disable in the reference flags both contacts and limits off
_XML = """
<mujoco model='acrobot'>
  <option timestep='0.01' integrator='RK4'>
    <flag contact='disable' limit='disable'/>
  </option>
  <default>
    <joint damping='.05'/>
    <geom type='capsule' mass='1'/>
  </default>
  <worldbody>
    <site name='target' pos='0 0 4' size='0.2'/>
    <body name='upper_arm' pos='0 0 2'>
      <joint name='shoulder' type='hinge' axis='0 1 0'/>
      <geom name='upper_arm' fromto='0 0 0 0 0 1' size='0.05'/>
      <body name='lower_arm' pos='0 0 1'>
        <joint name='elbow' type='hinge' axis='0 1 0'/>
        <geom name='lower_arm' fromto='0 0 0 0 0 1' size='0.049'/>
        <site name='tip' pos='0 0 1' size='0.01'/>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor name='elbow' joint='elbow' gear='2' ctrllimited='true'
           ctrlrange='-1 1'/>
  </actuator>
</mujoco>
"""
_TARGET_RADIUS = 0.2


class Balance(base.Task):
    """Swing up and balance the unactuated-shoulder double pendulum."""
    # observation and reward read only position/velocity-stage Data
    OBSERVES_ACC = False

    def __init__(self, sparse: bool):
        self._sparse = sparse

    def initialize_episode(self, model, batch, generator):
        u = torch.rand((batch, 2), generator=generator, dtype=model.dtype,
                       device=generator.device).to(model.device)
        return make_state(model, qpos=-np.pi + 2 * np.pi * u), ()

    def _orientations(self, model, data):
        arms = [model.name2id('body', 'upper_arm'),
                model.name2id('body', 'lower_arm')]
        horizontal = data.ximat[:, arms, 0, 2]     # xz
        vertical = data.ximat[:, arms, 2, 2]       # zz
        return torch.cat([horizontal, vertical], 1)

    def get_observation(self, model, phys, data):
        return {'orientations': self._orientations(model, data),
                'velocity': phys.qvel}

    def get_reward(self, model, phys, data, ctrl):
        target = model.name2id('site', 'target')
        tip = model.name2id('site', 'tip')
        to_target = torch.linalg.vector_norm(
            data.site_xpos[:, target] - data.site_xpos[:, tip], dim=-1)
        return rewards.tolerance(to_target, (0, _TARGET_RADIUS),
                                 margin=0 if self._sparse else 1)


def _env(sparse, time_limit, device, environment_kwargs):
    model = mjcf.parse(_XML).to(device)
    return control.Environment(model, Balance(sparse), time_limit=time_limit,
                               **(environment_kwargs or {}))


@SUITE.add('benchmarking')
def swingup(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
            environment_kwargs=None):
    return _env(False, time_limit, device, environment_kwargs)


@SUITE.add('benchmarking')
def swingup_sparse(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
                   environment_kwargs=None):
    return _env(True, time_limit, device, environment_kwargs)
