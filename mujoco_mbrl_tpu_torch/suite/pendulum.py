"""Pendulum swingup domain.

Port of mujoco_mbrl_tpu/suite/pendulum.py. The model XML is this package's
own copy of the JAX module's ``_XML`` (a test checks the two are equal).
"""

from __future__ import annotations

import numpy as np
import torch

from ..physics import make_state, mjcf
from . import base, control, rewards
from .registry import TaggedTasks

SUITE = TaggedTasks()
_DEFAULT_TIME_LIMIT = 20
_ANGLE_BOUND = 8
_COSINE_BOUND = float(np.cos(np.deg2rad(_ANGLE_BOUND)))

_XML = """
<mujoco model='pendulum'>
  <option timestep='0.02'>
    <flag contact='disable'/>
  </option>
  <worldbody>
    <camera name='fixed' pos='0 -1.5 2' xyaxes='1 0 0 0 1 1'/>
    <body name='pole' pos='0 0 .6'>
      <joint name='hinge' type='hinge' axis='0 1 0' damping='0.1'/>
      <geom name='pole' type='capsule' fromto='0 0 0 0 0 0.5'
            size='0.02' mass='0'/>
      <geom name='mass' type='sphere' pos='0 0 0.5' size='0.05' mass='1'/>
    </body>
  </worldbody>
  <actuator>
    <motor name='torque' joint='hinge' gear='1' ctrlrange='-1 1'
           ctrllimited='true'/>
  </actuator>
</mujoco>
"""


class SwingUp(base.Task):
    """Swing up and balance the pole."""
    # observation and reward read only position/velocity-stage Data
    OBSERVES_ACC = False

    def initialize_episode(self, model, batch, generator):
        u = torch.rand((batch,), generator=generator, dtype=model.dtype,
                       device=generator.device).to(model.device)
        qpos = torch.zeros((batch, model.nq), dtype=model.dtype,
                           device=model.device)
        qpos[:, 0] = -np.pi + 2 * np.pi * u
        return make_state(model, qpos=qpos), ()

    def get_observation(self, model, phys, data):
        pole = model.name2id('body', 'pole')
        orientation = data.ximat[:, pole, [2, 0], 2]    # [zz, xz]
        return {'orientation': orientation, 'velocity': phys.qvel}

    def get_reward(self, model, phys, data, ctrl):
        pole = model.name2id('body', 'pole')
        return rewards.tolerance(data.ximat[:, pole, 2, 2],
                                 (_COSINE_BOUND, 1))


@SUITE.add('benchmarking')
def swingup(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
            environment_kwargs=None):
    model = mjcf.parse(_XML).to(device)
    return control.Environment(model, SwingUp(), time_limit=time_limit,
                               **(environment_kwargs or {}))
