"""Two-link planar reacher: easy / hard.

Port of mujoco_mbrl_tpu/suite/reacher.py. The model XML is this package's
own copy of the JAX module's ``_XML`` (a test checks the two are equal).
The target position is drawn per episode and carried as the env params
(B, 2); ``apply_params`` writes it into a per-env ``geom_pos``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..physics import make_state, mjcf
from ..physics import model as M
from . import base, control, randomizers, rewards
from .registry import TaggedTasks

SUITE = TaggedTasks()
_DEFAULT_TIME_LIMIT = 20
_BIG_TARGET = .05
_SMALL_TARGET = .015

_XML = """
<mujoco model='two-link planar reacher'>
  <option timestep='0.02'>
    <flag contact='disable'/>
  </option>
  <default>
    <joint type='hinge' axis='0 0 1' damping='0.01'/>
    <motor gear='.05' ctrlrange='-1 1' ctrllimited='true'/>
  </default>
  <worldbody>
    <camera name='fixed' pos='0 0 .75' quat='1 0 0 0'/>
    <body name='arm' pos='0 0 .01'>
      <geom name='arm' type='capsule' fromto='0 0 0 0.12 0 0' size='.01'/>
      <joint name='shoulder'/>
      <body name='hand' pos='.12 0 0'>
        <geom name='hand' type='capsule' fromto='0 0 0 0.1 0 0' size='.01'/>
        <joint name='wrist' limited='true' range='-160 160'/>
        <body name='finger' pos='.12 0 0'>
          <geom name='finger' type='sphere' size='.01'/>
        </body>
      </body>
    </body>
    <geom name='target' pos='0 0 .01' type='sphere' size='.05'/>
  </worldbody>
  <actuator>
    <motor name='shoulder' joint='shoulder'/>
    <motor name='wrist' joint='wrist'/>
  </actuator>
</mujoco>
"""


def _uniform(generator, batch, lo, hi, dtype, device):
    u = torch.rand((batch,), generator=generator, dtype=dtype,
                   device=generator.device)
    return (lo + (hi - lo) * u).to(device)


class Reacher(base.Task):
    """Reach the randomized target."""
    # observation and reward read only position/velocity-stage Data
    OBSERVES_ACC = False

    def __init__(self, target_size: float):
        self._target_size = target_size

    def initialize_episode(self, model, batch, generator):
        qpos = randomizers.randomize_limited_and_rotational_joints(
            model, model.qpos0.expand(batch, model.nq), generator)
        dt, dev = qpos.dtype, qpos.device
        angle = _uniform(generator, batch, 0.0, 2 * np.pi, dt, dev)
        radius = _uniform(generator, batch, .05, .20, dt, dev)
        target_xy = torch.stack([radius * torch.sin(angle),
                                 radius * torch.cos(angle)], 1)
        return make_state(model, qpos=qpos), target_xy

    def apply_params(self, model, params):
        tid = model.name2id('geom', 'target')
        geom_pos = model.geom_pos.expand(params.shape[0], -1, -1).clone()
        geom_pos[:, tid, :2] = params
        return M.with_env_fields(model, geom_pos=geom_pos)

    def _finger_to_target(self, model, data):
        tid = model.name2id('geom', 'target')
        fid = model.name2id('geom', 'finger')
        return data.geom_xpos[:, tid, :2] - data.geom_xpos[:, fid, :2]

    def get_observation(self, model, phys, data):
        return {
            'position': phys.qpos,
            'to_target': self._finger_to_target(model, data),
            'velocity': phys.qvel,
        }

    def get_reward(self, model, phys, data, ctrl):
        fid = model.name2id('geom', 'finger')
        radii = self._target_size + M.cached(
            model, 'finger_size', lambda: float(model.geom_size[fid, 0]))
        dist = torch.linalg.norm(self._finger_to_target(model, data), dim=-1)
        return rewards.tolerance(dist, (0, radii))


def _env(target_size, time_limit, device, environment_kwargs):
    model = mjcf.parse(_XML)
    # the target size is fixed per task variant: baked into the model
    tid = model.name2id('geom', 'target')
    geom_size = model.geom_size.clone()
    geom_size[tid, 0] = target_size
    model = model.replace(geom_size=geom_size).to(device)
    return control.Environment(model, Reacher(target_size),
                               time_limit=time_limit,
                               **(environment_kwargs or {}))


@SUITE.add('benchmarking', 'easy')
def easy(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
         environment_kwargs=None):
    return _env(_BIG_TARGET, time_limit, device, environment_kwargs)


@SUITE.add('benchmarking')
def hard(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
         environment_kwargs=None):
    return _env(_SMALL_TARGET, time_limit, device, environment_kwargs)
