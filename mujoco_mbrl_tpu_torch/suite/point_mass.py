"""Planar point-mass domain: easy / hard.

Port of mujoco_mbrl_tpu/suite/point_mass.py. The model XML is this
package's own copy of the JAX module's ``_XML`` (a test checks the two are
equal). The env params are the target xy (B, 2), at the origin unless a
goal-state agent moves it; `hard` also draws the two actuators' tendon
directions per episode, carried as params (target_xy, tendon_moment (B, 2,
2)) and applied as a per-env ``tendon_moment``.
"""

from __future__ import annotations

import torch

from ..physics import make_state, mjcf
from ..physics import model as M
from . import base, control, randomizers, rewards
from .registry import TaggedTasks

SUITE = TaggedTasks()
_DEFAULT_TIME_LIMIT = 20
_DIRECTION_TRIALS = 20

_XML = """
<mujoco model='planar point mass'>
  <option timestep='0.02'>
    <flag contact='disable'/>
  </option>
  <default>
    <joint type='hinge' axis='0 0 1' limited='true' range='-.29 .29'
           damping='1'/>
    <motor gear='.1' ctrlrange='-1 1' ctrllimited='true'/>
  </default>
  <worldbody>
    <camera name='fixed' pos='0 0 .75' quat='1 0 0 0'/>
    <body name='pointmass' pos='0 0 .01'>
      <joint name='root_x' type='slide' pos='0 0 0' axis='1 0 0'/>
      <joint name='root_y' type='slide' pos='0 0 0' axis='0 1 0'/>
      <geom name='pointmass' type='sphere' size='.01' mass='.3'/>
    </body>
    <geom name='target' pos='0 0 .01' type='sphere' size='.015'/>
  </worldbody>
  <tendon>
    <fixed name='t1'>
      <joint joint='root_x' coef='1'/>
      <joint joint='root_y' coef='0'/>
    </fixed>
    <fixed name='t2'>
      <joint joint='root_x' coef='0'/>
      <joint joint='root_y' coef='1'/>
    </fixed>
  </tendon>
  <actuator>
    <motor name='t1' tendon='t1'/>
    <motor name='t2' tendon='t2'/>
  </actuator>
</mujoco>
"""


def tendon_directions(normals1: torch.Tensor,
                      normals2: torch.Tensor) -> torch.Tensor:
    """(B, 2, 2) actuation directions from standard normals: dir1 =
    normals1 (B, 2) normalised, dir2 the first of the 20 normalised
    candidates normals2 (B, 20, 2) with |cand . dir1| <= 0.9 (the first
    candidate when none is), as the JAX task's fixed-trial rejection
    sampling picks it."""
    dir1 = normals1 / torch.linalg.norm(normals1, dim=-1, keepdim=True)
    cands = normals2 / torch.linalg.norm(normals2, dim=-1, keepdim=True)
    ok = (cands @ dir1[:, :, None])[..., 0].abs() <= 0.9       # (B, 20)
    idx = torch.argmax(ok.to(torch.int8), dim=1)                # first True
    dir2 = cands[torch.arange(cands.shape[0]), idx]
    return torch.stack([dir1, dir2], 1)


class PointMass(base.Task):
    """Reach the target with smooth reward."""
    # observation and reward read only position/velocity-stage Data
    OBSERVES_ACC = False

    def __init__(self, randomize_gains: bool):
        self._randomize_gains = randomize_gains

    def initialize_episode(self, model, batch, generator):
        qpos = randomizers.randomize_limited_and_rotational_joints(
            model, model.qpos0.expand(batch, model.nq), generator)
        state = make_state(model, qpos=qpos)
        target_xy = torch.zeros((batch, 2), dtype=qpos.dtype,
                                device=qpos.device)
        if not self._randomize_gains:
            return state, target_xy
        normal = lambda *shape: torch.randn(
            (batch,) + shape, generator=generator, dtype=qpos.dtype,
            device=generator.device).to(qpos.device)
        moment = tendon_directions(normal(2), normal(_DIRECTION_TRIALS, 2))
        return state, (target_xy, moment)

    def apply_params(self, model, params):
        fields = {}
        if self._randomize_gains:
            params, fields['tendon_moment'] = params
        tid = model.name2id('geom', 'target')
        geom_pos = model.geom_pos.expand(params.shape[0], -1, -1).clone()
        geom_pos[:, tid, :2] = params
        return M.with_env_fields(model, geom_pos=geom_pos, **fields)

    def get_observation(self, model, phys, data):
        return {'position': phys.qpos, 'velocity': phys.qvel}

    def get_reward(self, model, phys, data, ctrl):
        target = model.name2id('geom', 'target')
        mass = model.name2id('geom', 'pointmass')
        target_size = M.cached(model, 'target_size', lambda: float(
            model.geom_size[target, 0]))
        dist = torch.linalg.norm(
            data.geom_xpos[:, target] - data.geom_xpos[:, mass], dim=-1)
        near_target = rewards.tolerance(
            dist, (0, target_size), margin=target_size)
        control_reward = rewards.tolerance(
            ctrl, margin=1, value_at_margin=0, sigmoid='quadratic').mean(-1)
        small_control = (control_reward + 4) / 5
        return near_target * small_control


def _env(randomize_gains, time_limit, device, environment_kwargs):
    model = mjcf.parse(_XML).to(device)
    return control.Environment(model, PointMass(randomize_gains),
                               time_limit=time_limit,
                               **(environment_kwargs or {}))


@SUITE.add('benchmarking', 'easy')
def easy(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
         environment_kwargs=None):
    return _env(False, time_limit, device, environment_kwargs)


@SUITE.add()
def hard(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
         environment_kwargs=None):
    return _env(True, time_limit, device, environment_kwargs)
