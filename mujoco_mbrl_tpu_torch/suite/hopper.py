"""Planar hopper domain: stand / hop.

Port of mujoco_mbrl_tpu/suite/hopper.py. The model XML is this package's
own copy of the JAX module's ``_XML`` (a test checks the two are equal).
Its 15 candidate pairs give 21 contact points, so 4 limit rows and 84
pyramid facet rows: 88 constraint rows, which the dense APGD kernel
solves one block per env (``apgd_block_kernel``). The touch sensors at the
toe and heel sites read the solved contact forces, so the task observes
the acceleration stage.
"""

from __future__ import annotations

import torch

from ..physics import make_state, mjcf
from . import base, control, randomizers, rewards, sensors
from .registry import TaggedTasks

SUITE = TaggedTasks()
_CONTROL_TIMESTEP = .02
_DEFAULT_TIME_LIMIT = 20
_STAND_HEIGHT = 0.6
_HOP_SPEED = 2

_XML = """
<mujoco model='planar hopper'>
  <option timestep='0.005'/>
  <default>
    <default class='hopper'>
      <site type='sphere' size='0.05'/>
      <joint type='hinge' axis='0 1 0' limited='true' damping='.05'
             armature='.2'/>
      <geom type='capsule'/>
    </default>
    <default class='free'>
      <joint limited='false' damping='0' armature='0' stiffness='0'/>
    </default>
    <motor ctrlrange='-1 1' ctrllimited='true'/>
  </default>
  <worldbody>
    <camera name='cam0' pos='0 -2.8 0.8' euler='90 0 0' mode='trackcom'/>
    <geom name='floor' type='plane' conaffinity='1' pos='48 0 0'
          size='50 1 .2'/>
    <body name='torso' pos='0 0 1' childclass='hopper'>
      <joint name='rootx' type='slide' axis='1 0 0' class='free'/>
      <joint name='rootz' type='slide' axis='0 0 1' class='free'/>
      <joint name='rooty' type='hinge' axis='0 1 0' class='free'/>
      <geom name='torso' fromto='0 0 -.05 0 0 .2' size='0.0653'/>
      <geom name='nose' fromto='.08 0 .13 .15 0 .14' size='0.03'/>
      <body name='pelvis' pos='0 0 -.05'>
        <joint name='waist' range='-30 30'/>
        <geom name='pelvis' fromto='0 0 0 0 0 -.15' size='0.065'/>
        <body name='thigh' pos='0 0 -.2'>
          <joint name='hip' range='-170 10'/>
          <geom name='thigh' fromto='0 0 0 0 0 -.33' size='0.04'/>
          <body name='calf' pos='0 0 -.33'>
            <joint name='knee' range='5 150'/>
            <geom name='calf' fromto='0 0 0 0 0 -.32' size='0.03'/>
            <body name='foot' pos='0 0 -.32'>
              <joint name='ankle' range='-45 45'/>
              <geom name='foot' fromto='-.08 0 0 .17 0 0' size='0.04'/>
              <site name='touch_toe' pos='.17 0 0'/>
              <site name='touch_heel' pos='-.08 0 0'/>
            </body>
          </body>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor name='waist' joint='waist' gear='30'/>
    <motor name='hip' joint='hip' gear='40'/>
    <motor name='knee' joint='knee' gear='30'/>
    <motor name='ankle' joint='ankle' gear='10'/>
  </actuator>
</mujoco>
"""


def touch(model, data) -> torch.Tensor:
    """(B, 2) log1p of the toe and heel touch sensors."""
    return torch.log1p(torch.stack([
        sensors.touch(model, data, model.name2id('site', 'touch_toe')),
        sensors.touch(model, data, model.name2id('site', 'touch_heel'))],
        1))


def height(model, data) -> torch.Tensor:
    """(B,) torso CoM height over the foot's."""
    torso = model.name2id('body', 'torso')
    foot = model.name2id('body', 'foot')
    return data.xipos[:, torso, 2] - data.xipos[:, foot, 2]


class Hopper(base.Task):
    """Stand upright / hop forward."""

    def __init__(self, hopping: bool):
        self._hopping = hopping

    def initialize_episode(self, model, batch, generator):
        qpos = randomizers.randomize_limited_and_rotational_joints(
            model, model.qpos0.expand(batch, model.nq), generator)
        return make_state(model, qpos=qpos), ()

    def get_observation(self, model, phys, data):
        return {'position': phys.qpos[:, 1:],   # translational invariance
                'velocity': phys.qvel,
                'touch': touch(model, data)}

    def get_reward(self, model, phys, data, ctrl):
        standing = rewards.tolerance(height(model, data), (_STAND_HEIGHT, 2))
        if self._hopping:
            torso = model.name2id('body', 'torso')
            speed = sensors.subtree_linvel(model, data, torso)[:, 0]
            hopping = rewards.tolerance(
                speed, bounds=(_HOP_SPEED, float('inf')),
                margin=_HOP_SPEED / 2, value_at_margin=0.5,
                sigmoid='linear')
            return standing * hopping
        small_control = rewards.tolerance(
            ctrl, margin=1, value_at_margin=0, sigmoid='quadratic').mean(1)
        small_control = (small_control + 4) / 5
        return standing * small_control


def _env(hopping, time_limit, device, environment_kwargs):
    model = mjcf.parse(_XML).to(device)
    kwargs = dict(environment_kwargs or {})
    kwargs.setdefault('control_timestep', _CONTROL_TIMESTEP)
    return control.Environment(model, Hopper(hopping),
                               time_limit=time_limit, **kwargs)


@SUITE.add('benchmarking')
def stand(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
          environment_kwargs=None):
    return _env(False, time_limit, device, environment_kwargs)


@SUITE.add('benchmarking')
def hop(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
        environment_kwargs=None):
    return _env(True, time_limit, device, environment_kwargs)
