"""Planar walker domain: stand / walk / run.

Port of mujoco_mbrl_tpu/suite/walker.py. The model XML is this package's
own copy of the JAX module's ``_XML`` (a test checks the two are equal).
"""

from __future__ import annotations

from ..physics import make_state, mjcf
from . import base, control, randomizers, rewards, sensors
from .registry import TaggedTasks

SUITE = TaggedTasks()
_DEFAULT_TIME_LIMIT = 25
_CONTROL_TIMESTEP = .025
_STAND_HEIGHT = 1.2
_WALK_SPEED = 1
_RUN_SPEED = 8

_XML = """
<mujoco model='planar walker'>
  <option timestep='0.0025'/>
  <default>
    <joint damping='.1' armature='0.01' limited='true'
           solimplimit='0 .99 .01'/>
    <geom contype='1' conaffinity='0' friction='.7 .1 .1'/>
    <motor ctrlrange='-1 1' ctrllimited='true'/>
    <default class='walker'>
      <geom type='capsule'/>
      <joint axis='0 -1 0'/>
    </default>
  </default>
  <worldbody>
    <geom name='floor' type='plane' conaffinity='1' pos='248 0 0'
          size='250 .8 .2' zaxis='0 0 1'/>
    <body name='torso' pos='0 0 1.3' childclass='walker'>
      <camera name='side' pos='0 -2 .7' euler='60 0 0' mode='trackcom'/>
      <camera name='back' pos='-2 0 .5' xyaxes='0 -1 0 1 0 3' mode='trackcom'/>
      <joint name='rootz' axis='0 0 1' type='slide' limited='false'
             armature='0' damping='0'/>
      <joint name='rootx' axis='1 0 0' type='slide' limited='false'
             armature='0' damping='0'/>
      <joint name='rooty' axis='0 1 0' type='hinge' limited='false'
             armature='0' damping='0'/>
      <geom name='torso' size='0.07 0.3'/>
      <body name='right_thigh' pos='0 -.05 -0.3'>
        <joint name='right_hip' range='-20 100'/>
        <geom name='right_thigh' pos='0 0 -0.225' size='0.05 0.225'/>
        <body name='right_leg' pos='0 0 -0.7'>
          <joint name='right_knee' pos='0 0 0.25' range='-150 0'/>
          <geom name='right_leg' size='0.04 0.25'/>
          <body name='right_foot' pos='0.06 0 -0.25'>
            <joint name='right_ankle' pos='-0.06 0 0' range='-45 45'/>
            <geom name='right_foot' zaxis='1 0 0' size='0.05 0.1'/>
          </body>
        </body>
      </body>
      <body name='left_thigh' pos='0 .05 -0.3'>
        <joint name='left_hip' range='-20 100'/>
        <geom name='left_thigh' pos='0 0 -0.225' size='0.05 0.225'/>
        <body name='left_leg' pos='0 0 -0.7'>
          <joint name='left_knee' pos='0 0 0.25' range='-150 0'/>
          <geom name='left_leg' size='0.04 0.25'/>
          <body name='left_foot' pos='0.06 0 -0.25'>
            <joint name='left_ankle' pos='-0.06 0 0' range='-45 45'/>
            <geom name='left_foot' zaxis='1 0 0' size='0.05 0.1'/>
          </body>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor name='right_hip' joint='right_hip' gear='100'/>
    <motor name='right_knee' joint='right_knee' gear='50'/>
    <motor name='right_ankle' joint='right_ankle' gear='20'/>
    <motor name='left_hip' joint='left_hip' gear='100'/>
    <motor name='left_knee' joint='left_knee' gear='50'/>
    <motor name='left_ankle' joint='left_ankle' gear='20'/>
  </actuator>
</mujoco>
"""


class PlanarWalker(base.Task):
    """Stand upright (+optionally move at a target horizontal speed)."""
    # observation and reward read only position/velocity-stage Data
    OBSERVES_ACC = False

    def __init__(self, move_speed: float):
        self._move_speed = move_speed

    def initialize_episode(self, model, batch, generator):
        qpos = randomizers.randomize_limited_and_rotational_joints(
            model, model.qpos0.expand(batch, model.nq), generator)
        return make_state(model, qpos=qpos), ()

    def get_observation(self, model, phys, data):
        B = phys.qpos.shape[0]
        torso = model.name2id('body', 'torso')
        # planar orientations of all non-world bodies: xmat xx, xz entries
        return {
            'orientations': data.ximat[:, 1:, 0][:, :, [0, 2]].reshape(B, -1),
            'height': data.xpos[:, torso, 2],
            'velocity': phys.qvel,
        }

    def get_reward(self, model, phys, data, ctrl):
        torso = model.name2id('body', 'torso')
        standing = rewards.tolerance(
            data.xpos[:, torso, 2], bounds=(_STAND_HEIGHT, float('inf')),
            margin=_STAND_HEIGHT / 2)
        upright = (1 + data.ximat[:, torso, 2, 2]) / 2
        stand_reward = (3 * standing + upright) / 4
        if self._move_speed == 0:
            return stand_reward
        speed = sensors.subtree_linvel(model, data, torso)[:, 0]
        move_reward = rewards.tolerance(
            speed, bounds=(self._move_speed, float('inf')),
            margin=self._move_speed / 2, value_at_margin=0.5,
            sigmoid='linear')
        return stand_reward * (5 * move_reward + 1) / 6


def _env(move_speed, time_limit, device, environment_kwargs):
    model = mjcf.parse(_XML).to(device)
    kwargs = dict(environment_kwargs or {})
    kwargs.setdefault('control_timestep', _CONTROL_TIMESTEP)
    return control.Environment(model, PlanarWalker(move_speed),
                               time_limit=time_limit, **kwargs)


@SUITE.add('benchmarking')
def stand(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
          environment_kwargs=None):
    return _env(0, time_limit, device, environment_kwargs)


@SUITE.add('benchmarking')
def walk(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
         environment_kwargs=None):
    return _env(_WALK_SPEED, time_limit, device, environment_kwargs)


@SUITE.add('benchmarking')
def run(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
        environment_kwargs=None):
    return _env(_RUN_SPEED, time_limit, device, environment_kwargs)
