"""Humanoid domain: stand / walk / run / run_pure_state.

Port of mujoco_mbrl_tpu/suite/humanoid.py. The model XML is this
package's own copy of the JAX module's ``_XML`` (a test checks the two
are equal): a free-root 3-D humanoid, 21 motors, condim-1 body geoms
against a condim-3 floor. Its 161 candidate pairs give 303 constraint
rows (21 joint limits, 142 condim-1 geom-geom rows, 35 floor pyramids of 4
rows), past the dense APGD kernel's 96-row wall, so every solve takes the
factored kernel's block path (``ops.apgd_solve.factored_route``).
"""

from __future__ import annotations

import torch

from ..physics import make_state, mjcf
from . import base, control, randomizers, rewards, sensors
from .randomizers import first_collision_free
from .registry import TaggedTasks

SUITE = TaggedTasks()
_DEFAULT_TIME_LIMIT = 25
_CONTROL_TIMESTEP = .025
_STAND_HEIGHT = 1.4
_WALK_SPEED = 1
_RUN_SPEED = 10

_XML = """
<mujoco model='humanoid'>
  <option timestep='.005'/>
  <default>
    <motor ctrlrange='-1 1' ctrllimited='true'/>
    <default class='body'>
      <geom type='capsule' condim='1' friction='.7'
            solimp='.9 .99 .003' solref='.015 1'/>
      <joint type='hinge' damping='.2' stiffness='1' armature='.01'
             limited='true' solimplimit='0 .99 .01'/>
      <default class='big_joint'>
        <joint damping='5' stiffness='10'/>
        <default class='big_stiff_joint'>
          <joint stiffness='20'/>
        </default>
      </default>
    </default>
  </default>
  <worldbody>
    <geom name='floor' type='plane' conaffinity='1' size='100 100 .2'/>
    <body name='torso' pos='0 0 1.5' childclass='body'>
      <freejoint name='root'/>
      <geom name='torso' fromto='0 -.07 0 0 .07 0' size='.07'/>
      <geom name='upper_waist' fromto='-.01 -.06 -.12 -.01 .06 -.12'
            size='.06'/>
      <body name='head' pos='0 0 .19'>
        <geom name='head' type='sphere' size='.09'/>
      </body>
      <body name='lower_waist' pos='-.01 0 -.260' quat='1.000 0 -.002 0'>
        <geom name='lower_waist' fromto='0 -.06 0 0 .06 0' size='.06'/>
        <joint name='abdomen_z' pos='0 0 .065' axis='0 0 1' range='-45 45'
               class='big_stiff_joint'/>
        <joint name='abdomen_y' pos='0 0 .065' axis='0 1 0' range='-75 30'
               class='big_joint'/>
        <body name='pelvis' pos='0 0 -.165' quat='1.000 0 -.002 0'>
          <joint name='abdomen_x' pos='0 0 .1' axis='1 0 0' range='-35 35'
                 class='big_joint'/>
          <geom name='butt' fromto='-.02 -.07 0 -.02 .07 0' size='.09'/>
          <body name='right_thigh' pos='0 -.1 -.04'>
            <joint name='right_hip_x' axis='1 0 0' range='-25 5'
                   class='big_joint'/>
            <joint name='right_hip_z' axis='0 0 1' range='-60 35'
                   class='big_joint'/>
            <joint name='right_hip_y' axis='0 1 0' range='-110 20'
                   class='big_stiff_joint'/>
            <geom name='right_thigh' fromto='0 0 0 0 .01 -.34' size='.06'/>
            <body name='right_shin' pos='0 .01 -.403'>
              <joint name='right_knee' pos='0 0 .02' axis='0 -1 0'
                     range='-160 2'/>
              <geom name='right_shin' fromto='0 0 0 0 0 -.3' size='.049'/>
              <body name='right_foot' pos='0 0 -.39'>
                <joint name='right_ankle_y' pos='0 0 .08' axis='0 1 0'
                       range='-50 50' stiffness='6'/>
                <joint name='right_ankle_x' pos='0 0 .04' axis='1 0 .5'
                       range='-50 50' stiffness='3'/>
                <geom name='right_right_foot' fromto='-.07 -.02 0 .14 -.04 0'
                      size='.027'/>
                <geom name='left_right_foot' fromto='-.07 0 0 .14 .02 0'
                      size='.027'/>
              </body>
            </body>
          </body>
          <body name='left_thigh' pos='0 .1 -.04'>
            <joint name='left_hip_x' axis='-1 0 0' range='-25 5'
                   class='big_joint'/>
            <joint name='left_hip_z' axis='0 0 -1' range='-60 35'
                   class='big_joint'/>
            <joint name='left_hip_y' axis='0 1 0' range='-120 20'
                   class='big_stiff_joint'/>
            <geom name='left_thigh' fromto='0 0 0 0 -.01 -.34' size='.06'/>
            <body name='left_shin' pos='0 -.01 -.403'>
              <joint name='left_knee' pos='0 0 .02' axis='0 -1 0'
                     range='-160 2'/>
              <geom name='left_shin' fromto='0 0 0 0 0 -.3' size='.049'/>
              <body name='left_foot' pos='0 0 -.39'>
                <joint name='left_ankle_y' pos='0 0 .08' axis='0 1 0'
                       range='-50 50' stiffness='6'/>
                <joint name='left_ankle_x' pos='0 0 .04' axis='1 0 .5'
                       range='-50 50' stiffness='3'/>
                <geom name='left_left_foot' fromto='-.07 .02 0 .14 .04 0'
                      size='.027'/>
                <geom name='right_left_foot' fromto='-.07 0 0 .14 -.02 0'
                      size='.027'/>
              </body>
            </body>
          </body>
        </body>
      </body>
      <body name='right_upper_arm' pos='0 -.17 .06'>
        <joint name='right_shoulder1' axis='2 1 1' range='-85 60'/>
        <joint name='right_shoulder2' axis='0 -1 1' range='-85 60'/>
        <geom name='right_upper_arm' fromto='0 0 0 .16 -.16 -.16'
              size='.04 .16'/>
        <body name='right_lower_arm' pos='.18 -.18 -.18'>
          <joint name='right_elbow' axis='0 -1 1' range='-90 50'
                 stiffness='0'/>
          <geom name='right_lower_arm' fromto='.01 .01 .01 .17 .17 .17'
                size='.031'/>
          <body name='right_hand' pos='.18 .18 .18'>
            <geom name='right_hand' type='sphere' size='.04'/>
          </body>
        </body>
      </body>
      <body name='left_upper_arm' pos='0 .17 .06'>
        <joint name='left_shoulder1' axis='2 -1 1' range='-60 85'/>
        <joint name='left_shoulder2' axis='0 1 1' range='-60 85'/>
        <geom name='left_upper_arm' fromto='0 0 0 .16 .16 -.16'
              size='.04 .16'/>
        <body name='left_lower_arm' pos='.18 .18 -.18'>
          <joint name='left_elbow' axis='0 -1 -1' range='-90 50'
                 stiffness='0'/>
          <geom name='left_lower_arm' fromto='.01 -.01 .01 .17 -.17 .17'
                size='.031'/>
          <body name='left_hand' pos='.18 -.18 .18'>
            <geom name='left_hand' type='sphere' size='.04'/>
          </body>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor name='abdomen_y' gear='40' joint='abdomen_y'/>
    <motor name='abdomen_z' gear='40' joint='abdomen_z'/>
    <motor name='abdomen_x' gear='40' joint='abdomen_x'/>
    <motor name='right_hip_x' gear='40' joint='right_hip_x'/>
    <motor name='right_hip_z' gear='40' joint='right_hip_z'/>
    <motor name='right_hip_y' gear='120' joint='right_hip_y'/>
    <motor name='right_knee' gear='80' joint='right_knee'/>
    <motor name='right_ankle_x' gear='20' joint='right_ankle_x'/>
    <motor name='right_ankle_y' gear='20' joint='right_ankle_y'/>
    <motor name='left_hip_x' gear='40' joint='left_hip_x'/>
    <motor name='left_hip_z' gear='40' joint='left_hip_z'/>
    <motor name='left_hip_y' gear='120' joint='left_hip_y'/>
    <motor name='left_knee' gear='80' joint='left_knee'/>
    <motor name='left_ankle_x' gear='20' joint='left_ankle_x'/>
    <motor name='left_ankle_y' gear='20' joint='left_ankle_y'/>
    <motor name='right_shoulder1' gear='20' joint='right_shoulder1'/>
    <motor name='right_shoulder2' gear='20' joint='right_shoulder2'/>
    <motor name='right_elbow' gear='40' joint='right_elbow'/>
    <motor name='left_shoulder1' gear='20' joint='left_shoulder1'/>
    <motor name='left_shoulder2' gear='20' joint='left_shoulder2'/>
    <motor name='left_elbow' gear='40' joint='left_elbow'/>
  </actuator>
</mujoco>
"""


class Humanoid(base.Task):
    """Stand / move at a target CoM speed (JAX humanoid.py Humanoid)."""
    # observation and reward read only position/velocity-stage Data
    OBSERVES_ACC = False

    _INIT_ATTEMPTS = 8

    def __init__(self, move_speed: float, pure_state: bool):
        self._move_speed = move_speed
        self._pure_state = pure_state

    def initialize_episode(self, model, batch, generator):
        """Collision-free random configurations by lockstep rejection
        sampling: ``_INIT_ATTEMPTS`` draws an env, the first without
        penetration kept."""
        q0 = model.qpos0.expand(self._INIT_ATTEMPTS * batch, model.nq)
        qposes = randomizers.randomize_limited_and_rotational_joints(
            model, q0, generator)
        qpos = first_collision_free(
            model, qposes.reshape(self._INIT_ATTEMPTS, batch, model.nq))
        return make_state(model, qpos=qpos), ()

    def _extremities(self, model, data):
        """Hands and feet relative to the torso, in its frame (B, 12)."""
        torso = model.name2id('body', 'torso')
        ids = [model.name2id('body', side + limb)
               for side in ('left_', 'right_') for limb in ('hand', 'foot')]
        rel = data.xpos[:, ids] - data.xpos[:, torso, None]
        return torch.einsum('bki,bij->bkj', rel,
                            data.ximat[:, torso]).reshape(rel.shape[0], -1)

    def get_observation(self, model, phys, data):
        if self._pure_state:
            return {'position': phys.qpos, 'velocity': phys.qvel}
        torso = model.name2id('body', 'torso')
        head = model.name2id('body', 'head')
        return {
            'joint_angles': phys.qpos[:, 7:],
            'head_height': data.xpos[:, head, 2],
            'extremities': self._extremities(model, data),
            'torso_vertical': data.ximat[:, torso, 2, :],
            'com_velocity': sensors.subtree_linvel(model, data, torso),
            'velocity': phys.qvel,
        }

    def get_reward(self, model, phys, data, ctrl):
        torso = model.name2id('body', 'torso')
        head = model.name2id('body', 'head')
        standing = rewards.tolerance(
            data.xpos[:, head, 2], bounds=(_STAND_HEIGHT, float('inf')),
            margin=_STAND_HEIGHT / 4)
        upright = rewards.tolerance(
            data.ximat[:, torso, 2, 2], bounds=(0.9, float('inf')),
            sigmoid='linear', margin=1.9, value_at_margin=0)
        stand_reward = standing * upright
        small_control = rewards.tolerance(
            ctrl, margin=1, value_at_margin=0, sigmoid='quadratic').mean(-1)
        small_control = (4 + small_control) / 5
        com_v = sensors.subtree_linvel(model, data, torso)[:, :2]
        if self._move_speed == 0:
            dont_move = rewards.tolerance(com_v, margin=2).mean(-1)
            return small_control * stand_reward * dont_move
        move = rewards.tolerance(
            torch.linalg.vector_norm(com_v, dim=-1),
            bounds=(self._move_speed, float('inf')),
            margin=self._move_speed, value_at_margin=0, sigmoid='linear')
        move = (5 * move + 1) / 6
        return small_control * stand_reward * move


def _env(move_speed, pure_state, time_limit, device, environment_kwargs):
    model = mjcf.parse(_XML).to(device)
    kwargs = dict(environment_kwargs or {})
    kwargs.setdefault('control_timestep', _CONTROL_TIMESTEP)
    return control.Environment(model, Humanoid(move_speed, pure_state),
                               time_limit=time_limit, **kwargs)


@SUITE.add('benchmarking')
def stand(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
          environment_kwargs=None):
    return _env(0, False, time_limit, device, environment_kwargs)


@SUITE.add('benchmarking')
def walk(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
         environment_kwargs=None):
    return _env(_WALK_SPEED, False, time_limit, device, environment_kwargs)


@SUITE.add('benchmarking')
def run(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
        environment_kwargs=None):
    return _env(_RUN_SPEED, False, time_limit, device, environment_kwargs)


@SUITE.add()
def run_pure_state(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
                   environment_kwargs=None):
    return _env(_RUN_SPEED, True, time_limit, device, environment_kwargs)
