"""Planar manipulator domain: bring_ball / bring_peg / insert_ball /
insert_peg.

Port of mujoco_mbrl_tpu/suite/manipulator.py. The props and
``_make_model_xml`` are this package's own copies of the JAX module's (a
test checks the XML they make is equal), shared with the stacker. The
hand's two fingers are coupled by a tendon-equality row; with it the
model stays in the dense regime at any row count, as in JAX: bring_ball's
118 candidate pairs give 148 contact points, so 1 equality row, 7 joint
limits and 148 cone triples, 452 constraint rows, which #1 solves one
block per env with Ad in device memory (insert_peg: 833 rows, with its
slot's box pairs). The touch sensors read the solved contact forces, so
the task observes the acceleration stage: a control step of 10 substeps
runs 11 solves. The reset draws 8 attempts an env and keeps its first
without penetration (the target and receptacle at their model poses, as
JAX checks them); the episode's target (x, z, angle) moves the target
body, and for the insert tasks the receptacle, per env (``body_pos`` /
``body_quat`` through ``model.with_env_fields``).
"""

from __future__ import annotations

import math

import torch

from ..physics import make_state, mjcf
from ..physics import model as M
from . import base, control, randomizers, rewards, sensors
from .registry import TaggedTasks

SUITE = TaggedTasks()
_CLOSE = .01
_CONTROL_TIMESTEP = .01
_TIME_LIMIT = 10
_P_IN_HAND = .1
_P_IN_TARGET = .1
_ARM_JOINTS = ['arm_root', 'arm_shoulder', 'arm_elbow', 'arm_wrist',
               'finger', 'fingertip', 'thumb', 'thumbtip']
_TOUCH_SITES = ['palm_touch', 'finger_touch', 'thumb_touch',
                'fingertip_touch', 'thumbtip_touch']
_INIT_ATTEMPTS = 8

_BALL = """
    <body name='ball' pos='.4 0 .4' childclass='object'>
      <joint name='ball_x' type='slide' axis='1 0 0' ref='.4'/>
      <joint name='ball_z' type='slide' axis='0 0 1' ref='.4'/>
      <joint name='ball_y' type='hinge' axis='0 1 0'/>
      <geom name='ball' type='sphere' size='.022'/>
      <site name='ball' type='sphere'/>
    </body>
    <body name='target_ball' pos='.4 .001 .4' childclass='ghost'>
      <geom name='target_ball' type='sphere' size='.02'/>
      <site name='target_ball' type='sphere'/>
    </body>
"""
_PEG = """
    <body name='peg' pos='-.4 0 .4' childclass='object'>
      <joint name='peg_x' type='slide' axis='1 0 0' ref='-.4'/>
      <joint name='peg_z' type='slide' axis='0 0 1' ref='.4'/>
      <joint name='peg_y' type='hinge' axis='0 1 0'/>
      <geom name='blade' type='capsule' size='.005'
            fromto='0 0 -.013 0 0 -.113'/>
      <geom name='guard' type='capsule' size='.005'
            fromto='-.017 0 -.043 .017 0 -.043'/>
      <body name='pommel' pos='0 0 -.013'>
        <geom name='pommel' type='sphere' size='.009'/>
      </body>
      <site name='peg' type='box' pos='0 0 -.063'/>
      <site name='peg_pinch' type='box' pos='0 0 -.025'/>
      <site name='peg_grasp' type='box' pos='0 0 0'/>
      <site name='peg_tip' type='box' pos='0 0 -.113'/>
    </body>
    <body name='target_peg' pos='-.2 .001 .4' childclass='ghost'>
      <geom name='target_blade' type='capsule' size='.005'
            fromto='0 0 -.013 0 0 -.113'/>
      <geom name='target_guard' type='capsule' size='.005'
            fromto='-.017 0 -.043 .017 0 -.043'/>
      <geom name='target_pommel' type='sphere' size='.009' pos='0 0 -.013'/>
      <site name='target_peg' type='box' pos='0 0 -.063'/>
      <site name='target_peg_pinch' type='box' pos='0 0 -.025'/>
      <site name='target_peg_grasp' type='box' pos='0 0 0'/>
      <site name='target_peg_tip' type='box' pos='0 0 -.113'/>
    </body>
"""
_SLOT = """
    <body name='slot' pos='-.405 0 .2' euler='0 20 0' childclass='obstacle'>
      <geom name='slot_0' type='box' pos='-.0252 0 -.083'
            size='.0198 .01 .035'/>
      <geom name='slot_1' type='box' pos='.0252 0 -.083'
            size='.0198 .01 .035'/>
      <geom name='slot_2' type='box' pos='0 0 -.138' size='.045 .01 .02'/>
      <site name='slot' type='box'/>
      <site name='slot_end' type='box' pos='0 0 -.05'/>
    </body>
"""
_CUP = """
    <body name='cup' pos='.3 0 .4' euler='0 -15 0' childclass='obstacle'>
      <geom name='cup_0' type='capsule' size='.008'
            fromto='-.03 0 .06 -.03 0 -.015'/>
      <geom name='cup_1' type='capsule' size='.008'
            fromto='-.03 0 -.015 0 0 -.04'/>
      <geom name='cup_2' type='capsule' size='.008'
            fromto='0 0 -.04 .03 0 -.015'/>
      <geom name='cup_3' type='capsule' size='.008'
            fromto='.03 0 -.015 .03 0 .06'/>
      <site name='cup' size='.005'/>
    </body>
"""


def _make_model_xml(use_peg: bool = False, insert: bool = False,
                    props: str = None, geom_solref: str = '.005 1') -> str:
    """Arena + arm + hand model; `props` overrides the prop bodies so the
    stacker domain (same arm, boxes for props, default geom solref .01 per
    stacker.xml:19) shares this template."""
    if props is None:
        props = _PEG if use_peg else _BALL
        if insert:
            props += _SLOT if use_peg else _CUP
    return f"""
<mujoco model='planar manipulator'>
  <option timestep='0.001' cone='elliptic'/>
  <default>
    <geom friction='.7' solimp='0.9 0.97 0.001' solref='{geom_solref}'/>
    <joint solimplimit='0 0.99 0.01' solreflimit='.005 1'/>
    <site size='.003 .003 .003'/>
    <default class='arm'>
      <geom type='capsule' density='500'/>
      <joint type='hinge' pos='0 0 0' axis='0 -1 0' limited='true'/>
      <default class='hand'>
        <joint damping='.5' range='-10 60'/>
        <geom size='.008'/>
        <site type='box' size='.018 .005 .005' pos='.022 0 -.002'
              euler='0 15 0'/>
        <default class='fingertip'>
          <geom type='sphere' size='.008'/>
          <joint damping='.01' stiffness='.01' range='-40 20'/>
          <site size='.012 .005 .008' pos='.003 0 .003' euler='0 0 0'/>
        </default>
      </default>
    </default>
    <default class='object'><geom/></default>
    <default class='obstacle'><geom friction='0'/></default>
    <default class='ghost'><geom contype='0' conaffinity='0'/></default>
  </default>
  <worldbody>
    <geom name='floor' type='plane' pos='0 0 0' size='.4 .2 10'/>
    <geom name='wall1' type='plane' pos='-.682843 0 .282843'
          size='.4 .2 10' zaxis='1 0 1'/>
    <geom name='wall2' type='plane' pos='.682843 0 .282843'
          size='.4 .2 10' zaxis='-1 0 1'/>
    <body name='upper_arm' pos='0 0 .4' childclass='arm'>
      <joint name='arm_root' damping='2' limited='false'/>
      <geom name='upper_arm' size='.02' fromto='0 0 0 0 0 .18'/>
      <body name='middle_arm' pos='0 0 .18' childclass='arm'>
        <joint name='arm_shoulder' damping='1.5' range='-160 160'/>
        <geom name='middle_arm' size='.017' fromto='0 0 0 0 0 .15'/>
        <body name='lower_arm' pos='0 0 .15'>
          <joint name='arm_elbow' damping='1' range='-160 160'/>
          <geom name='lower_arm' size='.014' fromto='0 0 0 0 0 .12'/>
          <body name='hand' pos='0 0 .12'>
            <joint name='arm_wrist' damping='.5' range='-140 140'/>
            <geom name='hand' size='.011' fromto='0 0 0 0 0 .03'/>
            <geom name='palm1' fromto='0 0 .03 .03 0 .045' class='hand'/>
            <geom name='palm2' fromto='0 0 .03 -.03 0 .045' class='hand'/>
            <site name='grasp' pos='0 0 .065'/>
            <body name='pinch site' pos='0 0 .090'>
              <site name='pinch'/>
              <inertial pos='0 0 0' mass='1e-6'
                        diaginertia='1e-12 1e-12 1e-12'/>
            </body>
            <body name='thumb' pos='.03 0 .045' euler='0 -90 0'
                  childclass='hand'>
              <joint name='thumb'/>
              <geom name='thumb1' fromto='0 0 0 .02 0 -.01' size='.007'/>
              <geom name='thumb2' fromto='.02 0 -.01 .04 0 -.01'
                    size='.007'/>
              <site name='thumb_touch'/>
              <body name='thumbtip' pos='.05 0 -.01' childclass='fingertip'>
                <joint name='thumbtip'/>
                <geom name='thumbtip1' pos='-.003 0 0'/>
                <geom name='thumbtip2' pos='.003 0 0'/>
                <site name='thumbtip_touch'/>
              </body>
            </body>
            <body name='finger' pos='-.03 0 .045' euler='0 90 180'
                  childclass='hand'>
              <joint name='finger'/>
              <geom name='finger1' fromto='0 0 0 .02 0 -.01' size='.007'/>
              <geom name='finger2' fromto='.02 0 -.01 .04 0 -.01'
                    size='.007'/>
              <site name='finger_touch'/>
              <body name='fingertip' pos='.05 0 -.01'
                    childclass='fingertip'>
                <joint name='fingertip'/>
                <geom name='fingertip1' pos='-.003 0 0'/>
                <geom name='fingertip2' pos='.003 0 0'/>
                <site name='fingertip_touch'/>
              </body>
            </body>
            <site name='palm_touch' type='box' size='.025 .005 .008'
                  pos='0 0 .043'/>
          </body>
        </body>
      </body>
    </body>
    {props}
  </worldbody>
  <tendon>
    <fixed name='grasp'>
      <joint joint='thumb' coef='.5'/>
      <joint joint='finger' coef='.5'/>
    </fixed>
    <fixed name='coupling'>
      <joint joint='thumb' coef='-.5'/>
      <joint joint='finger' coef='.5'/>
    </fixed>
  </tendon>
  <equality>
    <tendon name='coupling' tendon1='coupling'
            solimp='0.95 0.99 0.001' solref='.005 .5'/>
  </equality>
  <actuator>
    <motor name='root' joint='arm_root' ctrllimited='true'
           ctrlrange='-1 1' gear='12'/>
    <motor name='shoulder' joint='arm_shoulder' ctrllimited='true'
           ctrlrange='-1 1' gear='8'/>
    <motor name='elbow' joint='arm_elbow' ctrllimited='true'
           ctrlrange='-1 1' gear='4'/>
    <motor name='wrist' joint='arm_wrist' ctrllimited='true'
           ctrlrange='-1 1' gear='2'/>
    <motor name='grasp' tendon='grasp' ctrllimited='true'
           ctrlrange='-1 1' gear='2'/>
  </actuator>
</mujoco>
"""


def uniform(generator, shape, lo, hi, dtype, device):
    """Uniform draws in [lo, hi) from `generator`, moved to `device`."""
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device).to(device)
    return lo + (hi - lo) * u


def arm_qpos(model, n, generator):
    """qpos0 (n, nq) with the arm's joints drawn uniform in their ranges
    (an unlimited hinge in [-pi, pi)) and the finger set to the thumb
    (JAX manipulator.py:250-259, stacker.py:78-86)."""
    dt, dev = model.dtype, model.device
    qpos = model.qpos0.expand(n, model.nq).clone()
    rng = model.jnt_range.cpu().tolist()
    for j in _ARM_JOINTS:
        ji = model.name2id('joint', j)
        lo, hi = rng[ji] if model.jnt_limited[ji] else (-math.pi, math.pi)
        qpos[:, model.jnt_qposadr[ji]] = uniform(generator, (n,), lo, hi,
                                                 dt, dev)
    adr = lambda j: model.jnt_qposadr[model.name2id('joint', j)]
    qpos[:, adr('finger')] = qpos[:, adr('thumb')]
    return qpos


def touch(model, data):
    """(B, 5) log1p of the five touch sensors (palm, finger, thumb and
    their tips)."""
    return torch.log1p(torch.stack([
        sensors.touch(model, data, model.name2id('site', s))
        for s in _TOUCH_SITES], 1))


def joint_pos(model, phys, names):
    """(B, n, 2) sin and cos of the joints' angles."""
    q = phys.qpos[:, [model.jnt_qposadr[model.name2id('joint', j)]
                      for j in names]]
    return torch.stack([torch.sin(q), torch.cos(q)], -1)


def joint_vel(model, phys, names):
    return phys.qvel[:, [model.jnt_dofadr[model.name2id('joint', j)]
                         for j in names]]


def body_2d_pose(model, data, body_name, orientation=True):
    """(B, 4) the body's x, z and the w, y of its quaternion (or (B, 2))."""
    b = model.name2id('body', body_name)
    pos = data.xpos[:, b][:, [0, 2]]
    if not orientation:
        return pos
    return torch.cat([pos, data.xquat[:, b][:, [0, 2]]], 1)


def site_distance(model, data, s1, s2):
    return torch.linalg.vector_norm(
        data.site_xpos[:, model.name2id('site', s1)]
        - data.site_xpos[:, model.name2id('site', s2)], dim=-1)


def with_body_poses(model, bodies, params):
    """The model with each of `bodies` moved to the per-env (x, z, angle)
    of params (B, 3): x and z set, the rest of its position kept, and the
    rotation by the angle about y (JAX manipulator.py:304-318)."""
    B = params.shape[0]
    body_pos = model.body_pos.expand(B, -1, -1).clone()
    body_quat = model.body_quat.expand(B, -1, -1).clone()
    half = 0.5 * params[:, 2]
    quat = torch.stack([torch.cos(half), torch.zeros_like(half),
                        torch.sin(half), torch.zeros_like(half)], 1)
    for name in bodies:
        b = model.name2id('body', name)
        body_pos[:, b, 0] = params[:, 0]
        body_pos[:, b, 2] = params[:, 1]
        body_quat[:, b] = quat
    return M.with_env_fields(model, body_pos=body_pos, body_quat=body_quat)


class Bring(base.Task):
    """Bring the prop to the target (JAX manipulator.py Bring); the params
    are the target's (x, z, angle) a env (B, 3)."""

    def __init__(self, use_peg: bool, insert: bool, fully_observable: bool):
        self._use_peg = use_peg
        self._target = 'target_peg' if use_peg else 'target_ball'
        self._object = 'peg' if use_peg else 'ball'
        self._object_joints = [f'{self._object}_{d}' for d in 'xzy']
        self._receptacle = 'slot' if use_peg else 'cup'
        self._insert = insert
        self._fully_observable = fully_observable

    def attempts(self, model, batch, generator):
        """(qpos (A, B, nq), params (A, B, 3)): the reset's A = 8 draws an
        env (JAX manipulator.py:244-296)."""
        n, dt, dev = _INIT_ATTEMPTS * batch, model.dtype, model.device
        u = lambda lo, hi: uniform(generator, (n,), lo, hi, dt, dev)
        qpos = arm_qpos(model, n, generator)
        target_x, target_z = u(-.4, .4), u(.1, .4)
        lim = math.pi / 3 if self._insert else math.pi
        angle = u(-lim, lim)
        in_target = u(0., 1.) < _P_IN_TARGET
        obj = (torch.where(in_target, target_x, u(-.5, .5)),
               torch.where(in_target, target_z, u(0., .7)),
               torch.where(in_target, angle, u(0., 2 * math.pi)))
        for j, val in zip(self._object_joints, obj):
            qpos[:, model.jnt_qposadr[model.name2id('joint', j)]] = val
        params = torch.stack([target_x, target_z, angle], 1)
        return (qpos.reshape(_INIT_ATTEMPTS, batch, model.nq),
                params.reshape(_INIT_ATTEMPTS, batch, 3))

    def initialize_episode(self, model, batch, generator):
        """Random arm pose and prop and target placement, the first of 8
        attempts an env without penetration (JAX manipulator.py:244-302)."""
        qposes, params = self.attempts(model, batch, generator)
        idx = randomizers.first_collision_free_index(model, qposes)
        envs = torch.arange(batch, device=qposes.device)
        return make_state(model, qpos=qposes[idx, envs]), params[idx, envs]

    def apply_params(self, model, params):
        bodies = [self._target] + ([self._receptacle] if self._insert
                                   else [])
        return with_body_poses(model, bodies, params)

    def get_observation(self, model, phys, data):
        obs = {'arm_pos': joint_pos(model, phys, _ARM_JOINTS),
               'arm_vel': joint_vel(model, phys, _ARM_JOINTS),
               'touch': touch(model, data)}
        if self._fully_observable:
            obs['hand_pos'] = body_2d_pose(model, data, 'hand')
            obs['object_pos'] = body_2d_pose(model, data, self._object)
            obs['object_vel'] = joint_vel(model, phys, self._object_joints)
            obs['target_pos'] = body_2d_pose(model, data, self._target)
        return obs

    def _is_close(self, distance):
        return rewards.tolerance(distance, (0, _CLOSE), _CLOSE * 2)

    def get_reward(self, model, phys, data, ctrl):
        dist = lambda s1, s2: self._is_close(site_distance(model, data, s1,
                                                           s2))
        if self._use_peg:
            grasping = (dist('peg_grasp', 'grasp')
                        + dist('peg_pinch', 'pinch')) / 2
            bringing = (dist('peg', 'target_peg')
                        + dist('target_peg_tip', 'peg_tip')) / 2
            return torch.maximum(bringing, grasping / 3)
        return dist('ball', 'target_ball')


def _env(use_peg, insert, fully_observable, time_limit, device,
         environment_kwargs):
    model = mjcf.parse(_make_model_xml(use_peg, insert))
    task = Bring(use_peg=use_peg, insert=insert,
                 fully_observable=fully_observable)
    kwargs = dict(environment_kwargs or {})
    kwargs.setdefault('control_timestep', _CONTROL_TIMESTEP)
    return control.Environment(model.to(device), task, time_limit=time_limit,
                               **kwargs)


@SUITE.add('benchmarking', 'hard')
def bring_ball(fully_observable=True, time_limit=_TIME_LIMIT, device='cuda',
               environment_kwargs=None):
    return _env(False, False, fully_observable, time_limit, device,
                environment_kwargs)


@SUITE.add('hard')
def bring_peg(fully_observable=True, time_limit=_TIME_LIMIT, device='cuda',
              environment_kwargs=None):
    return _env(True, False, fully_observable, time_limit, device,
                environment_kwargs)


@SUITE.add('hard')
def insert_ball(fully_observable=True, time_limit=_TIME_LIMIT, device='cuda',
                environment_kwargs=None):
    return _env(False, True, fully_observable, time_limit, device,
                environment_kwargs)


@SUITE.add('hard')
def insert_peg(fully_observable=True, time_limit=_TIME_LIMIT, device='cuda',
               environment_kwargs=None):
    return _env(True, True, fully_observable, time_limit, device,
                environment_kwargs)
