"""Finger domain: spin / turn_easy / turn_hard.

Port of mujoco_mbrl_tpu/suite/finger.py. The model XML is this package's
own copy of the JAX module's ``_XML`` (a test checks the two are equal):
gravity off, an elliptic friction cone, a friction-loss spinner hinge and
a 200-iteration solver (the APGD cap is 400). Its 8 candidate pairs give
12 contact points, so 1 friction-loss row, 2 hinge limits and 12 cone
triples: 39 constraint rows, which the dense APGD kernel solves one env
per warp. The touch sensors at the fingertip read the solved contact
forces, so the task observes the acceleration stage. Turn draws a target
angle per episode and writes it into a per-env ``site_pos``.
"""

from __future__ import annotations

import math

import torch

from ..physics import make_state, mjcf
from ..physics import model as M
from . import base, control, randomizers, sensors
from .registry import TaggedTasks

SUITE = TaggedTasks()
_DEFAULT_TIME_LIMIT = 20
_CONTROL_TIMESTEP = .02
_EASY_TARGET_SIZE = 0.07
_HARD_TARGET_SIZE = 0.03
_SPIN_VELOCITY = 15.0

_XML = """
<mujoco model='finger'>
  <option timestep='0.01' cone='elliptic' iterations='200'>
    <flag gravity='disable'/>
  </option>
  <default>
    <geom solimp='0 0.9 0.01' solref='.02 1'/>
    <joint type='hinge' axis='0 -1 0'/>
    <motor ctrllimited='true' ctrlrange='-1 1'/>
    <default class='finger'>
      <joint damping='2.5' limited='true'/>
      <site type='ellipsoid' size='.025 .03 .025'/>
    </default>
  </default>
  <worldbody>
    <geom name='ground' type='plane' pos='0 0 0' size='.6 .2 10'/>
    <body name='proximal' pos='-.2 0 .4' childclass='finger'>
      <geom name='proximal_decoration' type='cylinder'
            fromto='0 -.033 0 0 .033 0' size='.034'/>
      <joint name='proximal' range='-110 110' ref='-90'/>
      <geom name='proximal' type='capsule' size='.03'
            fromto='0 0 0 0 0 -.17'/>
      <body name='distal' pos='0 0 -.18' childclass='finger'>
        <joint name='distal' range='-110 110'/>
        <geom name='distal' type='capsule' size='.028'
              fromto='0 0 0 0 0 -.16' contype='0' conaffinity='0'/>
        <geom name='fingertip' type='capsule' size='.03'
              fromto='0 0 -.13 0 0 -.161'/>
        <site name='touchtop' pos='.01 0 -.17'/>
        <site name='touchbottom' pos='-.01 0 -.17'/>
      </body>
    </body>
    <body name='spinner' pos='.2 0 .4'>
      <joint name='hinge' frictionloss='.1' damping='.5'/>
      <geom name='cap1' type='capsule' size='.04 .09' pos='.02 0 0'/>
      <geom name='cap2' type='capsule' size='.04 .09' pos='-.02 0 0'/>
      <site name='tip' pos='0 0 .13'/>
      <geom name='spinner_decoration' type='cylinder'
            fromto='0 -.045 0 0 .045 0' size='.02'/>
    </body>
    <site name='target' pos='0 0 .4'/>
  </worldbody>
  <actuator>
    <motor name='proximal' joint='proximal' gear='30'/>
    <motor name='distal' joint='distal' gear='15'/>
  </actuator>
</mujoco>
"""


class _FingerTask(base.Task):
    _INIT_ATTEMPTS = 8

    def _random_joint_angles(self, model, batch, generator):
        """Collision-free random joint angles (JAX finger.py
        _random_joint_angles): ``_INIT_ATTEMPTS`` draws an env, the first
        without penetration kept."""
        q0 = model.qpos0.expand(self._INIT_ATTEMPTS * batch, model.nq)
        qposes = randomizers.randomize_limited_and_rotational_joints(
            model, q0, generator)
        return randomizers.first_collision_free(
            model, qposes.reshape(self._INIT_ATTEMPTS, batch, model.nq))

    def _touch(self, model, data):
        return torch.log1p(torch.stack([
            sensors.touch(model, data, model.name2id('site', 'touchtop')),
            sensors.touch(model, data, model.name2id('site', 'touchbottom'))],
            1))

    def _tip_position(self, model, data):
        tip = model.name2id('site', 'tip')
        spinner = model.name2id('body', 'spinner')
        return (data.site_xpos[:, tip][:, [0, 2]]
                - data.xpos[:, spinner][:, [0, 2]])

    def _bounded_position(self, model, phys, data):
        return torch.cat([phys.qpos[:, :2], self._tip_position(model, data)],
                         1)


class Spin(_FingerTask):
    """Keep the spinner rotating (JAX finger.py Spin)."""

    def initialize_episode(self, model, batch, generator):
        return make_state(model, qpos=self._random_joint_angles(
            model, batch, generator)), ()

    def get_observation(self, model, phys, data):
        return {
            'position': self._bounded_position(model, phys, data),
            'velocity': phys.qvel,
            'touch': self._touch(model, data),
        }

    def get_reward(self, model, phys, data, ctrl):
        hinge_dof = model.jnt_dofadr[model.names['joint']['hinge']]
        return (phys.qvel[:, hinge_dof] <= -_SPIN_VELOCITY).to(
            phys.qpos.dtype)


class Turn(_FingerTask):
    """Turn the spinner tip to a random target angle (JAX finger.py Turn).
    The params are the target's (x, z) a env (B, 2)."""

    def __init__(self, target_radius: float):
        self._target_radius = target_radius

    def initialize_episode(self, model, batch, generator):
        dt, dev = model.dtype, model.device
        u = torch.rand((batch,), generator=generator, dtype=dt,
                       device=generator.device).to(dev)
        angle = -math.pi + 2 * math.pi * u
        cap1 = model.name2id('geom', 'cap1')
        radius, hinge = M.cached(model, 'turn_circle', lambda: (
            float(model.geom_size[cap1].sum()),
            model.body_pos[model.name2id('body', 'spinner')].tolist()))
        target_xz = torch.stack([hinge[0] + radius * torch.sin(angle),
                                 hinge[2] + radius * torch.cos(angle)], 1)
        qpos = self._random_joint_angles(model, batch, generator)
        return make_state(model, qpos=qpos), target_xz

    def apply_params(self, model, params):
        tid = model.name2id('site', 'target')
        site_pos = model.site_pos.expand(params.shape[0], -1, -1).clone()
        site_pos[:, tid, 0] = params[:, 0]
        site_pos[:, tid, 2] = params[:, 1]
        return M.with_env_fields(model, site_pos=site_pos)

    def _target_position(self, model, data):
        tid = model.name2id('site', 'target')
        spinner = model.name2id('body', 'spinner')
        return (data.site_xpos[:, tid][:, [0, 2]]
                - data.xpos[:, spinner][:, [0, 2]])

    def _dist_to_target(self, model, data):
        d = self._target_position(model, data) - self._tip_position(
            model, data)
        return torch.linalg.vector_norm(d, dim=-1) - self._target_radius

    def get_observation(self, model, phys, data):
        return {
            'position': self._bounded_position(model, phys, data),
            'velocity': phys.qvel,
            'touch': self._touch(model, data),
            'target_position': self._target_position(model, data),
            'dist_to_target': self._dist_to_target(model, data),
        }

    def get_reward(self, model, phys, data, ctrl):
        return (self._dist_to_target(model, data) <= 0).to(phys.qpos.dtype)


def _env(task, time_limit, device, environment_kwargs, spin=False):
    model = mjcf.parse(_XML)
    if spin:
        # Spin overrides the spinner hinge damping (JAX finger.py:193-197)
        hinge_dof = model.jnt_dofadr[model.names['joint']['hinge']]
        damping = model.dof_damping.clone()
        damping[hinge_dof] = .03
        model = model.replace(dof_damping=damping)
    kwargs = dict(environment_kwargs or {})
    kwargs.setdefault('control_timestep', _CONTROL_TIMESTEP)
    return control.Environment(model.to(device), task, time_limit=time_limit,
                               **kwargs)


@SUITE.add('benchmarking')
def spin(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
         environment_kwargs=None):
    return _env(Spin(), time_limit, device, environment_kwargs, spin=True)


@SUITE.add('benchmarking')
def turn_easy(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
              environment_kwargs=None):
    return _env(Turn(_EASY_TARGET_SIZE), time_limit, device,
                environment_kwargs)


@SUITE.add('benchmarking')
def turn_hard(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
              environment_kwargs=None):
    return _env(Turn(_HARD_TARGET_SIZE), time_limit, device,
                environment_kwargs)
