"""Fish domain: upright / swim.

Port of mujoco_mbrl_tpu/suite/fish.py. The model XML is this package's
own copy of the JAX module's ``_XML`` (a test checks the two are equal):
a free-floating body in a density-5000 fluid with gravity, contacts and
limits off, so no constraint row and no solve; five ``<position>`` servos
(an affine bias), one on a fixed tendon coupling the fins. The reset
draws a unit quaternion for the root and the seven joint angles in
[-0.2, 0.2); swim draws a target per env and writes it into a per-env
``geom_pos``.
"""

from __future__ import annotations

import torch

from ..physics import make_state, mjcf
from ..physics import model as M
from . import base, control, rewards
from .registry import TaggedTasks

SUITE = TaggedTasks()
_DEFAULT_TIME_LIMIT = 40
_CONTROL_TIMESTEP = .04
_JOINTS = ['tail1', 'tail_twist', 'tail2', 'finright_roll',
           'finright_pitch', 'finleft_roll', 'finleft_pitch']

_XML = """
<mujoco model='fish'>
  <option timestep='0.004' density='5000'>
    <flag gravity='disable' contact='disable' limit='disable'/>
  </option>
  <default>
    <default class='fish'>
      <joint type='hinge' limited='false' range='-60 60' damping='2e-5'
             solreflimit='.1 1' solimplimit='0 .8 .1'/>
    </default>
  </default>
  <worldbody>
    <geom name='target' type='sphere' pos='0 .4 .1' size='.04'/>
    <body name='torso' pos='0 0 .1' childclass='fish'>
      <joint name='root' type='free' damping='0' limited='false'/>
      <geom name='torso_massive' type='box' size='.002 .06 .03'/>
      <geom name='mouth' type='capsule' fromto='0 .079 0 0 .07 0'
            size='.005' mass='0'/>
      <site name='torso' size='.01'/>
      <body name='tail1' pos='0 -.09 0'>
        <joint name='tail1' axis='0 0 1' pos='0 .01 0'/>
        <joint name='tail_twist' axis='0 1 0' pos='0 .01 0'
               range='-30 30'/>
        <geom name='tail1' type='ellipsoid' size='.001 .008 .016'/>
        <body name='tail2' pos='0 -.028 0'>
          <joint name='tail2' axis='0 0 1' pos='0 .02 0'
                 stiffness='8e-5'/>
          <geom name='tail2' type='ellipsoid' size='.001 .018 .035'/>
        </body>
      </body>
      <body name='finright' pos='.01 0 0'>
        <joint name='finright_roll' axis='0 1 0'/>
        <joint name='finright_pitch' axis='1 0 0' pos='0 .005 0'/>
        <geom name='finright' type='ellipsoid' pos='.015 0 0'
              size='.02 .015 .001'/>
      </body>
      <body name='finleft' pos='-.01 0 0'>
        <joint name='finleft_roll' axis='0 1 0'/>
        <joint name='finleft_pitch' axis='1 0 0' pos='0 .005 0'/>
        <geom name='finleft' type='ellipsoid' pos='-.015 0 0'
              size='.02 .015 .001'/>
      </body>
    </body>
  </worldbody>
  <tendon>
    <fixed name='fins_flap'>
      <joint joint='finleft_roll' coef='-.5'/>
      <joint joint='finright_roll' coef='.5'/>
    </fixed>
    <fixed name='fins_sym' stiffness='1e-4'>
      <joint joint='finleft_roll' coef='.5'/>
      <joint joint='finright_roll' coef='.5'/>
    </fixed>
  </tendon>
  <actuator>
    <position name='tail' joint='tail1' ctrllimited='true'
              ctrlrange='-1 1' kp='5e-4'/>
    <position name='tail_twist' joint='tail_twist' ctrllimited='true'
              ctrlrange='-1 1' kp='1e-4'/>
    <position name='fins_flap' tendon='fins_flap' ctrllimited='true'
              ctrlrange='-1 1' kp='3e-4'/>
    <position name='finleft_pitch' joint='finleft_pitch' ctrllimited='true'
              ctrlrange='-1 1' kp='1e-4'/>
    <position name='finright_pitch' joint='finright_pitch'
              ctrllimited='true' ctrlrange='-1 1' kp='1e-4'/>
  </actuator>
</mujoco>
"""


class _FishTask(base.Task):
    # observation and reward read only position/velocity-stage Data
    OBSERVES_ACC = False

    def _joint_qpos(self, model, phys):
        return phys.qpos[:, [model.jnt_qposadr[model.name2id('joint', j)]
                             for j in _JOINTS]]

    def _init_qpos(self, model, batch, generator):
        """qpos0 with a random unit root quaternion and the joints uniform
        in [-0.2, 0.2) (JAX fish.py:88-98)."""
        dt, dev = model.dtype, model.device
        qpos = model.qpos0.expand(batch, model.nq).clone()
        quat = torch.randn((batch, 4), generator=generator, dtype=dt,
                           device=generator.device).to(dev)
        qpos[:, 3:7] = quat / torch.linalg.vector_norm(quat, dim=1,
                                                       keepdim=True)
        vals = torch.rand((batch, len(_JOINTS)), generator=generator,
                          dtype=dt, device=generator.device).to(dev)
        qpos[:, [model.jnt_qposadr[model.name2id('joint', j)]
                 for j in _JOINTS]] = -.2 + .4 * vals
        return qpos

    def _upright(self, model, data):
        return data.ximat[:, model.name2id('body', 'torso'), 2, 2]


class Upright(_FishTask):
    """Right the fish (JAX fish.py Upright)."""

    def initialize_episode(self, model, batch, generator):
        return make_state(model, qpos=self._init_qpos(model, batch,
                                                      generator)), ()

    def get_observation(self, model, phys, data):
        return {'joint_angles': self._joint_qpos(model, phys),
                'upright': self._upright(model, data),
                'velocity': phys.qvel}

    def get_reward(self, model, phys, data, ctrl):
        return rewards.tolerance(self._upright(model, data), (1, 1),
                                 margin=1)


class Swim(_FishTask):
    """Swim the mouth to the target (JAX fish.py Swim); the params are
    the target's position a env (B, 3)."""

    def initialize_episode(self, model, batch, generator):
        qpos = self._init_qpos(model, batch, generator)
        u = torch.rand((batch, 3), generator=generator, dtype=model.dtype,
                       device=generator.device).to(model.device)
        lo = torch.tensor([-.4, -.4, .1], dtype=model.dtype,
                          device=model.device)
        hi = torch.tensor([.4, .4, .3], dtype=model.dtype,
                          device=model.device)
        return make_state(model, qpos=qpos), lo + (hi - lo) * u

    def apply_params(self, model, params):
        tid = model.name2id('geom', 'target')
        geom_pos = model.geom_pos.expand(params.shape[0], -1, -1).clone()
        geom_pos[:, tid] = params
        return M.with_env_fields(model, geom_pos=geom_pos)

    def _mouth_to_target(self, model, data):
        tid = model.name2id('geom', 'target')
        mid = model.name2id('geom', 'mouth')
        vec = data.geom_xpos[:, tid] - data.geom_xpos[:, mid]
        return torch.einsum('bi,bij->bj', vec, data.geom_xmat[:, mid])

    def get_observation(self, model, phys, data):
        return {'joint_angles': self._joint_qpos(model, phys),
                'upright': self._upright(model, data),
                'target': self._mouth_to_target(model, data),
                'velocity': phys.qvel}

    def get_reward(self, model, phys, data, ctrl):
        tid = model.name2id('geom', 'target')
        mid = model.name2id('geom', 'mouth')
        radii = float(model.geom_size[tid, 0] + model.geom_size[mid, 0])
        in_target = rewards.tolerance(
            torch.linalg.vector_norm(self._mouth_to_target(model, data),
                                     dim=-1),
            bounds=(0, radii), margin=2 * radii)
        is_upright = 0.5 * (self._upright(model, data) + 1)
        return (7 * in_target + is_upright) / 8


def _env(task, time_limit, device, environment_kwargs):
    kwargs = dict(environment_kwargs or {})
    kwargs.setdefault('control_timestep', _CONTROL_TIMESTEP)
    return control.Environment(mjcf.parse(_XML).to(device), task,
                               time_limit=time_limit, **kwargs)


@SUITE.add('benchmarking')
def upright(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
            environment_kwargs=None):
    return _env(Upright(), time_limit, device, environment_kwargs)


@SUITE.add('benchmarking')
def swim(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
         environment_kwargs=None):
    return _env(Swim(), time_limit, device, environment_kwargs)
