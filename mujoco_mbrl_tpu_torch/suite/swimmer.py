"""Swimmer domain: swimmer6 / swimmer15, and ``swimmer(n_links)``.

Port of mujoco_mbrl_tpu/suite/swimmer.py. ``_make_model_xml`` is this
package's own copy of the JAX module's (a test checks the two give the
same XML). Propulsion comes from the fluid's density drag (option
density 3000, ``physics.smooth.fluid_force``); contacts are disabled, so
the joint limits are the only constraint rows (n - 1 of them). The
target is drawn per episode and carried as the env params (B, 2);
``apply_params`` writes it into a per-env ``geom_pos``, as the reacher's.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..physics import make_state, mjcf
from ..physics import model as M
from . import base, control, randomizers, rewards
from .registry import TaggedTasks

SUITE = TaggedTasks()
_DEFAULT_TIME_LIMIT = 30
_CONTROL_TIMESTEP = .03


def _make_model_xml(n_bodies: int) -> str:
    """The n-link swimmer (swimmer.py _make_model semantics)."""
    if n_bodies < 3:
        raise ValueError(f'At least 3 bodies required. Received {n_bodies}')
    joint_limit = 360.0 / n_bodies
    segments = ''
    for i in range(n_bodies - 1):
        segments += (
            f"<body name='segment_{i}' pos='0 .1 0'>"
            f"<geom name='visual_{i}' class='visual'/>"
            f"<geom name='inertial_{i}' class='inertial'/>"
            f"<site name='site_{i}'/>"
            f"<joint name='joint_{i}' range='{-joint_limit} {joint_limit}'/>"
        )
    segments += '</body>' * (n_bodies - 1)
    motors = ''.join(
        f"<motor name='motor_{i}' joint='joint_{i}'/>"
        for i in range(n_bodies - 1))
    return f"""
<mujoco model='swimmer'>
  <option timestep='0.002' density='3000'>
    <flag contact='disable'/>
  </option>
  <default>
    <default class='swimmer'>
      <joint type='hinge' pos='0 -.05 0' axis='0 0 1' limited='true'
             solreflimit='.05 1' solimplimit='0 .8 .1' armature='1e-6'/>
      <default class='inertial'>
        <geom type='box' size='.001 .05 .01' mass='.01'/>
      </default>
      <default class='visual'>
        <geom type='capsule' size='.01' fromto='0 -.05 0 0 .05 0'
              mass='0'/>
      </default>
      <site size='.01'/>
    </default>
    <default class='free'>
      <joint limited='false' stiffness='0' armature='0'/>
    </default>
    <motor gear='5e-4' ctrllimited='true' ctrlrange='-1 1'/>
  </default>
  <worldbody>
    <body name='head' pos='0 0 .05' childclass='swimmer'>
      <geom name='nose' type='sphere' pos='0 -.06 0' size='.004' mass='0'/>
      <joint name='rootx' class='free' type='slide' axis='1 0 0'
             pos='0 -.05 0'/>
      <joint name='rooty' class='free' type='slide' axis='0 1 0'
             pos='0 -.05 0'/>
      <joint name='rootz' class='free' type='hinge' axis='0 0 1'
             pos='0 -.05 0'/>
      <geom name='inertial' class='inertial'/>
      <geom name='visual' class='visual'/>
      <site name='head'/>
      {segments}
    </body>
    <geom name='target' type='sphere' pos='1 1 .05' size='.1'/>
  </worldbody>
  <actuator>{motors}</actuator>
</mujoco>
"""


class Swimmer(base.Task):
    """Swim the nose to the randomized target."""
    # observation and reward read only position/velocity-stage Data
    OBSERVES_ACC = False

    def initialize_episode(self, model, batch, generator):
        qpos = randomizers.randomize_limited_and_rotational_joints(
            model, model.qpos0.expand(batch, model.nq), generator)
        dt, dev = qpos.dtype, qpos.device
        u = lambda *shape: torch.rand(shape, generator=generator, dtype=dt,
                                      device=generator.device).to(dev)
        # a close target with probability .2, a far one otherwise
        # (swimmer.py:189-193)
        box = torch.where(u(batch) < 0.2, 0.3, 2.0).to(dt)
        target_xy = (2.0 * u(batch, 2) - 1.0) * box[:, None]
        return make_state(model, qpos=qpos), target_xy

    def apply_params(self, model, params):
        tid = model.name2id('geom', 'target')
        geom_pos = model.geom_pos.expand(params.shape[0], -1, -1).clone()
        geom_pos[:, tid, :2] = params
        return M.with_env_fields(model, geom_pos=geom_pos)

    def _nose_to_target(self, model, data):
        tid = model.name2id('geom', 'target')
        nid = model.name2id('geom', 'nose')
        head = model.name2id('body', 'head')
        vec = data.geom_xpos[:, tid] - data.geom_xpos[:, nid]
        return torch.einsum('ni,nij->nj', vec, data.ximat[:, head])[:, :2]

    def _body_velocities(self, model, data):
        """Local velocimeter (x, y) and gyro (z) at each site
        (swimmer.py body_velocities): (B, 3 nsite)."""
        sb = list(model.site_body)
        R = data.ximat[:, sb]                               # (B, ns, 3, 3)
        w_world = data.cvel[:, sb, :3]
        v_world = data.cvel[:, sb, 3:] + torch.linalg.cross(
            w_world, data.site_xpos)
        v = torch.einsum('nsji,nsj->nsi', R, v_world)
        w = torch.einsum('nsji,nsj->nsi', R, w_world)
        return torch.stack([v[..., 0], v[..., 1], w[..., 2]], -1).reshape(
            v.shape[0], -1)

    def get_observation(self, model, phys, data):
        return {'joints': phys.qpos[:, 3:],
                'to_target': self._nose_to_target(model, data),
                'body_velocities': self._body_velocities(model, data)}

    def get_reward(self, model, phys, data, ctrl):
        tid = model.name2id('geom', 'target')
        target_size = M.cached(model, 'target_size',
                               lambda: float(model.geom_size[tid, 0]))
        dist = torch.linalg.vector_norm(self._nose_to_target(model, data),
                                        dim=-1)
        return rewards.tolerance(dist, (0, target_size),
                                 margin=5 * target_size,
                                 sigmoid='long_tail')


def _make_swimmer(n, time_limit, device, environment_kwargs):
    model = mjcf.parse(_make_model_xml(n)).to(device)
    kwargs = dict(environment_kwargs or {})
    kwargs.setdefault('control_timestep', _CONTROL_TIMESTEP)
    return control.Environment(model, Swimmer(), time_limit=time_limit,
                               **kwargs)


@SUITE.add('benchmarking')
def swimmer6(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
             environment_kwargs=None):
    return _make_swimmer(6, time_limit, device, environment_kwargs)


@SUITE.add('benchmarking')
def swimmer15(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
              environment_kwargs=None):
    return _make_swimmer(15, time_limit, device, environment_kwargs)


def swimmer(n_links=3, time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
            environment_kwargs=None):
    """An n-link swimmer environment on `device` (default ``cuda``)."""
    return _make_swimmer(n_links, time_limit, resolve_device(device),
                         environment_kwargs)
