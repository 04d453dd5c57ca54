"""Planar stacker domain: stack_2 / stack_4.

Port of mujoco_mbrl_tpu/suite/stacker.py: the manipulator's arena and arm
(``manipulator._make_model_xml``) with boxes for props and the default
geom solref .01. Its box pairs (plane-box, sphere-box, capsule-box and
box-box) and the hand's tendon-equality row give 641 constraint rows for
stack_2 and 977 for stack_4, which #1 solves one block per env with Ad in
device memory. The reset draws 8 attempts an env and keeps its first
without penetration; the target column's (x, height) moves the target
body per env.
"""

from __future__ import annotations

import math

import torch

from ..physics import make_state, mjcf
from ..physics import model as M
from . import base, control, randomizers, rewards
from .manipulator import (_ARM_JOINTS, _INIT_ATTEMPTS, _make_model_xml,
                          arm_qpos, body_2d_pose, joint_pos, joint_vel,
                          site_distance, touch, uniform)
from .registry import TaggedTasks

SUITE = TaggedTasks()
_CLOSE = .01
_CONTROL_TIMESTEP = .01
_TIME_LIMIT = 10
_BOX_SIZE = .022


def _box_xml(b: int, x: float) -> str:
    return f"""
    <body name='box{b}' pos='{x} 0 .4' childclass='object'>
      <joint name='box{b}_x' type='slide' axis='1 0 0' ref='{x}'/>
      <joint name='box{b}_z' type='slide' axis='0 0 1' ref='.4'/>
      <joint name='box{b}_y' type='hinge' axis='0 1 0'/>
      <geom name='box{b}' type='box' size='.022 .022 .022'/>
      <site name='box{b}' type='sphere'/>
    </body>"""


def _props_xml(n_boxes: int) -> str:
    boxes = ''.join(_box_xml(b, x)
                    for b, x in zip(range(n_boxes), (.5, .4, .3, .2)))
    return boxes + """
    <body name='target' pos='0 .001 .022' childclass='ghost'>
      <geom name='target' type='box' size='.022 .022 .022'/>
      <site name='target' type='sphere'/>
    </body>"""


class Stack(base.Task):
    """Stack the boxes on the target (JAX stacker.py Stack); the params
    are the target's (x, z) a env (B, 2)."""

    def __init__(self, n_boxes: int, fully_observable: bool):
        self._n_boxes = n_boxes
        self._box_names = [f'box{b}' for b in range(n_boxes)]
        # observation order x, y (hinge), z a box (JAX stacker.py:58-60)
        self._box_joints = [f'{n}_{d}' for n in self._box_names
                            for d in 'xyz']
        self._fully_observable = fully_observable

    def attempts(self, model, batch, generator):
        """(qpos (A, B, nq), params (A, B, 2)): the reset's A = 8 draws an
        env (JAX stacker.py:72-105)."""
        n, dt, dev = _INIT_ATTEMPTS * batch, model.dtype, model.device
        u = lambda lo, hi: uniform(generator, (n,), lo, hi, dt, dev)
        qpos = arm_qpos(model, n, generator)
        level = torch.randint(0, self._n_boxes, (n,), generator=generator,
                              device=generator.device).to(dev)
        target_z = _BOX_SIZE * (2 * level + 1).to(dt)
        target_x = u(-.37, .37)
        adr = lambda j: model.jnt_qposadr[model.name2id('joint', j)]
        for name in self._box_names:
            qpos[:, adr(f'{name}_x')] = u(.1, .3)
            qpos[:, adr(f'{name}_z')] = u(0., .7)
            qpos[:, adr(f'{name}_y')] = u(0., 2 * math.pi)
        params = torch.stack([target_x, target_z], 1)
        return (qpos.reshape(_INIT_ATTEMPTS, batch, model.nq),
                params.reshape(_INIT_ATTEMPTS, batch, 2))

    def initialize_episode(self, model, batch, generator):
        """Random arm pose, box placements and target column, the first of
        8 attempts an env without penetration (JAX stacker.py:65-111)."""
        qposes, params = self.attempts(model, batch, generator)
        idx = randomizers.first_collision_free_index(model, qposes)
        envs = torch.arange(batch, device=qposes.device)
        return make_state(model, qpos=qposes[idx, envs]), params[idx, envs]

    def apply_params(self, model, params):
        tid = model.name2id('body', 'target')
        body_pos = model.body_pos.expand(params.shape[0], -1, -1).clone()
        body_pos[:, tid, 0] = params[:, 0]
        body_pos[:, tid, 2] = params[:, 1]
        return M.with_env_fields(model, body_pos=body_pos)

    def get_observation(self, model, phys, data):
        obs = {'arm_pos': joint_pos(model, phys, _ARM_JOINTS),
               'arm_vel': joint_vel(model, phys, _ARM_JOINTS),
               'touch': touch(model, data)}
        if self._fully_observable:
            obs['hand_pos'] = body_2d_pose(model, data, 'hand')
            obs['box_pos'] = torch.stack([body_2d_pose(model, data, n)
                                          for n in self._box_names], 1)
            obs['box_vel'] = joint_vel(model, phys, self._box_joints)
            obs['target_pos'] = body_2d_pose(model, data, 'target',
                                             orientation=False)
        return obs

    def get_reward(self, model, phys, data, ctrl):
        box_dists = torch.stack([site_distance(model, data, n, 'target')
                                 for n in self._box_names], 1)
        box_is_close = rewards.tolerance(box_dists.min(1).values,
                                         margin=2 * _BOX_SIZE)
        hand_is_far = rewards.tolerance(
            site_distance(model, data, 'grasp', 'target'),
            bounds=(.1, float('inf')), margin=_CLOSE)
        return box_is_close * hand_is_far


def _env(n_boxes, fully_observable, time_limit, device, environment_kwargs):
    model = mjcf.parse(_make_model_xml(props=_props_xml(n_boxes),
                                       geom_solref='.01 1'))
    task = Stack(n_boxes=n_boxes, fully_observable=fully_observable)
    kwargs = dict(environment_kwargs or {})
    kwargs.setdefault('control_timestep', _CONTROL_TIMESTEP)
    return control.Environment(model.to(device), task, time_limit=time_limit,
                               **kwargs)


@SUITE.add('hard')
def stack_2(fully_observable=True, time_limit=_TIME_LIMIT, device='cuda',
            environment_kwargs=None):
    return _env(2, fully_observable, time_limit, device, environment_kwargs)


@SUITE.add('hard')
def stack_4(fully_observable=True, time_limit=_TIME_LIMIT, device='cuda',
            environment_kwargs=None):
    return _env(4, fully_observable, time_limit, device, environment_kwargs)
