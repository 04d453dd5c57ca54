"""Locomotion tasks over composer-lite entities (port of
mujoco_mbrl_tpu/locomotion/tasks.py), batched.

* :class:`RunThroughCorridor` — reward the walker for moving at a target
  velocity along the corridor with the reference's linear `tolerance`
  (locomotion/tasks/corridors.py get_reward: tolerance(xvel, (v, v),
  margin=v, sigmoid='linear', value_at_margin=0)); the episode ends when
  the torso falls below `terminate_at_height`.
* :class:`GoToTarget` — sparse reward within `distance_tolerance` of a
  per-episode random target (locomotion/tasks/go_to_target.py); each
  env's target moves its own ``site_pos`` (``with_env_fields``).
"""

from __future__ import annotations

import torch

from .. import composer, variation
from ..physics import model as M
from ..suite import rewards
from . import arenas, walkers


class RunThroughCorridor(composer.Task):
    control_timestep = 0.025
    OBSERVES_ACC = False

    def __init__(self, walker: composer.Entity = None,
                 arena: composer.Entity = None,
                 target_velocity: float = 3.0,
                 terminate_at_height: float = 0.3,
                 walker_spawn_x=None):
        arena = arena or arenas.Corridor()
        super().__init__(arena)
        self.arena = arena
        self.walker = self.attach(walker or walkers.PlanarWalker(),
                                  'walker/')
        self._vel = target_velocity
        self._terminate_at_height = terminate_at_height
        self._spawn_x = walker_spawn_x or variation.Uniform(-0.4, 0.4)

    def initialize_episode(self, model, batch, generator):
        state = M.make_state(model, batch=batch)
        jx = model.names['joint']['walker/rootx']
        qpos = state.qpos.clone()
        qpos[:, model.jnt_qposadr[jx]] = self._spawn_x(
            generator, (batch,), qpos.device).to(qpos.dtype)
        return state.replace(qpos=qpos), ()

    def get_reward(self, model, phys, data, ctrl):
        xvel = self.walker.forward_velocity(model, phys, data)
        return rewards.tolerance(xvel, (self._vel, self._vel),
                                 margin=self._vel, sigmoid='linear',
                                 value_at_margin=0.0)

    def get_termination(self, model, phys, data):
        height = self.walker.torso_height(model, phys, data)
        return height < self._terminate_at_height, torch.zeros_like(height)


class GoToTarget(composer.Task):
    control_timestep = 0.025
    OBSERVES_ACC = False

    def __init__(self, walker: composer.Entity = None,
                 arena: composer.Entity = None,
                 distance_tolerance: float = 0.5,
                 target_spawn_range: float = 5.0):
        arena = arena or arenas.Floor()
        super().__init__(arena)
        self.arena = arena
        self.walker = self.attach(walker or walkers.PlanarWalker(),
                                  'walker/')
        self._tol = distance_tolerance
        self._range = target_spawn_range

    def initialize_episode_mjcf(self, root):
        root.worldbody.add('site', name='target', type='sphere',
                           size=[0.1], pos=[0, 0, 0.1])

    def initialize_episode(self, model, batch, generator):
        """The reference pose and each env's target xy (B, 2) in
        [-range, range)."""
        target_xy = variation.Uniform(-self._range, self._range)(
            generator, (batch, 2), model.device).to(model.dtype)
        return M.make_state(model, batch=batch), target_xy

    def apply_params(self, model, params):
        sid = model.names['site']['target']
        site_pos = model.site_pos.expand(
            (params.shape[0],) + tuple(model.site_pos.shape[-2:])).clone()
        site_pos[:, sid, :2] = params
        return M.with_env_fields(model, site_pos=site_pos)

    def get_reward(self, model, phys, data, ctrl):
        sid = model.names['site']['target']
        dist = torch.linalg.vector_norm(
            data.site_xpos[:, sid, :2]
            - self.walker.root_xy(model, phys, data), dim=-1)
        return (dist < self._tol).to(phys.qpos.dtype)
