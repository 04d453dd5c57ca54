"""Class-style planner API (port of mujoco_mbrl_tpu/planners/api.py).

``plan(initial_states (B, sd), model, cost, sample_action, horizon,
initial_trajectory=None, generator=None, **kwargs) -> Trajectory`` with
states (B, H+1, sd) and actions (B, H, ad): the per-env planners over a
leading env axis (see ``shooting``), with a ``torch.Generator`` in place
of the JAX key. The agents' batched CEM (``cem_batched``) reads
``CEMPlanner.defaults``.

``CEMPlanner.plan`` hands a ``normals`` kwarg on to ``cem``, for tests
that feed it JAX's draws.

``ILQRPlanner.plan`` fails as the JAX one does: the JAX method imports
``from . import ilqr``, and the package's ``ilqr`` is the function its
``__init__`` re-exports, so the attribute lookup raises. The ``ilqr``
function itself runs.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import gradient, shooting
from .shooting import Trajectory


def _generator(generator: Optional[torch.Generator],
               initial_states: torch.Tensor) -> torch.Generator:
    """The caller's generator, else one on the states' device seeded 0
    (JAX's default key is PRNGKey(0))."""
    if generator is not None:
        return generator
    return torch.Generator(device=initial_states.device).manual_seed(0)


class ModelPlanner:
    defaults: dict = {}

    @classmethod
    def plan(cls, initial_states, model, cost, sample_action, horizon,
             initial_trajectory=None, generator=None,
             **kwargs) -> Trajectory:
        raise NotImplementedError


class RandomShootingPlanner(ModelPlanner):
    defaults = dict(num_trajectories=1000)

    @classmethod
    def plan(cls, initial_states, model, cost, sample_action, horizon,
             initial_trajectory=None, generator=None,
             **kwargs) -> Trajectory:
        return shooting.random_shooting(
            _generator(generator, initial_states), initial_states, model,
            cost, sample_action, horizon,
            num_trajectories=kwargs.get('num_trajectories',
                                        cls.defaults['num_trajectories']),
            initial_trajectory=initial_trajectory)


class CEMPlanner(ModelPlanner):
    defaults = dict(num_candidates=1000, num_elites=100, num_iterations=5,
                    action_low=-1.0, action_high=1.0)

    @classmethod
    def plan(cls, initial_states, model, cost, sample_action, horizon,
             initial_trajectory=None, generator=None,
             **kwargs) -> Trajectory:
        """``action_dim`` from kwargs, else from one ``sample_action``
        draw, as in JAX."""
        generator = _generator(generator, initial_states)
        cfg = {**cls.defaults, **kwargs}
        action_dim = kwargs.get('action_dim')
        if action_dim is None:
            action_dim = sample_action(generator, (1,)).shape[-1]
        return shooting.cem(
            generator, initial_states, model, cost, horizon, action_dim,
            num_candidates=cfg['num_candidates'],
            num_elites=cfg['num_elites'],
            num_iterations=cfg['num_iterations'],
            init_mean=(initial_trajectory.actions
                       if initial_trajectory is not None else None),
            action_low=cfg['action_low'], action_high=cfg['action_high'],
            normals=kwargs.get('normals'))


class GradientDescentPlanner(ModelPlanner):
    defaults = dict(num_iterations=40, stop_condition=0.002)

    @classmethod
    def plan(cls, initial_states, model, cost, sample_action, horizon,
             initial_trajectory=None, generator=None,
             **kwargs) -> Trajectory:
        cfg = {**cls.defaults, **kwargs}
        return gradient.gradient_descent(
            _generator(generator, initial_states), initial_states, model,
            cost, sample_action, horizon,
            num_iterations=cfg['num_iterations'],
            stop_condition=cfg['stop_condition'],
            initial_trajectory=initial_trajectory)


class ILQRPlanner(ModelPlanner):
    defaults = dict(num_iterations=10)

    @classmethod
    def plan(cls, initial_states, model, cost, sample_action, horizon,
             initial_trajectory=None, generator=None,
             **kwargs) -> Trajectory:
        raise AttributeError(
            "'function' object has no attribute 'ilqr': as in "
            'mujoco_mbrl_tpu.planners.api.ILQRPlanner.plan, whose '
            '`from . import ilqr` finds the function the package '
            're-exports under that name; call planners.ilqr directly')
