"""Control-suite port: the walker, cheetah, hopper, reacher, point_mass,
pendulum, cartpole, acrobot, swimmer and humanoid domains and the
environment core.

Each domain module registers its tasks in its own ``SUITE``
(``registry.TaggedTasks``), as in mujoco_mbrl_tpu/suite/__init__.py;
``load`` looks the task up there.
"""

from __future__ import annotations

from ..device import resolve_device
from . import (acrobot, cartpole, cheetah, control, hopper, humanoid,
               pendulum, point_mass, reacher, registry, swimmer, walker)
from .control import EnvState, Environment, TimeStep, flatten_observation

_DOMAINS = {'acrobot': acrobot, 'cartpole': cartpole, 'cheetah': cheetah,
            'hopper': hopper, 'humanoid': humanoid, 'pendulum': pendulum,
            'point_mass': point_mass, 'reacher': reacher,
            'swimmer': swimmer, 'walker': walker}


def load(domain: str, task: str, device=None, **kwargs) -> Environment:
    """Environment for domain/task on `device` (default ``cuda``)."""
    if domain not in _DOMAINS:
        raise NotImplementedError(
            f'domain {domain!r} is not ported (mujoco_mbrl_tpu.suite.load)')
    suite = _DOMAINS[domain].SUITE
    if task not in suite:
        raise ValueError(
            f'Level {task!r} does not exist in domain {domain!r}.')
    return suite[task](device=resolve_device(device), **kwargs)


__all__ = ['EnvState', 'Environment', 'TimeStep', 'acrobot', 'cartpole',
           'cheetah', 'control', 'flatten_observation', 'hopper', 'humanoid',
           'load', 'pendulum', 'point_mass', 'reacher', 'registry', 'swimmer',
           'walker']
