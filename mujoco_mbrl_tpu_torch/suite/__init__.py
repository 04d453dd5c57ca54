"""Control-suite port: the walker, cheetah, reacher, point_mass,
pendulum and humanoid domains and the environment core.

Each domain module registers its tasks in its own ``SUITE``
(``registry.TaggedTasks``), as in mujoco_mbrl_tpu/suite/__init__.py;
``load`` looks the task up there.
"""

from __future__ import annotations

from ..device import resolve_device
from . import (cheetah, control, humanoid, pendulum, point_mass, reacher,
               registry, walker)
from .control import EnvState, Environment, TimeStep, flatten_observation

_DOMAINS = {'cheetah': cheetah, 'humanoid': humanoid,
            'pendulum': pendulum, 'point_mass': point_mass,
            'reacher': reacher, 'walker': walker}


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


__all__ = ['EnvState', 'Environment', 'TimeStep', 'cheetah', 'control',
           'flatten_observation', 'humanoid', 'load', 'pendulum',
           'point_mass', 'reacher', 'registry', 'walker']
