"""Control-suite port: the walker, cheetah, hopper, reacher, point_mass,
pendulum, cartpole, acrobot, swimmer, humanoid, humanoid_cmu, finger,
ball_in_cup, lqr, manipulator, stacker, fish and quadruped domains (all 18
of the JAX package's) and the environment core.

Each domain module registers its tasks in its own ``SUITE``
(``registry.TaggedTasks``), as in mujoco_mbrl_tpu/suite/__init__.py;
``load`` looks the task up there. ``all_tasks`` and ``benchmarking`` list
the ported domains' tasks in the JAX package's domain order; a domain not
ported is skipped, as the JAX loader skips one that fails to import.
"""

from __future__ import annotations

from typing import Optional

from ..device import resolve_device
from . import (acrobot, ball_in_cup, cartpole, cheetah, control, finger,
               fish, hopper, humanoid, humanoid_cmu, lqr, manipulator,
               pendulum, point_mass, quadruped, reacher, registry, stacker,
               swimmer, walker)
from .control import EnvState, Environment, TimeStep, flatten_observation

# the JAX package's domain order (mujoco_mbrl_tpu/suite/__init__.py)
_JAX_DOMAINS = ('acrobot', 'ball_in_cup', 'cartpole', 'cheetah', 'finger',
                'fish', 'hopper', 'humanoid', 'humanoid_cmu', 'lqr',
                'manipulator', 'pendulum', 'point_mass', 'quadruped',
                'reacher', 'stacker', 'swimmer', 'walker')
_DOMAINS = {'acrobot': acrobot, 'ball_in_cup': ball_in_cup,
            'cartpole': cartpole, 'cheetah': cheetah, 'finger': finger,
            'fish': fish, 'hopper': hopper, 'humanoid': humanoid,
            'humanoid_cmu': humanoid_cmu, 'lqr': lqr, 'manipulator': manipulator, 'pendulum': pendulum,
            'point_mass': point_mass, 'quadruped': quadruped,
            'reacher': reacher,
            'stacker': stacker, 'swimmer': swimmer, 'walker': walker}


def _get_tasks(tag: Optional[str]):
    return tuple((d, t) for d in _JAX_DOMAINS if d in _DOMAINS
                 for t in (_DOMAINS[d].SUITE if tag is None
                           else _DOMAINS[d].SUITE.tagged(tag)))


def all_tasks():
    """(domain, task) of every ported task."""
    return _get_tasks(None)


def benchmarking():
    """(domain, task) of every ported task tagged 'benchmarking'."""
    return _get_tasks('benchmarking')


def load(domain: str, task: str, task_kwargs: Optional[dict] = None,
         environment_kwargs: Optional[dict] = None,
         device=None) -> Environment:
    """Environment for domain/task on `device` (default ``cuda``);
    ``task_kwargs`` go to the task's factory (``time_limit``, lqr's
    ``seed``), ``environment_kwargs`` to the Environment."""
    # the reference's capitalized spelling, as JAX's _get_domain takes it
    domain = {'humanoid_CMU': 'humanoid_cmu'}.get(domain, domain)
    if domain not in _DOMAINS:
        # JAX imports the domain's module and fails with this error
        raise ModuleNotFoundError(f'no suite domain {domain!r}')
    suite = _DOMAINS[domain].SUITE
    if task not in suite:
        raise ValueError(
            f'Level {task!r} does not exist in domain {domain!r}.')
    kwargs = dict(task_kwargs or {})
    if environment_kwargs is not None:
        kwargs['environment_kwargs'] = environment_kwargs
    return suite[task](device=resolve_device(device), **kwargs)


__all__ = ['EnvState', 'Environment', 'TimeStep', 'acrobot', 'all_tasks',
           'ball_in_cup', 'benchmarking', 'cartpole', 'cheetah', 'control',
           'finger', 'fish', 'flatten_observation', 'hopper', 'humanoid',
           'humanoid_cmu', 'load', 'lqr', 'manipulator', 'pendulum', 'point_mass',
           'quadruped', 'reacher', 'registry', 'stacker', 'swimmer', 'walker']
