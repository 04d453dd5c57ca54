"""Control-suite port: the walker, cheetah, hopper, reacher, point_mass,
pendulum, cartpole, acrobot, swimmer, humanoid, humanoid_cmu, finger,
ball_in_cup, lqr, manipulator, stacker, fish and quadruped domains (all 18
of the JAX package's) and the environment core.

Each domain module registers its tasks in its own ``SUITE``
(``registry.TaggedTasks``), as in mujoco_mbrl_tpu/suite/__init__.py;
``load`` (or ``build_environment``) looks the task up there.
``all_tasks`` and ``benchmarking`` list the ported domains' tasks in the
JAX package's domain order; a domain not ported is skipped, as the JAX
loader skips one that fails to import.
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


ALL_TASKS = None          # filled by all_tasks()
BENCHMARKING = None       # filled by benchmarking()


def all_tasks():
    """(domain, task) of every ported task."""
    global ALL_TASKS
    if ALL_TASKS is None:
        ALL_TASKS = _get_tasks(None)
    return ALL_TASKS


def benchmarking():
    """(domain, task) of every ported task tagged 'benchmarking'."""
    global BENCHMARKING
    if BENCHMARKING is None:
        BENCHMARKING = _get_tasks('benchmarking')
    return BENCHMARKING


def load(domain_name: Optional[str] = None, task_name: Optional[str] = None,
         task_kwargs: Optional[dict] = None,
         environment_kwargs: Optional[dict] = None, device=None, *,
         domain: Optional[str] = None,
         task: Optional[str] = None) -> Environment:
    """Environment for a domain / task pair on `device` (default
    ``cuda``), named by JAX's ``domain_name`` / ``task_name`` or by
    ``domain`` / ``task``; ``task_kwargs`` go to the task's factory
    (``time_limit``, lqr's ``seed``), ``environment_kwargs`` to the
    Environment (``control_timestep``, ``max_reset_attempts``)."""
    domain_name = domain if domain_name is None else domain_name
    task_name = task if task_name is None else task_name
    if domain_name is None or task_name is None:
        raise TypeError('load() needs a domain_name and a task_name')
    return build_environment(domain_name, task_name, task_kwargs,
                             environment_kwargs, device)


def build_environment(domain_name: str, task_name: str,
                      task_kwargs: Optional[dict] = None,
                      environment_kwargs: Optional[dict] = None,
                      device=None) -> Environment:
    """`load`'s worker, as in the JAX package."""
    # the reference's capitalized spelling, as JAX's _get_domain takes it
    domain_name = {'humanoid_CMU': 'humanoid_cmu'}.get(domain_name,
                                                       domain_name)
    if domain_name not in _DOMAINS:
        # JAX imports the domain's module and fails with this error
        raise ModuleNotFoundError(f'no suite domain {domain_name!r}')
    suite = _DOMAINS[domain_name].SUITE
    if task_name not in suite:
        raise ValueError(f'Level {task_name!r} does not exist in domain '
                         f'{domain_name!r}.')
    kwargs = dict(task_kwargs or {})
    if environment_kwargs is not None:
        kwargs['environment_kwargs'] = environment_kwargs
    return suite[task_name](device=resolve_device(device), **kwargs)


__all__ = ['ALL_TASKS', 'BENCHMARKING', 'EnvState', 'Environment',
           'TimeStep', 'acrobot', 'all_tasks', 'ball_in_cup', 'benchmarking',
           'build_environment', 'cartpole', 'cheetah', 'control',
           'finger', 'fish', 'flatten_observation', 'hopper', 'humanoid',
           'humanoid_cmu', 'load', 'lqr', 'manipulator', 'pendulum', 'point_mass',
           'quadruped', 'reacher', 'registry', 'stacker', 'swimmer', 'walker']
