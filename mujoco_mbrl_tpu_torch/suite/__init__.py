"""Control-suite port: the walker and cheetah domains and the environment
core."""

from __future__ import annotations

from ..device import resolve_device
from . import cheetah, control, walker
from .control import EnvState, Environment, TimeStep, flatten_observation

_DOMAINS = {'cheetah': cheetah, 'walker': walker}


def load(domain: str, task: str, device=None, **kwargs) -> Environment:
    """Environment for domain/task on `device` (default ``cuda``)."""
    if domain not in _DOMAINS:
        raise NotImplementedError(
            f'domain {domain!r} is not ported (mujoco_mbrl_tpu.suite.load)')
    return getattr(_DOMAINS[domain], task)(device=resolve_device(device),
                                           **kwargs)


__all__ = ['EnvState', 'Environment', 'TimeStep', 'cheetah', 'control',
           'flatten_observation', 'load', 'walker']
