"""MBRL-facing env wrappers: featured state, goals, batched collection."""

from .wrappers import Cheetah, EnvWrapper, Walker, load

__all__ = ['Cheetah', 'EnvWrapper', 'Walker', 'load']
