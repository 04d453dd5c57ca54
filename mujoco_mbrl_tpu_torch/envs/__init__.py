"""MBRL-facing env wrappers: featured state, goals, batched collection."""

from .wrappers import EnvWrapper, Walker, load

__all__ = ['EnvWrapper', 'Walker', 'load']
