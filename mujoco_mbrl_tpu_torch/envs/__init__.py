"""MBRL-facing env wrappers: featured state, goals, batched collection."""

from .wrappers import (Cartpole, Cheetah, EnvWrapper, Pendulum, PointMass,
                       Reacher, Walker, load)

__all__ = ['Cartpole', 'Cheetah', 'EnvWrapper', 'Pendulum', 'PointMass',
           'Reacher', 'Walker', 'load']
