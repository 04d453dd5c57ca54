"""Trajectory-optimization planners: random shooting, per-env CEM,
gradient descent and iLQR over a leading env axis, the batched CEM of the
agents' control step, and the class-style ``plan`` API."""

from .shooting import Trajectory, cem, cem_batched, random_shooting
from .gradient import gradient_descent
from .ilqr import ilqr
from .api import (CEMPlanner, GradientDescentPlanner, ILQRPlanner,
                  ModelPlanner, RandomShootingPlanner)

__all__ = ['CEMPlanner', 'GradientDescentPlanner', 'ILQRPlanner',
           'ModelPlanner', 'RandomShootingPlanner', 'Trajectory', 'cem',
           'cem_batched', 'gradient_descent', 'ilqr', 'random_shooting']
