"""Planners: the batched CEM of the MPC control step."""

from .api import CEMPlanner
from .shooting import Trajectory, cem_batched

__all__ = ['CEMPlanner', 'Trajectory', 'cem_batched']
