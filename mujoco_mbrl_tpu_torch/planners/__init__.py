"""Planners: the batched CEM of the MPC control step."""

from .shooting import Trajectory, cem_batched

__all__ = ['Trajectory', 'cem_batched']
