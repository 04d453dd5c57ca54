"""MPC agents: the outer MBRL loop on the batched CEM planner."""

from .mpc import (BatchedMPCPolicy, GoalStateAgent, MPCAgent, MPCPolicy,
                  RewardAgent, load, save)

__all__ = ['BatchedMPCPolicy', 'GoalStateAgent', 'MPCAgent', 'MPCPolicy',
           'RewardAgent', 'load', 'save']
