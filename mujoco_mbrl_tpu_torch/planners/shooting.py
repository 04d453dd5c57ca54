"""Batched CEM planner.

Port of mujoco_mbrl_tpu/planners/shooting.py:cem_batched.

Only the fused path is ported: ``sample_costs_fn(seed, mean, std)`` samples,
rolls out and costs the candidates (``ops.mlp_sample_rollout_costs``) and
returns exact-K buffers; the elite refit is per env. The per-iteration
seeds are passed in (the JAX function draws them from its key).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch


class Trajectory(NamedTuple):
    states: Optional[torch.Tensor]   # (H+1, B, sd) or None
    actions: torch.Tensor            # (H, B, ad)


def cem_batched(seeds: Sequence[int], initial_states: torch.Tensor,
                horizon: int, action_dim: int, num_candidates: int = 1000,
                num_elites: int = 100,
                init_mean: Optional[torch.Tensor] = None,
                init_std: float = 1.0, action_low: float = -1.0,
                action_high: float = 1.0, min_std: float = 1e-2,
                alpha: float = 0.1,
                sample_costs_fn: Optional[Callable] = None,
                return_states: bool = False) -> Trajectory:
    """CEM for a whole env batch; one iteration per entry of ``seeds``.

    ``sample_costs_fn(seed, mean (B, H, ad), std) -> (costs (B, K),
    actions (B, H, ad, K))``. Each iteration refits every env's proposal
    on its ``num_elites`` lowest-cost candidates:
    mean <- alpha mean + (1 - alpha) elite_mean,
    std <- max(alpha std + (1 - alpha) elite_std, min_std).
    Returns the clipped final mean as actions (H, B, ad).
    """
    if sample_costs_fn is None or return_states:
        raise NotImplementedError(
            'only the fused sample_costs_fn path without states is ported '
            '(mujoco_mbrl_tpu.planners.shooting.cem_batched)')
    H, ad, K = horizon, action_dim, num_candidates
    B = initial_states.shape[0]
    dt, dev = initial_states.dtype, initial_states.device
    mean = (init_mean if init_mean is not None
            else torch.zeros((B, H, ad), dtype=dt, device=dev))
    std = torch.full((B, H, ad), init_std, dtype=dt, device=dev)
    for seed in seeds:
        costs, actions = sample_costs_fn(seed, mean, std)
        if costs.shape != (B, K) or actions.shape != (B, H, ad, K):
            raise ValueError('sample_costs_fn must return exact-K buffers')
        elite_idx = torch.topk(-costs, num_elites, dim=1).indices  # (B, E)
        elites = torch.gather(actions, 3, elite_idx[:, None, None, :].expand(
            B, H, ad, num_elites))
        new_mean = elites.sum(3) / num_elites
        var = torch.clamp((elites * elites).sum(3) / num_elites
                          - new_mean * new_mean, min=0.0)
        mean = alpha * mean + (1 - alpha) * new_mean
        std = torch.clamp(alpha * std + (1 - alpha) * torch.sqrt(var),
                          min=min_std)
    final = torch.clamp(mean, action_low, action_high)
    return Trajectory(states=None, actions=final.transpose(0, 1))
