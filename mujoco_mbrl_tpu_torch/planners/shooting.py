"""Batched CEM planner.

Port of mujoco_mbrl_tpu/planners/shooting.py:cem_batched, both of its
candidate paths:

* fused: ``sample_costs_fn(seed, mean, std)`` samples, rolls out and costs
  the candidates (``ops.mlp_sample_rollout_costs``) and returns exact-K
  buffers;
* non-fused: the candidates are drawn here, a normal draw clipped to the
  action range in the (H, ad, B, K) layout, and ``rollout_costs_fn(s0T
  (sd, B K), actionsT (H, ad, B K))`` costs them
  (``ops.mlp_rollout_costs_t``).

The elite refit is per env. The per-iteration seeds are passed in (the
JAX function draws them from its key); the non-fused path draws each
iteration's normals from a generator on the states' device seeded with
that iteration's seed. The model / cost scan (``_rollout_costs``, both
functions None) and ``return_states`` are not ported.
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
                rollout_costs_fn: Optional[Callable] = None,
                sample_costs_fn: Optional[Callable] = None,
                return_states: bool = False) -> Trajectory:
    """CEM for a whole env batch; one iteration per entry of ``seeds``.

    ``sample_costs_fn(seed, mean (B, H, ad), std) -> (costs (B, K),
    actions (B, H, ad, K))`` takes precedence; without it
    ``rollout_costs_fn(s0T, actionsT) -> (B K,)`` costs candidates drawn
    here. Each iteration refits every env's proposal on its
    ``num_elites`` lowest-cost candidates:
    mean <- alpha mean + (1 - alpha) elite_mean,
    std <- max(alpha std + (1 - alpha) elite_std, min_std).
    Returns the clipped final mean as actions (H, B, ad).
    """
    if (sample_costs_fn is None and rollout_costs_fn is None) \
            or return_states:
        raise NotImplementedError(
            'the model / cost scan path (_rollout_costs) and return_states '
            'are not ported (mujoco_mbrl_tpu.planners.shooting.cem_batched)')
    H, ad, K = horizon, action_dim, num_candidates
    B, sd = initial_states.shape
    dt, dev = initial_states.dtype, initial_states.device
    mean = (init_mean if init_mean is not None
            else torch.zeros((B, H, ad), dtype=dt, device=dev))
    std = torch.full((B, H, ad), init_std, dtype=dt, device=dev)
    if sample_costs_fn is None:
        # kernel-layout initial states: (sd, B K), candidates trailing
        s0T = initial_states.T[:, :, None].expand(sd, B, K).reshape(
            sd, B * K).contiguous()
    for seed in seeds:
        if sample_costs_fn is not None:
            costs, actions = sample_costs_fn(seed, mean, std)
            if costs.shape != (B, K) or actions.shape != (B, H, ad, K):
                raise ValueError('sample_costs_fn must return exact-K '
                                 'buffers')
            elite_idx = torch.topk(-costs, num_elites, dim=1).indices
            elites = torch.gather(actions, 3, elite_idx[:, None, None, :]
                                  .expand(B, H, ad, num_elites))
            sum1, sum2 = elites.sum(3), (elites * elites).sum(3)
        else:
            g = torch.Generator(device=dev).manual_seed(int(seed))
            eps = torch.randn((H, ad, B, K), generator=g, dtype=dt,
                              device=dev)
            actions = torch.clamp(
                mean.permute(1, 2, 0)[..., None]
                + std.permute(1, 2, 0)[..., None] * eps,
                action_low, action_high)                   # (H, ad, B, K)
            costs = rollout_costs_fn(
                s0T, actions.reshape(H, ad, B * K)).reshape(B, K)
            elite_idx = torch.topk(-costs, num_elites, dim=1).indices
            # masked reduction over K (JAX shooting.py:271-289)
            member = torch.zeros((B, K), dtype=dt, device=dev)
            member.scatter_(1, elite_idx, 1.0)
            sum1 = torch.einsum('hdbk,bk->bhd', actions, member)
            sum2 = torch.einsum('hdbk,bk->bhd', actions * actions, member)
        new_mean = sum1 / num_elites
        var = torch.clamp(sum2 / num_elites - new_mean * new_mean, min=0.0)
        mean = alpha * mean + (1 - alpha) * new_mean
        std = torch.clamp(alpha * std + (1 - alpha) * torch.sqrt(var),
                          min=min_std)
    final = torch.clamp(mean, action_low, action_high)
    return Trajectory(states=None, actions=final.transpose(0, 1))
