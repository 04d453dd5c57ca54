"""The plain reference of the planner: the rollout cost of given
candidates through the MLP dynamics model, and the CEM refit.

A candidate's cost is the sum over the horizon of the goal-state cost of
the next state and the action cost of the action (Khodeir/mujoco-mbrl's
smooth-abs state cost and cosh action cost):
    s_{t+1} = f([s_t; a_t]),
    c += sum_d (sqrt(((s_{t+1} - goal) w)_d^2 + as^2) - as)
         + aa^2 mean_j (cosh(a_{t,j} / aa) - 1),
with as = 0.4 and aa = 0.25. The refit keeps each env's ``num_elites``
lowest-cost candidates as a 0/1 membership and takes their moments by a
masked contraction over the candidates.
"""

from __future__ import annotations

import torch

ALPHA_STATE, ALPHA_ACTION = 0.4, 0.25


def mlp_step(params, s, a):
    """One step of the model on rows s (N, sd), a (N, ad)."""
    x = torch.cat([s, a], -1)
    h = torch.relu(x @ params['l1']['w'] + params['l1']['b'])
    h = torch.relu(h @ params['l2']['w'] + params['l2']['b'])
    return h @ params['l3']['w'] + params['l3']['b']


def rollout_costs(params, s0, actions, goal, weights):
    """Costs (N,) of candidates from start states s0 (N, sd) under actions
    (N, H, ad)."""
    s = s0
    acc = torch.zeros(s0.shape[0], dtype=s0.dtype, device=s0.device)
    for t in range(actions.shape[1]):
        a = actions[:, t]
        s = mlp_step(params, s, a)
        d = (s - goal) * weights
        acc = acc + (torch.sum(torch.sqrt(d * d + ALPHA_STATE ** 2)
                               - ALPHA_STATE, -1)
                     + ALPHA_ACTION ** 2 * torch.mean(
                         torch.cosh(a / ALPHA_ACTION) - 1.0, -1))
    return acc


def candidate_costs(params, s0, cands, goal, weights,
                    block: int = 200_000):
    """Costs (E, K) of sampler-layout candidates cands (E, H, ad, K) from
    s0 (E, sd), computed in blocks of rows."""
    E, H, ad, K = cands.shape
    rows = cands.permute(0, 3, 1, 2).reshape(E * K, H, ad)
    starts = s0[:, None, :].expand(E, K, s0.shape[-1]).reshape(E * K, -1)
    out = [rollout_costs(params, starts[i:i + block], rows[i:i + block],
                         goal, weights)
           for i in range(0, E * K, block)]
    return torch.cat(out).reshape(E, K)


def refit(mean, std, costs, cands, num_elites: int, alpha: float = 0.1,
          min_std: float = 1e-2):
    """One CEM refit of proposals mean / std (E, H, ad) on candidates
    cands (E, H, ad, K) ranked by costs (E, K)."""
    idx = torch.topk(-costs, num_elites, dim=1).indices
    member = torch.zeros_like(costs, dtype=cands.dtype)
    member.scatter_(1, idx, 1.0)
    sum1 = torch.einsum('ehdk,ek->ehd', cands, member)
    sum2 = torch.einsum('ehdk,ek->ehd', cands * cands, member)
    new_mean = sum1 / num_elites
    var = torch.clamp(sum2 / num_elites - new_mean * new_mean, min=0.0)
    mean = alpha * mean + (1 - alpha) * new_mean
    std = torch.clamp(alpha * std + (1 - alpha) * torch.sqrt(var),
                      min=min_std)
    return mean, std


def draw_candidates(generator: torch.Generator, mean, std, K: int):
    """K antithetic candidates (E, H, ad, K) around mean / std: triangular
    noise (u1 + u2 - 1) sqrt(6) of unit variance, candidate k + K/2 the
    mirror of k, clipped to [-1, 1]."""
    E, H, ad = mean.shape
    Kz = (K + 1) // 2
    u = torch.rand((2, E, H, ad, Kz), generator=generator, dtype=mean.dtype,
                   device=mean.device)
    z = (u[0] + u[1] - 1.0) * 6.0 ** 0.5
    z = torch.cat([z, -z[..., :K - Kz]], -1)
    return torch.clamp(mean[..., None] + std[..., None] * z, -1.0, 1.0)

