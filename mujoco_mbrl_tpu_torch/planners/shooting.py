"""Sampling planners: random shooting, per-env CEM and the batched CEM.

Port of mujoco_mbrl_tpu/planners/shooting.py.

``random_shooting`` and ``cem`` are the per-env planners. JAX writes them
for one env and the per-env policy maps them over the envs with ``vmap``;
here they take a leading env axis, initial states (B, sd), and return
``Trajectory(states (B, H+1, sd), actions (B, H, ad))``, the vmapped
layout. The model and the cost are mapped over that axis with
``torch.func.vmap`` (``env_map``), so they see the shapes JAX's one-env
planner gives them: a (K, dim) candidate batch in the candidate rollouts,
a single (dim,) state in the re-roll of the chosen sequence. That keeps
the ensemble's row rule per env (``EnsembleDynamics.forward_ts`` splits
members by the rows it is given). Draws come from the ``generator``;
tests hand in JAX's own: the candidates through ``sample_action`` and
CEM's normals through ``normals``.

``cem_batched`` plans for a whole env batch in one call, with three
candidate paths:

* fused: ``sample_costs_fn(seed, mean, std)`` samples, rolls out and costs
  the candidates (``ops.mlp_sample_rollout_costs``) and returns exact-K
  buffers;
* non-fused: the candidates are drawn here, a normal draw clipped to the
  action range in the (H, ad, B, K) layout, and ``rollout_costs_fn(s0T
  (sd, B K), actionsT (H, ad, B K))`` costs them
  (``ops.mlp_rollout_costs_t``);
* the model / cost scan (both functions None): the same draw, costed by
  ``_rollout_costs``, an H-step loop of ``model(s, a)`` over all B K
  candidates that sums ``cost(s_next, a)`` (plain PyTorch, as the JAX
  package leaves it to XLA).

The elite refit is per env. The per-iteration seeds are passed in (the
JAX function draws them from its key); the paths that draw here take each
iteration's normals from ``_normals``: a generator on the states' device
seeded with that iteration's seed. ``return_states`` re-rolls the final
mean through ``model``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch


class Trajectory(NamedTuple):
    """``cem_batched``: states (H+1, B, sd) or None, actions (H, B, ad);
    the per-env planners: states (B, H+1, sd), actions (B, H, ad)."""
    states: Optional[torch.Tensor]
    actions: torch.Tensor


def rollout_actions(model: Callable, initial_state: torch.Tensor,
                    actions: torch.Tensor) -> torch.Tensor:
    """Unroll ``model`` over a (H, ..., ad) action sequence -> (H, ...,
    sd); leading batch axes of ``initial_state`` broadcast."""
    states, s = [], initial_state
    for a in actions:
        s = model(s, a)
        states.append(s)
    return torch.stack(states)


def _rollout_costs(model: Callable, cost: Callable,
                   initial_state: torch.Tensor,
                   actions: torch.Tensor) -> torch.Tensor:
    """Total cost of each candidate, sum over t of cost(s_{t+1}, a_t),
    without keeping the state trajectory. initial_state (N, sd), actions
    (H, N, ad) -> (N,)."""
    s = initial_state
    acc = torch.zeros(initial_state.shape[:-1], dtype=initial_state.dtype,
                      device=initial_state.device)
    for a in actions:
        s = model(s, a)
        acc = acc + cost(s, a)
    return acc


def env_map(fn: Callable, dims: int = 1) -> Callable:
    """``fn`` mapped over ``dims`` leading env axes (``torch.func.vmap``):
    inside, it sees one env's arrays."""
    for _ in range(dims):
        fn = torch.func.vmap(fn)
    return fn


def rollout_env(model: Callable, initial_states: torch.Tensor,
                actions: torch.Tensor) -> torch.Tensor:
    """Each env's sequence through ``model`` from its own state, the
    model seeing one env's (sd,) state: initial_states (B, sd), actions
    (B, H, ad) -> states (B, H, sd)."""
    step, s, states = env_map(model), initial_states, []
    for t in range(actions.shape[1]):
        s = step(s, actions[:, t])
        states.append(s)
    return torch.stack(states, 1)


def env_trajectory(model: Callable, initial_states: torch.Tensor,
                   actions: torch.Tensor) -> Trajectory:
    """(B, H, ad) actions re-rolled per env: states (B, H+1, sd)."""
    states = rollout_env(model, initial_states, actions)
    return Trajectory(states=torch.cat([initial_states[:, None], states], 1),
                      actions=actions)


def env_rollout_costs(model: Callable, cost: Callable,
                      initial_states: torch.Tensor,
                      actions: torch.Tensor) -> torch.Tensor:
    """Total cost of each env's candidates, sum over t of cost(s_{t+1},
    a_t), the model and cost seeing one env's (K, dim) batch:
    initial_states (B, sd), actions (B, H, K, ad) -> (B, K)."""
    B, H, K, _ = actions.shape
    step, step_cost = env_map(model), env_map(cost)
    s = initial_states[:, None].expand(B, K, initial_states.shape[-1])
    acc = initial_states.new_zeros((B, K))
    for t in range(H):
        s = step(s, actions[:, t])
        acc = acc + step_cost(s, actions[:, t])
    return acc


def random_shooting(generator: torch.Generator,
                    initial_states: torch.Tensor, model: Callable,
                    cost: Callable, sample_action: Callable, horizon: int,
                    num_trajectories: int = 1000,
                    initial_trajectory: Optional[Trajectory] = None,
                    info: Optional[dict] = None) -> Trajectory:
    """K candidate sequences per env from ``sample_action(generator, (B,
    H, K))``, the lowest total cost kept and re-rolled through the model
    (shooting.py:66-93). A warm start, ``initial_trajectory.actions`` (B,
    H, ad), replaces each env's candidate 0. ``info``, when given,
    receives 'costs' (B, K), the candidates' total costs."""
    actions = sample_action(generator, (initial_states.shape[0], horizon,
                                        num_trajectories))
    if initial_trajectory is not None:
        actions = actions.clone()
        actions[:, :, 0] = initial_trajectory.actions
    costs = env_rollout_costs(model, cost, initial_states, actions)
    if info is not None:
        info['costs'] = costs
    best = torch.argmin(costs, dim=1)
    env = torch.arange(actions.shape[0], device=actions.device)
    return env_trajectory(model, initial_states, actions[env, :, best])


def cem(generator: torch.Generator, initial_states: torch.Tensor,
        model: Callable, cost: Callable, horizon: int, action_dim: int,
        num_candidates: int = 1000, num_elites: int = 100,
        num_iterations: int = 5, init_mean: Optional[torch.Tensor] = None,
        init_std: float = 1.0, action_low: float = -1.0,
        action_high: float = 1.0, min_std: float = 1e-2, alpha: float = 0.1,
        normals: Optional[torch.Tensor] = None,
        info: Optional[dict] = None) -> Trajectory:
    """The per-env cross-entropy method (shooting.py:96-140): each env's
    Gaussian over its (H, ad) sequence is refit on its ``num_elites``
    lowest-cost candidates, mean <- alpha mean + (1 - alpha) elite mean,
    std <- max(alpha std + (1 - alpha) elite std, min_std) (the elites'
    population std); returns the clipped final mean re-rolled through the
    model. ``init_mean`` (B, H, ad); ``normals`` (num_iterations, B, H, K,
    ad) replaces the draws from ``generator``. ``info``, when given,
    receives 'costs' (num_iterations, B, K), each iteration's candidate
    costs."""
    B, H, ad, K = initial_states.shape[0], horizon, action_dim, num_candidates
    dt, dev = initial_states.dtype, initial_states.device
    mean = (init_mean if init_mean is not None
            else torch.zeros((B, H, ad), dtype=dt, device=dev))
    std = torch.full((B, H, ad), init_std, dtype=dt, device=dev)
    all_costs = []
    for i in range(num_iterations):
        eps = (normals[i] if normals is not None else torch.randn(
            (B, H, K, ad), generator=generator, dtype=dt,
            device=generator.device).to(dev))
        actions = torch.clamp(mean[:, :, None] + std[:, :, None] * eps,
                              action_low, action_high)      # (B, H, K, ad)
        costs = env_rollout_costs(model, cost, initial_states, actions)
        all_costs.append(costs)
        elite_idx = torch.topk(-costs, num_elites, dim=1).indices
        elites = torch.gather(actions, 2, elite_idx[:, None, :, None].expand(
            B, H, num_elites, ad))
        mean = alpha * mean + (1 - alpha) * elites.mean(2)
        std = torch.clamp(alpha * std + (1 - alpha) * elites.std(
            2, correction=0), min=min_std)
    if info is not None:
        info['costs'] = torch.stack(all_costs)
    return env_trajectory(model, initial_states,
                          torch.clamp(mean, action_low, action_high))


def _normals(seed: int, shape, dtype, device) -> torch.Tensor:
    """Standard normals of one CEM iteration, from a generator on
    ``device`` seeded with the iteration's seed."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn(shape, generator=g, dtype=dtype, device=device)


def cem_batched(seeds: Sequence[int], initial_states: torch.Tensor,
                horizon: int, action_dim: int, num_candidates: int = 1000,
                num_elites: int = 100,
                init_mean: Optional[torch.Tensor] = None,
                init_std: float = 1.0, action_low: float = -1.0,
                action_high: float = 1.0, min_std: float = 1e-2,
                alpha: float = 0.1,
                rollout_costs_fn: Optional[Callable] = None,
                sample_costs_fn: Optional[Callable] = None,
                return_states: bool = False,
                model: Optional[Callable] = None,
                cost: Optional[Callable] = None) -> Trajectory:
    """CEM for a whole env batch; one iteration per entry of ``seeds``.

    ``sample_costs_fn(seed, mean (B, H, ad), std) -> (costs (B, K),
    actions (B, H, ad, K))`` (actions float32 or bf16) takes precedence;
    without it candidates are drawn here and costed by
    ``rollout_costs_fn(s0T, actionsT) -> (B K,)`` or, without that too, by
    the scan of ``model(s (N, sd), a (N, ad)) -> (N, sd)`` and ``cost(s,
    a) -> (N,)``. Each iteration refits every
    env's proposal on its ``num_elites`` lowest-cost candidates:
    mean <- alpha mean + (1 - alpha) elite_mean,
    std <- max(alpha std + (1 - alpha) elite_std, min_std).
    Returns the clipped final mean as actions (H, B, ad) and, with
    ``return_states`` (which needs ``model``), its states (H+1, B, sd)
    re-rolled through ``model``; the JAX default is True, the port's
    False, as every batched caller asks.
    """
    scan = sample_costs_fn is None and rollout_costs_fn is None
    if (scan and (model is None or cost is None)) or (
            return_states and model is None):
        raise ValueError('cem_batched needs sample_costs_fn, '
                         'rollout_costs_fn or a model and a cost')
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
            # bf16 actions (the kernels' bf16 mode) are widened to the
            # proposal's dtype, as JAX's refit promotes them against its
            # float32 membership
            elites = torch.gather(actions, 3, elite_idx[:, None, None, :]
                                  .expand(B, H, ad, num_elites)).to(dt)
            sum1, sum2 = elites.sum(3), (elites * elites).sum(3)
        else:
            eps = _normals(seed, (H, ad, B, K), dt, dev)
            actions = torch.clamp(
                mean.permute(1, 2, 0)[..., None]
                + std.permute(1, 2, 0)[..., None] * eps,
                action_low, action_high)                   # (H, ad, B, K)
            flat = actions.reshape(H, ad, B * K)
            if scan:
                costs = _rollout_costs(model, cost, s0T.T,
                                       flat.transpose(1, 2)).reshape(B, K)
            else:
                costs = rollout_costs_fn(s0T, flat).reshape(B, K)
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
    acts = torch.clamp(mean, action_low, action_high).transpose(0, 1)
    if not return_states:
        return Trajectory(states=None, actions=acts)
    states = rollout_actions(model, initial_states, acts)
    return Trajectory(states=torch.cat([initial_states[None], states], 0),
                      actions=acts)
