"""Gradient-descent trajectory optimizer (port of
mujoco_mbrl_tpu/planners/gradient.py).

Adam on each env's action sequence through the unrolled model, with an
early stop per env. JAX runs one env's ``lax.while_loop`` under ``vmap``:
the loop goes on while any env's condition holds, and an env whose
condition has failed keeps its carry (actions, Adam moments, count). So
the Adam here is optax's, written by hand over (B, H, ad) with a per-env
mask; ``torch.optim.Adam`` cannot freeze single envs. The gradient is
``torch.func.grad`` of one env's total cost, mapped over the envs, so the
model sees one env's (sd,) state as in JAX.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .shooting import Trajectory, env_map, env_trajectory

# optax.adam's defaults
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def gradient_descent(generator: torch.Generator,
                     initial_states: torch.Tensor, model: Callable,
                     cost: Callable, sample_action: Callable, horizon: int,
                     num_iterations: int = 40,
                     stop_condition: float = 0.002,
                     learning_rate: float = 0.01,
                     initial_trajectory: Optional[Trajectory] = None,
                     info: Optional[dict] = None) -> Trajectory:
    """Adam(``learning_rate``) on the (B, H, ad) actions; env b stops after
    ``num_iterations`` or once the mean |change of its actions| in an
    iteration falls below ``stop_condition`` (gradient.py:21-66). The
    start is ``initial_trajectory.actions``, else ``sample_action(
    generator, (B, H))``. ``info``, when given, receives 'iterations'
    (B,): the iterations each env ran."""
    B = initial_states.shape[0]
    actions = (sample_action(generator, (B, horizon))
               if initial_trajectory is None else initial_trajectory.actions)

    def total_cost(acts, s0):
        s, states = s0, []
        for a in acts:
            s = model(s, a)
            states.append(s)
        return torch.sum(cost(torch.stack(states), acts))

    grad_fn = env_map(torch.func.grad(total_cost))
    mu, nu = torch.zeros_like(actions), torch.zeros_like(actions)
    count = torch.zeros((B,), dtype=actions.dtype, device=actions.device)
    delta = torch.full((B,), float('inf'), dtype=actions.dtype,
                       device=actions.device)
    while True:
        active = (count < num_iterations) & (delta >= stop_condition)
        if not bool(active.any()):
            break
        g = grad_fn(actions, initial_states)
        mu_new = (1 - _B1) * g + _B1 * mu
        nu_new = (1 - _B2) * g * g + _B2 * nu
        c = (count + 1)[:, None, None]
        step = (mu_new / (1 - _B1 ** c)) / (
            torch.sqrt(nu_new / (1 - _B2 ** c)) + _EPS)
        new_actions = actions + (-learning_rate) * step
        d = torch.mean(torch.abs(new_actions - actions), dim=(1, 2))
        on = active[:, None, None]
        actions = torch.where(on, new_actions, actions)
        mu = torch.where(on, mu_new, mu)
        nu = torch.where(on, nu_new, nu)
        count = torch.where(active, count + 1, count)
        delta = torch.where(active, d, delta)
    if info is not None:
        info['iterations'] = count.to(torch.int64)
    return env_trajectory(model, initial_states, actions)
