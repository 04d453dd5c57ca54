"""iLQR trajectory optimizer over the learned dynamics model (port of
mujoco_mbrl_tpu/planners/ilqr.py).

Per env, as JAX's one-env ``ilqr`` under ``vmap``: the model is
linearised along the nominal trajectory (``utils.jacobian``, forward mode
here), the cost's gradients and Hessians come from ``torch.func``, the
backward Riccati recursion runs over (B, ...) matrices, and the forward
pass tries five step sizes; each env keeps its best only if it lowers
that env's cost.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..utils.jacobian import compute_jacobian
from .shooting import Trajectory, env_map, env_trajectory, rollout_env

_ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.03)


def ilqr(generator: torch.Generator, initial_states: torch.Tensor,
         model: Callable, cost: Callable, sample_action: Callable,
         horizon: int, num_iterations: int = 10, reg: float = 1e-6,
         initial_trajectory: Optional[Trajectory] = None,
         info: Optional[dict] = None) -> Trajectory:
    """Iterative LQR over (B, H, ad) actions (ilqr.py:24-108); ``cost(
    states, actions)`` is per step. ``info``, when given, receives
    'alphas' (num_iterations, B): the step size each env accepted in each
    iteration, 0 where it kept its sequence; 'costs' (num_iterations, 5,
    B): each step size's total cost; 'initial_cost' (B,)."""
    B, sd = initial_states.shape
    actions = (sample_action(generator, (B, horizon))
               if initial_trajectory is None else initial_trajectory.actions)
    ad = actions.shape[-1]
    dt, dev = actions.dtype, actions.device
    alphas = torch.tensor(_ALPHAS, dtype=dt, device=dev)
    n_a = len(_ALPHAS)

    def step_cost(s, a):
        return cost(s[None], a[None])[0]

    per_step = lambda fn: env_map(fn, 2)        # over (env, step)
    A_fn = per_step(lambda x, a: compute_jacobian(lambda y: model(y, a), x))
    B_fn = per_step(lambda x, a: compute_jacobian(lambda u: model(x, u), a))
    cx_fn = per_step(torch.func.grad(step_cost, argnums=0))
    cu_fn = per_step(torch.func.grad(step_cost, argnums=1))
    cxx_fn = per_step(torch.func.hessian(step_cost, argnums=0))
    cuu_fn = per_step(torch.func.hessian(step_cost, argnums=1))
    seq_cost = env_map(lambda s, a: cost(s, a).sum(), 2)
    T = lambda m: m.transpose(-1, -2)
    mv = lambda m, v: (m @ v[..., None])[..., 0]
    eye = reg * torch.eye(ad, dtype=dt, device=dev)

    prev_cost = env_map(lambda s, a: cost(s, a).sum())(
        rollout_env(model, initial_states, actions), actions)
    initial_cost, accepted, tried = prev_cost, [], []
    for _ in range(num_iterations):
        states = rollout_env(model, initial_states, actions)
        xs = torch.cat([initial_states[:, None], states[:, :-1]], 1)
        A, Bm = A_fn(xs, actions), B_fn(xs, actions)
        cx, cu = cx_fn(xs, actions), cu_fn(xs, actions)
        cxx, cuu = cxx_fn(xs, actions), cuu_fn(xs, actions)

        Vx = torch.zeros((B, sd), dtype=dt, device=dev)
        Vxx = torch.zeros((B, sd, sd), dtype=dt, device=dev)
        ks, Ks = [None] * horizon, [None] * horizon
        for t in reversed(range(horizon)):
            At, Bt = A[:, t], Bm[:, t]
            Qx = cx[:, t] + mv(T(At), Vx)
            Qu = cu[:, t] + mv(T(Bt), Vx)
            Qxx = cxx[:, t] + T(At) @ Vxx @ At
            Quu = cuu[:, t] + T(Bt) @ Vxx @ Bt + eye
            Qux = T(Bt) @ Vxx @ At
            Quu_inv = torch.linalg.inv(Quu)
            k, K = -mv(Quu_inv, Qu), -Quu_inv @ Qux
            Vx = Qx + mv(T(K) @ Quu, k) + mv(T(K), Qu) + mv(T(Qux), k)
            Vxx = Qxx + T(K) @ Quu @ K + T(K) @ Qux + T(Qux) @ K
            Vxx = 0.5 * (Vxx + T(Vxx))
            ks[t], Ks[t] = k, K

        # forward pass, every step size at once: (alpha, env, ...)
        s = initial_states.expand(n_a, B, sd)
        new_actions, new_states = [], []
        for t in range(horizon):
            a = (actions[:, t] + alphas[:, None, None] * ks[t]
                 + mv(Ks[t], s - xs[:, t]))
            s = env_map(model, 2)(s, a)
            new_actions.append(a)
            new_states.append(s)
        cand = torch.stack(new_actions, 2)                  # (A, B, H, ad)
        cand_costs = seq_cost(torch.stack(new_states, 2), cand)    # (A, B)
        tried.append(cand_costs)
        best = torch.argmin(cand_costs, dim=0)
        env = torch.arange(B, device=dev)
        best_cost = cand_costs[best, env]
        improved = best_cost < prev_cost
        actions = torch.where(improved[:, None, None], cand[best, env],
                              actions)
        prev_cost = torch.minimum(best_cost, prev_cost)
        accepted.append(torch.where(improved, alphas[best],
                                    torch.zeros_like(best_cost)))
    if info is not None:
        info.update(alphas=torch.stack(accepted), costs=torch.stack(tried),
                    initial_cost=initial_cost)
    return env_trajectory(model, initial_states, actions)
