"""Rollout cost of given actions (ops.cem_rollout.mlp_rollout_costs_t) and
cem_batched's non-fused branch, port against the JAX package.

``mlp_rollout_costs_t`` / ``mlp_rollout_costs`` on CPU tensors (the plain
version, what the CUDA kernel is held to on the card) are compared with
the JAX ``mlp_rollout_costs_reference`` and with the JAX Pallas kernel in
interpret mode (``mlp_rollout_costs_t(..., interpret=True)``) on the same
numpy inputs at the cheetah widths (sd 17, ad 6, hidden 50), with and
without normalizers: rtol 1e-5 (float32 of the same operations; the
rollout is 8 steps). The non-fused planner's elite refit is checked
against a direct computation on the candidates it drew (1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mbrl_tpu.models import MLPDynamics as JMLP
from mujoco_mbrl_tpu.models import Normalizers as JNorm
from mujoco_mbrl_tpu.ops import cem_rollout as jcem
from mujoco_mbrl_tpu_torch import convert
from mujoco_mbrl_tpu_torch.models import MLPDynamics
from mujoco_mbrl_tpu_torch.ops import cem_rollout
from mujoco_mbrl_tpu_torch.planners import cem_batched

SD, AD, HID, H, N = 17, 6, 50, 8, 96


def _inputs(seed, normalized):
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(np.asarray, JMLP(SD, AD, HID).init(
        jax.random.PRNGKey(seed)))
    norm = None
    if normalized:
        norm = dict(state_mean=rng.normal(size=SD),
                    state_std=0.1 + rng.uniform(size=SD),
                    action_mean=0.1 * rng.normal(size=AD),
                    action_std=0.5 + rng.uniform(size=AD))
        norm = {k: np.asarray(v, np.float32) for k, v in norm.items()}
    s0 = rng.normal(size=(N, SD)).astype(np.float32)
    if norm is not None:
        s0 = norm['state_mean'] + norm['state_std'] * s0
    acts = rng.uniform(-1, 1, size=(H, N, AD)).astype(np.float32)
    goal = rng.normal(size=SD).astype(np.float32)
    w = rng.uniform(size=SD).astype(np.float32)
    return params, norm, s0, acts, goal, w


@pytest.mark.parametrize('normalized', [False, True])
def test_rollout_costs_match_jax_reference_and_kernel(normalized):
    params, norm, s0, acts, goal, w = _inputs(int(normalized), normalized)
    jnorm = None if norm is None else JNorm(
        **{k: jnp.asarray(v) for k, v in norm.items()})
    tnorm = None if norm is None else convert.normalizers(
        JNorm(**norm))
    ref = np.asarray(jcem.mlp_rollout_costs_reference(
        params, s0, acts, goal, w, jnorm, alpha_action=0.3))
    kern = np.asarray(jcem.mlp_rollout_costs_t(
        params, jnp.asarray(s0.T), jnp.asarray(acts.transpose(0, 2, 1)),
        goal, w, jnorm, alpha_action=0.3, interpret=True))
    tp = convert.mlp_params(params)
    ours_t = cem_rollout.mlp_rollout_costs_t(
        tp, torch.as_tensor(s0.T.copy()),
        torch.as_tensor(acts.transpose(0, 2, 1).copy()),
        torch.as_tensor(goal), torch.as_tensor(w), tnorm, alpha_action=0.3)
    ours = cem_rollout.mlp_rollout_costs(
        tp, torch.as_tensor(s0), torch.as_tensor(acts),
        torch.as_tensor(goal), torch.as_tensor(w), tnorm, alpha_action=0.3)
    assert ours_t.shape == ours.shape == (N,)
    for got in (ours_t, ours):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), kern, rtol=1e-5, atol=1e-5)


def test_rollout_costs_reject_other_compute_dtypes():
    params, _, s0, acts, goal, w = _inputs(0, False)
    with pytest.raises(NotImplementedError, match='compute_dtype'):
        cem_rollout.mlp_rollout_costs_t(
            convert.mlp_params(params), torch.as_tensor(s0.T.copy()),
            torch.as_tensor(acts.transpose(0, 2, 1).copy()),
            torch.as_tensor(goal), torch.as_tensor(w),
            compute_dtype=torch.float16)


def test_non_fused_cem_refit_equals_direct_computation():
    """One iteration of the non-fused branch: normal draws from a
    generator seeded with the iteration's seed, in the (H, ad, B, K)
    layout, clipped, costed through
    rollout_costs_fn on (sd, B K) states; the refit on the 10 cheapest
    candidates per env equals a direct gather-based computation (the
    returned plan is the refitted mean after one iteration)."""
    B, K, E, Hh = 3, 40, 10, 5
    params = MLPDynamics(SD, AD).init(torch.Generator().manual_seed(0),
                                      device='cpu')
    s0 = torch.randn((B, SD), generator=torch.Generator().manual_seed(1))
    goal, w = torch.zeros(SD), torch.ones(SD)
    seen = []

    def rc(s0T, actionsT):
        seen.append((s0T, actionsT))
        return cem_rollout.mlp_rollout_costs_t(params, s0T, actionsT, goal,
                                               w)
    mean0 = 0.2 * torch.randn((B, Hh, AD),
                              generator=torch.Generator().manual_seed(2))
    traj = cem_batched([7], s0, Hh, AD, num_candidates=K, num_elites=E,
                       init_mean=mean0, rollout_costs_fn=rc)
    s0T, flat = seen[0]
    assert s0T.shape == (SD, B * K) and flat.shape == (Hh, AD, B * K)
    torch.testing.assert_close(s0T.reshape(SD, B, K)[..., 5], s0.T)
    eps = torch.randn((Hh, AD, B, K),
                      generator=torch.Generator().manual_seed(7))
    acts = torch.clamp(mean0.permute(1, 2, 0)[..., None] + eps, -1.0, 1.0)
    torch.testing.assert_close(flat, acts.reshape(Hh, AD, B * K), rtol=0,
                               atol=0)
    costs = cem_rollout.mlp_rollout_costs_reference(
        params, s0[:, None].expand(B, K, SD),
        acts.permute(0, 2, 3, 1), goal, w)                # (B, K)
    idx = torch.topk(-costs, E, dim=1).indices
    elites = torch.stack([acts[:, :, b, idx[b]] for b in range(B)])
    mean = 0.1 * mean0 + 0.9 * elites.mean(-1)            # (B, H, ad)
    torch.testing.assert_close(traj.actions, torch.clamp(
        mean, -1.0, 1.0).transpose(0, 1), rtol=1e-6, atol=1e-6)


def test_batched_policy_plans_through_rollout_costs_fn():
    """Without a sampler builder BatchedMPCPolicy plans through the given
    rollout_costs_fn: one call per CEM iteration on (sd, B K) states."""
    from mujoco_mbrl_tpu_torch.agents import BatchedMPCPolicy
    B, K, Hh = 2, 30, 4
    params = MLPDynamics(SD, AD).init(torch.Generator().manual_seed(0),
                                      device='cpu')
    calls = []

    def rc(s0T, actionsT):
        calls.append(actionsT.shape)
        return cem_rollout.mlp_rollout_costs_t(
            params, s0T, actionsT, torch.zeros(SD), torch.ones(SD))
    policy = BatchedMPCPolicy(Hh, AD, planner_kwargs=dict(
        num_candidates=K, num_elites=3, num_iterations=2),
        rollout_costs_fn=rc)
    obs = torch.randn((B, SD), generator=torch.Generator().manual_seed(1))
    act, (valid, plan) = policy(torch.Generator().manual_seed(2), 0, obs,
                                obs, policy.init_carry())
    assert calls == [(Hh, AD, B * K)] * 2
    assert act.shape == (B, AD) and plan.shape == (Hh, B, AD) and valid
    assert float(act.abs().max()) <= 1.0
