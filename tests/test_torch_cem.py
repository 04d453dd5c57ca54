"""Planner port (models, ops.cem_rollout plain version, planners.cem_batched)
against the JAX package.

* The plain rollout cost against the JAX ``mlp_rollout_costs_reference``
  on the same actions, with and without normalizers (rtol 1e-5).
* The CEM refit against the JAX ``cem_batched``: both driven by a
  ``sample_costs_fn`` that builds candidates from the same numpy noise,
  looked up by the per-iteration seed (the JAX seeds are precomputed
  from its key). Every iteration's proposal mean and std must agree
  (atol 1e-5), and so must the returned actions.
* The plain sampler's own noise: unit-variance moments and antithetic
  pairs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mbrl_tpu import models as jmodels
from mujoco_mbrl_tpu import planners as jplanners
from mujoco_mbrl_tpu.ops.cem_rollout import (
    mlp_rollout_costs_reference as jax_rollout_costs)
from mujoco_mbrl_tpu_torch import convert, models, planners
from mujoco_mbrl_tpu_torch.ops import cem_rollout

SD, AD, HID = 24, 6, 50


@pytest.fixture(scope='module')
def jparams():
    p = jmodels.MLPDynamics(SD, AD, hidden_units=HID).init(
        jax.random.PRNGKey(1))
    return jax.tree_util.tree_map(np.asarray, p)


def _goal():
    goal = np.zeros(SD, np.float32)
    goal[1] = 1.0
    return goal, np.ones(SD, np.float32)


@pytest.mark.parametrize('with_normalizers', [False, True])
def test_rollout_cost_matches_jax_reference(jparams, with_normalizers):
    rng = np.random.RandomState(0)
    K, H = 64, 5
    s0 = rng.normal(size=(K, SD)).astype(np.float32)
    actions = rng.uniform(-1, 1, (H, K, AD)).astype(np.float32)
    goal, weights = _goal()
    jnorm = tnorm = None
    if with_normalizers:
        stats = dict(state_mean=rng.normal(size=SD),
                     state_std=rng.uniform(0.5, 2.0, SD),
                     action_mean=rng.normal(0, 0.1, AD),
                     action_std=rng.uniform(0.5, 1.5, AD))
        stats = {k: v.astype(np.float32) for k, v in stats.items()}
        jnorm = jmodels.Normalizers(**{k: jnp.asarray(v)
                                       for k, v in stats.items()})
        tnorm = convert.normalizers(jax.tree_util.tree_map(np.asarray, jnorm))
    ref = jax_rollout_costs(jparams, s0, actions, goal, weights, jnorm)
    ours = cem_rollout.mlp_rollout_costs_reference(
        convert.mlp_params(jparams), torch.as_tensor(s0),
        torch.as_tensor(actions), torch.as_tensor(goal),
        torch.as_tensor(weights), tnorm)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_mlp_forward_matches_jax(jparams):
    rng = np.random.RandomState(1)
    s = rng.normal(size=(8, SD)).astype(np.float32)
    a = rng.uniform(-1, 1, (8, AD)).astype(np.float32)
    ref = jmodels.MLPDynamics(SD, AD, HID).forward(jparams, s, a)
    ours = models.MLPDynamics(SD, AD, HID).forward(
        convert.mlp_params(jparams), torch.as_tensor(s), torch.as_tensor(a))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def _jax_seeds(key, n):
    return [int(jax.random.randint(k, (), 0, jnp.iinfo(jnp.int32).max))
            for k in jax.random.split(key, n)]


def run_both_cem(jparams, s0, *, K, H, iters, num_elites, noise_seed=0):
    """Drive JAX and port cem_batched with the same injected noise.

    Returns (jax_actions, port_actions, jax_records, port_records, seeds)
    where records map iteration seed -> (mean, std) proposal at that
    iteration."""
    B = s0.shape[0]
    goal, weights = _goal()
    key = jax.random.PRNGKey(7)
    seeds = _jax_seeds(key, iters)
    rng = np.random.RandomState(noise_seed)
    Z = {s: ((rng.uniform(size=(B, H, AD, K // 2))
              + rng.uniform(size=(B, H, AD, K // 2)) - 1.0)
             * 2.4494897).astype(np.float32) for s in seeds}

    seeds_arr = jnp.asarray(seeds, jnp.int32)
    Zs = jnp.asarray(np.stack([Z[s] for s in seeds]))
    jrec, trec = {}, {}

    def record(store):
        def cb(seed, mean, std):
            store[int(seed)] = (np.asarray(mean), np.asarray(std))
        return cb

    def jscf(seed, mean, std):
        jax.debug.callback(record(jrec), seed, mean, std, ordered=True)
        z = Zs[jnp.argmax(seeds_arr == seed)]
        a = jnp.clip(mean[..., None]
                     + std[..., None] * jnp.concatenate([z, -z], -1), -1, 1)
        s = jnp.broadcast_to(jnp.asarray(s0)[:, None, :], (B, K, SD))
        return jax_rollout_costs(jparams, s, a.transpose(1, 0, 3, 2),
                                 goal, weights), a

    traj = jax.jit(lambda k: jplanners.cem_batched(
        k, jnp.asarray(s0), None, None, horizon=H, action_dim=AD,
        num_candidates=K, num_elites=num_elites, num_iterations=iters,
        sample_costs_fn=jscf, return_states=False))(key)
    j_actions = np.asarray(traj.actions)
    jax.effects_barrier()

    tparams = convert.mlp_params(jparams)
    t_s0 = torch.tensor(s0)

    def tscf(seed, mean, std):
        trec[int(seed)] = (mean.numpy().copy(), std.numpy().copy())
        return cem_rollout.mlp_sample_rollout_costs_plain(
            tparams, seed, t_s0, mean, std, torch.as_tensor(goal),
            torch.as_tensor(weights), K, z=torch.as_tensor(Z[seed]))

    t_traj = planners.cem_batched(seeds, t_s0, H, AD, num_candidates=K,
                                  num_elites=num_elites,
                                  sample_costs_fn=tscf)
    return j_actions, t_traj.actions.numpy(), jrec, trec, seeds


def test_cem_refit_matches_jax(jparams):
    rng = np.random.RandomState(3)
    s0 = rng.normal(size=(3, SD)).astype(np.float32)
    ja, ta, jrec, trec, seeds = run_both_cem(
        jparams, s0, K=64, H=5, iters=4, num_elites=6)
    assert sorted(jrec) == sorted(trec) == sorted(seeds)
    for s in seeds:
        np.testing.assert_allclose(trec[s][0], jrec[s][0], atol=1e-5)
        np.testing.assert_allclose(trec[s][1], jrec[s][1], atol=1e-5)
    assert ta.shape == ja.shape == (5, 3, AD)
    np.testing.assert_allclose(ta, ja, atol=1e-5)
    # the refits moved the proposal (the comparison is not vacuous)
    assert np.abs(jrec[seeds[-1]][1] - 1.0).max() > 0.1


@pytest.mark.parametrize('sampler', ['triangular', 'normal'])
def test_plain_sampler_noise(sampler):
    B, H, K = 4, 10, 2000
    s0 = torch.zeros((B, SD))
    params = models.MLPDynamics(SD, AD, HID).init(
        torch.Generator().manual_seed(0), device='cpu')
    mean = torch.zeros((B, H, AD))
    std = torch.full((B, H, AD), 0.1)
    costs, acts = cem_rollout.mlp_sample_rollout_costs(
        params, 5, s0, mean, std, torch.zeros(SD), torch.ones(SD), K,
        sampler=sampler)
    assert costs.shape == (B, K) and acts.shape == (B, H, AD, K)
    z = acts[..., :K // 2] / 0.1
    assert abs(float(z.mean())) < 2e-2 and abs(float(z.var()) - 1) < 3e-2
    torch.testing.assert_close(acts[..., K // 2:], -acts[..., :K // 2])
    again, _ = cem_rollout.mlp_sample_rollout_costs(
        params, 5, s0, mean, std, torch.zeros(SD), torch.ones(SD), K,
        sampler=sampler)
    torch.testing.assert_close(costs, again)     # deterministic in seed
