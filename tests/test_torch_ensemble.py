"""Ensemble TS-infinity planning and the spline4 sampler, port vs JAX.

* The plain ensemble cost of given actions (candidate k rolled by member
  k % n) against the JAX per-member ``mlp_rollout_costs_reference``
  selected by k % n (as ``bench.py`` checks its kernel) and against the
  JAX ``forward_ts`` rollout plus costs, with and without normalizers
  (rtol 1e-5, atol 1e-6).
* ``EnsembleDynamics.forward / forward_all / forward_ts / loss`` (no
  bootstrap key) against JAX (rtol 1e-5).
* A candidate count whose antithetic pairs straddle members.
* spline4 noise from given knots against a numpy transcription of
  ``mujoco_mbrl_tpu/ops/cem_rollout.py:295-310``: the JAX spline4 exists
  only inside the Pallas kernel, whose on-core PRNG has no CPU lowering.
* The samplers' defaults against the JAX signatures.
"""

import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mbrl_tpu import models as jmodels
from mujoco_mbrl_tpu import ops as jops
from mujoco_mbrl_tpu.ops.cem_rollout import (
    _fold_normalizers as jax_fold,
    mlp_rollout_costs_reference as jax_rollout_costs)
from mujoco_mbrl_tpu_torch import convert, models
from mujoco_mbrl_tpu_torch.ops import cem_rollout

SD, AD, HID, N = 20, 6, 32, 4


@pytest.fixture(scope='module')
def jens():
    ens = jmodels.EnsembleDynamics(jmodels.MLPDynamics(SD, AD, HID), N)
    params = jax.tree_util.tree_map(np.asarray,
                                    ens.init(jax.random.PRNGKey(3)))
    return ens, params


def _normalizers(rng):
    stats = dict(state_mean=rng.normal(size=SD),
                 state_std=rng.uniform(0.5, 2.0, SD),
                 action_mean=rng.normal(0, 0.1, AD),
                 action_std=rng.uniform(0.5, 1.5, AD))
    stats = {k: v.astype(np.float32) for k, v in stats.items()}
    jnorm = jmodels.Normalizers(**{k: jnp.asarray(v)
                                   for k, v in stats.items()})
    return jnorm, convert.normalizers(jax.tree_util.tree_map(np.asarray,
                                                             jnorm))


def _inputs(rng, B, H, K):
    s0 = rng.normal(size=(B, SD)).astype(np.float32)
    acts = rng.uniform(-1, 1, (B, H, AD, K)).astype(np.float32)
    goal = rng.normal(size=SD).astype(np.float32)
    weights = rng.uniform(0, 1, SD).astype(np.float32)
    return s0, acts, goal, weights


def _jax_per_member(params, s0, acts, goal, weights, norm):
    """bench.py:612-624: each member's reference cost, picked by k % n."""
    B, H, ad, K = acts.shape
    flat = jnp.asarray(acts).transpose(1, 0, 3, 2).reshape(H, B * K, ad)
    s0f = jnp.broadcast_to(jnp.asarray(s0)[:, None], (B, K, SD)).reshape(
        B * K, SD)
    refs = jnp.stack([jax_rollout_costs(
        jax.tree_util.tree_map(lambda v: v[m], params), s0f, flat,
        jnp.asarray(goal), jnp.asarray(weights), norm).reshape(B, K)
        for m in range(N)])
    return np.asarray(refs[jnp.arange(K) % N, :, jnp.arange(K)].T)


def _jax_forward_ts(ens, params, s0, acts, goal, weights, norm):
    """Candidate rows b-major (b * K + k), rolled with forward_ts."""
    B, H, ad, K = acts.shape
    s = jnp.broadcast_to(jnp.asarray(s0)[:, None], (B, K, SD)).reshape(
        B * K, SD)
    a_all = jnp.asarray(acts).transpose(1, 0, 3, 2).reshape(H, B * K, ad)
    acc = jnp.zeros(B * K)
    for t in range(H):
        s = ens.forward_ts(params, s, a_all[t], norm)
        acc = acc + (jmodels.smooth_abs_loss(s, jnp.asarray(goal),
                                             jnp.asarray(weights))
                     + jmodels.cosh_loss(a_all[t]))
    return np.asarray(acc.reshape(B, K))


@pytest.mark.parametrize('with_normalizers', [False, True])
def test_ensemble_costs_match_jax_per_member(jens, with_normalizers):
    ens, params = jens
    rng = np.random.RandomState(0)
    s0, acts, goal, weights = _inputs(rng, 3, 5, 8 * N)
    jnorm, tnorm = _normalizers(rng) if with_normalizers else (None, None)
    ref = _jax_per_member(params, s0, acts, goal, weights, jnorm)
    got = cem_rollout.rollout_costs_of_actions_ensemble(
        convert.ensemble_params(params), torch.as_tensor(s0),
        torch.as_tensor(acts), torch.as_tensor(goal),
        torch.as_tensor(weights), tnorm)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('with_normalizers', [False, True])
def test_ensemble_costs_match_jax_forward_ts(jens, with_normalizers):
    ens, params = jens
    rng = np.random.RandomState(1)
    s0, acts, goal, weights = _inputs(rng, 2, 4, 3 * N)
    jnorm, tnorm = _normalizers(rng) if with_normalizers else (None, None)
    ref = _jax_forward_ts(ens, params, s0, acts, goal, weights, jnorm)
    got = cem_rollout.rollout_costs_of_actions_ensemble(
        convert.ensemble_params(params), torch.as_tensor(s0),
        torch.as_tensor(acts), torch.as_tensor(goal),
        torch.as_tensor(weights), tnorm)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_fold_normalizers_takes_a_member_axis(jens):
    _, params = jens
    jnorm, tnorm = _normalizers(np.random.RandomState(2))
    got = cem_rollout._fold_normalizers(convert.ensemble_params(params),
                                        tnorm)
    ref = jax_fold(params, jnorm)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.shape[0] == N
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)


def test_ensemble_forwards_and_loss_match_jax(jens):
    ens, params = jens
    rng = np.random.RandomState(3)
    tens = models.EnsembleDynamics(models.MLPDynamics(SD, AD, HID), N)
    tp = convert.ensemble_params(params)
    jnorm, tnorm = _normalizers(rng)
    s = rng.normal(size=(12, SD)).astype(np.float32)
    a = rng.normal(size=(12, AD)).astype(np.float32)
    ts, ta = torch.as_tensor(s), torch.as_tensor(a)
    for name in ('forward', 'forward_all', 'forward_ts'):
        ref = getattr(ens, name)(params, jnp.asarray(s), jnp.asarray(a),
                                 jnorm)
        got = getattr(tens, name)(tp, ts, ta, tnorm)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    # 10 rows do not divide over 4 members: forward_ts is the mean there
    np.testing.assert_allclose(
        tens.forward_ts(tp, ts[:10], ta[:10], tnorm).numpy(),
        np.asarray(ens.forward(params, jnp.asarray(s[:10]),
                               jnp.asarray(a[:10]), jnorm)),
        rtol=1e-5, atol=1e-6)
    batch = dict(states=rng.normal(size=(16, 2, SD)),
                 actions=rng.normal(size=(16, 2, AD)),
                 next_states=rng.normal(size=(16, 2, SD)),
                 rewards=rng.normal(size=(16, 2)))
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    ref = ens.loss(params, {k: jnp.asarray(v) for k, v in batch.items()},
                   jnorm)
    got = tens.loss(tp, {k: torch.as_tensor(v) for k, v in batch.items()},
                    tnorm)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


def test_antithetic_pairs_straddling_members(jens):
    """K = 60, n = 4: candidate k's partner k + 30 is member (k + 2) % 4.
    Given noise z, candidate k + 30 gets -z[k]; every candidate's cost is
    its own member's JAX reference cost."""
    _, params = jens
    B, H, K, n = 2, 4, 60, N
    assert (K + 1) // 2 % n != 0
    rng = np.random.RandomState(4)
    s0 = rng.normal(size=(B, SD)).astype(np.float32)
    z = rng.normal(size=(B, H, AD, (K + 1) // 2)).astype(np.float32)
    mean = (0.2 * rng.normal(size=(B, H, AD))).astype(np.float32)
    std = rng.uniform(0.1, 0.5, (B, H, AD)).astype(np.float32)
    goal = np.zeros(SD, np.float32)
    weights = np.ones(SD, np.float32)
    T = torch.as_tensor
    costs, acts = cem_rollout.mlp_sample_rollout_costs_ensemble_plain(
        convert.ensemble_params(params), 0, T(s0), T(mean), T(std), T(goal),
        T(weights), K, n, z=T(z))
    a = acts.numpy()
    expect = np.clip(mean[..., None] + std[..., None] * np.concatenate(
        [z, -z], -1), -1, 1)
    np.testing.assert_array_equal(a, expect.astype(np.float32))
    ref = _jax_per_member(params, s0, a, goal, weights, None)
    np.testing.assert_allclose(costs.numpy(), ref, rtol=1e-5, atol=1e-6)


def _numpy_spline4(knots, H):
    """cem_rollout.py:295-306 in numpy float32, one knot axis (axis 1)."""
    rows = []
    for t in range(H):
        i, w = t // 4, (t % 4) * 0.25
        zt = knots[:, i] if w == 0.0 else (
            ((1.0 - w) * knots[:, i] + w * knots[:, i + 1])
            * np.float32(1.0 / float(np.sqrt((1.0 - w) ** 2 + w ** 2))))
        rows.append(zt)
    return np.stack(rows, 1)


@pytest.mark.parametrize('H', [30, 7, 1])
def test_spline4_noise_matches_numpy_transcription(H):
    n_knots = (H + 3) // 4 + 1
    rng = np.random.RandomState(H)
    u = rng.uniform(size=(2, 3, n_knots, AD, 17)).astype(np.float32)
    knots = (u[0] + u[1] - np.float32(1.0)) * np.float32(2.4494897)
    ref = _numpy_spline4(knots, H)
    got = cem_rollout.spline4_from_knots(torch.as_tensor(knots), H)
    assert got.shape == (3, H, AD, 17)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-7)


def test_spline4_noise_moments_and_antithetic_actions():
    g = torch.Generator().manual_seed(0)
    z = cem_rollout.draw_noise(g, (16, 30, AD, 500), 'spline4')
    assert abs(float(z.mean())) < 1e-2 and abs(float(z.var()) - 1) < 2e-2
    # steps between knots are their renormalised lerp
    w = 0.25
    lerp = ((1 - w) * z[:, 0] + w * z[:, 4]) / math.sqrt(
        (1 - w) ** 2 + w ** 2)
    torch.testing.assert_close(z[:, 1], lerp, rtol=1e-5, atol=1e-6)
    mean = torch.zeros((2, 5, AD))
    std = torch.full((2, 5, AD), 0.1)
    _, acts = cem_rollout.mlp_sample_rollout_costs_plain(
        models.MLPDynamics(SD, AD, HID).init(torch.Generator().manual_seed(0),
                                             device='cpu'),
        3, torch.zeros((2, SD)), mean, std, torch.zeros(SD), torch.ones(SD),
        9, sampler='spline4')
    torch.testing.assert_close(acts[..., 5:], -acts[..., :4])


def test_ensemble_spline4_draws_normal_noise(jens):
    """As the JAX ensemble kernels do (cem_rollout.py:873-878, :981)."""
    _, params = jens
    tp = convert.ensemble_params(params)
    args = (tp, 11, torch.zeros((2, SD)), torch.zeros((2, 5, AD)),
            torch.full((2, 5, AD), 0.3), torch.zeros(SD), torch.ones(SD),
            4 * N, N)
    c1, a1 = cem_rollout.mlp_sample_rollout_costs_ensemble(
        *args, sampler='spline4')
    c2, a2 = cem_rollout.mlp_sample_rollout_costs_ensemble(
        *args, sampler='normal')
    torch.testing.assert_close(a1, a2, rtol=0, atol=0)
    torch.testing.assert_close(c1, c2, rtol=0, atol=0)


def test_sampler_defaults_match_jax():
    jdefault = lambda f: inspect.signature(f).parameters['sampler'].default
    assert jdefault(jops.mlp_sample_rollout_costs) == 'normal'
    assert jdefault(jops.mlp_sample_rollout_costs_ensemble) == 'normal'
    for f in (cem_rollout.mlp_sample_rollout_costs,
              cem_rollout.mlp_sample_rollout_costs_plain):
        assert jdefault(f) == jdefault(jops.mlp_sample_rollout_costs)
    for f in (cem_rollout.mlp_sample_rollout_costs_ensemble,
              cem_rollout.mlp_sample_rollout_costs_ensemble_plain):
        assert jdefault(f) == jdefault(jops.mlp_sample_rollout_costs_ensemble)


def test_unsupported_options_raise(jens):
    _, params = jens
    tp = convert.ensemble_params(params)
    args = (tp, 0, torch.zeros((1, SD)), torch.zeros((1, 3, AD)),
            torch.ones((1, 3, AD)), torch.zeros(SD), torch.ones(SD))
    with pytest.raises(ValueError, match='divide'):
        cem_rollout.mlp_sample_rollout_costs_ensemble(*args, 10, N)
    with pytest.raises(NotImplementedError, match='compute_dtype'):
        cem_rollout.mlp_sample_rollout_costs_ensemble(
            *args, 4 * N, N, compute_dtype=torch.float16)
    mlp = {l: {k: v[0] for k, v in p.items()} for l, p in tp.items()}
    with pytest.raises(NotImplementedError, match='compute_dtype'):
        cem_rollout.mlp_sample_rollout_costs(
            mlp, *args[1:], 8, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match='member axis'):
        convert.ensemble_params(jax.tree_util.tree_map(lambda v: v[0],
                                                       params))
