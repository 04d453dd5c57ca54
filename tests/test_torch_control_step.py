"""The slice as a whole: one walker_walk MPC control step, port vs JAX.

Small size (4 envs, 64 candidates, horizon 5, 2 CEM iterations, one
control step). Both packages start from the same JAX-drawn reset state
and MLP weights (carried across with ``convert``) and plan with the same
injected noise; the planned actions, then qpos, qvel, reward and the
observation after ``env.step``, must agree at atol 1e-4. Reset
randomisation, drawn from different generators, is checked by its range.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mbrl_tpu import models as jmodels
from mujoco_mbrl_tpu import suite as jsuite
from mujoco_mbrl_tpu_torch import convert, suite
from mujoco_mbrl_tpu_torch.bench import build_bench

from test_torch_cem import run_both_cem

B, K, H, ITERS = 4, 64, 5, 2


@pytest.fixture(scope='module')
def both():
    jenv = jsuite.load('walker', 'walk')
    state0, _ = jax.jit(jax.vmap(jenv.reset))(
        jax.random.split(jax.random.PRNGKey(0), B))
    obs0 = jax.jit(jax.vmap(lambda s: jsuite.flatten_observation(
        jenv._observe(jenv._model_with(s.params), s.physics,
                      s.params))))(state0)
    jparams = jax.tree_util.tree_map(np.asarray, jmodels.MLPDynamics(
        24, 6, hidden_units=50).init(jax.random.PRNGKey(1)))
    tenv = suite.load('walker', 'walk', device='cpu')
    tstate = convert.env_state(state0.physics.qpos, state0.physics.qvel,
                               time=state0.physics.time,
                               step_count=state0.step_count)
    tobs0 = suite.flatten_observation(tenv._observe(
        tenv.model, tstate.physics, ()))
    return jenv, state0, np.asarray(obs0), jparams, tenv, tstate, tobs0


def test_observation_at_reset_matches(both):
    _, _, obs0, _, _, _, tobs0 = both
    np.testing.assert_allclose(tobs0.numpy(), obs0, atol=1e-5)


def test_control_step_matches_jax(both):
    jenv, state0, obs0, jparams, tenv, tstate, tobs0 = both
    ja, ta, _, _, _ = run_both_cem(jparams, obs0, K=K, H=H, iters=ITERS,
                                   num_elites=K // 10)
    np.testing.assert_allclose(ta, ja, atol=1e-4)

    jstate, jts = jax.jit(jax.vmap(jenv.step))(state0, jnp.asarray(ja[0]))
    tstate1, tts = tenv.step(tstate, torch.as_tensor(ta[0]))
    np.testing.assert_allclose(tstate1.physics.qpos.numpy(),
                               np.asarray(jstate.physics.qpos), atol=1e-4)
    np.testing.assert_allclose(tstate1.physics.qvel.numpy(),
                               np.asarray(jstate.physics.qvel), atol=1e-4)
    np.testing.assert_allclose(tts.reward.numpy(), np.asarray(jts.reward),
                               atol=1e-4)
    jobs = jax.vmap(jsuite.flatten_observation)(jts.observation)
    np.testing.assert_allclose(
        suite.flatten_observation(tts.observation).numpy(),
        np.asarray(jobs), atol=1e-4)
    assert tstate1.step_count.tolist() == [1] * B


def test_reset_randomisation_range():
    env = suite.load('walker', 'walk', device='cpu')
    state, ts = env.reset(256, torch.Generator().manual_seed(0))
    q = state.physics.qpos.numpy()
    lo = env.model.jnt_range[:, 0].numpy()
    hi = env.model.jnt_range[:, 1].numpy()
    assert np.all(q[:, :2] == 0.0)                   # unlimited slides
    assert np.all(np.abs(q[:, 2]) <= np.pi)          # unlimited hinge
    assert np.all((q[:, 3:] >= lo[3:]) & (q[:, 3:] <= hi[3:]))
    # spread over the range, not a constant
    assert np.all(q[:, 2:].std(0) > 0.2 * np.r_[np.pi, hi[3:] - lo[3:]] / 2)
    assert np.all(state.physics.qvel.numpy() == 0.0)
    assert ts.observation['orientations'].shape == (256, 14)


def test_bench_runs_on_cpu():
    run, (params, state, gen) = build_bench('walker_walk', 3, 16, 4, 2, 2,
                                            device='cpu')
    state, rewards = run(params, state, gen)
    assert rewards.shape == (2,) and bool(torch.isfinite(rewards).all())
    assert bool(torch.isfinite(state.physics.qpos).all())
