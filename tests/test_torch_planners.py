"""The per-env planners, port vs JAX.

* The toy 1-D world of ``tests/test_planners.py`` (s' = s + a, cost |s -
  5|) for random shooting, CEM, gradient descent and iLQR (a quadratic
  cost there), over a leading env axis, and the ``plan`` interface;
  ``ILQRPlanner.plan`` fails on both sides (the JAX method's ``from .
  import ilqr`` finds the function).
* ``random_shooting``, ``cem``, ``gradient_descent`` and ``ilqr`` at B = 3
  on a carried-over MLP with a goal-state cost, against JAX's one-env
  functions under ``vmap``, on JAX's own draws: the candidates (through
  ``sample_action``), CEM's per-iteration normals, the initial action
  sequences. Random shooting and CEM pick the same candidates, so the
  actions agree to rtol 1e-5; gradient descent's envs stop at different
  iterations, each env's count equal to JAX's (an env one iteration
  apart would be decided by rounding in the stop test; none is at these
  inputs), actions at rtol 1e-4 / atol 1e-5 after up to 40 float32 Adam
  steps; iLQR's actions at rtol 1e-4 / atol 1e-4 after 10 Riccati passes.
* The ensemble's row rules (JAX splits members by the rows a call gets):
  random shooting and CEM give it each env's (K, sd) candidates, TS when
  K % n == 0 and the mean otherwise; the re-roll of the chosen sequence,
  gradient descent and iLQR give it one (sd,) state, the mean when sd %
  n != 0 and a TypeError on both sides when it divides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mbrl_tpu import models as jmodels
from mujoco_mbrl_tpu import planners as jplanners
from mujoco_mbrl_tpu_torch import convert, models, planners

GOAL = 5.0
B, H, AD, HID = 3, 4, 2, 16


# ---------------------------------------------------------------- toy world
def toy_model(s, a):
    return s + a


def toy_cost(states, actions):
    return torch.abs(states[..., 0] - GOAL)


def toy_quadratic(states, actions):
    return (states[..., 0] - GOAL) ** 2 + 0.01 * (actions ** 2).sum(-1)


def toy_sample(generator, batch_shape):
    return torch.rand(tuple(batch_shape) + (1,), generator=generator,
                      device=generator.device) * 2 - 1


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_toy_random_shooting_reaches_goal_and_keeps_warm_start():
    """The kept sequence is each env's cheapest candidate (the total of
    |s_t - 5| over the horizon, so its last state may pass the goal: each
    env ends within 1.5 of it from 5 away)."""
    s0 = torch.zeros(2, 1)
    info = {}
    traj = planners.random_shooting(_gen(), s0, toy_model, toy_cost,
                                    toy_sample, 10, 500, info=info)
    assert traj.actions.shape == (2, 10, 1) and traj.states.shape == (2, 11,
                                                                       1)
    kept = toy_cost(traj.states[:, 1:], traj.actions).sum(1)
    torch.testing.assert_close(kept, info['costs'].min(1).values)
    assert (traj.states[:, -1, 0] - GOAL).abs().max() < 1.5
    perfect = planners.Trajectory(states=None,
                                  actions=torch.full((2, 10, 1), 0.5))
    traj = planners.random_shooting(_gen(1), s0, toy_model, toy_cost,
                                    toy_sample, 10, 8,
                                    initial_trajectory=perfect)
    warm_cost = toy_cost(torch.cumsum(perfect.actions, 1), perfect.actions)
    assert bool((toy_cost(traj.states[:, 1:], traj.actions).sum(1)
                 <= warm_cost.sum(1) + 1e-5).all())


def test_toy_cem_reaches_goal_and_beats_random_shooting():
    s0 = torch.zeros(2, 1)
    ce = planners.cem(_gen(42), s0, toy_model, toy_cost, 10, 1, 300, 30, 5)
    assert (ce.states[:, -1, 0] - GOAL).abs().max() < 0.8
    rs = planners.random_shooting(_gen(42), s0, toy_model, toy_cost,
                                  toy_sample, 10, 1500)
    assert bool(((ce.states[:, -1, 0] - GOAL).abs()
                 <= (rs.states[:, -1, 0] - GOAL).abs() + 0.2).all())


def test_toy_gradient_descent_reaches_goal_and_stops_early():
    s0 = torch.zeros(2, 1)
    info = {}
    traj = planners.gradient_descent(_gen(), s0, toy_model, toy_cost,
                                     toy_sample, 10, 200, 1e-5, 0.1,
                                     info=info)
    assert (traj.states[:, -1, 0] - GOAL).abs().max() < 0.5
    assert info['iterations'].shape == (2,)
    init = planners.Trajectory(states=None, actions=torch.zeros(2, 10, 1))
    info = {}
    traj = planners.gradient_descent(_gen(), s0, toy_model, toy_cost,
                                     toy_sample, 10, 40, 1e9,
                                     initial_trajectory=init, info=info)
    assert float(traj.actions.abs().max()) < 0.05      # one Adam step
    assert info['iterations'].tolist() == [1, 1]


def test_toy_ilqr_reaches_goal():
    info = {}
    traj = planners.ilqr(_gen(), torch.zeros(2, 1), toy_model,
                         toy_quadratic, toy_sample, 10, info=info)
    assert (traj.states[:, -1, 0] - GOAL).abs().max() < 0.1
    assert info['alphas'].shape == (10, 2)
    assert set(info['alphas'].flatten().tolist()) <= {
        0.0, 1.0, 0.5, 0.25, 0.1, 0.03}


def test_plan_interface_and_ilqr_planner_fails_on_both_sides():
    jsample = lambda key, shape: jax.random.uniform(
        key, tuple(shape) + (1,), minval=-1.0, maxval=1.0)
    jtoy_cost = lambda s, a: jnp.abs(s[..., 0] - GOAL)
    for cls in (planners.RandomShootingPlanner, planners.CEMPlanner,
                planners.GradientDescentPlanner):
        traj = cls.plan(torch.zeros(2, 1), toy_model, toy_cost, toy_sample,
                        horizon=5, generator=_gen())
        assert traj.actions.shape == (2, 5, 1)
        assert traj.states.shape == (2, 6, 1)
        assert cls.defaults == getattr(jplanners, cls.__name__).defaults
    assert (planners.ILQRPlanner.defaults
            == jplanners.ILQRPlanner.defaults)
    with pytest.raises(AttributeError, match="no attribute 'ilqr'"):
        jplanners.ILQRPlanner.plan(jnp.zeros(1), toy_model, jtoy_cost,
                                   jsample, 5, key=jax.random.PRNGKey(0))
    with pytest.raises(AttributeError, match="no attribute 'ilqr'"):
        planners.ILQRPlanner.plan(torch.zeros(2, 1), toy_model, toy_cost,
                                  toy_sample, 5)


# ------------------------------------------------- carried-over MLP, B = 3
@pytest.fixture(scope='module')
def world():
    """A JAX MLP (sd 6) and its port copy, a goal-state cost on both
    sides, B start states, JAX keys and warm-start sequences."""
    sd = 6
    jm = jmodels.MLPDynamics(sd, AD, hidden_units=HID)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = models.MLPDynamics(sd, AD, hidden_units=HID)
    tp = convert.mlp_params(jax.tree_util.tree_map(np.asarray, jp))
    return _world(jm, jp, tm, tp, sd)


def _world(jm, jp, tm, tp, sd, forward='forward'):
    rng = np.random.RandomState(1)
    goal = rng.normal(size=sd).astype(np.float32)
    weights = rng.uniform(0.5, 2.0, sd).astype(np.float32)
    s0 = rng.normal(size=(B, sd)).astype(np.float32)
    warm = rng.uniform(-1, 1, (B, H, AD)).astype(np.float32)

    def jcost(s, a):
        return (jmodels.smooth_abs_loss(s, goal, weights)
                + jmodels.cosh_loss(a, 0.25))

    def tcost(s, a):
        return (models.smooth_abs_loss(s, torch.as_tensor(goal),
                                       torch.as_tensor(weights))
                + models.cosh_loss(a, 0.25))
    jmodel = lambda s, a: getattr(jm, forward)(jp, s, a)
    tmodel = lambda s, a: getattr(tm, forward)(tp, s, a)
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    return dict(jmodel=jmodel, tmodel=tmodel, jcost=jcost, tcost=tcost,
                s0=s0, warm=warm, keys=keys, sd=sd)


def jsample(key, shape):
    return jax.random.uniform(key, tuple(shape) + (AD,), minval=-1.0,
                              maxval=1.0)


def _fed(draws):
    """A port ``sample_action`` handing back JAX's draws."""
    return lambda generator, shape: torch.as_tensor(np.asarray(draws))


def _rs_both(w, K, warm=True):
    jtraj = lambda w0: jplanners.Trajectory(states=jnp.zeros((H + 1,
                                                              w['sd'])),
                                            actions=w0)
    jout = jax.vmap(lambda k, s, w0: jplanners.random_shooting(
        k, s, w['jmodel'], w['jcost'], jsample, H, num_trajectories=K,
        initial_trajectory=jtraj(w0) if warm else None))(
            w['keys'], w['s0'], w['warm'])
    # JAX's candidates: sample_action(split(key)[0], (H, K)) per env
    cand = jax.vmap(lambda k: jsample(jax.random.split(k)[0], (H, K)))(
        w['keys'])
    info = {}
    tout = planners.random_shooting(
        _gen(), torch.as_tensor(w['s0']), w['tmodel'], w['tcost'],
        _fed(cand), H, K,
        initial_trajectory=planners.Trajectory(
            states=None, actions=torch.as_tensor(w['warm']))
        if warm else None, info=info)
    return jout, tout, info


def _assert_traj(jout, tout, rtol, atol):
    np.testing.assert_allclose(tout.actions.numpy(),
                               np.asarray(jout.actions), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(tout.states.numpy(), np.asarray(jout.states),
                               rtol=rtol, atol=max(atol, 1e-5))


def test_random_shooting_matches_jax_on_its_candidates(world):
    for warm in (True, False):
        jout, tout, info = _rs_both(world, K=12, warm=warm)
        assert info['costs'].shape == (B, 12)
        _assert_traj(jout, tout, 1e-5, 1e-6)


def _jax_normals(keys, iters, K):
    """JAX cem's per-iteration normals, (iters, B, H, K, ad)."""
    per_env = jax.vmap(lambda k: jnp.stack([
        jax.random.normal(ik, (H, K, AD), jnp.float32)
        for ik in jax.random.split(k, iters)]))(keys)
    return torch.as_tensor(np.asarray(per_env)).transpose(0, 1)


def _cem_both(w, K, E, iters=3):
    jout = jax.vmap(lambda k, s, m: jplanners.cem(
        k, s, w['jmodel'], w['jcost'], H, AD, num_candidates=K,
        num_elites=E, num_iterations=iters, init_mean=m))(
            w['keys'], w['s0'], w['warm'])
    tout = planners.cem(
        _gen(), torch.as_tensor(w['s0']), w['tmodel'], w['tcost'], H, AD,
        num_candidates=K, num_elites=E, num_iterations=iters,
        init_mean=torch.as_tensor(w['warm']),
        normals=_jax_normals(w['keys'], iters, K))
    return jout, tout


def test_cem_matches_jax_on_its_normals(world):
    jout, tout = _cem_both(world, K=12, E=3)
    _assert_traj(jout, tout, 1e-5, 1e-6)


def _jax_gd(w, n, stop, lr):
    return jax.vmap(lambda s, a0: jplanners.gradient_descent(
        jax.random.PRNGKey(0), s, w['jmodel'], w['jcost'], jsample, H,
        num_iterations=n, stop_condition=stop, learning_rate=lr,
        initial_trajectory=jplanners.Trajectory(
            states=jnp.zeros((H + 1, w['sd'])), actions=a0)))(
                w['s0'], w['warm'])


def test_gradient_descent_matches_jax_per_env_stop(world):
    stop, lr, n_max = 8e-3, 0.01, 40
    gd = jax.jit(lambda n: _jax_gd(world, n, stop, lr).actions)
    per_n = [np.asarray(gd(n)) for n in range(n_max + 1)]
    final = per_n[-1]
    # the iterations each JAX env ran: the first cap at which its carry
    # is already its final one (a frozen env's carry does not change)
    jcounts = [next(n for n in range(n_max + 1)
                    if np.array_equal(per_n[n][b], final[b]))
               for b in range(B)]
    info = {}
    tout = planners.gradient_descent(
        _gen(), torch.as_tensor(world['s0']), world['tmodel'],
        world['tcost'], None, H, num_iterations=n_max, stop_condition=stop,
        learning_rate=lr, initial_trajectory=planners.Trajectory(
            states=None, actions=torch.as_tensor(world['warm'])),
        info=info)
    assert len(set(jcounts)) > 1, jcounts          # envs stop apart
    assert info['iterations'].tolist() == jcounts
    jout = _jax_gd(world, n_max, stop, lr)
    _assert_traj(jout, tout, 1e-4, 1e-5)


def test_ilqr_matches_jax(world):
    jout = jax.vmap(lambda s, a0: jplanners.ilqr(
        jax.random.PRNGKey(0), s, world['jmodel'], world['jcost'], jsample,
        H, initial_trajectory=jplanners.Trajectory(
            states=jnp.zeros((H + 1, world['sd'])), actions=a0)))(
                world['s0'], world['warm'])
    info = {}
    tout = planners.ilqr(
        _gen(), torch.as_tensor(world['s0']), world['tmodel'],
        world['tcost'], None, H, initial_trajectory=planners.Trajectory(
            states=None, actions=torch.as_tensor(world['warm'])),
        info=info)
    assert bool((info['alphas'] > 0).any())
    _assert_traj(jout, tout, 1e-4, 1e-4)


# ------------------------------------------------------- ensemble row rules
def _ensemble_world(sd, n=3):
    jm = jmodels.EnsembleDynamics(jmodels.MLPDynamics(sd, AD,
                                                      hidden_units=HID), n)
    jp = jm.init(jax.random.PRNGKey(2))
    tm = models.EnsembleDynamics(models.MLPDynamics(sd, AD,
                                                    hidden_units=HID), n)
    tp = convert.ensemble_params(jax.tree_util.tree_map(np.asarray, jp))
    return _world(jm, jp, tm, tp, sd, forward='forward_ts')


@pytest.mark.parametrize('K', [12, 10])
def test_ensemble_shooting_rows_per_env(K):
    """sd 5 over 3 members: the candidates TS when K % 3 == 0, the mean
    when not; the re-roll of one state takes the mean (5 % 3 != 0)."""
    w = _ensemble_world(sd=5)
    jout, tout, _ = _rs_both(w, K)
    _assert_traj(jout, tout, 1e-5, 1e-6)
    jout, tout = _cem_both(w, K, E=3, iters=2)
    _assert_traj(jout, tout, 1e-5, 1e-6)


def test_ensemble_single_state_rows():
    """Gradient descent gives the ensemble one state: the mean at sd 5;
    at sd 6 (divisible by 3) JAX fails to reshape the action, and so does
    the port, for gradient descent, iLQR and random shooting's re-roll."""
    w = _ensemble_world(sd=5)
    jout = _jax_gd(w, 5, 2e-3, 0.01)
    tout = planners.gradient_descent(
        _gen(), torch.as_tensor(w['s0']), w['tmodel'], w['tcost'], None, H,
        num_iterations=5, initial_trajectory=planners.Trajectory(
            states=None, actions=torch.as_tensor(w['warm'])))
    _assert_traj(jout, tout, 1e-4, 1e-5)
    w = _ensemble_world(sd=6)
    with pytest.raises(TypeError, match='reshape'):
        _jax_gd(w, 5, 2e-3, 0.01)
    with pytest.raises(TypeError, match='reshape'):
        _rs_both(w, 12)
    s0, warm = torch.as_tensor(w['s0']), planners.Trajectory(
        states=None, actions=torch.as_tensor(w['warm']))
    for planner in (planners.gradient_descent, planners.ilqr):
        with pytest.raises(TypeError, match='single state of 6 dims'):
            planner(_gen(), s0, w['tmodel'], w['tcost'], None, H,
                    initial_trajectory=warm)
    cand = torch.rand((B, H, 12, AD), generator=_gen()) * 2 - 1
    with pytest.raises(TypeError, match='single state of 6 dims'):
        planners.random_shooting(_gen(), s0, w['tmodel'], w['tcost'],
                                 _fed(cand), H, 12)
