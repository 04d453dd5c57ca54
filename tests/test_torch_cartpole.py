"""The RK4 domains (cartpole, acrobot), port against the JAX package.

Same inputs, drawn with numpy or by the JAX reset, go through both
packages (B = 4; the JAX environments are built once a module):

* ``_make_model_xml`` (1, 2 and 3 poles) and acrobot's ``_XML`` give the
  JAX modules' XML;
* the compiled models field by field (rtol 1e-5): the cart's box inertia,
  acrobot's two sites, the integrator;
* ``site_xpos`` on random poses (rtol = atol = 1e-5);
* one RK4 step at random states (rtol = atol = 1e-5): cartpole's four
  cold one-row solves, and acrobot with no constraint row;
* the dense APGD plain twin on the four one-row solves of a cartpole RK4
  step captured from the port, against the XLA iterate (rtol = atol =
  2e-4);
* three control steps from JAX-drawn resets with numpy actions: qpos,
  qvel, observation and reward (atol = rtol = 1e-4);
* the CPU golden fixture of tests/test_golden_trajectories.py
  (cartpole_swingup) from the JAX-drawn reset and actions (its tolerance);
* the MuJoCo parity fixtures within the CPU bands of
  tests/test_parity_physics.py THRESHOLDS;
* the Cartpole wrapper (dims, goal, goal weights, featured state and
  observation), ``bench.config('cartpole')`` and its route (the model /
  cost scan, no sampler), and a tiny CLI run on the CPU.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from mujoco_mbrl_tpu import suite as jsuite
from mujoco_mbrl_tpu.physics import engine as jengine
from mujoco_mbrl_tpu.physics import model as JM
from mujoco_mbrl_tpu.suite import acrobot as jacrobot
from mujoco_mbrl_tpu.suite import cartpole as jcartpole
from mujoco_mbrl_tpu_torch import bench, envs, suite
from mujoco_mbrl_tpu_torch.ops import apgd_solve
from mujoco_mbrl_tpu_torch.physics import engine
from mujoco_mbrl_tpu_torch.physics import model as M
from mujoco_mbrl_tpu_torch.physics.model import State
from mujoco_mbrl_tpu_torch.suite import acrobot, cartpole
from parity_utils import steps_within
from test_parity_physics import THRESHOLDS
from test_torch_apgd import _jax_xla
from test_torch_contact_free import _jax_reset, _jax_wrapper, _port_state

FIXTURES = os.path.join(os.path.dirname(__file__), 'fixtures')
B = 4
PHYS_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
APGD_TOL = dict(rtol=2e-4, atol=2e-4)
TASKS = [('cartpole', t) for t in cartpole.SUITE] + [
    ('acrobot', t) for t in acrobot.SUITE]

_JENVS = {}


def jenv_of(domain, task):
    """The JAX environment of domain/task, built once."""
    if (domain, task) not in _JENVS:
        _JENVS[domain, task] = jsuite.load(domain, task)
    return _JENVS[domain, task]


def assert_model_matches(jm, tm, held_apart=()):
    """Every field of the port's model against the JAX model's (tensors
    rtol 1e-5), the name tables and the options that steer the step; the
    fields named in ``held_apart`` are the caller's to check."""
    for f in dataclasses.fields(tm):
        if f.name == 'opt' or f.name in held_apart:
            continue
        ours, ref = getattr(tm, f.name), getattr(jm, f.name)
        if isinstance(ours, torch.Tensor):
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                       rtol=1e-5, atol=1e-7, err_msg=f.name)
        elif f.name == 'names':
            for kind, table in ours.items():
                assert table == ref.get(kind, {}), kind
        else:
            assert ours == ref, f.name
    for name in ('integrator', 'disableflags', 'solver_iterations', 'solver',
                 'cone', 'impratio', 'solver_warmstart',
                 'enable_geom_geom_contacts'):
        assert getattr(tm.opt, name) == getattr(jm.opt, name), name
    for name in ('timestep', 'gravity', 'density', 'viscosity', 'wind'):
        np.testing.assert_allclose(getattr(tm.opt, name).numpy(),
                                   np.asarray(getattr(jm.opt, name)),
                                   err_msg=name)


def tracks_mujoco_fixture(domain, task, model, min_steps, tol):
    """The port alone from the oracle's post-reset state (its activations
    too, where the model has them; the episode's terrain, where it has a
    heightfield), the recorded ctrl held over the substeps: at least
    ``min_steps`` physics steps within ``tol`` of MuJoCo's qpos."""
    fix = np.load(os.path.join(FIXTURES, 'parity', f'{domain}_{task}.npz'))
    ctrl = np.repeat(fix['ctrl'], int(fix['n_sub_steps']), axis=0)
    if model.hfield_nrow:
        model = model.replace(hfield_data=torch.tensor(
            fix['ep_hfield_data'], dtype=torch.float32).reshape(
                model.hfield_nrow, model.hfield_ncol))
    act = fix['init_act'] if 'init_act' in fix.files else np.zeros(0)
    s = State(qpos=torch.tensor(fix['init_qpos'], dtype=torch.float32)[None],
              qvel=torch.tensor(fix['init_qvel'], dtype=torch.float32)[None],
              time=torch.zeros(1),
              act=(torch.tensor(act, dtype=torch.float32)[None] if act.size
                   else None))
    qpos = [fix['init_qpos']]
    for u in ctrl[:min_steps]:
        s = engine.step(model, s, torch.tensor(u, dtype=torch.float32)[None])
        qpos.append(s.qpos[0].numpy())
    k, dev = steps_within(np.array(qpos), fix['p_qpos'], tol)
    assert k >= min(min_steps, len(qpos) - 1), (k, dev[:k + 3])


def golden_rollout(domain, task):
    """tests/test_golden_trajectories.py's rollout (seed 1234, 15 control
    steps) from the JAX-drawn reset and actions, stepped by the port:
    (qpos (15, nq), rewards (15,))."""
    jenv = jenv_of(domain, task)
    key = jax.random.PRNGKey(1234)
    jstate, _ = jax.jit(jenv.reset)(key)
    spec = jenv.action_spec()
    lo = np.where(np.isfinite(spec.minimum), spec.minimum, -1.0)
    hi = np.where(np.isfinite(spec.maximum), spec.maximum, 1.0)
    actions = np.asarray(jax.random.uniform(
        jax.random.fold_in(key, 1), (15,) + spec.shape, minval=lo,
        maxval=hi))
    state = _port_state(jax.tree_util.tree_map(lambda x: x[None], jstate))
    env = suite.load(domain, task, device='cpu')
    qpos, rewards = [], []
    for a in actions:
        state, ts = env.step(state, torch.as_tensor(np.array(a))[None])
        qpos.append(state.physics.qpos[0].numpy())
        rewards.append(float(ts.reward[0]))
    return np.array(qpos), np.array(rewards)


def control_steps_match(domain, task, n_steps=3, seed=3):
    """``n_steps`` control steps of the port and of JAX from JAX-drawn
    resets with numpy actions: qpos, qvel, reward and observation
    (atol = rtol = 1e-4)."""
    jenv = jenv_of(domain, task)
    env = suite.load(domain, task, device='cpu')
    jstate, jts = _jax_reset(jenv, B, seed)
    state = _port_state(jstate)
    _, ts = env.start(state.physics, state.params)
    for k, v in ts.observation.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jts.observation[k]),
                                   err_msg=k, **STEP_TOL)
    rng = np.random.RandomState(5)
    jstep = jax.jit(jax.vmap(jenv.step))
    for _ in range(n_steps):
        a = rng.uniform(-1, 1, (B, env.model.nu)).astype(np.float32)
        jstate, jts = jstep(jstate, jnp.asarray(a))
        state, ts = env.step(state, torch.as_tensor(a))
        for ours, ref, name in (
                (state.physics.qpos, jstate.physics.qpos, 'qpos'),
                (state.physics.qvel, jstate.physics.qvel, 'qvel'),
                (ts.reward, jts.reward, 'reward')):
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                       err_msg=name, **STEP_TOL)
        assert list(ts.observation) == sorted(jts.observation)
        for k, v in ts.observation.items():
            np.testing.assert_allclose(v.numpy(),
                                       np.asarray(jts.observation[k]),
                                       err_msg=k, **STEP_TOL)
    return state


@pytest.mark.parametrize('n_poles', [1, 2, 3])
def test_cartpole_xml_is_a_copy(n_poles):
    assert cartpole._make_model_xml(n_poles) == jcartpole._make_model_xml(
        n_poles)


def test_acrobot_xml_is_a_copy():
    assert acrobot._XML == jacrobot._XML


@pytest.mark.parametrize('domain,task', TASKS)
def test_model_matches_jax_field_by_field(domain, task):
    jm = jenv_of(domain, task).model
    tm = suite.load(domain, task, device='cpu').model
    assert_model_matches(jm, tm)
    assert tm.opt.integrator == M.RK4 and tm.opt.disableflags & 1
    if domain == 'cartpole':
        # the cart's box: mass 1, 0.4 x 0.3 x 0.2
        cart = tm.name2id('body', 'cart')
        np.testing.assert_allclose(
            np.diag(tm.body_inertia[cart].numpy()),
            np.array([.09 + .04, .16 + .04, .16 + .09]) / 12, rtol=1e-6)
        assert tm.geom_type[tm.name2id('geom', 'cart')] == M.BOX
    else:
        assert tm.nsite == 2 and tm.site_type == (M.SPHERE, M.SPHERE)
        np.testing.assert_allclose(tm.site_size.numpy(),
                                   [[.2] * 3, [.01] * 3])


@pytest.mark.parametrize('domain,task', [('cartpole', 'three_poles'),
                                         ('acrobot', 'swingup')])
def test_site_xpos_and_rk4_step_match_jax(domain, task):
    """Forward kinematics (site_xpos, ximat) and one RK4 step from random
    states with random controls, against JAX under vmap."""
    jm = jenv_of(domain, task).model
    tm = suite.load(domain, task, device='cpu').model
    rng = np.random.RandomState(1)
    qpos = rng.uniform(-2, 2, (B, tm.nq)).astype(np.float32)
    qpos[:, 0] = rng.uniform(-1.9, 1.9, B) if domain == 'cartpole' else (
        qpos[:, 0])
    qvel = rng.normal(0, 2, (B, tm.nv)).astype(np.float32)
    ctrl = rng.uniform(-1, 1, (B, tm.nu)).astype(np.float32)
    js = lambda q, v: JM.make_state(jm, qpos=q, qvel=v)
    jd = jax.jit(jax.vmap(lambda q, v, u: jengine.forward(jm, js(q, v), u)))(
        qpos, qvel, ctrl)
    ref = jax.jit(jax.vmap(lambda q, v, u: jengine.step(jm, js(q, v), u)))(
        qpos, qvel, ctrl)
    s = State(qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
              time=torch.zeros(B))
    td = engine.forward(tm, s, torch.as_tensor(ctrl))
    for name in ('site_xpos', 'ximat', 'qacc', 'qfrc_constraint'):
        np.testing.assert_allclose(getattr(td, name).numpy(),
                                   np.asarray(getattr(jd, name)),
                                   err_msg=name, **PHYS_TOL)
    out = engine.step(tm, s, torch.as_tensor(ctrl))
    np.testing.assert_allclose(out.qpos.numpy(), np.asarray(ref.qpos),
                               **PHYS_TOL)
    np.testing.assert_allclose(out.qvel.numpy(), np.asarray(ref.qvel),
                               **PHYS_TOL)
    assert tm.nsite == (2 if domain == 'acrobot' else 0)


def test_cartpole_rk4_solves_match_jax_apgd():
    """A cartpole RK4 step runs four cold one-row solves (the slider's
    limit, pushed past it), none warm; the plain twin on each against the
    XLA iterate."""
    tm = suite.load('cartpole', 'swingup', device='cpu').model
    rng = np.random.RandomState(2)
    sign = rng.choice([-1.0, 1.0], 8)
    qpos = np.stack([sign * rng.uniform(1.79, 1.82, 8),
                     rng.uniform(-3, 3, 8)], 1).astype(np.float32)
    qvel = np.stack([sign * rng.uniform(0.5, 2, 8), rng.normal(size=8)],
                    1).astype(np.float32)
    captured, real = [], apgd_solve.apgd_iterate_batched

    def capture(*args, **kw):
        captured.append((tuple(a.numpy().copy() for a in args), dict(kw)))
        return real(*args, **kw)

    apgd_solve.apgd_iterate_batched = capture
    try:
        s, f, v = engine.step_warm(
            tm, State(qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
                      time=torch.zeros(8)), torch.zeros((8, 1)))
    finally:
        apgd_solve.apgd_iterate_batched = real
    assert f is None and v is None
    assert [kw['cold'] for _, kw in captured] == [True] * 4
    for args, kw in captured:
        assert args[0].shape == (8, 1, 1) and args[4].sum() >= 4
        ref = _jax_xla(args, nonneg=kw['nonneg'], box=kw['box_rows'],
                       con0=kw['con0'], iterations=kw['iterations'],
                       cold=True, eq_rows=kw['eq_rows'])
        out = real(*[torch.as_tensor(a) for a in args], **kw)
        for o, r in zip(out, ref):
            np.testing.assert_allclose(o.numpy(), r, **APGD_TOL)
        assert float(np.abs(out[0].numpy()).max()) > 1e-3


@pytest.mark.parametrize('domain,task', [
    ('cartpole', 'balance_sparse'), ('cartpole', 'two_poles'),
    ('acrobot', 'swingup')])
def test_control_steps_match_jax(domain, task):
    """(cartpole_swingup's steps: the golden fixture below.)"""
    control_steps_match(domain, task)


def test_golden_fixture():
    golden = np.load(os.path.join(FIXTURES, 'golden_cartpole_swingup.npz'))
    qpos, rewards = golden_rollout('cartpole', 'swingup')
    np.testing.assert_allclose(qpos, golden['qpos'], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(rewards, golden['rewards'], rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize('domain,task', TASKS)
def test_tracks_mujoco_fixture(domain, task):
    tracks_mujoco_fixture(domain, task,
                          suite.load(domain, task, device='cpu').model,
                          *THRESHOLDS[(domain, task)])


def test_wrapper_matches_jax():
    jw = _jax_wrapper('cartpole', 'swingup')
    w = envs.load('cartpole', 'swingup', device='cpu')
    assert (w.state_dim, w.observation_dim, w.action_dim) == (
        jw.state_dim, jw.observation_dim, jw.action_dim) == (4, 5, 1)
    np.testing.assert_array_equal(w.get_goal_weights().numpy(),
                                  np.asarray(jw.get_goal_weights()))
    np.testing.assert_array_equal(w.set_goal().numpy(), np.asarray(
        jw.set_goal(jax.random.PRNGKey(0))))
    jstate, _ = _jax_reset(jw.env, B, 11)
    js, jo = jax.jit(jax.vmap(jw._observe_full))(jstate)
    s, o = w._observe_full(_port_state(jstate))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **PHYS_TOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **PHYS_TOL)
    x = w.sample_state(torch.Generator().manual_seed(0), (500,)).numpy()
    bound = np.array([.5, .5, 1, 1], np.float32)
    assert x.shape == (500, 4)
    assert (np.abs(x) <= bound).all() and (np.abs(x).max(0) > .9 * bound).all()


def test_bench_preset_and_route(monkeypatch):
    """bench.config('cartpole') is the JAX preset; 5 + 1 dims plan through
    the model / cost scan (no sampler call); a tiny control step on the
    CPU is one RK4 step: four one-row solves."""
    assert bench.config('cartpole') == dict(jbench.CONFIGS['cartpole'])
    assert not hasattr(bench, '_NOT_PORTED')
    calls = {'sampler': 0, 'apgd': 0}
    monkeypatch.setattr(bench, 'mlp_sample_rollout_costs', lambda *a, **k: (
        calls.__setitem__('sampler', 1)))
    real = apgd_solve.apgd_iterate_batched

    def count(*a, **k):
        calls['apgd'] += 1
        return real(*a, **k)

    monkeypatch.setattr(apgd_solve, 'apgd_iterate_batched', count)
    run, (p, s, g) = bench.build_bench('cartpole_swingup', 3, 16, 4, 2, 2,
                                       device='cpu')
    state, rewards = run(p, s, g)
    assert calls == {'sampler': 0, 'apgd': 4 * 2}
    assert state.physics.qpos.shape == (3, 2)
    assert bool(torch.isfinite(rewards).all())


def test_cli_runs_on_cpu(tmp_path):
    from mujoco_mbrl_tpu_torch import experiment
    agent = experiment.main(experiment.parse_args([
        '--exp_dir', str(tmp_path), '--environment', 'cartpole_swingup',
        '--planner', 'cem', '--model', 'nn', '--rollout_length', '3',
        '--num_rollouts_per_iteration', '2', '--num_train_iterations', '1',
        '--train_epochs', '1', '--device', 'cpu', '--planner_kwargs',
        '{"num_candidates": 16, "num_elites": 4}']))
    assert agent.plan_dim == 5 and agent.obs_only
    buf = agent.dataset
    assert buf.observations.shape[-1] == 5
    assert bool(torch.isfinite(buf.observations[:buf.filled]).all())


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device works')
    from mujoco_mbrl_tpu_torch import experiment
    for domain, task in (('cartpole', 'swingup'), ('acrobot', 'swingup')):
        with pytest.raises(RuntimeError, match='CUDA'):
            suite.load(domain, task)
    with pytest.raises(RuntimeError, match='CUDA'):
        envs.load('cartpole', 'swingup')
    with pytest.raises(RuntimeError, match='CUDA'):
        experiment.main(experiment.parse_args(
            ['--exp_dir', '', '--environment', 'cartpole_swingup']))
    cfg = bench.config('cartpole')
    with pytest.raises(RuntimeError, match='CUDA'):
        bench.build_bench(cfg['task'], 2, 8, 3, 1, 1)
