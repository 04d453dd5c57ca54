"""The hopper (sites, touch sensors, 88 constraint rows), port against the
JAX package.

Same inputs, drawn with numpy or by the JAX reset, go through both
packages (B = 4; the JAX forward compiles once, module scoped):

* ``_XML`` is the JAX module's, and the compiled models of both tasks
  match field by field (rtol 1e-5): the two touch sites, the armature;
* on poses in floor contact: kinematics with ``site_xpos`` (rtol = atol
  = 1e-5), the 88 constraint rows in JAX's order (4 limits, then 21
  contact points of 4 pyramid facets; the block list, J, aref, R, active
  at rtol 1e-5), the solve's forces (rtol 1e-4) and the touch sensors
  read from them (rtol 1e-4);
* the dense APGD plain twin at 88 rows (the block path's shape) on the
  cold and warm solves the port's own substeps build at those poses,
  against the XLA iterate and, for the cold one, the JAX Pallas kernel in
  interpret mode (rtol = atol = 2e-4);
* one control step (4 substeps) from JAX-drawn resets with numpy
  actions: qpos, qvel, reward, observation and the wrapper's featured
  state (atol = rtol = 1e-4);
* the CPU golden fixture (hopper_stand) from the JAX-drawn reset and
  actions, and the MuJoCo parity fixtures within the CPU bands of
  tests/test_parity_physics.py THRESHOLDS;
* the Hopper wrapper (dims, goal, goal weights, sample_state),
  ``build_bench('hopper_hop')``'s route (the sampler at sd 15 / ad 4, the
  (3, 7, 2) tiles; 5 solves a control step) and a tiny CLI on the CPU.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mbrl_tpu import envs as jenvs
from mujoco_mbrl_tpu.physics import collision as jcollision
from mujoco_mbrl_tpu.physics import engine as jengine
from mujoco_mbrl_tpu.physics import model as JM
from mujoco_mbrl_tpu.physics import smooth as jsmooth
from mujoco_mbrl_tpu.physics import solver as jsolver
from mujoco_mbrl_tpu.suite import hopper as jhopper
from mujoco_mbrl_tpu.suite import sensors as jsensors
from mujoco_mbrl_tpu_torch import bench, convert, envs, suite
from mujoco_mbrl_tpu_torch.ops import apgd_solve, cem_mma
from mujoco_mbrl_tpu_torch.physics import collision, engine, smooth, solver
from mujoco_mbrl_tpu_torch.physics import model as M
from mujoco_mbrl_tpu_torch.physics.model import State
from mujoco_mbrl_tpu_torch.suite import hopper, sensors
from test_parity_physics import THRESHOLDS
from test_torch_apgd import _jax_pallas, _jax_xla
from test_torch_cartpole import (APGD_TOL, B, FIXTURES, PHYS_TOL, STEP_TOL,
                                 assert_model_matches, golden_rollout,
                                 jenv_of, tracks_mujoco_fixture)


def test_hopper_xml_is_a_copy():
    assert hopper._XML == jhopper._XML


@pytest.mark.parametrize('task', ['stand', 'hop'])
def test_model_matches_jax_field_by_field(task):
    jm = jenv_of('hopper', task).model
    tm = suite.load('hopper', task, device='cpu').model
    assert_model_matches(jm, tm)
    assert (tm.nq, tm.nv, tm.nu, tm.nsite) == (7, 7, 4, 2)
    assert tm.site_type == (M.SPHERE, M.SPHERE)
    np.testing.assert_allclose(tm.site_size.numpy(), 0.05)
    assert tm.site_body == (tm.name2id('body', 'foot'),) * 2


def contact_poses(tm, n, seed):
    """Standing hopper poses low enough to press the foot into the floor,
    the knee at times bent less than its 5-degree limit (a limit row
    active), random velocities and controls."""
    rng = np.random.RandomState(seed)
    qpos = np.zeros((n, 7))
    qpos[:, 0] = rng.uniform(-1, 1, n)
    qpos[:, 1] = rng.uniform(-0.17, -0.12, n)
    for i, (lo, hi) in enumerate(((-.2, .2), (-.2, .2), (-.3, .1),
                                  (.05, .4), (-.4, .4))):
        qpos[:, 2 + i] = rng.uniform(lo, hi, n)
    qvel = rng.normal(0.0, 1.0, (n, 7))
    ctrl = rng.uniform(-1.0, 1.0, (n, 4))
    return [x.astype(np.float32) for x in (qpos, qvel, ctrl)]


@pytest.fixture(scope='module')
def forward_pair():
    """JAX and port forward passes on B poses in contact, with JAX's
    constraint rows, block list and touch sensors."""
    jm = jenv_of('hopper', 'hop').model
    tm = suite.load('hopper', 'hop', device='cpu').model
    qpos, qvel, ctrl = contact_poses(tm, B, seed=2)
    blocks = []
    toe, heel = (jm.name2id('site', s) for s in ('touch_toe', 'touch_heel'))

    def jfwd(q, v, u):
        meta = jsmooth.tree_meta(jm)
        d = jengine.forward(jm, JM.State(qpos=q, qvel=v, time=jnp.zeros(())),
                            u)
        con = jcollision.detect(jm, d.geom_xpos, d.geom_xmat,
                                jcollision.candidate_pairs(jm))
        cs = jsolver.assemble(jm, meta, q, v, d.cdof, con)
        blocks[:] = [cs.blocks]
        touch = jnp.stack([jsensors.touch(jm, d, toe),
                           jsensors.touch(jm, d, heel)])
        return d, (cs.J, cs.aref, cs.R, cs.active), touch

    with jax.default_matmul_precision('highest'):
        jd, jrows, jtouch = jax.jit(jax.vmap(jfwd))(qpos, qvel, ctrl)
    ts = State(qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
               time=torch.zeros(B))
    return dict(jm=jm, tm=tm, jd=jd, jrows=[np.asarray(x) for x in jrows],
                jtouch=np.asarray(jtouch), blocks=blocks[0], ts=ts,
                ctrl=torch.as_tensor(ctrl),
                td=engine.forward(tm, ts, torch.as_tensor(ctrl)))


def test_kinematics_and_sites_match_jax(forward_pair):
    jd, td = forward_pair['jd'], forward_pair['td']
    for name in ('xpos', 'ximat', 'xipos', 'site_xpos', 'geom_xpos', 'cvel',
                 'qM', 'qfrc_bias', 'qfrc_passive', 'contact_dist',
                 'contact_pos'):
        np.testing.assert_allclose(getattr(td, name).numpy(),
                                   np.asarray(getattr(jd, name)),
                                   err_msg=name, **PHYS_TOL)
    # the toe and heel sites sit at the foot capsule's two ends
    foot = forward_pair['tm'].name2id('geom', 'foot')
    ends = td.geom_xpos[:, foot, None] + torch.einsum(
        'nij,j->ni', td.geom_xmat[:, foot], torch.tensor([0., 0., 1.])
    )[:, None] * torch.tensor([[-.125], [.125]])
    np.testing.assert_allclose(td.site_xpos.numpy(), ends.numpy(),
                               atol=1e-6)


def test_88_rows_in_jax_order(forward_pair):
    """4 limit rows, then 21 contact points (6 floor-capsule pairs of 2,
    9 capsule pairs of 1) as pyramids of 4 facets: J, aref, R, active."""
    tm, jm = forward_pair['tm'], forward_pair['jm']
    pairs = collision.candidate_pairs(tm)
    assert pairs == jcollision.candidate_pairs(jm) and len(pairs) == 15
    assert len(sensors.contact_layout(tm)) == 21
    td, ts = forward_pair['td'], forward_pair['ts']
    con = collision.detect(tm, td.geom_xpos, td.geom_xmat, pairs)
    cs = solver.assemble(tm, smooth.tree_meta(tm), ts.qpos, ts.qvel,
                         td.cdof, con)
    assert cs.J.shape == (B, 88, 7)
    assert cs.blocks == forward_pair['blocks']
    assert [k for k, _ in cs.blocks] == ['limit'] * 4 + ['facet'] * 84
    for ours, ref, name in zip((cs.J, cs.aref, cs.R, cs.active),
                               forward_pair['jrows'],
                               ('J', 'aref', 'R', 'active')):
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(ref).max(), 1.0),
                                   err_msg=name)
    act = cs.active.numpy()
    assert act[:, 4:].sum() >= 4 * 8 and act[:, :4].sum() >= 1, act.sum(0)


def test_solve_and_touch_match_jax(forward_pair):
    """The forward's solve (rtol 1e-4) and the toe and heel touch sensors
    on it (rtol 1e-4), with floor contact under the foot."""
    jd, td = forward_pair['jd'], forward_pair['td']
    f_ref = np.asarray(jd.efc_force)
    scale = np.abs(f_ref).max()
    for name in ('efc_force', 'qfrc_constraint', 'contact_force', 'qacc'):
        np.testing.assert_allclose(getattr(td, name).numpy(),
                                   np.asarray(getattr(jd, name)), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)
    tm = forward_pair['tm']
    touch = torch.stack([sensors.touch(tm, td, tm.name2id('site', s))
                         for s in ('touch_toe', 'touch_heel')], 1)
    ref = forward_pair['jtouch']
    assert (ref > 1.0).sum() >= 2, 'no touch exercised'
    np.testing.assert_allclose(touch.numpy(), ref, rtol=1e-4,
                               atol=1e-5 * ref.max())
    np.testing.assert_allclose(hopper.touch(tm, td).numpy(), np.log1p(ref),
                               rtol=1e-4, atol=1e-5)


def test_apgd_plain_at_88_rows_matches_jax(forward_pair):
    """The port's plain dense iterate on the cold and warm 88-row solves
    of two substeps from the contact poses, against the XLA iterate (and
    the Pallas kernel in interpret mode for the cold one)."""
    tm, ts = forward_pair['tm'], forward_pair['ts']
    captured, real = [], apgd_solve.apgd_iterate_batched

    def capture(*args, **kw):
        captured.append((tuple(a.numpy().copy() for a in args), dict(kw)))
        return real(*args, **kw)

    apgd_solve.apgd_iterate_batched = capture
    try:
        s1, f, v = engine.step_warm(tm, ts, forward_pair['ctrl'])
        engine.step_warm(tm, s1, forward_pair['ctrl'], warm_f=f, warm_v=v)
    finally:
        apgd_solve.apgd_iterate_batched = real
    assert [kw['cold'] for _, kw in captured] == [True, False]
    for args, kw in captured:
        assert args[0].shape == (B, 88, 88) and len(kw['nonneg']) == 88
        assert not kw['con0'] and not kw['box_rows']
        jkw = dict(nonneg=kw['nonneg'], box=kw['box_rows'],
                   con0=kw['con0'], iterations=kw['iterations'],
                   cold=kw['cold'], eq_rows=kw['eq_rows'])
        out = real(*[torch.as_tensor(a) for a in args], **kw)
        refs = [_jax_xla(args, **jkw)]
        if kw['cold']:
            refs.append(_jax_pallas(args, **jkw))
        for ref in refs:
            np.testing.assert_allclose(out[0].numpy(), ref[0], **APGD_TOL)
            np.testing.assert_allclose(out[1].numpy(), ref[1], **APGD_TOL)
        assert float(np.abs(out[0].numpy()).max()) > 1e-2


def _jax_wrapper():
    """The JAX Hopper wrapper, made without its eager observation-spec
    reset (its dims are class constants)."""
    cls = jenvs.wrappers.Hopper
    w = cls.__new__(cls)
    w._env, w._state_penalty = jenv_of('hopper', 'hop'), 1.0
    w.action_dim = 4
    return w


@pytest.fixture(scope='module')
def jax_episode():
    """JAX-drawn resets (falling at a random pitch), one control step of
    numpy actions with the JAX wrapper's featured state of it."""
    jenv, jw = jenv_of('hopper', 'hop'), _jax_wrapper()
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    acts = np.random.RandomState(2).uniform(-1, 1, (B, 4)).astype(
        np.float32)

    def episode(k, a):
        s0, ts0 = jenv.reset(k)
        s1, ts1, d = jenv.step_with_data(s0, a)
        return s0, ts0, s1, ts1, jw.get_state(s1, d)

    s0, ts0, s1, ts1, feat = jax.jit(jax.vmap(episode))(keys, acts)
    return dict(state0=s0, ts0=ts0, acts=acts, state1=s1, ts1=ts1,
                feat1=np.asarray(feat))


def test_control_step_from_jax_reset_matches(jax_episode):
    wrap = envs.load('hopper', 'hop', device='cpu')
    env = wrap.env
    assert env._n_sub_steps == 4
    j0, j1 = jax_episode['state0'], jax_episode['state1']
    s = convert.env_state(j0.physics.qpos, j0.physics.qvel,
                          time=j0.physics.time)
    _, ts0 = env.start(s.physics)
    for k, v in ts0.observation.items():
        np.testing.assert_allclose(
            v.numpy(), np.asarray(jax_episode['ts0'].observation[k]),
            err_msg=k, **STEP_TOL)
    s1, ts, data = env.step_with_data(s, torch.as_tensor(jax_episode['acts']))
    for ours, ref, name in ((s1.physics.qpos, j1.physics.qpos, 'qpos'),
                            (s1.physics.qvel, j1.physics.qvel, 'qvel'),
                            (ts.reward, jax_episode['ts1'].reward, 'reward')):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   err_msg=name, **STEP_TOL)
    jobs = jax_episode['ts1'].observation
    assert list(ts.observation) == sorted(jobs)
    for k, v in ts.observation.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jobs[k]), err_msg=k,
                                   **STEP_TOL)
    np.testing.assert_allclose(wrap.get_state(s1, data).numpy(),
                               jax_episode['feat1'], **STEP_TOL)


def test_golden_fixture():
    golden = np.load(os.path.join(FIXTURES, 'golden_hopper_stand.npz'))
    qpos, rewards = golden_rollout('hopper', 'stand')
    np.testing.assert_allclose(qpos, golden['qpos'], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(rewards, golden['rewards'], rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize('task', ['stand', 'hop'])
def test_tracks_mujoco_fixture(task):
    tracks_mujoco_fixture('hopper', task,
                          suite.load('hopper', task, device='cpu').model,
                          *THRESHOLDS[('hopper', task)])


def test_wrapper_matches_jax(jax_episode):
    w = envs.load('hopper', 'hop', device='cpu')
    jw = _jax_wrapper()
    assert (w.state_dim, w.observation_dim, w.action_dim) == (
        jw.state_dim, jw.observation_dim, jw.action_dim) == (17, 15, 4)
    np.testing.assert_array_equal(w.get_goal_weights().numpy(),
                                  np.asarray(jw.get_goal_weights()))
    np.testing.assert_array_equal(w.set_goal().numpy(), np.asarray(
        jw.set_goal(jax.random.PRNGKey(0))))
    st = w.sample_state(torch.Generator().manual_seed(0), (400,)).numpy()
    js = np.asarray(jw.sample_state(jax.random.PRNGKey(1)))
    lo, hi = map(np.array, zip(*w._SAMPLE_RANGES))
    for x in (st, js[None]):
        assert x.shape[1] == 14 and (x[:, 1] == np.float32(-0.078789)).all()
        assert ((x[:, 2:7] >= lo) & (x[:, 2:7] <= hi)).all()
        assert (np.abs(x[:, 7:]) <= .01).all() and (x[:, 0] == 0).all()


def test_bench_route(monkeypatch):
    """hopper_hop plans on its 15-dim observation with 4 actions (19 dims:
    the fused sampler, tiles (3, 7, 2)); a control step is 4 substeps and
    the observation's forward (the touch sensors read its solve): 5 dense
    solves at 88 rows, after the first observation's one."""
    assert cem_mma.layout(15, 4, 50)[:3] == (3, 7, 2)
    assert cem_mma.layout(17, 4, 50)[:3] == (3, 7, 3)
    taken, solves = [], []
    real = bench.mlp_sample_rollout_costs
    monkeypatch.setattr(bench, 'mlp_sample_rollout_costs', lambda *a, **k: (
        taken.append(a[2].shape), real(*a, **k))[1])
    real_apgd = apgd_solve.apgd_iterate_batched
    monkeypatch.setattr(apgd_solve, 'apgd_iterate_batched', lambda *a, **k: (
        solves.append(a[0].shape), real_apgd(*a, **k))[1])
    run, (p, s, g) = bench.build_bench('hopper_hop', 2, 16, 3, 2, 1,
                                       device='cpu')
    solves.clear()
    state, rewards = run(p, s, g)
    assert taken == [(2, 15)] * 2
    # the first observation's forward, then the control step's 5
    assert solves == [(2, 88, 88)] * (1 + 5)
    assert state.physics.qpos.shape == (2, 7)
    assert bool(torch.isfinite(rewards).all())


def test_cli_runs_on_cpu(tmp_path):
    from mujoco_mbrl_tpu_torch import experiment
    agent = experiment.main(experiment.parse_args([
        '--exp_dir', str(tmp_path), '--environment', 'hopper_hop',
        '--planner', 'cem', '--model', 'nn', '--rollout_length', '3',
        '--num_rollouts_per_iteration', '2', '--num_train_iterations', '1',
        '--train_epochs', '1', '--device', 'cpu', '--planner_kwargs',
        '{"num_candidates": 16, "num_elites": 4}']))
    assert agent.plan_dim == 17 and not agent.obs_only
    buf = agent.dataset
    assert buf.states.shape[-1] == 17
    assert bool(torch.isfinite(buf.states[:buf.filled]).all())


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device works')
    from mujoco_mbrl_tpu_torch import experiment
    with pytest.raises(RuntimeError, match='CUDA'):
        suite.load('hopper', 'hop')
    with pytest.raises(RuntimeError, match='CUDA'):
        envs.load('hopper', 'stand')
    with pytest.raises(RuntimeError, match='CUDA'):
        experiment.main(experiment.parse_args(
            ['--exp_dir', '', '--environment', 'hopper_hop']))
    with pytest.raises(RuntimeError, match='CUDA'):
        bench.build_bench('hopper_hop', 2, 8, 3, 1, 1)
