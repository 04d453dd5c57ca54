"""The cheetah_run slice, port against the JAX package.

Same inputs, drawn with numpy or by the JAX reset, go through both
packages: the compiled Model field by field; the candidate pairs (16
plane-capsule and 19 capsule-capsule contacts, 35 in all); capsule-capsule
distance, point and frame on JAX kinematics, with near-parallel segments;
the 146 constraint rows and their solve (the factored APGD regime); one
and five control steps from JAX-drawn reset states; observation, reward
and the Cheetah wrapper's featured state. Tolerances: geometry and rows
1e-5 (float32 of the same operations), forces rtol 1e-4, steps 1e-4. The
port alone tracks the MuJoCo fixture for 40 steps within 1e-3 (the CPU
band of tests/test_parity_physics.py). The 200-step settling of the reset
against JAX's runs with RUN_HEAVY=1.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mbrl_tpu import envs as jenvs
from mujoco_mbrl_tpu import suite as jsuite
from mujoco_mbrl_tpu.physics import collision as jcollision
from mujoco_mbrl_tpu.physics import engine as jengine
from mujoco_mbrl_tpu.physics import mjcf as jmjcf
from mujoco_mbrl_tpu.physics import model as JM
from mujoco_mbrl_tpu.physics import smooth as jsmooth
from mujoco_mbrl_tpu.physics import solver as jsolver
from mujoco_mbrl_tpu.suite import cheetah as jcheetah
from mujoco_mbrl_tpu_torch import convert, envs, suite
from mujoco_mbrl_tpu_torch.physics import collision, engine, mjcf, smooth
from mujoco_mbrl_tpu_torch.physics import solver
from mujoco_mbrl_tpu_torch.physics.model import State
from mujoco_mbrl_tpu_torch.suite import cheetah

FIXTURE = os.path.join(os.path.dirname(__file__), 'fixtures', 'parity',
                       'cheetah_run.npz')
B = 3


@pytest.fixture(scope='module')
def models():
    return jmjcf.parse(jcheetah._XML), mjcf.parse(cheetah._XML)


def test_cheetah_xml_is_a_copy():
    assert cheetah._XML == jcheetah._XML


def test_model_matches_jax_field_by_field(models):
    jm, tm = models
    for f in dataclasses.fields(tm):
        if f.name == 'opt':
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
    for name in ('timestep', 'gravity', 'viscosity', 'density', 'wind'):
        np.testing.assert_allclose(getattr(tm.opt, name).numpy(),
                                   np.asarray(getattr(jm.opt, name)))
    for name in ('integrator', 'disableflags', 'solver_iterations', 'solver',
                 'cone', 'impratio', 'solver_warmstart',
                 'enable_geom_geom_contacts'):
        assert getattr(tm.opt, name) == getattr(jm.opt, name), name


def test_candidate_pairs_give_35_contacts(models):
    jm, tm = models
    flag = tm.opt.enable_geom_geom_contacts
    pairs = collision.candidate_pairs(tm, include_geom_geom=flag)
    assert pairs == jcollision.candidate_pairs(jm, include_geom_geom=flag)
    kinds = [(tm.geom_type[a], tm.geom_type[b]) for a, b in pairs]
    from mujoco_mbrl_tpu_torch.physics import model as M
    assert kinds.count((M.PLANE, M.CAPSULE)) == 8
    assert kinds.count((M.CAPSULE, M.CAPSULE)) == 19
    assert sum(collision._PAIR_POINTS[k] for k in kinds) == 35


def _random_states(tm, n, seed):
    """Cheetah states low enough to touch the floor with feet and legs
    folded into the body (capsule-capsule contacts), some joints past
    their limits, random velocities and controls."""
    rng = np.random.RandomState(seed)
    lo, hi = tm.jnt_range[:, 0].numpy(), tm.jnt_range[:, 1].numpy()
    qpos = np.zeros((n, tm.nq), np.float32)
    qpos[:, 0] = rng.uniform(-1.0, 1.0, n)             # rootx
    qpos[:, 1] = rng.uniform(-0.75, -0.55, n)          # rootz
    qpos[:, 2] = rng.uniform(-0.5, 0.5, n)             # rooty
    qpos[:, 3:] = lo[3:] + rng.uniform(-0.05, 1.05, (n, 6)) * (
        hi[3:] - lo[3:])
    qvel = rng.normal(0.0, 1.0, (n, tm.nv)).astype(np.float32)
    ctrl = rng.uniform(-1.0, 1.0, (n, tm.nu)).astype(np.float32)
    return qpos, qvel, ctrl


@pytest.fixture(scope='module')
def forward_pair(models):
    jm, tm = models
    qpos, qvel, ctrl = _random_states(tm, 6, seed=0)

    def jfwd(q, v, u):
        meta = jsmooth.tree_meta(jm)
        d = jengine.forward(jm, JM.State(qpos=q, qvel=v, time=jnp.zeros(())),
                            u)
        pairs = jcollision.candidate_pairs(
            jm, include_geom_geom=jm.opt.enable_geom_geom_contacts)
        con = jcollision.detect(jm, d.geom_xpos, d.geom_xmat, pairs)
        cs = jsolver.assemble(jm, meta, q, v, d.cdof, con)
        return d, (cs.J, cs.aref, cs.R, cs.active)

    jd, jrows = jax.jit(jax.vmap(jfwd))(qpos, qvel, ctrl)
    ts = State(qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
               time=torch.zeros(6))
    td = engine.forward(tm, ts, torch.as_tensor(ctrl))
    return jd, jrows, td, ts


def test_collision_matches_jax_on_jax_kinematics(models, forward_pair):
    jm, tm = models
    jd, _, _, _ = forward_pair
    pairs = collision.candidate_pairs(
        tm, include_geom_geom=tm.opt.enable_geom_geom_contacts)
    con = collision.detect(tm, torch.tensor(np.asarray(jd.geom_xpos)),
                           torch.tensor(np.asarray(jd.geom_xmat)), pairs)
    for ours, name in ((con.dist, 'contact_dist'), (con.pos, 'contact_pos'),
                       (con.frame, 'contact_frame')):
        np.testing.assert_allclose(ours.numpy(),
                                   np.asarray(getattr(jd, name)),
                                   atol=1e-5, err_msg=name)
    assert con.dist.shape == (6, 35)
    d = con.dist.numpy()
    assert (d[:, :16] < 0).any(), 'no floor contact exercised'
    assert (d[:, 16:] < 0.05).any(), 'no capsule pair close'


def test_closest_segment_segment_matches_jax_near_parallel():
    """Random segment pairs, half of them parallel up to 1e-7 .. 1e-3 of
    a radian (the s = 0 branch of the clamped solve), against the JAX
    ``_closest_segment_segment`` and ``_k_capsule_capsule``."""
    rng = np.random.RandomState(1)
    n = 64
    a0 = rng.normal(size=(n, 3))
    d1 = rng.normal(size=(n, 3))
    b0 = a0 + 0.1 * rng.normal(size=(n, 3))
    d2 = rng.normal(size=(n, 3))
    tilt = 10.0 ** rng.uniform(-7, -3, size=(n // 2, 1))
    d2[:n // 2] = (d1[:n // 2] * rng.uniform(-2, 2, size=(n // 2, 1))
                   + tilt * rng.normal(size=(n // 2, 3)))
    seg = [np.asarray(x, np.float32) for x in (a0, a0 + d1, b0, b0 + d2)]
    jp = jax.vmap(jcollision._closest_segment_segment)(*seg)
    tp = collision._closest_segment_segment(*map(torch.as_tensor, seg))
    for o, r in zip(tp, jp):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5)
    # capsules: centre, frame (axis = z column) and (radius, half-length)
    R = np.zeros((n, 2, 3, 3), np.float32)
    for i, d in enumerate((d1, d2)):
        z = d / np.linalg.norm(d, axis=1, keepdims=True)
        x = np.cross(z, np.array([0.3, 0.5, 0.8]))
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        R[:, i] = np.stack([x, np.cross(z, x), z], axis=2)
    half = 0.5 * np.linalg.norm(np.stack([d1, d2], 1), axis=2)
    size = np.stack([0.05 + 0.05 * rng.uniform(size=(n, 2)), half,
                     np.zeros((n, 2))], 2).astype(np.float32)
    ctr = np.stack([a0 + 0.5 * d1, b0 + 0.5 * d2], 1).astype(np.float32)
    jk = jax.vmap(jcollision._k_capsule_capsule)(
        ctr[:, 0], R[:, 0], size[:, 0], ctr[:, 1], R[:, 1], size[:, 1])
    t = lambda x: torch.as_tensor(x)
    tk = collision._k_capsule_capsule(
        t(ctr[None, :, 0]), t(R[None, :, 0]), t(size[:, 0]),
        t(ctr[None, :, 1]), t(R[None, :, 1]), t(size[:, 1]))
    for o, r, name in zip(tk, jk, ('dist', 'pos', 'normal')):
        np.testing.assert_allclose(o[0].numpy(), np.asarray(r), atol=1e-5,
                                   err_msg=name)


def test_constraint_rows_and_solve_match_jax(models, forward_pair):
    jm, tm = models
    jd, jrows, td, ts = forward_pair
    meta = smooth.tree_meta(tm)
    pairs = collision.candidate_pairs(
        tm, include_geom_geom=tm.opt.enable_geom_geom_contacts)
    con = collision.detect(tm, td.geom_xpos, td.geom_xmat, pairs)
    cs = solver.assemble(tm, meta, ts.qpos, ts.qvel, td.cdof, con)
    assert cs.J.shape == (6, 146, 9)
    for ours, ref, name in zip((cs.J, cs.aref, cs.R, cs.active), jrows,
                               ('J', 'aref', 'R', 'active')):
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(ref).max(), 1.0),
                                   err_msg=name)
    # the factored regime solves them (nr = 146 > 96)
    f_ref = np.asarray(jd.efc_force)
    assert (np.abs(f_ref) > 1e-3).sum() > 20, 'too few active rows'
    scale = np.abs(f_ref).max()
    for name in ('efc_force', 'qfrc_constraint', 'contact_force', 'qacc'):
        ref = np.asarray(getattr(jd, name))
        np.testing.assert_allclose(getattr(td, name).numpy(), ref,
                                   rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=name)


@pytest.fixture(scope='module')
def jax_episode():
    """JAX-drawn reset states (200 settling steps each) and 5 control
    steps of random actions, with the wrapper's featured states."""
    jenv = jsuite.load('cheetah', 'run')
    # the JAX wrapper without its __init__, whose observation spec would
    # run a 200-step reset; get_state, goals and weights read only these
    jwrap = object.__new__(jenvs.wrappers.Cheetah)
    jwrap._env, jwrap._state_penalty = jenv, 1.0
    state0, ts0 = jax.jit(jax.vmap(jenv.reset))(
        jax.random.split(jax.random.PRNGKey(0), B))
    acts = np.random.RandomState(2).uniform(-1, 1, (5, B, 6)).astype(
        np.float32)
    step = jax.jit(jax.vmap(jenv.step_with_data))
    feat = jax.jit(jax.vmap(jwrap.get_state))
    states, steps = [state0], []
    for a in acts:
        s, ts, d = step(states[-1], a)
        states.append(s)
        steps.append((ts, feat(s, d)))
    return state0, ts0, acts, states, steps, jwrap


@pytest.fixture(scope='module')
def port_wrapper():
    return envs.load('cheetah', 'run', device='cpu')


def _to_port(js):
    return convert.env_state(js.physics.qpos, js.physics.qvel,
                             time=js.physics.time, step_count=js.step_count)


def test_steps_from_jax_reset_states_match(jax_episode, port_wrapper):
    state0, ts0, acts, jstates, jsteps, _ = jax_episode
    wrap = port_wrapper
    env = wrap.env
    s = _to_port(state0)
    np.testing.assert_allclose(
        suite.flatten_observation(env._observe(env.model, s.physics, ()))
        .numpy(), np.asarray(jax.vmap(jsuite.flatten_observation)(
            ts0.observation)), atol=1e-5)
    for t, a in enumerate(acts):
        s, ts, data = env.step_with_data(s, torch.as_tensor(a))
        js, (jts, jfeat) = jstates[t + 1], jsteps[t]
        # one step, then five: contacts make the error grow; 1e-4 holds
        np.testing.assert_allclose(s.physics.qpos.numpy(),
                                   np.asarray(js.physics.qpos), atol=1e-4,
                                   err_msg=f'qpos step {t}')
        np.testing.assert_allclose(s.physics.qvel.numpy(),
                                   np.asarray(js.physics.qvel), atol=1e-4,
                                   rtol=1e-4, err_msg=f'qvel step {t}')
        np.testing.assert_allclose(ts.reward.numpy(), np.asarray(jts.reward),
                                   atol=1e-5)
        for k in ('position', 'velocity'):
            np.testing.assert_allclose(ts.observation[k].numpy(),
                                       np.asarray(jts.observation[k]),
                                       atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(wrap.get_state(s, data).numpy(),
                                   np.asarray(jfeat), atol=1e-4, rtol=1e-4)
    assert list(ts.observation) == ['position', 'velocity']


def test_wrapper_goal_weights_and_dims(jax_episode, port_wrapper):
    jwrap, wrap = jax_episode[-1], port_wrapper
    assert (wrap.state_dim, wrap.observation_dim, wrap.action_dim) == (
        jwrap.state_dim, jwrap.observation_dim, jwrap._env.model.nu) == (
            19, 17, 6)
    np.testing.assert_array_equal(wrap.get_goal_weights().numpy(),
                                  np.asarray(jwrap.get_goal_weights()))
    np.testing.assert_array_equal(wrap.set_goal().numpy(), np.asarray(
        jwrap.set_goal(jax.random.PRNGKey(0))))


def test_reset_settles_and_restarts_time():
    """The port's own reset: limited joints drawn in range, 200 settling
    steps, time 0, the torso resting near the floor."""
    env = suite.load('cheetah', 'run', device='cpu')
    state, ts = env.reset(2, torch.Generator().manual_seed(0))
    q = state.physics.qpos
    assert bool(torch.isfinite(q).all())
    assert state.physics.time.tolist() == [0.0, 0.0]
    assert ts.observation['position'].shape == (2, 8)
    # after 2 s of settling the body has come to rest on the floor
    assert float(state.physics.qvel.abs().max()) < 0.5
    assert float(q[:, 1].abs().max()) < 0.3


def test_tracks_mujoco_fixture_40_steps(models):
    """Port alone vs the MuJoCo oracle: 40 physics steps within the CPU
    band of tests/test_parity_physics.py (1e-3 on qpos)."""
    _, tm = models
    fix = np.load(FIXTURE)
    ctrl = np.repeat(fix['ctrl'], int(fix['n_sub_steps']), axis=0)[:40]
    s = State(qpos=torch.tensor(fix['init_qpos'], dtype=torch.float32)[None],
              qvel=torch.tensor(fix['init_qvel'], dtype=torch.float32)[None],
              time=torch.zeros(1))
    qpos = [fix['init_qpos']]
    for u in ctrl:
        s = engine.step(tm, s, torch.tensor(u, dtype=torch.float32)[None])
        qpos.append(s.qpos[0].numpy())
    dev = np.abs(np.array(qpos) - fix['p_qpos'][:41]).max(axis=1)
    assert dev.max() <= 1e-3, dev


@pytest.mark.skipif(os.environ.get('RUN_HEAVY', '') != '1',
                    reason='200 settling steps in both packages; '
                           'RUN_HEAVY=1')
def test_reset_settling_matches_jax(models, jax_episode):
    """The 200 settling steps of the reset from JAX's own pre-settle
    draws (limited joints uniform from per-joint keys), port vs JAX."""
    jm, tm = models
    state0 = jax_episode[0]
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    q0 = np.tile(np.asarray(jm.qpos0), (B, 1)).astype(np.float32)
    for b in range(B):
        jk = jax.random.split(keys[b], jm.njnt)
        for j in range(jm.njnt):
            if jm.jnt_limited[j]:
                q0[b, jm.jnt_qposadr[j]] = float(jax.random.uniform(
                    jk[j], (), minval=jm.jnt_range[j, 0],
                    maxval=jm.jnt_range[j, 1]))
    s = State(qpos=torch.as_tensor(q0), qvel=torch.zeros((B, tm.nv)),
              time=torch.zeros(B))
    for _ in range(200):
        s = engine.step(tm, s, torch.zeros((B, tm.nu)))
    np.testing.assert_allclose(s.qpos.numpy(),
                               np.asarray(state0.physics.qpos), atol=1e-3)


def test_full_loop_and_control_steps_run_on_cpu():
    """The slice's entry points at a tiny size: bench.full_loop_bench
    (seed collection, then collect -> add -> fit) and one control step
    through the non-fused CEM route from the loop's final states."""
    from mujoco_mbrl_tpu_torch.bench import build_bench, full_loop_bench
    out = full_loop_bench('cheetah_run', 2, 16, 4, 2, 3, device='cpu',
                          train_epochs=2, train_batch=4)
    assert out['replay'].filled == 4
    assert out['losses'].shape == (2 * (4 * 3 // 4),)
    assert bool(torch.isfinite(out['losses']).all())
    assert out['iteration_s'] >= out['fit_s'] > 0.0
    assert out['env_steps_per_s'] == pytest.approx(2 * 3 / out['iteration_s'])
    run, (params, _, gen) = build_bench('cheetah_run', 2, 16, 4, 2, 1,
                                        device='cpu', fused=False)
    state, rewards = run(params, out['env_state'], gen)
    assert rewards.shape == (1,) and bool(torch.isfinite(rewards).all())
    assert state.physics.qpos.shape == (2, 9)
