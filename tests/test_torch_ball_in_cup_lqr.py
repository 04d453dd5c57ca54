"""ball_in_cup (a spatial-tendon limit row, 21 constraint rows) and lqr
(early termination, autoreset, the analytic LQR oracle), port against the
JAX package.

Same inputs, drawn with numpy or by the JAX reset, go through both
packages (B = 4; the JAX forward and episodes compile once, module
scoped):

* ball_in_cup's ``_XML`` and lqr's ``_make_model_xml`` (both tasks, two
  seeds) give the JAX modules' XML, and the compiled models match field
  by field (rtol 1e-5), the string's limit-row invweight at qpos0
  included;
* on ball_in_cup poses with the ball in the cup or the string
  over-stretched: ``site_xpos`` and the 21 rows in JAX's order (the
  tendon limit, then 5 sphere-capsule points of 4 facets; J, aref, R,
  active at rtol 1e-5) and the solve (rtol 1e-4), and #1's plain twin on
  the 21-row cold and warm solves against JAX's XLA iterate (rtol = atol
  = 2e-4);
* one control step (10 substeps) of ball_in_cup and of each lqr task
  from JAX-drawn resets with numpy actions (atol = rtol = 1e-4);
* the MuJoCo parity fixtures within the CPU bands of
  tests/test_parity_physics.py THRESHOLDS (ball_in_cup 100 steps at
  1e-4) and HEAVY_THRESHOLDS (lqr 50 steps at 1e-4);
* ``lqr_solver`` equals JAX's; its optimal policy stabilizes the port's
  system at the predicted rate (as tests/test_lqr_oracle.py) and, from
  states of norm sqrt(2) 1e-6, drives it below the 1e-6 termination
  bound: LAST with discount 0, then ``autoreset_step`` restarts those
  envs (FIRST) and steps the others; autoreset after a time limit set
  through ``task_kwargs``, and after divergence;
* ``all_tasks`` / ``benchmarking`` equal JAX's restricted to the ported
  domains, task kwargs reach the task through ``suite.load`` and the
  wrapper, and the entry points default to the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mbrl_tpu import suite as jsuite
from mujoco_mbrl_tpu.physics import collision as jcollision
from mujoco_mbrl_tpu.physics import engine as jengine
from mujoco_mbrl_tpu.physics import model as JM
from mujoco_mbrl_tpu.physics import smooth as jsmooth
from mujoco_mbrl_tpu.physics import solver as jsolver
from mujoco_mbrl_tpu.suite import ball_in_cup as jball
from mujoco_mbrl_tpu.suite import lqr as jlqr
from mujoco_mbrl_tpu.suite import lqr_solver as jlqr_solver
from mujoco_mbrl_tpu_torch import envs, suite
from mujoco_mbrl_tpu_torch.ops import apgd_solve
from mujoco_mbrl_tpu_torch.physics import collision, engine, smooth, solver
from mujoco_mbrl_tpu_torch.physics.model import State
from mujoco_mbrl_tpu_torch.suite import ball_in_cup, control, lqr, lqr_solver
from parity_utils import SEED
from test_parity_physics import HEAVY_THRESHOLDS, THRESHOLDS
from test_torch_apgd import _jax_xla
from test_torch_cartpole import (APGD_TOL, B, PHYS_TOL, STEP_TOL,
                                 assert_model_matches, jenv_of,
                                 tracks_mujoco_fixture)
from test_torch_contact_free import _port_state
from test_torch_finger import capture_solves

LQR_TASKS = ('lqr_2_1', 'lqr_6_2')
_JLQR = {}


def jlqr_env(task, seed=0):
    if (task, seed) not in _JLQR:
        _JLQR[task, seed] = jsuite.load('lqr', task,
                                        task_kwargs={'seed': seed})
    return _JLQR[task, seed]


def test_xml_copies():
    assert ball_in_cup._XML == jball._XML
    for n_b, n_a in ((2, 1), (6, 2)):
        for seed in (0, 7):
            assert lqr._make_model_xml(
                n_b, n_a, np.random.RandomState(seed)) == \
                jlqr._make_model_xml(n_b, n_a, np.random.RandomState(seed))


def test_ball_in_cup_model_matches_jax_field_by_field():
    jm = jenv_of('ball_in_cup', 'catch').model
    tm = suite.load('ball_in_cup', 'catch', device='cpu').model
    assert_model_matches(jm, tm, held_apart=('spatial_tendons',))
    assert len(tm.spatial_tendons) == len(jm.spatial_tendons) == 1
    ours, ref = tm.spatial_tendons[0], jm.spatial_tendons[0]
    assert ours[:3] == ref[:3] == (tm.name2id('site', 'ball'),
                                   tm.name2id('site', 'cup'), True)
    np.testing.assert_allclose(ours[3:], ref[3:], rtol=1e-5)
    assert ours[4] == pytest.approx(0.3) and ours[5] > 1.0


@pytest.mark.parametrize('task', LQR_TASKS)
def test_lqr_model_matches_jax_field_by_field(task):
    tm = suite.load('lqr', task, task_kwargs={'seed': 0}, device='cpu').model
    assert_model_matches(jlqr_env(task).model, tm)
    other = suite.load('lqr', task, task_kwargs={'seed': 1},
                       device='cpu').model
    assert not torch.equal(other.jnt_stiffness, tm.jnt_stiffness)


def cup_poses(n, seed):
    """The ball resting in the cup's bottom or against its side (sphere-
    capsule contacts) in the first envs, hanging far below it (the string
    past its 0.3 length) in the last; random velocities and controls."""
    rng = np.random.RandomState(seed)
    qpos = np.zeros((n, 4), np.float32)
    qpos[:, :2] = rng.uniform(-.02, .02, (n, 2))          # cup_x, cup_z
    qpos[:, 2] = qpos[:, 0] + np.float32([0.0, .02, -.02, 0.0])[:n]
    qpos[:, 3] = qpos[:, 1] + .325
    qpos[-1, 3] = qpos[-1, 1] - .1                         # string taut
    qvel = rng.normal(0.0, 0.3, (n, 4)).astype(np.float32)
    ctrl = rng.uniform(-1.0, 1.0, (n, 2)).astype(np.float32)
    return qpos, qvel, ctrl


@pytest.fixture(scope='module')
def cup_pair():
    jm = jenv_of('ball_in_cup', 'catch').model
    tm = suite.load('ball_in_cup', 'catch', device='cpu').model
    qpos, qvel, ctrl = cup_poses(B, seed=0)
    blocks = []

    def jfwd(q, v, u):
        d = jengine.forward(jm, JM.State(qpos=q, qvel=v, time=jnp.zeros(())),
                            u)
        con = jcollision.detect(jm, d.geom_xpos, d.geom_xmat,
                                jcollision.candidate_pairs(jm))
        cs = jsolver.assemble(jm, jsmooth.tree_meta(jm), q, v, d.cdof, con,
                              site_xpos=d.site_xpos)
        blocks[:] = [cs.blocks]
        return d, (cs.J, cs.aref, cs.R, cs.active)

    with jax.default_matmul_precision('highest'):
        jd, jrows = jax.jit(jax.vmap(jfwd))(qpos, qvel, ctrl)
    ts = State(qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
               time=torch.zeros(B))
    return dict(tm=tm, jm=jm, jd=jd, jrows=[np.asarray(x) for x in jrows],
                blocks=blocks[0], ts=ts, ctrl=torch.as_tensor(ctrl),
                td=engine.forward(tm, ts, torch.as_tensor(ctrl)))


def test_21_rows_in_jax_order(cup_pair):
    tm, jd, td, ts = (cup_pair[k] for k in ('tm', 'jd', 'td', 'ts'))
    for name in ('xpos', 'site_xpos', 'geom_xpos', 'qM', 'contact_dist',
                 'contact_pos'):
        np.testing.assert_allclose(getattr(td, name).numpy(),
                                   np.asarray(getattr(jd, name)),
                                   err_msg=name, **PHYS_TOL)
    pairs = collision.candidate_pairs(tm)
    assert pairs == jcollision.candidate_pairs(cup_pair['jm'])
    assert len(pairs) == 5
    con = collision.detect(tm, td.geom_xpos, td.geom_xmat, pairs)
    cs = solver.assemble(tm, smooth.tree_meta(tm), ts.qpos, ts.qvel,
                         td.cdof, con, site_xpos=td.site_xpos)
    assert cs.J.shape == (B, 21, 4)
    assert cs.blocks == cup_pair['blocks']
    assert [k for k, _ in cs.blocks] == ['limit'] + ['facet'] * 20
    for ours, ref, name in zip((cs.J, cs.aref, cs.R, cs.active),
                               cup_pair['jrows'],
                               ('J', 'aref', 'R', 'active')):
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(ref).max(), 1.0),
                                   err_msg=name)
    act = cs.active.numpy()
    assert act[-1, 0] == 1 and act[:-1, 0].sum() == 0
    assert act[:-1, 1:].sum(1).min() >= 4, act.sum(0)
    # the solve, and the limit row pulls the ball back
    f_ref = np.asarray(jd.efc_force)
    for name in ('efc_force', 'qfrc_constraint', 'qacc'):
        np.testing.assert_allclose(getattr(td, name).numpy(),
                                   np.asarray(getattr(jd, name)), rtol=1e-4,
                                   atol=1e-5 * np.abs(f_ref).max(),
                                   err_msg=name)
    assert f_ref[-1, 0] > 0.1


def test_apgd_plain_at_21_rows_matches_jax(cup_pair):
    captured = capture_solves(cup_pair['tm'], cup_pair['ts'],
                              cup_pair['ctrl'])
    assert [kw['cold'] for _, kw in captured] == [True, False]
    for args, kw in captured:
        assert args[0].shape == (B, 21, 21) and len(kw['nonneg']) == 21
        assert not kw['box_rows'] and not kw['con0']
        assert kw['iterations'] == 60
        f, v = apgd_solve.apgd_iterate_batched(
            *[torch.as_tensor(a) for a in args], **kw)
        ref = _jax_xla(args, nonneg=kw['nonneg'], box=kw['box_rows'],
                       con0=kw['con0'], iterations=kw['iterations'],
                       cold=kw['cold'], eq_rows=kw['eq_rows'])
        np.testing.assert_allclose(f.numpy(), ref[0], **APGD_TOL)
        np.testing.assert_allclose(v.numpy(), ref[1], **APGD_TOL)
        assert float(np.abs(f.numpy()).max()) > 1e-2


@pytest.fixture(scope='module')
def jax_episodes():
    """Per (domain, task): JAX-drawn resets and one control step of numpy
    actions."""
    out = {}
    for domain, task, jenv in (
            ('ball_in_cup', 'catch', jenv_of('ball_in_cup', 'catch')),
            ('lqr', 'lqr_2_1', jlqr_env('lqr_2_1')),
            ('lqr', 'lqr_6_2', jlqr_env('lqr_6_2'))):
        nu = jenv.model.nu
        acts = np.random.RandomState(2).uniform(-1, 1, (B, nu)).astype(
            np.float32)

        def episode(k, a, jenv=jenv):
            s0, ts0 = jenv.reset(k)
            s1, ts1 = jenv.step(s0, a)
            return s0, ts0, s1, ts1

        keys = jax.random.split(jax.random.PRNGKey(5), B)
        out[domain, task] = acts, jax.jit(jax.vmap(episode))(keys, acts)
    return out


@pytest.mark.parametrize('domain,task', [('ball_in_cup', 'catch'),
                                         ('lqr', 'lqr_2_1'),
                                         ('lqr', 'lqr_6_2')])
def test_control_step_from_jax_reset_matches(domain, task, jax_episodes):
    acts, (j0, jts0, j1, jts1) = jax_episodes[domain, task]
    env = suite.load(domain, task, device='cpu',
                     task_kwargs={'seed': 0} if domain == 'lqr' else None)
    assert env._n_sub_steps == (10 if domain == 'ball_in_cup' else 1)
    s = _port_state(j0)
    s1, ts = env.step(s, torch.as_tensor(acts))
    for ours, ref, name in ((s1.physics.qpos, j1.physics.qpos, 'qpos'),
                            (s1.physics.qvel, j1.physics.qvel, 'qvel'),
                            (ts.reward, jts1.reward, 'reward'),
                            (ts.discount, jts1.discount, 'discount')):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   err_msg=name, **STEP_TOL)
    np.testing.assert_array_equal(ts.step_type.numpy(),
                                  np.asarray(jts1.step_type))
    assert list(ts.observation) == sorted(jts1.observation)
    for k, v in ts.observation.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jts1.observation[k]),
                                   err_msg=k, **STEP_TOL)


@pytest.mark.parametrize('domain,task', [('ball_in_cup', 'catch'),
                                         ('lqr', 'lqr_2_1'),
                                         ('lqr', 'lqr_6_2')])
def test_tracks_mujoco_fixture(domain, task):
    env = suite.load(domain, task, device='cpu', task_kwargs=(
        {'seed': SEED} if domain == 'lqr' else None))
    # lqr's bands sit in HEAVY_THRESHOLDS for the JAX compile they cost
    # there; the port's CPU run is cheap
    tracks_mujoco_fixture(domain, task, env.model, *{
        **THRESHOLDS, **HEAVY_THRESHOLDS}[(domain, task)])


def test_ball_in_cup_reset_is_collision_free():
    env = suite.load('ball_in_cup', 'catch', device='cpu')
    m = env.model
    state, _ = env.reset(64, torch.Generator().manual_seed(0))
    q = state.physics.qpos
    kin = smooth.kinematics(m, q, smooth.tree_meta(m))
    dist = collision.detect(m, kin[3], kin[4],
                            collision.candidate_pairs(m)).dist
    assert not bool((dist < 0).any())
    assert bool(((q[:, 2] >= -.2) & (q[:, 2] <= .2)).all())
    assert bool(((q[:, 3] >= .2) & (q[:, 3] <= .5)).all())
    assert bool((q[:, :2] == 0).all())


@pytest.mark.parametrize('task', LQR_TASKS)
def test_lqr_solver_matches_jax(task):
    env = suite.load('lqr', task, task_kwargs={'seed': 0}, device='cpu')
    p, k, beta = lqr_solver.solve(env)
    jp, jk, jbeta = jlqr_solver.solve(jlqr_env(task))
    np.testing.assert_allclose(p, jp, rtol=1e-4)
    np.testing.assert_allclose(k, jk, rtol=1e-4, atol=1e-6)
    assert beta == pytest.approx(jbeta, rel=1e-6) and beta < 1.0


def _drive(env, state, K, n_steps):
    """n_steps control steps under u = K x; the state norms before each."""
    norms = []
    for _ in range(n_steps):
        x = torch.cat([state.physics.qpos, state.physics.qvel], 1)
        norms.append(torch.linalg.vector_norm(x, dim=1))
        state, ts = env.step(state, x @ K.T)
    return state, ts, torch.stack(norms)


@pytest.mark.parametrize('task', LQR_TASKS)
def test_optimal_policy_stabilizes(task):
    """tests/test_lqr_oracle.py on the port, from its JAX-drawn reset:
    geometric decay at ~beta."""
    env = suite.load('lqr', task, task_kwargs={'seed': 0}, device='cpu')
    p, k, beta = lqr_solver.solve(env)
    jstate, _ = jax.jit(jlqr_env(task).reset)(jax.random.PRNGKey(0))
    state = _port_state(jax.tree_util.tree_map(lambda x: x[None], jstate))
    _, _, norms = _drive(env, state, torch.tensor(k, dtype=torch.float32),
                         300)
    norms = norms[:, 0].numpy()
    assert norms[-1] < norms[0] * max(beta ** 300 * 2.0, 2e-3), (
        norms[0], norms[-1], beta)
    assert norms[-1] < norms[0]


def test_termination_then_autoreset():
    """From states of norm sqrt(2) 1e-6 the optimal policy drives every
    env below 1e-6: LAST with discount 0, where it stays; autoreset_step
    then starts those envs afresh (FIRST, step_count 0, norm sqrt(2))
    and steps the rest."""
    env = suite.load('lqr', 'lqr_2_1', task_kwargs={'seed': 0}, device='cpu')
    _, k, _ = lqr_solver.solve(env)
    K = torch.tensor(k, dtype=torch.float32)
    state, _ = env.reset(B, torch.Generator().manual_seed(0))
    state, ts = env.start(state.physics.replace(
        qpos=state.physics.qpos * 1e-6))
    ended = torch.zeros(B, dtype=torch.bool)
    for _ in range(300):
        x = torch.cat([state.physics.qpos, state.physics.qvel], 1)
        state, ts = env.step(state, x @ K.T)
        last = ts.step_type == control.LAST
        assert bool((ts.discount[last] == 0).all())
        assert bool((ts.discount[~last] == 1).all())
        ended |= last
        if bool(ended.all()) and bool(last.all()):
            break
    assert bool(last.all()) and bool(state.last.all())
    new, ts = env.autoreset_step(state, torch.zeros(B, 1),
                                 torch.Generator().manual_seed(1))
    assert bool((ts.step_type == control.FIRST).all())
    assert bool((new.step_count == 0).all()) and not bool(new.last.any())
    np.testing.assert_allclose(
        torch.linalg.vector_norm(new.physics.qpos, dim=1).numpy(),
        np.sqrt(2), rtol=1e-6)
    # an env not at its end steps on
    mixed = state.__class__(physics=state.physics, params=state.params,
                            step_count=state.step_count,
                            last=torch.tensor([True, False, True, False]))
    new, ts = env.autoreset_step(mixed, torch.zeros(B, 1),
                                 torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(ts.step_type.numpy(), [0, 2, 0, 2])
    np.testing.assert_array_equal(new.step_count.numpy(),
                                  [0, int(state.step_count[1]) + 1, 0,
                                   int(state.step_count[3]) + 1])


def test_autoreset_after_time_limit_and_divergence():
    """A time limit given through task_kwargs (3 control steps) ends the
    episode with discount 1; the next autoreset_step restarts it. A
    diverged env restarts too."""
    env = suite.load('lqr', 'lqr_2_1', device='cpu',
                     task_kwargs={'seed': 0, 'time_limit': 0.09})
    assert env._max_steps == 3
    g = torch.Generator().manual_seed(0)
    state, ts = env.reset(B, g)
    for _ in range(3):
        state, ts = env.autoreset_step(state, torch.zeros(B, 1), g)
    assert bool((ts.step_type == control.LAST).all())
    assert bool((ts.discount == 1).all())
    state, ts = env.autoreset_step(state, torch.zeros(B, 1), g)
    assert bool((ts.step_type == control.FIRST).all())
    assert bool((state.step_count == 0).all())
    qpos = state.physics.qpos.clone()
    qpos[2, 0] = float('nan')
    bad = state.__class__(physics=state.physics.replace(qpos=qpos),
                          params=state.params, step_count=state.step_count,
                          last=state.last)
    new, ts = env.autoreset_step(bad, torch.zeros(B, 1), g)
    np.testing.assert_array_equal(ts.step_type.numpy(), [1, 1, 0, 1])
    assert bool(torch.isfinite(new.physics.qpos).all())


def test_task_lists_and_kwargs():
    ported = set(suite._DOMAINS)
    assert suite.all_tasks() == tuple(
        t for t in jsuite.all_tasks() if t[0] in ported)
    assert suite.benchmarking() == tuple(
        t for t in jsuite.benchmarking() if t[0] in ported)
    assert ('finger', 'turn_hard') in suite.benchmarking()
    assert ('lqr', 'lqr_6_2') in suite.all_tasks()
    # task kwargs reach the task through the wrapper, as in JAX
    w = envs.load('walker', 'walk', device='cpu', time_limit=2)
    assert w.env._max_steps == 80
    w = envs.load('walker', 'walk', device='cpu')
    assert w.env._max_steps == 1000


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device works')
    with pytest.raises(RuntimeError, match='CUDA'):
        suite.load('ball_in_cup', 'catch')
    for task in LQR_TASKS:
        with pytest.raises(RuntimeError, match='CUDA'):
            suite.load('lqr', task, task_kwargs={'seed': 0})
