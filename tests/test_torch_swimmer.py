"""The swimmer (box geoms, sites, the fluid force), port against the JAX
package.

Same inputs, drawn with numpy or by the JAX reset, go through both
packages (B = 4):

* ``_make_model_xml`` (3, 6 and 15 links) gives the JAX module's XML, and
  the compiled models of swimmer6, swimmer15 and ``swimmer(4)`` match
  field by field (rtol 1e-5): box inertia, the sites, the density and
  each body's equivalent inertia box and principal frame;
* ``fluid_force`` and ``qfrc_passive`` at random states (rtol 1e-4) on
  a swimmer6 variant whose medium has viscosity and wind beside the
  density (the control step below holds the density-only medium);
* the dense APGD plain twin on the 5 limit rows of a swimmer6 substep,
  cold and warm, against the XLA iterate (rtol = atol = 2e-4);
* one control step (15 substeps) from JAX-drawn resets and targets with
  numpy actions: qpos, qvel, observation, reward and the wrapper's
  featured state (atol = rtol = 1e-4);
* the MuJoCo parity fixtures within the CPU band that
  tests/test_parity_physics.py calibrates for the swimmer
  (HEAVY_THRESHOLDS; its TPU overrides do not apply);
* the Swimmer wrapper (dims, goal weights, goal, sample_state) and a
  tiny CLI run on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mbrl_tpu import envs as jenvs
from mujoco_mbrl_tpu.physics import engine as jengine
from mujoco_mbrl_tpu.physics import mjcf as jmjcf
from mujoco_mbrl_tpu.physics import model as JM
from mujoco_mbrl_tpu.physics import smooth as jsmooth
from mujoco_mbrl_tpu.suite import swimmer as jswimmer
from mujoco_mbrl_tpu_torch import envs, suite
from mujoco_mbrl_tpu_torch.ops import apgd_solve
from mujoco_mbrl_tpu_torch.physics import engine, mjcf, smooth
from mujoco_mbrl_tpu_torch.physics import model as M
from mujoco_mbrl_tpu_torch.physics.model import State
from mujoco_mbrl_tpu_torch.suite import swimmer
from test_parity_physics import HEAVY_THRESHOLDS
from test_torch_apgd import _jax_xla
from test_torch_cartpole import (APGD_TOL, B, STEP_TOL, assert_model_matches,
                                 jenv_of, tracks_mujoco_fixture)
from test_torch_contact_free import _port_state

FORCE_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize('n', [3, 6, 15])
def test_xml_is_a_copy(n):
    assert swimmer._make_model_xml(n) == jswimmer._make_model_xml(n)


INVWEIGHT = ('dof_invweight0', 'body_invweight0')


@pytest.mark.parametrize('task', ['swimmer6', 'swimmer15', 'n4'])
def test_model_matches_jax_field_by_field(task):
    if task == 'n4':
        jm = jswimmer.swimmer(4).model
        tm = swimmer.swimmer(4, device='cpu').model
    else:
        jm = jenv_of('swimmer', task).model
        tm = suite.load('swimmer', task, device='cpu').model
    if task != 'swimmer15':
        assert_model_matches(jm, tm)
    else:
        # mj_setConst's invweights invert the mass matrix at qpos0, which
        # both packages form in float32; swimmer15's has condition number
        # 1.8e5, so the float32 rounding of its entries, which differs
        # with the order of the operations, moves the inverse's diagonal
        # by up to 3e-4 relative. Both are held to the float64 compile's
        # (the port's own parse in float64) within 1e-3 relative; every
        # other field to JAX's at rtol 1e-5.
        assert_model_matches(jm, tm, held_apart=INVWEIGHT)
        m64 = mjcf.parse(swimmer._make_model_xml(15), dtype=torch.float64)
        for name in INVWEIGHT:
            ref = getattr(m64, name).numpy()
            for ours in (getattr(tm, name).numpy(),
                         np.asarray(getattr(jm, name))):
                np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=0,
                                           err_msg=name)
    n = tm.nbody - 1
    assert tm.nsite == n and tm.site_type == (M.SPHERE,) * n
    assert float(tm.opt.density) == 3000.0 and tm.opt.disableflags & 1
    # the inertial box .002 x .1 x .02 of mass .01 (the visual capsule is
    # massless): its equivalent box is itself, turned to the principal
    # axes, whose moments come in ascending order
    head = tm.name2id('body', 'head')
    np.testing.assert_allclose(np.sort(tm.body_fluid_box[head].numpy()),
                               [.001, .01, .05], rtol=1e-5)
    R = tm.body_principal_mat[head].numpy()
    np.testing.assert_allclose(R.T @ R, np.eye(3), atol=1e-6)


def _states(tm, n, seed):
    rng = np.random.RandomState(seed)
    qpos = rng.uniform(-1, 1, (n, tm.nq)).astype(np.float32)
    qvel = rng.normal(0, 2, (n, tm.nv)).astype(np.float32)
    ctrl = rng.uniform(-1, 1, (n, tm.nu)).astype(np.float32)
    return qpos, qvel, ctrl


def test_fluid_force_matches_jax():
    xml = swimmer._make_model_xml(6).replace(
        "density='3000'", "density='3000' viscosity='0.2' "
        "wind='0.3 -0.2 0.1'")
    jm, tm = jmjcf.parse(xml), mjcf.parse(xml)
    assert_model_matches(jm, tm)
    qpos, qvel, ctrl = _states(tm, B, 4)

    def jfwd(q, v, u):
        d = jengine.forward(jm, JM.make_state(jm, qpos=q, qvel=v), u,
                            acc_stage=False)
        return d, jsmooth.fluid_force(jm, d.xipos, d.xquat, d.cvel, d.cdof,
                                      jsmooth.tree_meta(jm))

    with jax.default_matmul_precision('highest'):
        jd, jf = jax.jit(jax.vmap(jfwd))(qpos, qvel, ctrl)
    s = State(qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
              time=torch.zeros(B))
    td = engine.forward(tm, s, torch.as_tensor(ctrl), acc_stage=False)
    f = smooth.fluid_force(tm, td.xipos, td.xquat, td.cvel, td.cdof,
                           smooth.tree_meta(tm))
    assert float(np.abs(np.asarray(jf)).max()) > 1e-4
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), **FORCE_TOL)
    np.testing.assert_allclose(td.qfrc_passive.numpy(),
                               np.asarray(jd.qfrc_passive), **FORCE_TOL)


def test_apgd_plain_at_five_limit_rows_matches_jax():
    """swimmer6's five joint-limit rows, joints pushed past +-60 degrees:
    the cold solve of a substep and the warm one after it."""
    tm = suite.load('swimmer', 'swimmer6', device='cpu').model
    rng = np.random.RandomState(6)
    sign = rng.choice([-1.0, 1.0], (8, 5))
    qpos = np.zeros((8, 8), np.float32)
    qpos[:, 3:] = sign * rng.uniform(1.03, 1.07, (8, 5))
    qvel = np.zeros((8, 8), np.float32)
    qvel[:, 3:] = sign * rng.uniform(0.5, 2.0, (8, 5))
    captured, real = [], apgd_solve.apgd_iterate_batched

    def capture(*args, **kw):
        captured.append((tuple(a.numpy().copy() for a in args), dict(kw)))
        return real(*args, **kw)

    s = State(qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
              time=torch.zeros(8))
    apgd_solve.apgd_iterate_batched = capture
    try:
        engine.substep(tm, s, torch.zeros((8, 5)), 2)
    finally:
        apgd_solve.apgd_iterate_batched = real
    assert [kw['cold'] for _, kw in captured] == [True, False]
    for args, kw in captured:
        assert args[0].shape == (8, 5, 5) and args[4].sum() >= 20
        ref = _jax_xla(args, nonneg=kw['nonneg'], box=kw['box_rows'],
                       con0=kw['con0'], iterations=kw['iterations'],
                       cold=kw['cold'], eq_rows=kw['eq_rows'])
        out = real(*[torch.as_tensor(a) for a in args], **kw)
        for o, r in zip(out, ref):
            np.testing.assert_allclose(o.numpy(), r, **APGD_TOL)
        assert float(np.abs(out[0].numpy()).max()) > 1e-4


def _jax_wrapper():
    """The JAX Swimmer wrapper of swimmer6, made without its eager
    observation-spec reset."""
    jenv = jenv_of('swimmer', 'swimmer6')
    cls = jenvs.wrappers.Swimmer
    w = cls.__new__(cls)
    w._env, w._state_penalty = jenv, 1.0
    w.action_dim, w.state_dim = jenv.model.nu, 8 + 8 + 2
    return w


def test_control_step_and_featured_state_match_jax():
    """One control step of 15 substeps from JAX-drawn resets and targets
    (the per-env target rides on ``geom_pos``): state, reward, observation
    and the wrapper's featured state with the head's orientation."""
    jenv, jw = jenv_of('swimmer', 'swimmer6'), _jax_wrapper()
    acts = np.random.RandomState(2).uniform(-1, 1, (B, 5)).astype(
        np.float32)

    def episode(k, a):
        s0, ts0 = jenv.reset(k)
        s1, ts1, d = jenv.step_with_data(s0, a)
        return s0, ts0, s1, ts1, jw.get_state(s1, d)

    s0, ts0, s1, ts1, feat = jax.jit(jax.vmap(episode))(
        jax.random.split(jax.random.PRNGKey(3), B), acts)
    w = envs.load('swimmer', 'swimmer6', device='cpu')
    state = _port_state(s0)
    assert state.params.shape == (B, 2)
    _, ts = w.env.start(state.physics, state.params)
    for k, v in ts.observation.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(ts0.observation[k]),
                                   err_msg=k, **STEP_TOL)
    state1, ts, data = w.env.step_with_data(state, torch.as_tensor(acts))
    for ours, ref, name in ((state1.physics.qpos, s1.physics.qpos, 'qpos'),
                            (state1.physics.qvel, s1.physics.qvel, 'qvel'),
                            (ts.reward, ts1.reward, 'reward')):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   err_msg=name, **STEP_TOL)
    for k, v in ts.observation.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(ts1.observation[k]),
                                   err_msg=k, **STEP_TOL)
    np.testing.assert_allclose(w.get_state(state1, data).numpy(),
                               np.asarray(feat), **STEP_TOL)


@pytest.mark.parametrize('task', ['swimmer6', 'swimmer15'])
def test_tracks_mujoco_fixture(task):
    tracks_mujoco_fixture('swimmer', task,
                          suite.load('swimmer', task, device='cpu').model,
                          *HEAVY_THRESHOLDS[('swimmer', task)])


def test_wrapper_matches_jax():
    jw = _jax_wrapper()
    w = envs.load('swimmer', 'swimmer6', device='cpu')
    assert (w.state_dim, w.observation_dim, w.action_dim) == (18, 25, 5)
    np.testing.assert_array_equal(w.get_goal_weights().numpy(),
                                  np.asarray(jw.get_goal_weights()))
    g = torch.Generator().manual_seed(0)
    goal = w.set_goal(g)
    assert goal.shape == (18,) and (goal[2:] == 0).all()
    assert bool((goal[:2].abs() <= .5).all())
    st = w.sample_state(g, (300,)).numpy()
    assert st.shape == (300, 16) and (np.delete(st, 2, 1) == 0).all()
    assert np.abs(st[:, 2]).max() <= 3 and np.abs(st[:, 2]).max() > 2.5


def test_cli_runs_on_cpu(tmp_path):
    from mujoco_mbrl_tpu_torch import experiment
    agent = experiment.main(experiment.parse_args([
        '--exp_dir', str(tmp_path), '--environment', 'swimmer_swimmer6',
        '--planner', 'cem', '--model', 'nn', '--rollout_length', '2',
        '--num_rollouts_per_iteration', '2', '--num_train_iterations', '1',
        '--train_epochs', '1', '--device', 'cpu', '--planner_kwargs',
        '{"num_candidates": 16, "num_elites": 4}']))
    assert agent.plan_dim == 18 and not agent.obs_only
    buf = agent.dataset
    assert bool(torch.isfinite(buf.states[:buf.filled]).all())


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device works')
    from mujoco_mbrl_tpu_torch import experiment
    with pytest.raises(RuntimeError, match='CUDA'):
        suite.load('swimmer', 'swimmer6')
    with pytest.raises(RuntimeError, match='CUDA'):
        swimmer.swimmer(4)
    with pytest.raises(RuntimeError, match='CUDA'):
        envs.load('swimmer', 'swimmer15')
    with pytest.raises(RuntimeError, match='CUDA'):
        experiment.main(experiment.parse_args(
            ['--exp_dir', '', '--environment', 'swimmer_swimmer6']))
