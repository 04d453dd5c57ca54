"""Soccer, port against the JAX package: the pitch (fixed and randomized),
ball, boxhead players, goal sensing, per-player rewards, termination,
the egocentric observables and ``load``.

Inputs are drawn with numpy or by JAX's vmapped reset (B = 4, 1v1 on a
``RandomizedPitch``) and carried across with ``convert`` (the pitch's
per-env size ratios included):

* the Models field by field (rtol 1e-5), fixed and randomized pitch, and
  the candidate contact pairs: the posts are cylinders, for which neither
  package has a pair kernel, so no pair holds a post;
* ``apply_params``' per-env wall and post positions against JAX's, and
  every observable of the reset;
* two control steps from JAX-drawn resets with numpy actions: qpos,
  qvel, every observable, the (B, 2) reward and the step type within
  1e-4;
* goal sensing on each env's sampled pitch: a ball past the sampled goal
  line scores [+1, -1], wide of the posts nothing, as JAX's rewards and
  terminations on the same positions;
* after a goal: LAST with discount 0, then ``autoreset_step`` returns
  FIRST with (B, 2n) zero rewards for the envs that reset, JAX's per-env
  ``where`` of a reset's scalar reward against a stepped vector (held to
  ``jnp.where`` under ``vmap`` on the same leaves).

One JAX step is jitted, once a module.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mbrl_tpu import composer as jcomposer
from mujoco_mbrl_tpu.locomotion import soccer as jsoccer
from mujoco_mbrl_tpu.physics import collision as jcollision
from mujoco_mbrl_tpu_torch import composer, convert
from mujoco_mbrl_tpu_torch.locomotion import soccer
from mujoco_mbrl_tpu_torch.physics import collision, engine
from mujoco_mbrl_tpu_torch.physics import model as M
from mujoco_mbrl_tpu_torch.suite import control
from test_torch_cartpole import assert_model_matches
from test_torch_composer import as_np, assert_obs_close, jax_reset

B = 4
TOL = dict(rtol=1e-4, atol=1e-4)
OBS_TOL = dict(rtol=1e-5, atol=1e-5)

_ENVS = {}


def envs(name):
    """(port env on the CPU, JAX env, port task, JAX task), built once:
    'randomized' is 1v1 on a RandomizedPitch, 'fixed' 1v1 on the Pitch."""
    if name not in _ENVS:
        kw = lambda mod: (dict(pitch=mod.RandomizedPitch(
            min_size=(6.0, 4.0), max_size=(12.0, 9.0)))
            if name == 'randomized' else {})
        pt = soccer.Soccer(team_size=1, **kw(soccer))
        jt = jsoccer.Soccer(team_size=1, **kw(jsoccer))
        _ENVS[name] = (composer.make_env(pt, time_limit=5.0, device='cpu'),
                       jcomposer.make_env(jt, time_limit=5.0), pt, jt)
    return _ENVS[name]


_JSTEP = []


def jax_step():
    if not _JSTEP:
        _JSTEP.append(jax.jit(jax.vmap(envs('randomized')[1].step)))
    return _JSTEP[0]


_Data = collections.namedtuple('_Data', ('xpos',))
_Phys = collections.namedtuple('_Phys', ('qpos', 'qvel'))


def jax_view(state, data):
    return (_Phys(jnp.asarray(state.qpos.numpy()),
                  jnp.asarray(state.qvel.numpy())),
            _Data(jnp.asarray(data.xpos.numpy())))


# ---- models ------------------------------------------------------------------

@pytest.mark.parametrize('name', ['fixed', 'randomized'])
def test_soccer_model_matches_jax(name):
    env, jenv, _, _ = envs(name)
    m, jm = env.model, jenv.model
    assert_model_matches(jm, m)
    assert m.nu == 6
    pairs = collision.candidate_pairs(m)
    assert pairs == [tuple(p) for p in jcollision.candidate_pairs(jm)]
    posts = {m.names['geom'][f'{s}_post_{e}'] for s in ('home', 'away')
             for e in ('n', 'p')}
    assert all(m.geom_type[g] == M.CYLINDER for g in posts)
    assert not posts & {g for p in pairs for g in p}


def test_bad_team_size_raises():
    for n in (0, 12):
        with pytest.raises(ValueError):
            soccer.Soccer(team_size=n)


# ---- resets and control steps from JAX draws ------------------------------------

def test_reset_params_and_observables_match_jax():
    env, jenv, pt, jt = envs('randomized')
    jstate, jts = jax_reset(jenv, 5)
    state = convert.composed_env_state(jstate)
    ratios = state.params[0]
    assert ratios.shape == (B, 2)
    assert all(p == () for p in state.params[1:])
    m_ep = env._model_with(state.params)
    jgp = jax.jit(jax.vmap(lambda p: jt.apply_params(jenv.model,
                                                     p).geom_pos))(
        jstate.params)
    np.testing.assert_allclose(m_ep.geom_pos.numpy(), np.asarray(jgp),
                               rtol=0, atol=1e-6)
    _, ts0 = env.start(state.physics, state.params)
    assert_obs_close(ts0.observation, jts.observation, OBS_TOL)
    # the port's own draws: each player in its own half of its env's pitch
    s, ts = env.reset(64, torch.Generator().manual_seed(1))
    m1 = env._model_with(s.params)
    data = engine.forward(m1, s.physics, torch.zeros(64, 6), acc_stage=False)
    length, _ = pt.pitch.episode_size(s.params[0])
    hx = data.xpos[:, m1.names['body']['home0/root'], 0]
    ax = data.xpos[:, m1.names['body']['away0/root'], 0]
    assert (hx <= 0).all() and (ax >= 0).all()
    assert (hx.abs() <= length / 2).all() and (ax.abs() <= length / 2).all()


def test_control_steps_like_jax_from_jax_resets():
    env, jenv, _, _ = envs('randomized')
    jstate, _ = jax_reset(jenv, 7)
    state = convert.composed_env_state(jstate)
    acts = np.random.default_rng(8).uniform(-1, 1, (2, B, 6)).astype(
        np.float32)
    step = jax_step()
    for k in range(2):
        jstate, jts = step(jstate, jnp.asarray(acts[k]))
        state, ts = env.step(state, torch.tensor(acts[k]))
        for f in ('qpos', 'qvel'):
            np.testing.assert_allclose(as_np(getattr(state.physics, f)),
                                       as_np(getattr(jstate.physics, f)),
                                       **TOL)
        assert_obs_close(ts.observation, jts.observation, TOL)
        assert ts.reward.shape == (B, 2)
        np.testing.assert_allclose(as_np(ts.reward), as_np(jts.reward),
                                   **TOL)
        np.testing.assert_array_equal(as_np(ts.step_type),
                                      as_np(jts.step_type))
    assert float(state.physics.qvel.abs().max()) > 1e-2


# ---- goals ------------------------------------------------------------------------

def _ball_at(m, phys, x, y):
    a = m.jnt_qposadr[m.names['joint']['ball/root']]
    qpos = phys.qpos.clone()
    qpos[:, a] = torch.as_tensor(x, dtype=qpos.dtype)
    qpos[:, a + 1] = torch.as_tensor(y, dtype=qpos.dtype)
    return phys.replace(qpos=qpos)


def test_goal_sensing_on_a_randomized_pitch_matches_jax():
    """Each env's ball placed 0.25 past its sampled goal lines, inside and
    wide of its sampled mouth: rewards and terminations against JAX's on
    each env's overridden model."""
    env, jenv, pt, jt = envs('randomized')
    jstate, _ = jax_reset(jenv, 9)
    state = convert.composed_env_state(jstate)
    m = env._model_with(state.params)
    length, width = pt.pitch.episode_size(state.params[0])
    half, gw = length / 2, width * soccer._GOAL_LENGTH_RATIO / 2
    cases = {'away goal': (half + 0.25, 0 * half, [1.0, -1.0]),
             'home goal': (-half - 0.25, 0 * half, [-1.0, 1.0]),
             'wide': (half + 0.25, gw + 0.5, [0.0, 0.0]),
             'midfield': (0 * half, 0 * half, [0.0, 0.0])}
    jm_of = jax.vmap(lambda p: jt.apply_params(jenv.model, p))
    jms = jm_of(jstate.params)
    for label, (x, y, want) in cases.items():
        phys = _ball_at(m, state.physics, x, y)
        data = engine.forward(m, phys, torch.zeros(B, 6), acc_stage=False)
        r = pt.get_reward(m, phys, data, None)
        done, disc = pt.get_termination(m, phys, data)
        np.testing.assert_array_equal(r.numpy(), np.tile(want, (B, 1)),
                                      err_msg=label)
        assert bool((done == (want[0] != 0)).all()), label
        assert float(disc.abs().max()) == 0.0
        jphys, jdata = jax_view(phys, data)
        jr = jax.vmap(lambda mm, p, d: jt.get_reward(mm, p, d, None),
                      in_axes=(jax.tree_util.tree_map(
                          lambda x: 0 if getattr(x, 'ndim', 0) else None,
                          jms), 0, 0))(jms, jphys, jdata)
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr),
                                      err_msg=label)


def test_goal_ends_the_episode_and_autoreset_restarts_it():
    """A ball in the away goal: the step is LAST with discount 0 and
    rewards [+1, -1]; the next ``autoreset_step`` returns FIRST with
    (B, 2) zero rewards, the reset's reward broadcast per env as JAX's
    per-env ``where`` does."""
    env = soccer.load(team_size=2, time_limit=5.0, device='cpu',
                      pitch=soccer.RandomizedPitch())
    g = torch.Generator().manual_seed(2)
    state, ts = env.reset(B, g)
    m = env._model_with(state.params)
    length, _ = env.task._task.pitch.episode_size(state.params[0])
    phys = _ball_at(m, state.physics, length / 2 + 0.25, 0 * length)
    state = control.EnvState(physics=phys, params=state.params,
                             step_count=state.step_count, last=state.last)
    state, ts = env.step(state, torch.zeros(B, 12))
    assert bool(ts.last().all()) and float(ts.discount.abs().max()) == 0.0
    np.testing.assert_array_equal(ts.reward.numpy(),
                                  np.tile([1.0, 1.0, -1.0, -1.0], (B, 1)))
    state2, ts2 = env.autoreset_step(state, torch.zeros(B, 12), g)
    assert bool(ts2.first().all())
    assert ts2.reward.shape == (B, 4) and float(ts2.reward.abs().max()) == 0
    assert bool((state2.step_count == 0).all())


def test_select_broadcasts_like_jax_per_env_where():
    """``_select`` of a (B,) leaf against a (B, k) leaf equals JAX's
    ``where`` under vmap on the same leaves."""
    rng = np.random.default_rng(0)
    mask = rng.random(6) < 0.5
    a, b = rng.normal(size=6).astype(np.float32), rng.normal(
        size=(6, 4)).astype(np.float32)
    ours = control._select(torch.tensor(mask), torch.tensor(a),
                           torch.tensor(b))
    ref = jax.vmap(jnp.where)(mask, a, b)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


# ---- egocentric observables and the 2v2 surface -----------------------------------

def test_egocentric_frame_and_possession():
    """Yaw 0: ego == the world offset; yaw pi/2: axes rotate (JAX's
    test_egocentric_frame); pushing the ball beside a player gives it
    possession."""
    env, _, pt, _ = envs('fixed')
    m = env.model
    st = M.make_state(m, batch=2)
    qpos = st.qpos.clone()
    adr = lambda j: m.jnt_qposadr[m.names['joint'][j]]
    qpos[:, adr('home0/root_x')] = 1.0
    qpos[:, adr('home0/root_y')] = -2.0
    qpos[:, adr('ball/root')] = 3.0
    qpos[:, adr('ball/root') + 1] = 1.0
    qpos[1, adr('home0/steer')] = np.pi / 2
    st = st.replace(qpos=qpos)
    data = engine.forward(m, st, torch.zeros(2, 6), acc_stage=False)
    ego = pt.observables()['home0/ball_ego'](m, st, data)
    np.testing.assert_allclose(ego.numpy(), [[2.0, 3.0], [3.0, -2.0]],
                               atol=1e-5)
    qpos = M.make_state(m, batch=1).qpos.clone()
    qpos[:, adr('home0/root_x')] = -1.0
    qpos[:, adr('ball/root')] = -1.2
    st = M.make_state(m, qpos=qpos)
    data = engine.forward(m, st, torch.zeros(1, 6), acc_stage=False)
    np.testing.assert_array_equal(
        pt.stats_possession(m, st, data).numpy(), [[1.0, 0.0]])


def test_2v2_surface():
    env = soccer.load(team_size=2, device='cpu')
    assert env.model.nu == 12
    _, ts = env.reset(3, torch.Generator().manual_seed(3))
    obs = ts.observation
    assert obs['home1/teammates_ego'].shape == (3, 2)
    assert obs['home0/opponents_ego'].shape == (3, 4)
    assert obs['stats_possession'].shape == (3, 4)
    assert torch.equal(obs['stats_possession'].sum(-1), torch.ones(3))


def test_load_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        soccer.load(team_size=1)
