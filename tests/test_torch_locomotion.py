"""Locomotion (arenas, walkers, corridor and go-to-target tasks), port
against the JAX package.

Inputs are drawn with numpy or by JAX's vmapped reset (B = 4) and carried
across with ``convert``:

* the composed Models field by field (rtol 1e-5): the corridor walker
  (three planes, two of them ``zaxis`` walls) and go-to-target's floor,
  walker and target site;
* the corridor's reset observation on JAX-drawn resets, then three
  control steps with numpy actions: qpos, qvel, every observable, reward,
  discount and step type within 1e-4 (the walker's 234 rows take #7's
  block path, solved to the same cap); the accelerometer (off by
  default; on in a second port env) against JAX's on JAX's step Data,
  and the termination against JAX's;
* the walker's egocentric observables and helpers on numpy poses, JAX's
  functions reading the port's kinematics (held to JAX's by the model
  and step checks), within 1e-5;
* go-to-target's per-env targets: ``apply_params``' ``site_pos`` and the
  sparse reward near and far, against JAX's;
* the CMU walker: its Model against the port's own humanoid_cmu Model
  less its floor, and a control step on the floor (4,352 rows on #1's
  dense iterate on factors). JAX's CMU Model build (its mj_setConst probe
  jit-compiles for many minutes on XLA:CPU) runs under ``RUN_HEAVY=1``
  only, as JAX's own tests/test_locomotion.py gates it.

One JAX step is jitted (the corridor's ``step_with_data``), once a module.
"""

import collections
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mbrl_tpu import composer as jcomposer
from mujoco_mbrl_tpu import locomotion as jlocomotion
from mujoco_mbrl_tpu.locomotion import walkers as jwalkers
from mujoco_mbrl_tpu_torch import composer, convert, locomotion
from mujoco_mbrl_tpu_torch.locomotion import walkers
from mujoco_mbrl_tpu_torch.ops import apgd_solve
from mujoco_mbrl_tpu_torch.physics import engine, mjcf
from mujoco_mbrl_tpu_torch.physics import model as M
from mujoco_mbrl_tpu_torch.suite import humanoid_cmu
from mujoco_mbrl_tpu_torch.utils.raycast import Camera
from test_torch_cartpole import assert_model_matches
from test_torch_composer import as_np, assert_obs_close, jax_reset

B = 4
TOL = dict(rtol=1e-4, atol=1e-4)
OBS_TOL = dict(rtol=1e-5, atol=1e-5)

_ENVS = {}


def envs(name):
    """(port env on the CPU, JAX env, port task, JAX task), built once."""
    if name not in _ENVS:
        if name == 'corridor':
            pt = locomotion.RunThroughCorridor(target_velocity=2.0)
            jt = jlocomotion.RunThroughCorridor(target_velocity=2.0)
        else:
            pt, jt = locomotion.GoToTarget(), jlocomotion.GoToTarget()
        _ENVS[name] = (composer.make_env(pt, time_limit=5.0, device='cpu'),
                       jcomposer.make_env(jt, time_limit=5.0), pt, jt)
    return _ENVS[name]


_JSTEP = []


def jax_step_with_data():
    if not _JSTEP:
        _JSTEP.append(jax.jit(jax.vmap(envs('corridor')[1].step_with_data)))
    return _JSTEP[0]


_Data = collections.namedtuple('_Data', ('xpos', 'ximat', 'cvel',
                                         'site_xpos'))
_Phys = collections.namedtuple('_Phys', ('qpos', 'qvel'))


def jax_view(state, data):
    """The port's batched state and kinematics as JAX arrays, for JAX's
    walker and task functions under vmap."""
    return (_Phys(*(jnp.asarray(getattr(state, f).numpy())
                    for f in _Phys._fields)),
            _Data(*(jnp.asarray(getattr(data, f).numpy())
                    for f in _Data._fields)))


def random_state(m, n, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    qpos = np.asarray(m.qpos0) + rng.normal(0, scale, (n, m.nq))
    qvel = rng.normal(0, 1.0, (n, m.nv))
    return M.make_state(m, qpos=torch.tensor(qpos, dtype=torch.float32),
                        qvel=torch.tensor(qvel, dtype=torch.float32))


# ---- models -------------------------------------------------------------------

@pytest.mark.parametrize('name', ['corridor', 'go_to_target'])
def test_locomotion_model_matches_jax(name):
    env, jenv, _, _ = envs(name)
    assert_model_matches(jenv.model, env.model)
    # the corridor's walls are planes turned by zaxis
    if name == 'corridor':
        g = env.model.names['geom']['wall_left']
        assert env.model.geom_type[g] == M.PLANE


# ---- the corridor: resets and control steps from JAX draws --------------------

def test_corridor_steps_like_jax_from_jax_resets():
    env, jenv, pt, jt = envs('corridor')
    jstate, jts = jax_reset(jenv, 11)
    state = convert.composed_env_state(jstate)
    _, ts0 = env.start(state.physics, state.params)
    assert_obs_close(ts0.observation, jts.observation, OBS_TOL)
    # the accelerometer, off by default, on in a second port env
    pa = locomotion.RunThroughCorridor(target_velocity=2.0)
    pa.walker.enable_observable('sensors_accelerometer')
    env_acc = composer.make_env(pa, time_limit=5.0, device='cpu')
    assert env_acc.task.OBSERVES_ACC and not env.task.OBSERVES_ACC
    acts = np.random.default_rng(4).uniform(-1, 1, (3, B, 6)).astype(
        np.float32)
    step = jax_step_with_data()
    state_acc = state
    for k in range(3):
        jstate, jts, jdata = step(jstate, jnp.asarray(acts[k]))
        state, ts = env.step(state, torch.tensor(acts[k]))
        state_acc, ts_acc, _ = env_acc.step_with_data(
            state_acc, torch.tensor(acts[k]))
        for f in ('qpos', 'qvel'):
            np.testing.assert_allclose(as_np(getattr(state.physics, f)),
                                       as_np(getattr(jstate.physics, f)),
                                       **TOL)
        assert_obs_close(ts.observation, jts.observation, TOL)
        for f in ('reward', 'discount', 'step_type'):
            np.testing.assert_allclose(as_np(getattr(ts, f)),
                                       as_np(getattr(jts, f)), **TOL)
        jm = jenv.model
        acc = jax.jit(jax.vmap(lambda p, d: jt.walker.sensors_accelerometer(
            jm, p, d)))(jstate.physics, jdata)
        np.testing.assert_allclose(
            as_np(ts_acc.observation['walker/sensors_accelerometer']),
            as_np(acc), rtol=1e-3, atol=1e-3)
        term, disc = jax.jit(jax.vmap(lambda p, d: jt.get_termination(
            jm, p, d)))(jstate.physics, jdata)
        data = engine.forward(env.model, state.physics, torch.zeros(B, 6),
                              acc_stage=False)
        pterm, pdisc = pt.get_termination(env.model, state.physics, data)
        np.testing.assert_array_equal(pterm.numpy(), np.asarray(term))
        np.testing.assert_array_equal(pdisc.numpy(), np.asarray(disc))
    assert float(np.abs(as_np(state.physics.qvel)).max()) > 1e-2


def test_corridor_rows_take_the_factored_block_path():
    """The walker in the corridor (capsules against three planes) solves
    234 rows over nv 9 each substep: the factored regime, #7's block path
    on the card; 5 solves a control step."""
    env = envs('corridor')[0]
    seen = []
    real = apgd_solve.apgd_iterate_factored
    try:
        apgd_solve.apgd_iterate_factored = lambda *a, **k: (
            seen.append(tuple(a[0].shape)) or real(*a, **k))
        s, _ = env.reset(2, torch.Generator().manual_seed(0))
        env.step(s, torch.zeros(2, 6))
    finally:
        apgd_solve.apgd_iterate_factored = real
    assert seen == [(2, 234, 9)] * 5
    assert apgd_solve.factored_route(234, 9) == 'block'


def test_corridor_reward_tracks_velocity():
    """tolerance(xvel, (v, v), margin=v, linear) at v = 2 (JAX's test)."""
    env, _, pt, _ = envs('corridor')
    m = env.model
    d = m.jnt_dofadr[m.names['joint']['walker/rootx']]
    st = M.make_state(m, batch=4)
    qvel = st.qvel.clone()
    qvel[:, d] = torch.tensor([0.0, 1.0, 2.0, 3.0])
    st = st.replace(qvel=qvel)
    data = engine.forward(m, st, torch.zeros(4, m.nu), acc_stage=False)
    r = pt.get_reward(m, st, data, None)
    np.testing.assert_allclose(r.numpy(), [0.0, 0.5, 1.0, 0.5], atol=1e-6)


def test_corridor_terminates_on_fall():
    task = locomotion.RunThroughCorridor(terminate_at_height=2.0)
    env = composer.make_env(task, time_limit=100.0, device='cpu')
    state, _ = env.reset(2, torch.Generator().manual_seed(0))
    _, ts = env.step(state, torch.zeros(2, 6))
    assert bool(ts.last().all()) and float(ts.discount.abs().max()) == 0.0
    env2 = envs('corridor')[0]
    state2, _ = env2.reset(2, torch.Generator().manual_seed(0))
    _, ts2 = env2.step(state2, torch.zeros(2, 6))
    assert not bool(ts2.last().any())


# ---- walker observables on numpy poses ------------------------------------------

def test_walker_observables_match_jax():
    env, jenv, pt, jt = envs('corridor')
    m, jm = env.model, jenv.model
    state = random_state(m, 8, seed=5)
    data = engine.forward(m, state, torch.zeros(8, 6), acc_stage=False)
    jphys, jdata = jax_view(state, data)
    w, jw = pt.walker, jt.walker
    names = sorted(n for n in w.observables()
                   if n not in ('sensors_accelerometer', 'egocentric_camera'))
    assert names == sorted(n for n in jw.observables()
                           if n not in ('sensors_accelerometer',
                                        'egocentric_camera'))
    fns = {n: (getattr(w, n), getattr(jw, n)) for n in names}
    fns.update(aliveness=(w.aliveness, jw.aliveness),
               forward_velocity=(w.forward_velocity, jw.forward_velocity),
               root_xy=(w.root_xy, jw.root_xy))
    for n, (ours, ref) in fns.items():
        got = ours(m, state, data)
        want = jax.vmap(lambda p, d: ref(jm, p, d))(jphys, jdata)
        np.testing.assert_allclose(as_np(got), as_np(want), err_msg=n,
                                   **OBS_TOL)
    vec = np.random.default_rng(6).normal(size=(8, 3)).astype(np.float32)
    mats = np.random.default_rng(7).normal(size=(8, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(
        w.transform_vec_to_egocentric_frame(m, data, torch.tensor(vec))
        .numpy(), np.asarray(jax.vmap(
            lambda d, v: jw.transform_vec_to_egocentric_frame(jm, d, v))(
                jdata, jnp.asarray(vec))), **OBS_TOL)
    np.testing.assert_allclose(
        w.transform_xmat_to_egocentric_frame(m, data, torch.tensor(mats))
        .numpy(), np.asarray(jax.vmap(
            lambda d, x: jw.transform_xmat_to_egocentric_frame(jm, d, x))(
                jdata, jnp.asarray(mats))), **OBS_TOL)
    assert w.proprioception == jw.proprioception
    assert w.kinematic_sensors == jw.kinematic_sensors


def test_egocentric_camera_observable():
    """Enabled per instance, the camera renders each env's view from the
    walker's `egocentric` camera (whose pose fields the model check holds
    to JAX's), 64 x 64 RGB."""
    task = locomotion.RunThroughCorridor()
    task.walker.enable_observable('egocentric_camera')
    env = composer.make_env(task, device='cpu')
    assert not env.task.OBSERVES_ACC
    state, ts = env.reset(2, torch.Generator().manual_seed(1))
    px = ts.observation['walker/egocentric_camera']
    assert px.shape == (2, 64, 64, 3)
    data = engine.forward(env.model, state.physics, torch.zeros(2, 6),
                          acc_stage=False)
    ref = Camera(env.model, 64, 64, 'walker/egocentric').render(data)
    assert torch.equal(px, ref)
    assert 'walker/egocentric_camera' not in envs('corridor')[0].reset(
        1, torch.Generator().manual_seed(0))[1].observation


# ---- go-to-target -----------------------------------------------------------------

def test_go_to_target_targets_and_reward_match_jax():
    env, jenv, pt, jt = envs('go_to_target')
    m, jm = env.model, jenv.model
    jstate, jts = jax_reset(jenv, 2)
    state = convert.composed_env_state(jstate)
    assert state.params.shape == (B, 2)
    m_ep = env._model_with(state.params)
    jsite = jax.vmap(lambda p: jt.apply_params(jm, p).site_pos)(
        jstate.params)
    np.testing.assert_array_equal(m_ep.site_pos.numpy(), np.asarray(jsite))
    _, ts0 = env.start(state.physics, state.params)
    assert_obs_close(ts0.observation, jts.observation, OBS_TOL)
    # the walker moved onto its target (reward 1) and 3 m past it (0)
    jx = m.jnt_qposadr[m.names['joint']['walker/rootx']]
    target = state.params.numpy()
    for dx in (0.0, 3.0):
        qpos = state.physics.qpos.clone()
        qpos[:, jx] = torch.tensor(target[:, 0] + dx)
        st = state.physics.replace(qpos=qpos)
        data = engine.forward(m_ep, st, torch.zeros(B, 6), acc_stage=False)
        ours = pt.get_reward(m_ep, st, data, None)
        jphys, jdata = jax_view(st, data)
        ref = jax.vmap(lambda p, d: jt.get_reward(jm, p, d, None))(
            jphys, jdata)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
        want = (np.abs(target[:, 1]) < 0.5) & (dx == 0.0)
        np.testing.assert_array_equal(ours.numpy(), want.astype(np.float32))
    # the port's own draws: per env, inside the spawn range
    s, _ = env.reset(64, torch.Generator().manual_seed(3))
    assert float(s.params.abs().max()) <= 5.0
    assert len(set(s.params[:, 0].tolist())) == 64


# ---- the CMU walker ----------------------------------------------------------------

def _cmu_suite_model():
    return mjcf.parse(humanoid_cmu._make_xml())


def test_cmu_walker_model_is_humanoid_cmu_less_its_floor():
    """The CMUHumanoid entity's Model is humanoid_cmu's with the floor
    geom removed and an `egocentric` camera on the root body: every body,
    joint, dof, actuator and contact field equal, the geom fields equal
    less the floor's row."""
    m = walkers.CMUHumanoid().mjcf_model.compile(device='cpu')
    ref = _cmu_suite_model()
    floor = ref.names['geom']['floor']
    keep = [g for g in range(ref.ngeom) if g != floor]
    assert m.ngeom == ref.ngeom - 1
    assert m.names['geom'] == {k: v - (v > floor) for k, v in
                               ref.names['geom'].items() if k != 'floor'}
    assert m.names['camera']['egocentric'] == m.ncam - 1
    for f in dataclasses.fields(m):
        ours, theirs = getattr(m, f.name), getattr(ref, f.name)
        if f.name in ('names', 'opt') or f.name.startswith('cam') or \
                f.name == 'ncam':
            continue
        if f.name.startswith('geom_') and f.name != 'geom_xpos':
            theirs = (theirs[keep] if isinstance(theirs, torch.Tensor)
                      else tuple(theirs[g] for g in keep))
        if f.name == 'ngeom':
            continue
        if isinstance(ours, torch.Tensor):
            np.testing.assert_allclose(ours.numpy(), theirs.numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=f.name)
        else:
            assert ours == theirs, f.name
    for kind in ('body', 'joint', 'actuator'):
        assert m.names[kind] == ref.names[kind], kind


def test_cmu_walker_go_to_target_steps():
    """GoToTarget with the CMU walker on the floor: reset and one control
    step of 2 envs, 5 substeps each solving 4,352 rows over 62 dofs on
    #1's dense iterate on factors; finite, the walker's observables."""
    env = composer.make_env(locomotion.GoToTarget(
        walker=walkers.CMUHumanoid()), time_limit=5.0, device='cpu')
    assert env.model.nu == 56
    seen = []
    real = apgd_solve.apgd_iterate_dense_factors
    try:
        apgd_solve.apgd_iterate_dense_factors = lambda *a, **k: (
            seen.append(tuple(a[0].shape)) or real(*a, **k))
        state, ts = env.reset(2, torch.Generator().manual_seed(0))
        state, ts = env.step(state, torch.zeros(2, 56))
    finally:
        apgd_solve.apgd_iterate_dense_factors = real
    assert seen == [(2, 4352, 62)] * 5
    assert torch.isfinite(ts.reward).all()
    assert torch.isfinite(state.physics.qpos).all()
    obs = ts.observation
    assert obs['walker/joints_pos'].shape == (2, 56)
    assert obs['walker/appendages_pos'].shape == (2, 15)
    assert obs['walker/head_height'].shape == (2,)
    assert walkers.CMUHumanoid().proprioception[-1] == 'appendages_pos'


@pytest.mark.skipif(os.environ.get('RUN_HEAVY', '') != '1',
                    reason="JAX's CMU Model build jit-compiles its invweight "
                           'probe for many minutes on XLA:CPU; RUN_HEAVY=1')
def test_cmu_walker_model_matches_jax():
    env = composer.make_env(locomotion.GoToTarget(
        walker=walkers.CMUHumanoid()), device='cpu')
    jenv = jcomposer.make_env(jlocomotion.GoToTarget(
        walker=jwalkers.CMUHumanoid()))
    assert_model_matches(jenv.model, env.model)
