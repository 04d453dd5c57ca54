"""humanoid_cmu (contact excludes, 4,352 dense rows over 62 dofs, #1's
dense iterate on factors, the last-attempt reset, parse_amc), port
against the JAX package and the MuJoCo fixtures.

JAX's ``mjcf.parse`` of this model jit-compiles its invweight probe for
minutes on the CPU, so no default test builds JAX's humanoid_cmu Model:
the port is held to the MuJoCo fixtures
(``tests/fixtures/parity/humanoid_cmu_{stand,run}.npz``: the compiled
``m_*`` fields, the contact pairs, 50 actions and the states and
observations they lead to), to JAX's XML string, to JAX's
``parse_amc.convert`` and to JAX's XLA iterate on inputs the port builds:

* ``_make_xml`` is the JAX module's, and the compiled model matches the
  fixture's ``m_*`` fields (``parity_utils.compare_models``, entities
  aligned by the names of ``m_names_json``), the five excluded body pairs
  among them;
* ``<contact><exclude>`` parses as JAX parses it, and ``<pair>`` and
  ``<sensor>`` raise; no excluded body pair reaches ``candidate_pairs``
  and every pair of ``contact_pairs_json`` is a candidate but the
  hand-ellipsoid against finger-capsule pair, for which JAX has no pair
  kernel either; the 4,352 rows split into 56 joint-limit rows and
  1,074 pyramids of 4 facets, all non-negative, and take the dense
  iterate on factors (JAX's dense regime past 1024 rows);
* that iterate's plain version against JAX's XLA iterate
  ``_apgd_dispatch(...).impl_fn`` on Ad formed in float32, on solves the
  port assembles at fixture poses in contact (B 2): cold, warm, and warm
  from a start the Rayleigh guard finds stale (the row-sum bound); every
  env by its dual objective (rtol 1e-5) and its joint-space force J~' f
  (2e-4 of its largest entry), and by f (rtol = atol = 2e-4) unless the
  two differ along a flat facet direction (energy under 2e-4 in Ad's
  norm);
* the observation and the reward against the fixture's at its states;
* 3 control steps (30 physics steps) of each fixture within the
  ``HEAVY_THRESHOLDS`` band of 1e-3 (tests/test_parity_physics.py);
* the reset's last-attempt rule on attempts drawn with numpy;
* ``parse_amc.convert`` against JAX's on a synthesised .amc file;
* registration equal to JAX's for all 18 domains, and the card as the
  default device.

``RUN_HEAVY=1`` adds what needs JAX's Model (built with the port's
invweights, as tests/test_torch_quadruped.py builds its own, and run
with jit disabled): the rows in JAX's ``assemble`` order and values, the
observation and the reward of JAX's task on the port's Data, and the 50
fixture steps (~2.5 min on one core).
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mujoco_mbrl_tpu.physics import collision as jcollision
from mujoco_mbrl_tpu.physics import solver as jsolver
from mujoco_mbrl_tpu.suite import humanoid_cmu as jhumanoid_cmu
from mujoco_mbrl_tpu.suite import parse_amc as jparse_amc
from mujoco_mbrl_tpu_torch import envs, suite
from mujoco_mbrl_tpu_torch.ops import apgd_solve
from mujoco_mbrl_tpu_torch.physics import collision, engine, smooth, solver
from mujoco_mbrl_tpu_torch.physics import model as M
from mujoco_mbrl_tpu_torch.physics.model import State
from mujoco_mbrl_tpu_torch.suite import humanoid_cmu, parse_amc, randomizers
from parity_utils import compare_models
from test_parity_physics import HEAVY_THRESHOLDS
from test_torch_cartpole import tracks_mujoco_fixture
from test_torch_manipulator import INVWEIGHTS
from test_torch_quadruped import _port_rows, assert_rows_match

HEAVY = os.environ.get('RUN_HEAVY', '') == '1'
FIXTURES = os.path.join(os.path.dirname(__file__), 'fixtures', 'parity')
TASKS = ('stand', 'run')
NR, NV = 4352, 62
APGD_TOL = dict(rtol=2e-4, atol=2e-4)
EXCLUDED = (('lclavicle', 'rclavicle'), ('lowerneck', 'lclavicle'),
            ('lowerneck', 'rclavicle'), ('upperneck', 'lclavicle'),
            ('upperneck', 'rclavicle'))


def heavy(reason):
    return pytest.mark.skipif(not HEAVY, reason=f'{reason}; RUN_HEAVY=1')


def fixture(task):
    return np.load(os.path.join(FIXTURES, f'humanoid_cmu_{task}.npz'))


_MODEL = {}


def port_model():
    if 'm' not in _MODEL:
        _MODEL['m'] = suite.load('humanoid_cmu', 'stand', device='cpu').model
    return _MODEL['m']


def test_xml_is_a_copy():
    assert humanoid_cmu._make_xml() == jhumanoid_cmu._make_xml()


@pytest.mark.parametrize('task', TASKS)
def test_model_matches_mujoco_fixture(task):
    m = port_model()
    fix = fixture(task)
    errors = [x for x in compare_models(m, fix) if x.severity == 'error']
    assert not errors, errors
    assert (m.nq, m.nv, m.nu, m.njnt, m.nbody, m.ngeom) == (
        63, 62, 56, 57, 32, 50)
    names = json.loads(str(fix['m_names_json']))
    assert sorted(m.names['body']) == sorted(n for n in names['body'] if n)
    assert m.contact_excludes == tuple(
        (m.name2id('body', a), m.name2id('body', b)) for a, b in EXCLUDED)
    # every geom condim 3, no friction loss, no equality row, 56 limits
    assert set(m.geom_condim) == {3}
    assert float(m.dof_frictionloss.abs().max()) == 0.0
    assert not m.eq_tendon and sum(m.jnt_limited) == 56


_SCENE = """
<mujoco>
  <worldbody>
    <geom name='floor' type='plane' size='1 1 .1'/>
    <body name='a' pos='0 0 .2'><freejoint/><geom size='.05'/></body>
    <body name='b' pos='0 0 .5'><freejoint/><geom size='.05'/></body>
  </worldbody>
  <contact>{}</contact>
</mujoco>
"""


def test_mjcf_contact_excludes_and_refusals():
    from mujoco_mbrl_tpu.physics import mjcf as jmjcf
    from mujoco_mbrl_tpu_torch.physics import mjcf
    xml = _SCENE.format("<exclude body1='b' body2='a'/>")
    m = mjcf.parse(xml)
    assert m.contact_excludes == ((2, 1),)
    assert m.contact_excludes == jmjcf.parse(xml).contact_excludes
    assert len(collision.candidate_pairs(m)) == 2
    assert len(collision.candidate_pairs(mjcf.parse(_SCENE.format('')))) == 3
    # a <pair> and a <sensor> are dropped, as JAX's compiler drops them:
    # the same excludes and the same candidate pairs as without them
    for extra in (_SCENE.format("<pair geom1='floor' geom2='floor'/>"),
                  _SCENE.replace('<contact>', '<sensor/><contact>').format(
                      '')):
        m2 = mjcf.parse(extra)
        assert m2.contact_excludes == jmjcf.parse(extra).contact_excludes
        assert m2.contact_excludes == ()
        assert len(collision.candidate_pairs(m2)) == 3


def test_contact_excludes_and_candidate_pairs():
    m = port_model()
    pairs = collision.candidate_pairs(m)
    assert len(pairs) == 1035
    excluded = {frozenset((m.name2id('body', a), m.name2id('body', b)))
                for a, b in EXCLUDED}
    bodies = {frozenset((m.geom_body[g1], m.geom_body[g2]))
              for g1, g2 in pairs}
    assert not excluded & bodies
    inv = {i: n for n, i in m.names['geom'].items()}
    ours = {frozenset((inv[g1], inv[g2])) for g1, g2 in pairs}
    for task in TASKS:
        seen = json.loads(str(fixture(task)['contact_pairs_json']))
        missed = [p for p in seen if frozenset(p) not in ours]
        # MuJoCo's one pair that neither package collides: a hand's
        # ellipsoid against a finger's capsule, which has no pair kernel
        # in JAX's collision (nor in the port's, its copy)
        assert len(seen) > 30 and missed == [['rfinger0', 'lhand']]
        types = {m.geom_type[m.name2id('geom', g)] for g in missed[0]}
        assert types == {M.CAPSULE, M.ELLIPSOID}
        assert (M.CAPSULE, M.ELLIPSOID) not in jcollision._PAIR_POINTS
        assert (M.ELLIPSOID, M.CAPSULE) not in jcollision._PAIR_POINTS


def _pose_states(fix, n=2, drop=0.02):
    """n states from the fixture's last physics state, each next one
    lowered by `drop` (in contact with the floor)."""
    qpos = torch.tensor(fix['p_qpos'][-1], dtype=torch.float32).repeat(n, 1)
    qpos[:, 2] -= drop * torch.arange(n)
    qvel = torch.tensor(fix['p_qvel'][-1], dtype=torch.float32).repeat(n, 1)
    return State(qpos=qpos, qvel=qvel, time=torch.zeros(n))


def test_rows_split_and_route():
    m = port_model()
    s = _pose_states(fixture('stand'))
    cs, con = _port_rows(m, s.qpos, s.qvel)
    assert cs.J.shape == (2, NR, NV) and con.dist.shape == (2, 1074)
    assert [k for k, _ in cs.blocks] == ['limit'] * 56 + ['facet'] * 4296
    assert [p[2] for p in cs.pyramids] == [2] * 1074
    nonneg, box_rows, con0 = solver._row_structure(cs)
    assert len(nonneg) == NR and not len(box_rows) and not len(con0)
    assert int(cs.active[:, 56:].sum()) > 0, 'no contact row active'
    # JAX's dense regime, past the rows the dense kernel's paths take
    assert not solver.factored_fits(NR, NV)
    assert NR > apgd_solve.DENSE_MAX_NR
    with pytest.raises(ValueError, match='1024'):
        apgd_solve.dense_route(NR)


def capture_solves(m, state, n_substeps=2):
    """[(args as numpy, kwargs)] of each dense-on-factors call of
    ``n_substeps`` warm-started substeps from `state`, zero ctrl."""
    captured, real = [], apgd_solve.apgd_iterate_dense_factors

    def capture(*args, **kw):
        captured.append((tuple(a.numpy().copy() for a in args), dict(kw)))
        return real(*args, **kw)

    ctrl = torch.zeros(state.qpos.shape[0], m.nu)
    apgd_solve.apgd_iterate_dense_factors = capture
    try:
        s, f, v = engine.step_warm(m, state, ctrl)
        for _ in range(n_substeps - 1):
            s, f, v = engine.step_warm(m, s, ctrl, warm_f=f, warm_v=v)
    finally:
        apgd_solve.apgd_iterate_dense_factors = real
    return captured


def stale_start(J, Minv, Rs, act):
    """A warm power vector each env's Rayleigh guard finds stale: on the
    active rows, the second eigenvector of Ad plus the leading one scaled
    by (lambda_2 / lambda_1)^7, so the power steps move the leading
    component from below to above the second's between steps 6 and 8."""
    v0 = np.zeros(act.shape, np.float32)
    for b in range(act.shape[0]):
        rows = np.nonzero(act[b])[0]
        Jb = J[b][rows].astype(np.float64)
        Ad = Jb @ Minv[b].astype(np.float64) @ Jb.T + np.diag(Rs[b][rows])
        w, u = np.linalg.eigh(Ad)
        v0[b, rows] = u[:, -2] + (w[-2] / w[-1]) ** 7 * u[:, -1]
    return v0


def warm_stale(J, Minv, Rs, v0):
    """(B,) the envs whose warm start the plain iterate's Rayleigh guard
    finds stale."""
    return apgd_solve.dense_factors_warm_stale(
        *[torch.as_tensor(a) for a in (J, Minv, Rs, v0)]).numpy()


_SOLVES = {}


def contact_solves():
    if 'c' not in _SOLVES:
        _SOLVES['c'] = capture_solves(port_model(),
                                      _pose_states(fixture('stand')))
    return _SOLVES['c']


@pytest.mark.parametrize('start', ['cold', 'warm', 'stale'])
def test_dense_factors_plain_matches_jax_xla_iterate(start):
    (cold_args, cold_kw), (warm_args, warm_kw) = contact_solves()
    args, kw = (cold_args, cold_kw) if start == 'cold' else (warm_args,
                                                             warm_kw)
    assert kw['cold'] == (start == 'cold')
    J, Minv, Rs, rhs, f0, v0, act = args
    assert J.shape == (2, NR, NV) and act[:, 56:].sum() > 0
    if start == 'stale':
        v0 = stale_start(J, Minv, Rs, act)
        args = (J, Minv, Rs, rhs, f0, v0, act)
        assert warm_stale(J, Minv, Rs, v0).all()
    elif start == 'warm':
        assert not warm_stale(J, Minv, Rs, v0).any()
    f, v, its = apgd_solve.apgd_iterate_dense_factors(
        *[torch.as_tensor(a) for a in args], **kw, return_iterations=True)
    f, v = f.numpy(), v.numpy()
    # JAX's dense iterate on Ad formed in float64 and rounded to float32
    J64 = J.astype(np.float64)
    Ad64 = J64 @ Minv.astype(np.float64) @ J64.transpose(0, 2, 1)
    Ad64 += Rs[:, :, None] * np.eye(NR)
    cv = jsolver._apgd_dispatch(kw['nonneg'], (), (), kw['iterations'],
                                kw['cold'])
    fn = jax.jit(jax.vmap(cv.impl_fn, in_axes=(0, 0, 0, 0, 0, None, None)))
    zeros = jnp.zeros(NR, jnp.float32)
    with jax.default_matmul_precision('highest'):
        f_j, v_j = (np.asarray(x) for x in fn(
            jnp.asarray(Ad64.astype(np.float32)), *[jnp.asarray(a) for a in
                                                    (rhs, f0, v0, act)],
            zeros, zeros))
    assert np.abs(f_j).max() > 1e-3, 'no force exercised'
    assert (f[act == 0] == 0).all() and (v[act == 0] == 0).all()
    phi = lambda x: 0.5 * np.einsum('br,brs,bs->b', x, Ad64, x) - (
        x * rhs).sum(1)
    np.testing.assert_allclose(phi(f), phi(f_j), rtol=1e-5)
    jf, jf_j = (np.einsum('brv,br->bv', J64, x) for x in (f, f_j))
    scale = np.abs(jf_j).max(1, keepdims=True)
    assert (np.abs(jf - jf_j) <= 2e-4 * (1.0 + scale)).all()
    df = f.astype(np.float64) - f_j
    valley = (np.einsum('br,brs,bs->b', df, Ad64, df)
              <= 4e-8 * (1.0 + np.einsum('br,brs,bs->b', f_j, Ad64, f_j)))
    apart = ~np.isclose(f, f_j, **APGD_TOL).all(1)
    assert not (apart & ~valley).any(), np.abs(df).max(1)
    np.testing.assert_allclose(v, v_j, err_msg='v', **APGD_TOL)


def test_dense_factors_refuses_other_rows():
    (args, kw), _ = contact_solves()
    with pytest.raises(ValueError, match='non-negative'):
        apgd_solve.apgd_iterate_dense_factors(
            *[torch.as_tensor(a) for a in args],
            **dict(kw, nonneg=kw['nonneg'][1:]))


@pytest.mark.parametrize('task', TASKS)
def test_observation_and_reward_match_fixture(task):
    """The task's observation and reward at the fixture's states after
    each of 5 control steps (its recorded ctrl), against MuJoCo's
    same-state observation and its reward (atol 1e-4 of each key's
    scale)."""
    fix = fixture(task)
    env = suite.load('humanoid_cmu', task, device='cpu')
    m, n = env.model, 5
    s = State(qpos=torch.tensor(fix['qpos'][:n], dtype=torch.float32),
              qvel=torch.tensor(fix['qvel'][:n], dtype=torch.float32),
              time=torch.zeros(n))
    ctrl = torch.tensor(fix['ctrl'][:n], dtype=torch.float32)
    data = engine.forward(m, s, ctrl, acc_stage=False)
    obs = env.task.get_observation(m, s, data)
    for key, x in obs.items():
        ref = fix[f'obs_fwd_{key}'][1:n + 1]
        np.testing.assert_allclose(
            x.numpy().reshape(ref.shape), ref, rtol=1e-4,
            atol=1e-4 * max(np.abs(ref).max(), 1.0), err_msg=key)
    np.testing.assert_allclose(
        env.task.get_reward(m, s, data, ctrl).numpy(), fix['reward'][:n],
        atol=1e-4)


@pytest.mark.parametrize('task', TASKS)
def test_tracks_mujoco_fixture(task):
    tracks_mujoco_fixture('humanoid_cmu', task, port_model(), 30,
                          HEAVY_THRESHOLDS['humanoid_cmu', task][1])


@heavy('the 50 fixture steps (~15 s a task on one core)')
@pytest.mark.parametrize('task', TASKS)
def test_tracks_mujoco_fixture_50_steps(task):
    steps, tol = HEAVY_THRESHOLDS['humanoid_cmu', task]
    tracks_mujoco_fixture('humanoid_cmu', task, port_model(), steps, tol)


def test_reset_keeps_the_first_free_attempt_else_the_last():
    """Attempts drawn with numpy (10 an env, hinges within 0.05 rad of the
    rest pose): env 0's all penetrate (the root sunk to 0.3 m), env 1's
    are free from attempt 3 on, env 2's all free; the port's pick against
    JAX's rule (argmax over the free flags with a True appended, capped
    at the last attempt) on the port's own contact distances; the other
    domains keep attempt 0."""
    m = port_model()
    rng = np.random.default_rng(7)
    A, nq = 10, m.nq
    q = np.tile(m.qpos0.numpy(), (A, 3, 1))
    for j in range(1, m.njnt):
        q[:, :, m.jnt_qposadr[j]] = rng.uniform(-0.05, 0.05, (A, 3))
    q[:, :, 2] = 1.5
    q[:, 0, 2] = 0.3
    q[:3, 1, 2] = 0.3
    qposes = torch.tensor(q, dtype=torch.float32)
    kin = smooth.kinematics(m, qposes.reshape(-1, nq), smooth.tree_meta(m))
    dist = collision.detect(m, kin[3], kin[4],
                            collision.candidate_pairs(m)).dist
    penet = (dist < 0).any(-1).reshape(A, 3).numpy()
    assert penet[:, 0].all() and penet[:3, 1].all() and not penet[3:, 1].any()
    idx = [int(jnp.minimum(jnp.argmax(jnp.concatenate(
        [~penet[:, b], jnp.ones(1, bool)])), A - 1)) for b in range(3)]
    assert idx == [9, 3, 0]
    assert randomizers.first_collision_free_index(
        m, qposes, fallback=-1).tolist() == idx
    assert randomizers.first_collision_free_index(m, qposes).tolist() == [
        0, 3, 0]
    np.testing.assert_array_equal(
        randomizers.first_collision_free(m, qposes, fallback=-1).numpy(),
        q[idx, np.arange(3)].astype(np.float32))


# two hinged capsules that cross for some draws, a metre above the floor:
# with geom-geom contacts off, no draw penetrates
_CROSSING_ARMS = """
<mujoco model='crossing_arms'>
  <worldbody>
    <geom name='floor' type='plane' size='5 5 .1'/>
    <body name='a' pos='-0.15 0 1'>
      <joint name='ja' type='hinge' axis='0 1 0' limited='true'
             range='-90 90'/>
      <geom name='ga' type='capsule' fromto='0 0 0 0.3 0 0' size='0.05'/>
    </body>
    <body name='b' pos='0.15 0 1'>
      <joint name='jb' type='hinge' axis='0 1 0' limited='true'
             range='-90 90'/>
      <geom name='gb' type='capsule' fromto='0 0 0 -0.3 0 0' size='0.05'/>
    </body>
  </worldbody>
</mujoco>"""


def test_reset_honours_geom_geom_option():
    """humanoid_cmu's reset with ``opt.enable_geom_geom_contacts`` off, on
    a small model whose only penetrations are geom-geom: the pairs it
    tests equal JAX's ``candidate_pairs(..., include_geom_geom=False)``
    (the floor's two), and on JAX's own ten draws of 6 keys the port
    keeps the draw JAX's ``initialize_episode`` keeps (exactly: the same
    float32 qpos); with the option on, the same draws keep another
    attempt in some env, so the option decides."""
    import dataclasses
    from mujoco_mbrl_tpu.physics import mjcf as jmjcf
    from mujoco_mbrl_tpu.suite import randomizers as jrandomizers
    from mujoco_mbrl_tpu_torch.physics import mjcf

    jm = jmjcf.parse(_CROSSING_ARMS)
    jm = jm.replace(opt=jm.opt.replace(enable_geom_geom_contacts=False))
    m = mjcf.parse(_CROSSING_ARMS)
    off = m.replace(opt=dataclasses.replace(
        m.opt, enable_geom_geom_contacts=False))
    assert collision.candidate_pairs(off, include_geom_geom=False) == \
        jcollision.candidate_pairs(jm, include_geom_geom=False) == [
            (0, 1), (0, 2)]
    assert len(collision.candidate_pairs(m)) == 3

    task = jhumanoid_cmu.HumanoidCMU(0)
    A, keys = 10, jax.random.split(jax.random.PRNGKey(5), 6)
    draws, kept = [], []
    for key in keys:
        draws.append(np.asarray(jax.vmap(
            lambda k: jrandomizers.randomize_limited_and_rotational_joints(
                jm, jnp.asarray(jm.qpos0), k))(jax.random.split(key, A))))
        kept.append(np.asarray(task.initialize_episode(jm, key)[0].qpos))
    qposes = torch.tensor(np.stack(draws, 1), dtype=torch.float32)
    kept = np.stack(kept)
    # JAX kept attempt 0 of every env: nothing it tests can penetrate
    np.testing.assert_array_equal(kept, qposes[0].numpy())
    got = randomizers.first_collision_free(
        off, qposes, fallback=-1,
        include_geom_geom=off.opt.enable_geom_geom_contacts)
    np.testing.assert_array_equal(got.numpy(), kept)
    on_idx = randomizers.first_collision_free_index(m, qposes, fallback=-1)
    assert bool((on_idx != 0).any()), on_idx

    # the task's reset reads the option: off keeps its first draw an env
    gen = lambda: torch.Generator().manual_seed(11)
    B = 64
    q = randomizers.randomize_limited_and_rotational_joints(
        m, m.qpos0.expand(A * B, m.nq), gen()).reshape(A, B, m.nq)
    port = humanoid_cmu.HumanoidCMU(0)
    phys, _ = port.initialize_episode(off, B, gen())
    np.testing.assert_array_equal(phys.qpos.numpy(), q[0].numpy())
    phys_on, _ = port.initialize_episode(m, B, gen())
    idx = randomizers.first_collision_free_index(m, q, fallback=-1)
    assert bool((idx != 0).any())
    np.testing.assert_array_equal(phys_on.qpos.numpy(),
                                  q[idx, torch.arange(B)].numpy())


def test_reset_and_step_through_suite_load():
    env = suite.load('humanoid_cmu', 'run', device='cpu')
    state, ts = env.reset(2, torch.Generator().manual_seed(0))
    assert state.physics.qpos.shape == (2, 63)
    np.testing.assert_allclose(
        state.physics.qpos[:, 3:7].norm(dim=1).numpy(), 1.0, atol=1e-6)
    assert ts.observation['joint_angles'].shape == (2, 56)
    state, ts = env.step(state, torch.zeros(2, 56))
    assert bool(torch.isfinite(state.physics.qvel).all())
    assert ts.reward.shape == (2,) and bool((ts.reward >= 0).all())


def _write_amc(path, n_frames, seed):
    """A synthetic .amc: a header, then per frame its number and one line
    per channel group (the root's 6 values, then 56 joint angles in
    degrees within +-40), as the CMU files lay them out."""
    rng = np.random.default_rng(seed)
    lines = ['# synthetic', ':FULLY-SPECIFIED', ':DEGREES']
    for k in range(1, n_frames + 1):
        root = np.concatenate([rng.normal(0, 5, 3), rng.uniform(-60, 60, 3)])
        lines.append(str(k))
        lines.append('root ' + ' '.join(f'{x:.6f}' for x in root))
        vals = rng.uniform(-40, 40, 56)
        for c in range(0, 56, 3):
            lines.append(f'j{c} ' + ' '.join(f'{x:.6f}' for x in
                                             vals[c:c + 3]))
    path.write_text('\n'.join(lines) + '\n')


def test_parse_amc_convert_matches_jax(tmp_path):
    m = port_model()
    amc = tmp_path / 'synthetic.amc'
    _write_amc(amc, 40, seed=3)
    ns = SimpleNamespace(nq=m.nq, names=m.names, jnt_qposadr=m.jnt_qposadr)
    ref = jparse_amc.convert(str(amc), ns, 0.02)
    for model in (ns, m):
        ours = parse_amc.convert(str(amc), model, 0.02)
        for name in ('qpos', 'qvel', 'time'):
            np.testing.assert_allclose(getattr(ours, name),
                                       getattr(ref, name), rtol=1e-12,
                                       atol=1e-12, err_msg=name)
    assert ref.qpos.shape == (63, 17) and ref.qvel.shape == (62, 16)
    frames = parse_amc.parse(str(amc))
    assert len(frames) == 40 and frames[0].shape == (62,)


def test_registered_as_in_jax():
    from mujoco_mbrl_tpu import envs as jenvs
    from mujoco_mbrl_tpu import suite as jsuite
    assert len({d for d, _ in jsuite.all_tasks()}) == 18
    assert suite.all_tasks() == jsuite.all_tasks()
    assert suite.benchmarking() == jsuite.benchmarking()
    assert [t for d, t in suite.all_tasks() if d == 'humanoid_cmu'] == list(
        TASKS)
    # no wrapper in either package
    with pytest.raises(NameError):
        jenvs.load('humanoid_cmu', 'stand')
    with pytest.raises(NotImplementedError, match='EnvWrapper.load'):
        envs.load('humanoid_cmu', 'stand', device='cpu')


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device works')
    for task in TASKS:
        with pytest.raises(RuntimeError, match='CUDA'):
            suite.load('humanoid_cmu', task)


# ---- behind RUN_HEAVY=1: what needs JAX's humanoid_cmu Model -----------

@pytest.fixture(scope='module')
def jax_model():
    """JAX's humanoid_cmu Model, compiled by JAX's ``mjcf.parse`` but for
    mj_setConst's weights, which it takes from the port's model (JAX's
    jit of their probe had not finished after 39 minutes on one core;
    ``test_model_matches_mujoco_fixture`` holds the rest of the port's
    model, and these tests its rows, which read the weights)."""
    from mujoco_mbrl_tpu.physics import mjcf as jmjcf
    real = jmjcf._with_invweight0
    jmjcf._with_invweight0 = lambda m: m
    try:
        jm = jmjcf.parse(jhumanoid_cmu._make_xml())
    finally:
        jmjcf._with_invweight0 = real
    tm = port_model()
    return jm.replace(**{n: jnp.asarray(getattr(tm, n).numpy())
                         for n in INVWEIGHTS})


def _jax_rows_eager(jm, q, v):
    """JAX's assembly at poses q (B, nq), env by env with jit disabled
    (XLA:CPU had not compiled the jitted 4,352-row assembly after half an
    hour; eagerly it takes ~25 s an env): (J, aref, R, active, mu) as
    numpy, and the static block list and pyramids."""
    from mujoco_mbrl_tpu.physics import smooth as jsmooth
    rows, static = [], None
    with jax.disable_jit():
        for b in range(q.shape[0]):
            meta = jsmooth.tree_meta(jm)
            kin = jsmooth.kinematics(jm, q[b], meta)
            cdof = jsmooth.motion_subspace(jm, kin[1], kin[6], kin[7], meta)
            con = jcollision.detect(jm, kin[3], kin[4],
                                    jcollision.candidate_pairs(jm))
            cs = jsolver.assemble(jm, meta, q[b], v[b], cdof, con,
                                  site_xpos=kin[5])
            rows.append([np.asarray(x) for x in (cs.J, cs.aref, cs.R,
                                                 cs.active, cs.mu)])
            static = (cs.blocks, cs.pyramids)
    return [np.stack(x) for x in zip(*rows)], static


@heavy('JAX assembles 4,352 rows in ~25 s an env, eagerly')
def test_rows_match_jax_assemble(jax_model):
    """The 4,352 rows at fixture poses in contact in JAX's order: the
    block list, the pyramids, J, aref, R, active and mu (rtol 1e-5)."""
    s = _pose_states(fixture('stand'))
    cs, _ = _port_rows(port_model(), s.qpos, s.qvel)
    jrows, jstatic = _jax_rows_eager(jax_model, jnp.asarray(s.qpos.numpy()),
                                     jnp.asarray(s.qvel.numpy()))
    assert_rows_match(cs, jrows, jstatic)


@heavy('JAX runs its humanoid_cmu forward eagerly, tens of seconds')
@pytest.mark.parametrize('task', TASKS)
def test_observation_and_reward_match_jax(jax_model, task):
    from mujoco_mbrl_tpu.physics import engine as jengine
    from mujoco_mbrl_tpu.physics import model as JM
    fix = fixture(task)
    env = suite.load('humanoid_cmu', task, device='cpu')
    jtask = jhumanoid_cmu.HumanoidCMU(0 if task == 'stand' else 10)
    m, n = env.model, 3
    s = State(qpos=torch.tensor(fix['qpos'][:n], dtype=torch.float32),
              qvel=torch.tensor(fix['qvel'][:n], dtype=torch.float32),
              time=torch.zeros(n))
    ctrl = torch.tensor(fix['ctrl'][:n], dtype=torch.float32)
    data = engine.forward(m, s, ctrl, acc_stage=False)
    obs = env.task.get_observation(m, s, data)
    reward = env.task.get_reward(m, s, data, ctrl)
    for b in range(n):
        phys = JM.State(qpos=jnp.asarray(s.qpos[b].numpy()),
                        qvel=jnp.asarray(s.qvel[b].numpy()),
                        time=jnp.zeros(()), act=None)
        with jax.disable_jit(), jax.default_matmul_precision('highest'):
            jd = jengine.forward(jax_model, phys,
                                 jnp.asarray(ctrl[b].numpy()),
                                 acc_stage=False)
            jobs = jtask.get_observation(jax_model, phys, jd)
            jrew = jtask.get_reward(jax_model, phys, jd,
                                    jnp.asarray(ctrl[b].numpy()))
        for key, x in obs.items():
            np.testing.assert_allclose(x[b].numpy().ravel(),
                                       np.asarray(jobs[key]).ravel(),
                                       rtol=1e-4, atol=1e-4, err_msg=key)
        np.testing.assert_allclose(float(reward[b]), float(jrew), atol=1e-5)
