"""The PGS solve (``m.opt.solver = 'pgs'``) of the port against the JAX package.

JAX's own PGS scenes (tests/test_solver_contact.py's ball on a plane,
tests/test_box_contacts.py's box stack) and the walker go through both
packages from the same states: the forward's row forces and 5 physics
steps (cold, and warm started from each solve's forces, as ``substep``
does) agree within 1e-4 in qvel and forces, the walker's within 1e-3; an
elliptic ball of condim 6 takes 3 rows a contact; a warm start cannot
revive rows inactive in this configuration.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mbrl_tpu import physics as jphysics
from mujoco_mbrl_tpu.physics import engine as jengine
from mujoco_mbrl_tpu.physics import model as JM
from mujoco_mbrl_tpu_torch.physics import engine, mjcf
from mujoco_mbrl_tpu_torch.physics import model as M
from mujoco_mbrl_tpu_torch.physics import smooth, solver

BALL_XML = """
<mujoco model='ball'>
  <option timestep='0.002' gravity='0 0 -9.81'{cone}/>
  <worldbody>
    <geom name='floor' type='plane' size='10 10 .1' friction='0.5'/>
    <body name='ball' pos='0 0 0.1'>
      <joint name='root' type='free'/>
      <geom name='ball' type='sphere' size='0.1' mass='1'
            friction='0.5 0.01 0.002'{condim}/>
    </body>
  </worldbody>
</mujoco>
"""

BOX_STACK_XML = """
<mujoco model='stack'>
  <option timestep='0.002'/>
  <worldbody>
    <geom name='floor' type='plane' size='2 2 .1'/>
    <body name='base' pos='0 0 0.1'><joint type='free'/>
      <geom name='base' type='box' size='0.1 0.1 0.1' mass='1'/></body>
    <body name='top' pos='0.01 0 0.26'><joint type='free'/>
      <geom name='top' type='box' size='0.05 0.05 0.05' mass='0.2'/></body>
  </worldbody>
</mujoco>
"""

B = 4


def _models(xml, solver_name='pgs', geom_geom=False):
    jm = jphysics.parse(xml)
    jm = jm.replace(opt=jm.opt.replace(
        solver=solver_name, enable_geom_geom_contacts=geom_geom))
    tm = mjcf.parse(xml)
    tm = tm.replace(opt=dataclasses.replace(
        tm.opt, solver=solver_name, enable_geom_geom_contacts=geom_geom))
    return jm, tm


def _states(tm, qpos, qvel):
    return M.State(qpos=torch.tensor(qpos), qvel=torch.tensor(qvel),
                   time=torch.zeros(len(qpos)), act=None)


def _jax_states(qpos, qvel):
    return JM.State(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                    time=jnp.zeros(len(qpos)), act=None)


def _ball_states(tm, seed):
    """The ball pressed 1-3 mm into the floor, rolling and spinning."""
    rng = np.random.RandomState(seed)
    qpos = np.tile(tm.qpos0.numpy(), (B, 1)).astype(np.float32)
    qpos[:, 2] = 0.1 - rng.uniform(0.001, 0.003, B)
    q = rng.normal(size=(B, 4))
    qpos[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    qvel = rng.normal(0.0, 1.0, (B, tm.nv)).astype(np.float32)
    qvel[:, 2] = -np.abs(qvel[:, 2])
    return qpos, qvel


def _jax_run(jm, qpos, qvel, n, warm):
    """n steps in one jitted scan: (qpos, qvel, the first solve's row
    forces); warm threads each solve's forces into the next (substep)."""
    ctrl = jnp.zeros(jm.nu)

    def fn(s):
        s, f, v = jengine.step_warm(jm, s, ctrl)
        if warm:
            body = lambda c, _: (jengine.step_warm(
                jm, c[0], ctrl, warm_f=c[1], warm_v=c[2]), None)
            (s, _, _), _ = jax.lax.scan(body, (s, f, v), None,
                                        length=n - 1)
        else:
            s, _ = jax.lax.scan(lambda c, _: (jengine.step(jm, c, ctrl),
                                              None), s, None, length=n - 1)
        return s.qpos, s.qvel, f
    return [np.asarray(x) for x in jax.jit(jax.vmap(fn))(
        _jax_states(qpos, qvel))]


def _port_run(tm, qpos, qvel, n, warm):
    ctrl = torch.zeros((len(qpos), tm.nu))
    s, f0, v = engine.step_warm(tm, _states(tm, qpos, qvel), ctrl)
    f = f0
    for _ in range(n - 1):
        if warm:
            s, f, v = engine.step_warm(tm, s, ctrl, warm_f=f, warm_v=v)
        else:
            s = engine.step(tm, s, ctrl)
    return s.qpos.numpy(), s.qvel.numpy(), f0.numpy()


def _forces(jm, tm, qpos, qvel):
    jd = jax.jit(jax.vmap(lambda s: jengine.forward(jm, s, jnp.zeros(
        jm.nu))))(_jax_states(qpos, qvel))
    td = engine.forward(tm, _states(tm, qpos, qvel), torch.zeros(
        (len(qpos), tm.nu)))
    return (np.asarray(jd.efc_force), td.efc_force.numpy(),
            np.asarray(jd.contact_force), td.contact_force.numpy())


@pytest.mark.parametrize('warm', [False, True], ids=['cold', 'warm'])
def test_ball_on_plane(warm):
    jm, tm = _models(BALL_XML.format(cone='', condim=''))
    qpos, qvel = _ball_states(tm, 0)
    jf, tf, jc, tc = _forces(jm, tm, qpos, qvel)
    np.testing.assert_allclose(tf, jf, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tc, jc, rtol=1e-4, atol=1e-4)
    assert (tc[:, :, 0].sum(1) > 0).all()
    jq, jv, _ = _jax_run(jm, qpos, qvel, 5, warm)
    tq, tv, _ = _port_run(tm, qpos, qvel, 5, warm)
    np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tq, jq, rtol=1e-5, atol=1e-5)


def test_elliptic_condim6_ball():
    """Elliptic cone at condim 6: 3 rows a contact (the torsional and
    rolling friction are not rows, as in JAX's assemble)."""
    xml = BALL_XML.format(cone=" cone='elliptic'", condim=" condim='6'")
    jm, tm = _models(xml)
    qpos, qvel = _ball_states(tm, 1)
    jf, tf, jc, tc = _forces(jm, tm, qpos, qvel)
    assert tf.shape == jf.shape == (B, 3)
    np.testing.assert_allclose(tf, jf, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tc, jc, rtol=1e-4, atol=1e-4)
    jq, jv, _ = _jax_run(jm, qpos, qvel, 5, True)
    tq, tv, _ = _port_run(tm, qpos, qvel, 5, True)
    np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-4)


def test_box_stack():
    jm, tm = _models(BOX_STACK_XML, geom_geom=True)
    rng = np.random.RandomState(2)
    qpos = np.tile(tm.qpos0.numpy(), (B, 1)).astype(np.float32)
    qpos[:, 2] -= rng.uniform(0.0, 0.002, B)          # base into the floor
    qpos[:, 9] -= 0.012 + rng.uniform(0.0, 0.002, B)  # top onto the base
    qvel = rng.normal(0.0, 0.3, (B, tm.nv)).astype(np.float32)
    jq, jv, jf = _jax_run(jm, qpos, qvel, 5, True)
    tq, tv, tf = _port_run(tm, qpos, qvel, 5, True)
    assert tf.shape == jf.shape and tf.shape[1] > 8
    np.testing.assert_allclose(tf, jf, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-4)


def test_walker_pgs_from_jax_draws():
    """Walker walk at 8 envs, joints drawn by jax.random in their ranges
    and the feet lowered into the floor: the first solve's row forces and
    qvel after 5 warm-started substeps within 1e-3 of JAX's PGS."""
    from mujoco_mbrl_tpu.suite import walker as jwalker
    from mujoco_mbrl_tpu_torch.suite import walker

    n = 8
    jm = jphysics.parse(jwalker._XML)
    jm = jm.replace(opt=jm.opt.replace(solver='pgs'))
    tm = mjcf.parse(walker._XML)
    tm = tm.replace(opt=dataclasses.replace(tm.opt, solver='pgs'))
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(3), 3)
    lo, hi = jm.jnt_range[3:, 0], jm.jnt_range[3:, 1]
    qpos = np.zeros((n, tm.nq), np.float32)
    qpos[:, 3:] = np.asarray(jax.random.uniform(k1, (n, 6), minval=lo,
                                                maxval=hi))
    qpos[:, 0] = np.asarray(jax.random.uniform(k2, (n,), minval=-1.25,
                                               maxval=-1.1))
    qvel = np.asarray(0.5 * jax.random.normal(k3, (n, tm.nv)), np.float32)
    jq, jv, jf = _jax_run(jm, qpos, qvel, 5, True)
    tq, tv, tf = _port_run(tm, qpos, qvel, 5, True)
    assert (tf > 0).any()
    np.testing.assert_allclose(tf, jf, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tv, jv, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tq, jq, rtol=1e-4, atol=1e-4)


def test_pgs_solve_masks_inactive_rows_of_the_warm_start():
    """A warm start on a row inactive in this configuration cannot leak
    into the solve: the forces equal a cold solve's where no row is
    active, and are zero there."""
    _, tm = _models(BALL_XML.format(cone='', condim=''))
    qpos, qvel = _ball_states(tm, 4)
    qpos[:, 2] = 0.5                                   # in the air
    st = _states(tm, qpos, qvel)
    meta = smooth.tree_meta(tm)
    d = engine.forward(tm, st, torch.zeros((B, 0)))
    cs = solver.assemble(tm, meta, st.qpos, st.qvel, d.cdof, None)
    assert cs is None
    from mujoco_mbrl_tpu_torch.physics import collision
    pairs = collision.candidate_pairs(tm)
    con = collision.detect(tm, d.geom_xpos, d.geom_xmat, pairs)
    cs = solver.assemble(tm, meta, st.qpos, st.qvel, d.cdof, con)
    L = torch.linalg.cholesky(d.qM)
    qf, f = solver.solve(tm, cs, L, torch.zeros((B, tm.nv)),
                         f0=torch.full((B, cs.J.shape[1]), 5.0))
    assert (f == 0).all() and (qf == 0).all()
