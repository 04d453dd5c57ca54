"""Physics port (mujoco_mbrl_tpu_torch.physics) against the JAX package.

Same walker inputs, drawn with numpy, go through both packages:
the compiled Model field by field, then kinematics, the mass matrix (CRBA),
the bias forces (RNEA), collision and the APGD constraint solve at random
walker states with contacts and active limits; and 100 physics steps of
the port alone against the MuJoCo fixture (the CPU band of
tests/test_parity_physics.py, 1e-3 on qpos).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mbrl_tpu.physics import engine as jengine
from mujoco_mbrl_tpu.physics import mjcf as jmjcf
from mujoco_mbrl_tpu.physics import model as JM
from mujoco_mbrl_tpu.suite import walker as jwalker
from mujoco_mbrl_tpu_torch.physics import engine, mjcf
from mujoco_mbrl_tpu_torch.physics.model import State
from mujoco_mbrl_tpu_torch.suite import walker

FIXTURE = os.path.join(os.path.dirname(__file__), 'fixtures', 'parity',
                       'walker_walk.npz')


@pytest.fixture(scope='module')
def models():
    return jmjcf.parse(jwalker._XML), mjcf.parse(walker._XML)


def test_walker_xml_is_a_copy():
    assert walker._XML == jwalker._XML


def test_model_matches_jax_field_by_field(models):
    jm, tm = models
    for f in dataclasses.fields(tm):
        ours = getattr(tm, f.name)
        if f.name == 'opt':
            continue
        ref = getattr(jm, f.name)
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
                 'cone', 'impratio', 'solver_warmstart'):
        assert getattr(tm.opt, name) == getattr(jm.opt, name), name


def _random_states(tm, n, seed):
    """Walker states low enough to touch the floor, some joints past
    their limits (active limit rows), random velocities and controls."""
    rng = np.random.RandomState(seed)
    rng_lo = tm.jnt_range[:, 0].numpy()
    rng_hi = tm.jnt_range[:, 1].numpy()
    qpos = np.zeros((n, tm.nq), np.float32)
    qpos[:, 0] = rng.uniform(-1.1, -0.4, n)           # rootz
    qpos[:, 1] = rng.uniform(-1.0, 1.0, n)            # rootx
    qpos[:, 2] = rng.uniform(-0.7, 0.7, n)            # rooty
    span = rng_hi[3:] - rng_lo[3:]
    qpos[:, 3:] = rng_lo[3:] + rng.uniform(-0.05, 1.05, (n, 6)) * span
    qvel = rng.normal(0.0, 1.0, (n, tm.nv)).astype(np.float32)
    ctrl = rng.uniform(-1.0, 1.0, (n, tm.nu)).astype(np.float32)
    return qpos, qvel, ctrl


@pytest.fixture(scope='module')
def forward_pair(models):
    jm, tm = models
    qpos, qvel, ctrl = _random_states(tm, 6, seed=0)

    def jfwd(q, v, u):
        return jengine.forward(jm, JM.State(qpos=q, qvel=v,
                                            time=jnp.zeros(())), u)

    jd = jax.jit(jax.vmap(jfwd))(qpos, qvel, ctrl)
    td = engine.forward(tm, State(qpos=torch.as_tensor(qpos),
                                  qvel=torch.as_tensor(qvel),
                                  time=torch.zeros(6)),
                        torch.as_tensor(ctrl))
    return jd, td


def _close(td, jd, fields, atol, rtol=0.0):
    for name in fields:
        ours = getattr(td, name).numpy()
        ref = np.asarray(getattr(jd, name))
        np.testing.assert_allclose(ours, ref, atol=atol, rtol=rtol,
                                   err_msg=name)


def test_kinematics_matches_jax(forward_pair):
    jd, td = forward_pair
    _close(td, jd, ('xpos', 'xquat', 'xipos', 'ximat', 'geom_xpos',
                    'geom_xmat', 'xanchor', 'xaxis', 'cdof', 'cvel'), 1e-5)


def test_crba_and_rnea_bias_match_jax(forward_pair):
    jd, td = forward_pair
    _close(td, jd, ('qM',), 1e-5)
    _close(td, jd, ('qfrc_bias', 'qfrc_passive', 'qfrc_actuator'), 1e-5,
           rtol=1e-6)


def test_collision_matches_jax(forward_pair):
    jd, td = forward_pair
    _close(td, jd, ('contact_dist', 'contact_pos', 'contact_frame'), 1e-5)
    assert td.contact_dist.shape[1] == 14
    assert bool((td.contact_dist < 0).any()), 'no contact exercised'


def test_solve_apgd_forces_match_jax(forward_pair):
    jd, td = forward_pair
    f_ref = np.asarray(jd.efc_force)
    assert td.efc_force.shape == f_ref.shape == (6, 62)
    assert (np.abs(f_ref) > 1e-3).sum() > 20, 'too few active rows'
    scale = np.abs(f_ref).max()
    np.testing.assert_allclose(td.efc_force.numpy(), f_ref, rtol=1e-4,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(td.qfrc_constraint.numpy(),
                               np.asarray(jd.qfrc_constraint), rtol=1e-4,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(td.contact_force.numpy(),
                               np.asarray(jd.contact_force), rtol=1e-4,
                               atol=1e-5 * scale)


def test_walker_tracks_mujoco_fixture_100_steps(models):
    """Port alone vs the MuJoCo oracle: 100 cold-solved physics steps
    within the CPU band (tests/test_parity_physics.py THRESHOLDS)."""
    _, tm = models
    fix = np.load(FIXTURE)
    ctrl = np.repeat(fix['ctrl'], int(fix['n_sub_steps']), axis=0)[:100]
    s = State(qpos=torch.tensor(fix['init_qpos'], dtype=torch.float32)[None],
              qvel=torch.tensor(fix['init_qvel'], dtype=torch.float32)[None],
              time=torch.zeros(1))
    qpos = [fix['init_qpos']]
    for u in ctrl:
        s = engine.step(tm, s, torch.tensor(u, dtype=torch.float32)[None])
        qpos.append(s.qpos[0].numpy())
    dev = np.abs(np.array(qpos) - fix['p_qpos'][:101]).max(axis=1)
    assert dev.max() <= 1e-3, dev
