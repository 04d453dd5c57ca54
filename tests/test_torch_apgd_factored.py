"""Factored APGD iterate port (ops.apgd_solve plain version) against JAX.

The port's ``apgd_iterate_factored`` on CPU tensors (its plain version,
what the CUDA kernel is held to on the card) is compared with the JAX
package's XLA factored iterate (``physics.solver._apgd_dispatch_factored``
under vmap, the oracle of tests/test_apgd_kernel.py
``_xla_factored_reference``) and with the JAX Pallas kernel in interpret
mode (``apgd_iterate_factored(..., interpret=True)``) on the same numpy
inputs: cheetah's shape (146 rows, all non-negative, nv 9) and the
humanoid's (303 rows: limits, then friction-cone triples; nv 27), cold
and warm, at small B; and the real cheetah solves that the port's physics
step builds at JAX-drawn reset states (B = 4; the cold solve of a zero-
action step, then the warm one of the next step from its forces).
Tolerance rtol = atol = 2e-4, as tests/test_apgd_kernel.py. Also the
choice of the CUDA kernel's path by shape (``factored_route``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mbrl_tpu import suite as jsuite
from mujoco_mbrl_tpu.ops import apgd_solve as japgd
from mujoco_mbrl_tpu.physics import solver as jsolver
from mujoco_mbrl_tpu_torch import convert, suite
from mujoco_mbrl_tpu_torch.ops import apgd_solve
from mujoco_mbrl_tpu_torch.physics import engine, solver

TOL = dict(rtol=2e-4, atol=2e-4)
ITERATIONS = 40
# (nr, nv, non-negative rows); the rest are cone triples
SHAPES = {'cheetah': (146, 9, 146), 'humanoid': (303, 27, 36)}


def _problem(seed, B, nr, nv):
    """Factored dual QP batch (numpy float32) as tests/test_apgd_kernel.py
    ``_factored_problem`` builds it: scaled and active-masked Jacobian,
    dense PSD M^-1, scaled regularizer and diagonal."""
    rng = np.random.RandomState(seed)
    J = rng.normal(size=(B, nr, nv))
    G = rng.normal(size=(B, nv + 2, nv))
    Minv = np.einsum('bij,bik->bjk', G, G) / nv + 0.1 * np.eye(nv)
    R = rng.uniform(0.05, 0.3, size=(B, nr))
    active = (rng.uniform(size=(B, nr)) > 0.75).astype(np.float64)
    d = np.einsum('brv,bvw,brw->br', J, Minv, J) + R
    s = 1.0 / np.sqrt(d)
    J_s = J * (s * active)[:, :, None]
    rhs = rng.normal(size=(B, nr)) * active
    f0 = 0.3 * rng.normal(size=(B, nr))
    v0 = rng.normal(size=(B, nr))
    return tuple(np.asarray(x, np.float32) for x in (
        J_s, Minv, s * s * R * active, s * s * d * active, rhs, f0, v0,
        active))


def _rows(nr, n_nonneg):
    con0 = tuple(range(n_nonneg, nr, 3))
    mu = np.zeros(nr, np.float32)
    mu[list(con0)] = 0.7
    return tuple(range(n_nonneg)), con0, mu


@pytest.fixture(scope='module')
def cheetah_reset_solves():
    """{cold: (numpy inputs, keywords)} of the factored solves that the
    port's cheetah physics step builds at JAX-drawn reset states (B = 4,
    200 settling steps each; zero actions): the cold solve of one step
    and the warm solve of the next, started from the first's forces."""
    jenv = jsuite.load('cheetah', 'run')
    state0, _ = jax.jit(jax.vmap(jenv.reset))(
        jax.random.split(jax.random.PRNGKey(0), 4))
    m = suite.load('cheetah', 'run', device='cpu').model
    phys = convert.env_state(state0.physics.qpos, state0.physics.qvel,
                             time=state0.physics.time).physics
    captured = {}
    real = apgd_solve.apgd_iterate_factored

    def capture(*args, **kw):
        captured[kw['cold']] = ([a.numpy().copy() for a in args], dict(kw))
        return real(*args, **kw)

    apgd_solve.apgd_iterate_factored = capture
    try:
        zero = torch.zeros((4, m.nu))
        s1, f, v = engine.step_warm(m, phys, zero)
        engine.step_warm(m, s1, zero, warm_f=f, warm_v=v)
    finally:
        apgd_solve.apgd_iterate_factored = real
    assert sorted(captured) == [False, True]
    return captured


@pytest.mark.parametrize('shape', sorted(SHAPES) + ['cheetah-reset'])
@pytest.mark.parametrize('cold', [True, False])
def test_plain_matches_jax_xla_and_kernel(shape, cold, request):
    if shape == 'cheetah-reset':
        solves = request.getfixturevalue('cheetah_reset_solves')
        (*args, mu, bounds), kw = solves[cold]
        args = tuple(args)
        B, nr = args[4].shape
        nonneg, con0, iterations = kw['nonneg'], kw['con0'], kw['iterations']
        assert args[0].shape == (4, 146, 9) and not con0
    else:
        nr, nv, n_nonneg = SHAPES[shape]
        B, iterations = 5, ITERATIONS
        args = _problem(int(cold) + nr, B, nr, nv)
        nonneg, con0, mu = _rows(nr, n_nonneg)
        bounds = np.zeros(nr, np.float32)

    cv = jsolver._apgd_dispatch_factored(nonneg, (), con0, iterations, cold)
    fn = jax.jit(lambda a: jax.vmap(cv)(*a, *[
        jnp.broadcast_to(jnp.asarray(x), (B, nr)) for x in (mu, bounds)]))
    with jax.default_matmul_precision('highest'):
        ref = [np.asarray(x) for x in fn(tuple(jnp.asarray(a)
                                                for a in args))]
    kern = [np.asarray(x) for x in japgd.apgd_iterate_factored(
        *[jnp.asarray(a) for a in args], jnp.asarray(mu),
        jnp.asarray(bounds), nonneg=nonneg, box_rows=(), con0=con0,
        iterations=iterations, cold=cold, interpret=True)]
    ours = apgd_solve.apgd_iterate_factored(
        *[torch.as_tensor(a) for a in args], torch.as_tensor(mu),
        torch.as_tensor(bounds), nonneg=nonneg, box_rows=(), con0=con0,
        iterations=iterations, cold=cold)
    assert any(np.abs(ref[0]).max(1) > 1e-3), 'no force exercised'
    for o, r, k, name in zip(ours, ref, kern, ('f', 'v')):
        np.testing.assert_allclose(o.numpy(), r, err_msg=name, **TOL)
        np.testing.assert_allclose(o.numpy(), k, err_msg=name, **TOL)


def test_factored_regime_selection_follows_jax():
    """The port selects the factored iterate where JAX does: past 96 rows
    when the factors fit the JAX budget and no equality row is present."""
    for nr, nv in ((146, 9), (303, 27), (4380, 62), (97, 9), (96, 9)):
        assert solver.factored_fits(nr, nv) == japgd.factored_fits(nr, nv)
    assert solver.MAX_NR == japgd.MAX_NR


# (nr, nv) -> the path: the cheetah's 146 x 9 and everything up to 160
# rows and nv 16 take one env per warp; the humanoid's 303 x 27 and every
# other shape up to 1024 rows one block per env
@pytest.mark.parametrize('nr,nv,route', [
    (146, 9, 'warp'), (160, 9, 'warp'), (161, 9, 'block'),
    (146, 16, 'warp'), (146, 17, 'block'), (97, 1, 'warp'),
    (303, 27, 'block'), (1024, 9, 'block')])
def test_factored_route(nr, nv, route):
    assert apgd_solve.factored_route(nr, nv) == route


def test_factored_route_refuses_past_1024_rows():
    with pytest.raises(ValueError, match='1024'):
        apgd_solve.factored_route(1025, 9)
