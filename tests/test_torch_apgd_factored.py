"""Factored APGD iterate port (ops.apgd_solve plain version) against JAX.

The port's ``apgd_iterate_factored`` on CPU tensors (its plain version,
what the CUDA kernel is held to on the card) is compared with the JAX
package's XLA factored iterate (``physics.solver._apgd_dispatch_factored``
under vmap, the oracle of tests/test_apgd_kernel.py
``_xla_factored_reference``) and with the JAX Pallas kernel in interpret
mode (``apgd_iterate_factored(..., interpret=True)``) on the same numpy
inputs: cheetah's shape (146 rows, all non-negative, nv 9) and the
humanoid's (303 rows: limits, then friction-cone triples; nv 27), cold
and warm, at small B. Tolerance rtol = atol = 2e-4, as
tests/test_apgd_kernel.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mbrl_tpu.ops import apgd_solve as japgd
from mujoco_mbrl_tpu.physics import solver as jsolver
from mujoco_mbrl_tpu_torch.ops import apgd_solve
from mujoco_mbrl_tpu_torch.physics import solver

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


@pytest.mark.parametrize('shape', sorted(SHAPES))
@pytest.mark.parametrize('cold', [True, False])
def test_plain_matches_jax_xla_and_kernel(shape, cold):
    nr, nv, n_nonneg = SHAPES[shape]
    B = 5
    args = _problem(int(cold) + nr, B, nr, nv)
    nonneg, con0, mu = _rows(nr, n_nonneg)
    bounds = np.zeros(nr, np.float32)

    cv = jsolver._apgd_dispatch_factored(nonneg, (), con0, ITERATIONS, cold)
    fn = jax.jit(lambda a: jax.vmap(cv)(*a, *[
        jnp.broadcast_to(jnp.asarray(x), (B, nr)) for x in (mu, bounds)]))
    with jax.default_matmul_precision('highest'):
        ref = [np.asarray(x) for x in fn(tuple(jnp.asarray(a)
                                                for a in args))]
    kern = [np.asarray(x) for x in japgd.apgd_iterate_factored(
        *[jnp.asarray(a) for a in args], jnp.asarray(mu),
        jnp.asarray(bounds), nonneg=nonneg, box_rows=(), con0=con0,
        iterations=ITERATIONS, cold=cold, interpret=True)]
    ours = apgd_solve.apgd_iterate_factored(
        *[torch.as_tensor(a) for a in args], torch.as_tensor(mu),
        torch.as_tensor(bounds), nonneg=nonneg, box_rows=(), con0=con0,
        iterations=ITERATIONS, cold=cold)
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
