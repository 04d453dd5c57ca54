"""Analytic LQR solution for the lqr domain (a correctness oracle).

Port of mujoco_mbrl_tpu/suite/lqr_solver.py, in numpy and scipy:
discretize the linear spring-mass dynamics of the compiled model, solve
the discrete algebraic Riccati equation and return (P, K, beta), the
value matrix, the optimal gain (u = K x, x = (qpos, qvel)) and the
closed loop's spectral radius.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import torch

from ..physics import engine, make_state


def solve(env):
    """Optimal (P, K, beta) for an lqr-domain environment, from its mass
    matrix at qpos0, with the semi-implicit discretization of the JAX
    solver: with J = -M^-1 [S D],
    A = I + dt [[dt J + [0 I]], [J]] and B = dt [[dt Bc], [Bc]]."""
    m = env.model
    n, nu = m.nq, m.nu
    data = engine.forward(m, make_state(m),
                          torch.zeros((1, nu), dtype=m.dtype,
                                      device=m.device))
    mass = data.qM[0].cpu().numpy()

    stiffness = np.diag(m.jnt_stiffness.cpu().numpy())
    damping = np.diag(m.dof_damping.cpu().numpy())
    dt = float(m.opt.timestep)

    j = np.linalg.solve(-mass, np.hstack((stiffness, damping)))
    a = np.eye(2 * n) + dt * np.vstack(
        (dt * j + np.hstack((np.zeros((n, n)), np.eye(n))), j))

    # actuator moment: joint transmission with gear
    bmat = np.zeros((n, nu))
    gear = m.actuator_gear.cpu().numpy()
    for u in range(nu):
        bmat[m.jnt_dofadr[m.actuator_trnid[u]], u] = float(gear[u])
    bc = np.linalg.solve(mass, bmat)
    b = dt * np.vstack((dt * bc, bc))

    q = np.diag(np.hstack([np.ones(n), np.zeros(n)]))
    r = env.task.control_cost_coef * np.eye(nu)

    p = scipy.linalg.solve_discrete_are(a, b, q, r)
    k = -np.linalg.solve(b.T @ p @ b + r, b.T @ p @ a)
    beta = np.abs(np.linalg.eigvals(a + b @ k)).max()
    if beta >= 1.0:
        raise RuntimeError('Controlled system is unstable.')
    return p, k, beta
