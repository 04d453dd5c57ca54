"""Analytic LQR solution for the lqr domain (a correctness oracle).

Port of mujoco_mbrl_tpu/suite/lqr_solver.py, in numpy: discretize the
linear spring-mass dynamics of the compiled model, solve the discrete
algebraic Riccati equation (SciPy's solver, or ``solve_dare_iter`` where
SciPy cannot be imported) and return (P, K, beta), the value matrix, the
optimal gain (u = K x, x = (qpos, qvel)) and the closed loop's spectral
radius.
"""

from __future__ import annotations

import numpy as np
import torch

from ..physics import engine, make_state


def solve_dare_iter(a, b, q, r, iters: int = 1_000_000, tol: float = 1e-12):
    """DARE by fixed-point iteration (used when SciPy is unavailable)."""
    p = np.eye(len(a))
    for _ in range(iters):
        a_p = a.T @ p
        a_p_b = a_p @ b
        p_next = q + a_p @ a - a_p_b @ np.linalg.solve(
            b.T @ p @ b + r, a_p_b.T)
        p_next = 0.5 * (p_next + p_next.T)
        if np.abs(p - p_next).max() < tol:
            p = p_next
            break
        p = p_next
    np.linalg.cholesky(p)   # raises if not PD
    return p


def _discretize(env):
    """(A, B, Q, R) of the DARE for an lqr-domain environment, from its
    mass matrix at qpos0, with the semi-implicit discretization of the JAX
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
    return a, b, q, r


def solve(env):
    """Optimal (P, K, beta) for an lqr-domain environment (`_discretize`'s
    DARE)."""
    a, b, q, r = _discretize(env)
    try:
        from scipy.linalg import solve_discrete_are
    except ImportError:         # no SciPy: the fixed-point iteration
        solve_discrete_are = solve_dare_iter
    p = solve_discrete_are(a, b, q, r)
    k = -np.linalg.solve(b.T @ p @ b + r, b.T @ p @ a)
    beta = np.abs(np.linalg.eigvals(a + b @ k)).max()
    if beta >= 1.0:
        raise RuntimeError('Controlled system is unstable.')
    return p, k, beta
