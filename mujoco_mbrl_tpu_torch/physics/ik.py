"""Inverse kinematics: damped least-squares site-pose solver.

Port of mujoco_mbrl_tpu/physics/ik.py, batched over envs: the site's
translational Jacobian from ``solver._site_jacobian`` on the model's
ancestor-dof mask, a damped least-squares update of a fixed number of
steps (the JAX ``lax.scan``; no early exit), and ``engine.integrate_pos``
for the update, so free joints turn on the sphere. Runs on the model's
device.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import engine, model as M, smooth
from .solver import _site_jacobian, ancestor_dof_mask


def site_jacobian(m: M.Model, qpos: torch.Tensor, site_id: int):
    """((B, 3, nv) translational Jacobian of the site, (B, 3) its world
    position) at qpos (B, nq)."""
    meta = smooth.tree_meta(m)
    (xpos, xquat, xmat, geom_xpos, geom_xmat, site_xpos, xanchor,
     xaxis) = smooth.kinematics(m, qpos, meta)
    cdof = smooth.motion_subspace(m, xquat, xanchor, xaxis, meta)
    amask = M.cached(m, 'ancestor_mask', lambda: torch.as_tensor(
        ancestor_dof_mask(m, meta), dtype=qpos.dtype, device=qpos.device))
    pos = site_xpos[:, site_id]
    J = _site_jacobian(cdof, m.site_body[site_id], pos, amask)
    return J.transpose(1, 2), pos


def qpos_from_site_pose(m: M.Model, site_name: str,
                        target_pos: torch.Tensor,
                        qpos0: Optional[torch.Tensor] = None,
                        max_steps: int = 50,
                        damping: float = 0.03,
                        max_update_norm: float = 2.0,
                        progress_thresh: float = 20.0):
    """qpos placing `site_name` at `target_pos`, per env.

    ``target_pos`` (3,) or (B, 3); ``qpos0`` (nq,) or (B, nq), the model's
    qpos0 when None. Returns (qpos (B, nq), the error norm (B,) at the
    start of the last step), as JAX returns its scan's last error.
    ``progress_thresh`` is accepted for the JAX signature; as there, the
    fixed step count replaces the reference's early exits.
    """
    site_id = m.name2id('site', site_name)
    qpos = m.qpos0 if qpos0 is None else torch.as_tensor(
        qpos0, dtype=m.dtype, device=m.device)
    target = torch.as_tensor(target_pos, dtype=m.dtype, device=m.device)
    B = max(qpos.shape[0] if qpos.dim() == 2 else 1,
            target.shape[0] if target.dim() == 2 else 1)
    qpos = qpos.expand(B, m.nq).clone()
    target = target.expand(B, 3)
    eye = torch.eye(3, dtype=qpos.dtype, device=qpos.device)
    err_norm = torch.zeros((B,), dtype=qpos.dtype, device=qpos.device)
    for _ in range(max_steps):
        J, pos = site_jacobian(m, qpos, site_id)
        err = target - pos
        # damped least squares: dq = J' (J J' + damping^2 I)^-1 err
        A = J @ J.transpose(1, 2) + (damping ** 2) * eye
        dq = (J.transpose(1, 2)
              @ torch.linalg.solve(A, err[..., None]))[..., 0]
        norm = torch.linalg.vector_norm(dq, dim=-1, keepdim=True)
        scale = torch.clamp(max_update_norm / torch.clamp(norm, min=1e-10),
                            max=1.0)
        qpos = engine.integrate_pos(m, qpos, dq * scale, 1.0)
        err_norm = torch.linalg.vector_norm(err, dim=-1)
    return qpos, err_norm
