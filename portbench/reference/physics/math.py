"""Quaternion and 6D spatial algebra (port of mujoco_mbrl_tpu/physics/math.py).

Every function broadcasts over leading dimensions (``...``): the env batch
and per-body axes are written out where the JAX package used ``vmap``.

Conventions: quaternions are ``(w, x, y, z)`` rotating local -> world;
spatial motion vectors are ``(angular, linear)`` in the world frame about
the origin, spatial forces ``(torque, force)``.
"""

from __future__ import annotations

import torch


def quat_mul(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Hamilton product u*v of wxyz quaternions (..., 4)."""
    w1, x1, y1, z1 = u.unbind(-1)
    w2, x2, y2, z2 = v.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (inverse of a unit quaternion) of wxyz quaternions."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate 3-vectors v by quaternions q (local -> world)."""
    u = q[..., 1:]
    w = q[..., :1]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v)
    return v + 2.0 * torch.linalg.cross(u, uv + w * v)


def quat_rot_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate 3-vectors v by q^-1 (world -> local)."""
    return quat_rot(quat_conj(q), v)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """`v` (..., n) over its norm along the last axis, floored at eps."""
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(
        eps)


def axis_angle_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Quaternions (..., 4) rotating by `angle` (...) about unit `axis`
    (..., 3)."""
    half = 0.5 * angle
    return torch.cat([torch.cos(half)[..., None],
                      axis * torch.sin(half)[..., None]], dim=-1)


def quat_integrate(q: torch.Tensor, omega_local: torch.Tensor,
                   dt) -> torch.Tensor:
    """Rotate q (..., 4) by the local angular velocity (..., 3) over dt,
    then renormalize (``mju_quatIntegrate``); a zero velocity takes the x
    axis, as the JAX function does."""
    norm = torch.linalg.vector_norm(omega_local, dim=-1)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=q.dtype, device=q.device)
    moving = (norm > 1e-12)[..., None]
    axis = torch.where(moving, omega_local / torch.where(
        moving, norm[..., None], 1.0), ex)
    out = quat_mul(q, axis_angle_quat(axis, norm * dt))
    return quat_normalize(out)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrices (columns = local axes in world)."""
    w, x, y, z = q.unbind(-1)
    rows = [
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ]
    return torch.stack(rows, dim=-2)


def skew(v: torch.Tensor) -> torch.Tensor:
    """Cross-product matrices [v]x (..., 3, 3)."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], dim=-2)


def motion_cross(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Spatial cross product v x m for motion vectors (..., 6)."""
    v, m = torch.broadcast_tensors(v, m)
    ang = torch.linalg.cross(v[..., :3], m[..., :3])
    lin = (torch.linalg.cross(v[..., 3:], m[..., :3])
           + torch.linalg.cross(v[..., :3], m[..., 3:]))
    return torch.cat([ang, lin], dim=-1)


def force_cross(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial cross product v x* f for force vectors (..., 6)."""
    ang = (torch.linalg.cross(v[..., :3], f[..., :3])
           + torch.linalg.cross(v[..., 3:], f[..., 3:]))
    lin = torch.linalg.cross(v[..., :3], f[..., 3:])
    return torch.cat([ang, lin], dim=-1)


def spatial_inertia(mass: torch.Tensor, inertia_world: torch.Tensor,
                    com_world: torch.Tensor) -> torch.Tensor:
    """(..., 6, 6) spatial inertia about the world origin."""
    cx = skew(com_world)
    m = mass[..., None, None]
    top_left = inertia_world + m * (cx @ cx.transpose(-1, -2))
    top_right = m * cx
    bot_left = m * cx.transpose(-1, -2)
    eye = torch.eye(3, dtype=inertia_world.dtype,
                    device=inertia_world.device)
    bot_right = (m * eye).expand_as(top_left)
    top = torch.cat([top_left, top_right], dim=-1)
    bot = torch.cat([bot_left, bot_right], dim=-1)
    return torch.cat([top, bot], dim=-2)
