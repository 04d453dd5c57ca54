"""Sensor helpers: the subtree sensors, the touch sensor and the
site-frame IMU and force-torque sensors (gyro, velocimeter,
accelerometer, force, torque) of mujoco_mbrl_tpu/suite/sensors.py, each
over the env batch."""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..physics import collision
from ..physics import math as pm
from ..physics import model as M
from ..physics import smooth


def subtree_bodies(m: M.Model, root: int) -> List[int]:
    """Bodies in the kinematic subtree rooted at `root` (inclusive)."""
    out = []
    for b in range(root, m.nbody):
        p = b
        while p >= root:
            if p == root:
                out.append(b)
                break
            p = m.body_parent[p]
    return out


def subtree_linvel(m: M.Model, data: M.Data, root: int) -> torch.Tensor:
    """(B, 3) linear velocity of the subtree's centre of mass:
    sum_b m_b (lin_b + ang_b x com_b) / sum_b m_b."""
    bodies = subtree_bodies(m, root)
    cvel = data.cvel[:, bodies]
    v = cvel[..., 3:] + torch.linalg.cross(cvel[..., :3],
                                           data.xipos[:, bodies])
    mass = m.body_mass[bodies]
    return (mass[:, None] * v).sum(1) / torch.clamp(mass.sum(), min=1e-12)


def subtree_com(m: M.Model, data: M.Data, root: int) -> torch.Tensor:
    """(B, 3) centre of mass of the subtree: sum_b m_b xipos_b / sum_b m_b."""
    bodies = subtree_bodies(m, root)
    mass = m.body_mass[bodies]
    return ((mass[:, None] * data.xipos[:, bodies]).sum(1)
            / torch.clamp(mass.sum(), min=1e-12))


def contact_layout(m: M.Model) -> List[Tuple[int, int]]:
    """Static (geom1, geom2) of each contact row, in the order
    ``collision.detect`` emits them for the model's candidate pairs."""
    pairs = collision.candidate_pairs(
        m, include_geom_geom=m.opt.enable_geom_geom_contacts)
    layout = []
    for g1, g2 in pairs:
        key = (m.geom_type[g1], m.geom_type[g2])
        layout.extend([(g1, g2)] * collision._PAIR_POINTS[key])
    return layout


def touch(m: M.Model, data: M.Data, site_id: int) -> torch.Tensor:
    """(B,) touch sensor with MuJoCo's rule (mjSENS_TOUCH): the sum of the
    normal forces of the penetrating contacts that involve a geom on the
    site's body and whose point lies inside the site's volume (sphere,
    capsule, ellipsoid; box for a box or cylinder zone), as the JAX
    function sums them. Vectorised over the env batch; only the contact
    rows on the site's body (a static subset of the layout) are read."""
    body = m.site_body[site_id]
    rows = M.cached(m, ('touch_rows', body), lambda: torch.as_tensor(
        [c for c, (g1, g2) in enumerate(contact_layout(m))
         if body in (m.geom_body[g1], m.geom_body[g2])],
        dtype=torch.long, device=m.device))
    if not len(rows):
        return torch.zeros_like(data.xpos[:, 0, 0])
    stype = m.site_type[site_id]
    size = m.site_size[site_id]
    R = data.ximat[:, body] @ pm.quat_to_mat(m.site_quat[site_id])
    # the contact points in the site's frame: (B, n, 3)
    p = torch.einsum('nci,nij->ncj', data.contact_pos[:, rows]
                     - data.site_xpos[:, site_id, None], R)
    if stype == M.SPHERE:
        inside = ((p / size[0]) ** 2).sum(-1) <= 1.0
    elif stype == M.CAPSULE:
        z = torch.clamp(p[..., 2], -size[1], size[1])
        inside = (p[..., 0] ** 2 + p[..., 1] ** 2
                  + (p[..., 2] - z) ** 2) <= size[0] ** 2
    elif stype == M.ELLIPSOID:
        inside = ((p / size) ** 2).sum(-1) <= 1.0
    else:
        inside = (p.abs() <= size).all(-1)
    hit = inside & (data.contact_dist[:, rows] < 0)
    force = torch.clamp(data.contact_force[:, rows, 0], min=0.0)
    return (hit.to(force.dtype) * force).sum(1)


# ---- site-frame IMU and force-torque sensors (the quadruped's) ----------


def site_xmat(m: M.Model, data: M.Data, site_id: int) -> torch.Tensor:
    """(B, 3, 3) world rotation of a site: its body's times its offset."""
    return data.ximat[:, m.site_body[site_id]] @ pm.quat_to_mat(
        m.site_quat[site_id])


def _in_site_frame(m, data, site_id, v):
    """World vectors v (B, 3) in the site's frame: R' v."""
    return torch.einsum('bji,bj->bi', site_xmat(m, data, site_id), v)


def gyro(m: M.Model, data: M.Data, site_id: int) -> torch.Tensor:
    """(B, 3) angular velocity of the site's body, in the site frame."""
    return _in_site_frame(m, data, site_id,
                          data.cvel[:, m.site_body[site_id], :3])


def _point_velocity(v6, p):
    """Linear velocity at points p of spatial velocities v6 about the
    origin: lin + ang x p."""
    return v6[..., 3:] + torch.linalg.cross(v6[..., :3], p)


def velocimeter(m: M.Model, data: M.Data, site_id: int) -> torch.Tensor:
    """(B, 3) linear velocity of the site point, in the site frame."""
    v = _point_velocity(data.cvel[:, m.site_body[site_id]],
                        data.site_xpos[:, site_id])
    return _in_site_frame(m, data, site_id, v)


def body_cacc(m: M.Model, data: M.Data, qvel: torch.Tensor) -> torch.Tensor:
    """(B, nbody, 6) spatial accelerations (world frame, about the origin):
    cacc[b] = cacc[parent] + sum_k cdof[k] qacc[k] + cdof_dot[k] qvel[k],
    the root seeded with -gravity so a body at rest reads +|g| on a z-up
    accelerometer (mjSENS_ACCELEROMETER)."""
    meta = smooth.tree_meta(m)
    B, dt = data.cvel.shape[0], data.cvel.dtype
    a0 = torch.cat([torch.zeros(3, dtype=dt, device=data.cvel.device),
                    -m.opt.gravity.to(dt)]).expand(B, 6)
    acc = [a0]
    for b in range(1, m.nbody):
        a = acc[m.body_parent[b]]
        for k in meta.body_dofs[b]:
            a = (a + data.cdof[:, k] * data.qacc[:, k, None]
                 + data.cdof_dot[:, k] * qvel[:, k, None])
        acc.append(a)
    return torch.stack(acc, 1)


def accelerometer(m: M.Model, data: M.Data, qvel: torch.Tensor,
                  site_id: int) -> torch.Tensor:
    """(B, 3) proper linear acceleration of the site point in the site
    frame: a(p) = A_lin + A_ang x p + w x v(p) from the body's spatial
    acceleration A about the origin."""
    b = m.site_body[site_id]
    A = body_cacc(m, data, qvel)[:, b]
    v6 = data.cvel[:, b]
    p = data.site_xpos[:, site_id]
    a_p = (A[:, 3:] + torch.linalg.cross(A[:, :3], p)
           + torch.linalg.cross(v6[:, :3], _point_velocity(v6, p)))
    return _in_site_frame(m, data, site_id, a_p)


def _contact_signs(m: M.Model, body: int) -> torch.Tensor:
    """(C,) +1 where the contact's second geom is on `body` (the normal
    points g1 -> g2), -1 where its first is, else 0."""
    def build():
        return torch.as_tensor(
            [1.0 if m.geom_body[g2] == body else
             -1.0 if m.geom_body[g1] == body else 0.0
             for g1, g2 in contact_layout(m)], device=m.device)
    return M.cached(m, ('contact_signs', body), build)


def _world_contact_forces(data: M.Data) -> torch.Tensor:
    """(B, C, 3) contact forces in the world: frame' (fn, ft1, ft2)."""
    return torch.einsum('bci,bcij->bcj', data.contact_force,
                        data.contact_frame)


def contact_force_on_body(m: M.Model, data: M.Data,
                          body: int) -> torch.Tensor:
    """(B, 3) net world-frame contact force on `body`'s geoms from the
    solver's per-contact forces: +frame' f on body(g2), -frame' f on
    body(g1)."""
    sign = _contact_signs(m, body).to(data.contact_force.dtype)
    return (sign[:, None] * _world_contact_forces(data)).sum(1)


def force_site(m: M.Model, data: M.Data, site_id: int) -> torch.Tensor:
    """(B, 3) the ground reaction on the site's body in the site frame:
    mjSENS_FORCE approximated by the net contact force on the body, as
    the JAX function does (the toes' mass is negligible beside it)."""
    f = contact_force_on_body(m, data, m.site_body[site_id])
    return _in_site_frame(m, data, site_id, f)


def torque_site(m: M.Model, data: M.Data, site_id: int) -> torch.Tensor:
    """(B, 3) contact torque about the site point, in the site frame (the
    same approximation as ``force_site``)."""
    sign = _contact_signs(m, m.site_body[site_id]).to(
        data.contact_force.dtype)
    fw = sign[:, None] * _world_contact_forces(data)
    r = data.contact_pos - data.site_xpos[:, site_id, None]
    tau = torch.linalg.cross(r, fw).sum(1)
    return _in_site_frame(m, data, site_id, tau)
