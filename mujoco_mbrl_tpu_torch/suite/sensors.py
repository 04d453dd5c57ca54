"""Sensor helpers: the subtree sensors and the touch sensor of
mujoco_mbrl_tpu/suite/sensors.py."""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..physics import collision
from ..physics import math as pm
from ..physics import model as M


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
