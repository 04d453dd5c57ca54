"""Sensor helpers: the walker's and cheetah's part of
mujoco_mbrl_tpu/suite/sensors.py."""

from __future__ import annotations

from typing import List

import torch

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
