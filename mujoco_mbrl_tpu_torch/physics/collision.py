"""Collision detection: static candidate pairs -> fixed-size contact set.

Port of mujoco_mbrl_tpu/physics/collision.py for plane-capsule pairs (the
walker's only colliding pairs: 7 pairs, 2 points each, 14 contacts). The
candidate list is static per model; inactive contacts are masked by
distance downstream. Any other geom pair type raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from . import model as M


class Contact(NamedTuple):
    """Potential contacts, batched over envs (B leading) where noted."""
    dist: torch.Tensor      # (B, C) signed distance (negative = penetrating)
    pos: torch.Tensor       # (B, C, 3)
    frame: torch.Tensor     # (B, C, 3, 3) rows: normal, tangent1, tangent2
    geom1: Tuple[int, ...]
    geom2: Tuple[int, ...]
    friction: torch.Tensor  # (C, 3)
    solref: torch.Tensor    # (C, 2)
    solimp: torch.Tensor    # (C, 5)


# pair types the JAX package collides, with their contact point counts
_PAIR_POINTS = {
    (M.PLANE, M.SPHERE): 1, (M.PLANE, M.CAPSULE): 2, (M.PLANE, M.BOX): 4,
    (M.PLANE, M.ELLIPSOID): 1, (M.SPHERE, M.SPHERE): 1,
    (M.SPHERE, M.CAPSULE): 1, (M.CAPSULE, M.CAPSULE): 1,
    (M.SPHERE, M.BOX): 1, (M.CAPSULE, M.BOX): 2, (M.BOX, M.BOX): 8,
    (M.HFIELD, M.SPHERE): 1, (M.HFIELD, M.CAPSULE): 2,
    (M.HFIELD, M.ELLIPSOID): 1,
}


def body_weldid(m: M.Model) -> List[int]:
    """Ancestor reached by walking up through jointless bodies."""
    has_joint = set(m.jnt_body)
    weld = [0] * m.nbody
    for b in range(1, m.nbody):
        w = b
        while w != 0 and w not in has_joint:
            w = m.body_parent[w]
        weld[b] = w
    return weld


def candidate_pairs(m: M.Model,
                    include_geom_geom: bool = True) -> List[Tuple[int, int]]:
    """Static candidate list (same-weld, parent-child, contype filters)."""
    excludes = frozenset(m.contact_excludes)
    weld = body_weldid(m)
    pweld = [weld[m.body_parent[w]] for w in weld]
    pairs = []
    for g1 in range(m.ngeom):
        for g2 in range(g1 + 1, m.ngeom):
            b1, b2 = m.geom_body[g1], m.geom_body[g2]
            w1, w2 = weld[b1], weld[b2]
            if w1 == w2:
                continue
            if (b1, b2) in excludes or (b2, b1) in excludes:
                continue
            if w1 != 0 and w2 != 0 and (pweld[b1] == w2 or pweld[b2] == w1):
                continue
            if not ((m.geom_contype[g1] & m.geom_conaffinity[g2]) or
                    (m.geom_contype[g2] & m.geom_conaffinity[g1])):
                continue
            t1, t2 = m.geom_type[g1], m.geom_type[g2]
            key = (t1, t2) if (t1, t2) in _PAIR_POINTS else (t2, t1)
            if key not in _PAIR_POINTS:
                continue
            if (not include_geom_geom and M.PLANE not in (t1, t2)
                    and M.HFIELD not in (t1, t2)):
                continue
            pairs.append((g1, g2) if (t1, t2) == key else (g2, g1))
    return pairs


def _combine_batched(m: M.Model, ga: np.ndarray, gb: np.ndarray):
    """Combined friction/solref/solimp per pair (mju_combine semantics)."""
    pri = np.asarray(m.geom_priority)
    dev = m.device
    take1 = torch.as_tensor(pri[ga] > pri[gb], device=dev)[:, None]
    take2 = torch.as_tensor(pri[gb] > pri[ga], device=dev)[:, None]
    s1, s2 = m.geom_solmix[ga], m.geom_solmix[gb]
    mix = (s1 / torch.clamp(s1 + s2, min=1e-12))[:, None]

    def pick(field, mixed):
        a, b = field[ga], field[gb]
        return torch.where(take1, a, torch.where(take2, b, mixed(a, b)))

    friction = pick(m.geom_friction, torch.maximum)
    solref = pick(m.geom_solref, lambda a, b: mix * a + (1 - mix) * b)
    solimp = pick(m.geom_solimp, lambda a, b: mix * a + (1 - mix) * b)
    return friction, solref, solimp


def _tangent_frame(n: torch.Tensor):
    """Orthonormal (t1, t2) completing normals n (..., 3)."""
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    ref = torch.where((n[..., :1].abs() < 0.5), ex, ey)
    t1 = torch.linalg.cross(n, ref)
    t1 = t1 / torch.clamp(torch.linalg.vector_norm(t1, dim=-1, keepdim=True),
                          min=1e-12)
    return t1, torch.linalg.cross(n, t1)


def detect(m: M.Model, geom_xpos, geom_xmat,
           pairs: List[Tuple[int, int]]) -> Contact:
    """Evaluate all candidate pairs -> Contact with C rows in pair order."""
    for g1, g2 in pairs:
        if (m.geom_type[g1], m.geom_type[g2]) != (M.PLANE, M.CAPSULE):
            raise NotImplementedError(
                'only plane-capsule contacts are ported '
                '(mujoco_mbrl_tpu.physics.collision.detect)')

    def build():
        ga = np.array([g1 for g1, _ in pairs])
        gb = np.array([g2 for _, g2 in pairs])
        row_pair = np.repeat(np.arange(len(pairs)), 2)
        friction, solref, solimp = _combine_batched(m, ga, gb)
        idx = lambda a: torch.as_tensor(a, device=m.device)
        return (idx(ga), idx(gb), m.geom_size[gb, 0][:, None],
                m.geom_size[gb, 1][:, None],
                tuple(int(ga[i]) for i in row_pair),
                tuple(int(gb[i]) for i in row_pair),
                friction[row_pair], solref[row_pair], solimp[row_pair])

    (ga, gb, r, half, geom1, geom2, friction, solref,
     solimp) = M.cached(m, ('plane_capsule', tuple(pairs)), build)
    # plane normal vs the capsule's two end caps as spheres
    # (_k_plane_capsule): dist = n.(end - plane_pos) - r
    n = geom_xmat[:, ga, :, 2][:, :, None, :]            # (B, P, 1, 3)
    p1 = geom_xpos[:, ga][:, :, None, :]
    axis = geom_xmat[:, gb, :, 2]
    ends = torch.stack([geom_xpos[:, gb] - half * axis,
                        geom_xpos[:, gb] + half * axis], dim=2)  # (B,P,2,3)
    dist = ((ends - p1) * n).sum(-1) - r                 # (B, P, 2)
    pos = ends - (r[:, :, None] + 0.5 * dist[..., None]) * n
    B, P = dist.shape[:2]
    nrm = n.expand(B, P, 2, 3).reshape(B, 2 * P, 3)
    t1, t2 = _tangent_frame(nrm)
    return Contact(dist=dist.reshape(B, 2 * P), pos=pos.reshape(B, 2 * P, 3),
                   frame=torch.stack([nrm, t1, t2], dim=2),
                   geom1=geom1, geom2=geom2, friction=friction,
                   solref=solref, solimp=solimp)
