"""Collision detection: static candidate pairs -> fixed-size contact set.

Port of mujoco_mbrl_tpu/physics/collision.py for plane-capsule pairs (2
points each), plane-sphere, sphere-sphere, sphere-capsule and
capsule-capsule pairs (1 point each), the box pairs: plane-box (the 4
deepest corners), sphere-box (1), capsule-box (the 2 deepest of the axis'
ends and midpoint) and box-box (each box's 4 deepest corners against the
other, 8), on the signed point-box distance ``_point_box``; plane-ellipsoid
(the support point along the plane's normal), and the heightfield pairs
against the terrain's local tangent plane (``hfield_height_normal``:
bilinear heights, a central-difference normal): hfield-sphere (1),
hfield-capsule (the end caps, 2) and hfield-ellipsoid (1). The walker's 7
plane-capsule pairs (14 contacts), the cheetah's 8 plane-capsule and 19
capsule-capsule pairs (35 contacts), the humanoid's 161 pairs of the first
five kinds (177 contacts), manipulator insert_peg's 203 pairs (275
contacts), stacker stack_4's 175 (323), quadruped walk's 133 contacts and
escape's 162 (its terrain per env). The candidate list is static per
model; inactive contacts are masked by distance downstream.
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


def _dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x * y).sum(-1)


def _segment(xpos, xmat, half):
    """World end points of capsule axes: xpos (B, P, 3), half (P, 1)."""
    axis = xmat[..., :, 2]
    return xpos - half * axis, xpos + half * axis


def _closest_segment_segment(a0, a1, b0, b1):
    """Closest points between segments [a0, a1] and [b0, b1] (..., 3):
    the JAX ``_closest_segment_segment`` clamped solve, in its order (s
    from the unclamped solve, t from s and clamped, s again from the
    clamped t; a near-parallel pair takes s = 0 first)."""
    d1, d2, r = a1 - a0, b1 - b0, a0 - b0
    a, e, f = _dot(d1, d1), _dot(d2, d2), _dot(d2, r)
    c, b = _dot(d1, r), _dot(d1, d2)
    denom = a * e - b * b
    s = torch.where(denom > 1e-12, torch.clamp(
        (b * f - c * e) / torch.clamp(denom, min=1e-12), 0.0, 1.0), 0.0)
    t = torch.clamp((b * s + f) / torch.clamp(e, min=1e-12), 0.0, 1.0)
    s = torch.clamp((b * t - c) / torch.clamp(a, min=1e-12), 0.0, 1.0)
    return a0 + d1 * s[..., None], b0 + d2 * t[..., None]


def _sphere_pair(c1, r1, c2, r2):
    """Contact of spheres (c1, r1) and (c2, r2), shapes (B, P, 3) and
    (P,): the normal points from the first to the second, the point lies
    halfway through the overlap. Returns (dist, pos, normal), (B, P, 1,
    ...)."""
    dvec = c2 - c1
    dist = torch.linalg.vector_norm(dvec, dim=-1)        # (B, P)
    n = dvec / torch.clamp(dist, min=1e-12)[..., None]
    d = dist - (r1 + r2)
    pos = c1 + n * (r1 + 0.5 * d)[..., None]
    return d[..., None], pos[:, :, None], n[:, :, None]


def _k_plane_sphere(p1, R1, s1, p2, R2, s2):
    """Plane normal vs the sphere (JAX ``_k_plane_sphere``): dist =
    n.(centre - plane_pos) - r. Returns (dist, pos, normal), (B, P, 1,
    ...)."""
    n = R1[..., :, 2]                                    # (B, P, 3)
    r = s2[:, 0]                                         # (P,)
    dist = ((p2 - p1) * n).sum(-1) - r                   # (B, P)
    pos = p2 - (r + 0.5 * dist)[..., None] * n
    return dist[..., None], pos[:, :, None], n[:, :, None]


def _k_sphere_sphere(p1, R1, s1, p2, R2, s2):
    """JAX ``_k_sphere_sphere``: one contact between the centres."""
    return _sphere_pair(p1, s1[:, 0], p2, s2[:, 0])


def _k_sphere_capsule(p1, R1, s1, p2, R2, s2):
    """JAX ``_k_sphere_capsule``: the sphere against the closest point of
    the capsule's axis (clamped projection onto the segment)."""
    e0, e1 = _segment(p2, R2, s2[:, 1:2])
    d = e1 - e0
    t = torch.clamp(_dot(p1 - e0, d) / torch.clamp(_dot(d, d), min=1e-12),
                    0.0, 1.0)
    return _sphere_pair(p1, s1[:, 0], e0 + t[..., None] * d, s2[:, 0])


def _k_plane_capsule(p1, R1, s1, p2, R2, s2):
    """Plane normal vs the capsule's two end caps as spheres:
    dist = n.(end - plane_pos) - r. Returns (dist, pos, normal), each
    (B, P, 2, ...)."""
    n = R1[..., :, 2][:, :, None, :]                     # (B, P, 1, 3)
    r = s2[:, 0:1]                                       # (P, 1)
    e0, e1 = _segment(p2, R2, s2[:, 1:2])
    ends = torch.stack([e0, e1], dim=2)                  # (B, P, 2, 3)
    dist = ((ends - p1[:, :, None, :]) * n).sum(-1) - r  # (B, P, 2)
    pos = ends - (r[:, :, None] + 0.5 * dist[..., None]) * n
    return dist, pos, n.expand(pos.shape)


def _k_capsule_capsule(p1, R1, s1, p2, R2, s2):
    """One contact between the axes' closest points (JAX
    ``_k_capsule_capsule``). Returns (dist, pos, normal), (B, P, 1, ...)."""
    c1, c2 = _closest_segment_segment(*_segment(p1, R1, s1[:, 1:2]),
                                      *_segment(p2, R2, s2[:, 1:2]))
    return _sphere_pair(c1, s1[:, 0], c2, s2[:, 0])


def _mat_t_vec(R, v):
    """R' v for rotations R (..., 3, 3) and vectors v (..., 3)."""
    return torch.einsum('...ji,...j->...i', R, v)


def _mat_vec(R, v):
    return torch.einsum('...ij,...j->...i', R, v)


def _point_box(p_loc, size):
    """Signed distance of points p_loc (..., 3) to the surface of boxes
    of half-sizes ``size`` in their frames (JAX ``_point_box``): (dist,
    outward normal n_loc) with dist < 0 inside, where the normal is the
    nearest face's (the first of equally near ones)."""
    c = torch.minimum(torch.maximum(p_loc, -size), size)
    out_vec = p_loc - c
    out_d = torch.linalg.vector_norm(out_vec, dim=-1)
    outside = out_d > 1e-9
    face_d = size - p_loc.abs()                 # >= 0 inside
    fmin, ax = face_d.min(-1)
    eye = torch.eye(3, dtype=p_loc.dtype, device=p_loc.device)
    n_in = eye[ax] * torch.sign(p_loc.gather(-1, ax[..., None]))
    n = torch.where(outside[..., None],
                    out_vec / torch.clamp(out_d, min=1e-12)[..., None], n_in)
    return torch.where(outside, out_d, -fmin), n


def _deepest(d, pos, n, k):
    """The k points of smallest distance, in a stable order (JAX's
    argsort): d (..., q), pos / n (..., q, 3)."""
    order = torch.argsort(d, dim=-1, stable=True)[..., :k]
    take = lambda x: x.gather(-2, order[..., None].expand(
        order.shape + (3,)))
    return d.gather(-1, order), take(pos), take(n)


# box corners, sign patterns in x-major order
_BOX_SIGNS = [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
              for sz in (-1, 1)]


def _box_corners(p, R, size):
    """World corners (B, P, 8, 3) of boxes at p (B, P, 3), R, size (P, 3)."""
    signs = torch.tensor(_BOX_SIGNS, dtype=p.dtype, device=p.device)
    local = signs * size[:, None, :]                     # (P, 8, 3)
    return p[:, :, None, :] + torch.einsum('pkj,bpij->bpki', local, R)


def _k_plane_box(p1, R1, s1, p2, R2, s2):
    """The box's 4 deepest corners against the plane (JAX
    ``_k_plane_box``). Returns (dist, pos, normal), (B, P, 4, ...)."""
    n = R1[..., :, 2][:, :, None, :]                     # (B, P, 1, 3)
    world = _box_corners(p2, R2, s2)
    ds = ((world - p1[:, :, None, :]) * n).sum(-1)       # (B, P, 8)
    d, w, _ = _deepest(ds, world, world, 4)
    return d, w - 0.5 * d[..., None] * n, n.expand(w.shape)


def _support(R2, s2, n):
    """The ellipsoid's extent r along unit normals n (B, P, 3) and its
    point p_loc (in its frame) deepest against them: with n~ = R2' n in
    the frame, r = |diag(s) n~| and p_loc = -diag(s^2) n~ / r."""
    scaled = s2 * _mat_t_vec(R2, n)
    r = torch.sqrt((scaled * scaled).sum(-1) + 1e-24)
    return r, -(s2 * scaled) / r[..., None]


def _k_plane_ellipsoid(p1, R1, s1, p2, R2, s2):
    """The ellipsoid's support point along the plane's normal (JAX
    ``_k_plane_ellipsoid``): dist = n.(centre - plane_pos) - r. (B, P, 1,
    ...)."""
    n = R1[..., :, 2]
    r, p_loc = _support(R2, s2, n)
    d = ((p2 - p1) * n).sum(-1) - r
    pos = p2 + _mat_vec(R2, p_loc) - 0.5 * d[..., None] * n
    return d[..., None], pos[:, :, None], n[:, :, None]


def _k_sphere_box(p1, R1, s1, p2, R2, s2):
    """The sphere's centre against the box (JAX ``_k_sphere_box``); the
    normal points from the sphere to the box. (B, P, 1, ...)."""
    r = s1[:, 0]
    d_pt, n_loc = _point_box(_mat_t_vec(R2, p1 - p2), s2)
    d = d_pt - r
    n = -_mat_vec(R2, n_loc)
    pos = p1 + n * (r + 0.5 * d)[..., None]
    return d[..., None], pos[:, :, None], n[:, :, None]


def _k_capsule_box(p1, R1, s1, p2, R2, s2):
    """The 2 deepest of the capsule axis' ends and midpoint, each a sphere
    against the box (JAX ``_k_capsule_box``). (B, P, 2, ...)."""
    r = s1[:, 0][:, None]                                # (P, 1)
    e0, e1 = _segment(p1, R1, s1[:, 1:2])
    pts = torch.stack([e0, 0.5 * (e0 + e1), e1], 2)      # (B, P, 3, 3)
    R2e = R2[:, :, None]
    d_pt, n_loc = _point_box(_mat_t_vec(R2e, pts - p2[:, :, None]),
                             s2[:, None, :])
    d = d_pt - r
    n = -_mat_vec(R2e, n_loc)
    return _deepest(d, pts + n * (r + 0.5 * d)[..., None], n, 2)


def _k_box_box(p1, R1, s1, p2, R2, s2):
    """Each box's 4 deepest corners against the other box, the second
    box's first (JAX ``_k_box_box``); the normal points from the first
    box to the second. (B, P, 8, ...)."""
    def corners_vs(pa, Ra, sa, pb, Rb, sb, sign):
        w = _box_corners(pb, Rb, sb)                     # (B, P, 8, 3)
        Rae = Ra[:, :, None]
        d, n_loc = _point_box(_mat_t_vec(Rae, w - pa[:, :, None]),
                              sa[:, None, :])
        n = sign * _mat_vec(Rae, n_loc)
        return _deepest(d, w - 0.5 * d[..., None] * n, n, 4)

    a = corners_vs(p1, R1, s1, p2, R2, s2, 1.0)
    b = corners_vs(p2, R2, s2, p1, R1, s1, -1.0)
    return tuple(torch.cat([x, y], 2) for x, y in zip(a, b))


# ---- the heightfield (quadruped escape): one per model, its data shared
# (nrow, ncol) or per env (B, nrow, ncol) -------------------------------


def hfield_height(m: M.Model, x, y):
    """Terrain height at world (x, y), each (B, ...): the bilinear
    interpolation of the env's grid (JAX ``hfield_height_normal``'s
    ``sample``), the grid clamped to its last cell."""
    rx, ry, z_top = m.hfield_size[0], m.hfield_size[1], m.hfield_size[2]
    px, py, pz = m.hfield_pos[0], m.hfield_pos[1], m.hfield_pos[2]
    nrow, ncol = m.hfield_nrow, m.hfield_ncol
    u = (x - px + rx) / (2.0 * rx) * (ncol - 1)
    v = (y - py + ry) / (2.0 * ry) * (nrow - 1)
    u = torch.clamp(u, 0.0, ncol - 1.001)
    v = torch.clamp(v, 0.0, nrow - 1.001)
    u0, v0 = torch.floor(u), torch.floor(v)
    fu, fv = u - u0, v - v0
    i00 = v0.long() * ncol + u0.long()
    data = m.hfield_data
    if data.dim() == 2:
        flat = data.reshape(-1)
        at = lambda i: flat[i]
    else:
        flat = data.reshape(data.shape[0], -1)
        at = lambda i: torch.gather(flat, 1, i.reshape(i.shape[0], -1)
                                    ).reshape(i.shape)
    h00, h01 = at(i00), at(i00 + 1)
    h10, h11 = at(i00 + ncol), at(i00 + ncol + 1)
    h = ((1 - fv) * ((1 - fu) * h00 + fu * h01)
         + fv * ((1 - fu) * h10 + fu * h11))
    return h * z_top + pz


def hfield_height_normal(m: M.Model, x, y):
    """Terrain height (B, ...) and outward unit normal (B, ..., 3) at
    world (x, y): the normal from central differences one grid cell wide
    (JAX ``hfield_height_normal``)."""
    rx, ry = m.hfield_size[0], m.hfield_size[1]
    eps_x = 2.0 * rx / (m.hfield_ncol - 1)
    eps_y = 2.0 * ry / (m.hfield_nrow - 1)
    # the five samples in one gather: the point and its four neighbours
    xs = torch.stack([x, x + eps_x, x - eps_x, x, x], -1)
    ys = torch.stack([y, y, y, y + eps_y, y - eps_y], -1)
    hs = hfield_height(m, xs, ys)
    dhdx = (hs[..., 1] - hs[..., 2]) / (2 * eps_x)
    dhdy = (hs[..., 3] - hs[..., 4]) / (2 * eps_y)
    n = torch.stack([-dhdx, -dhdy, torch.ones_like(dhdx)], -1)
    return hs[..., 0], n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)


def _hf_point(m, point, radius):
    """Spheres of `radius` at points (B, ..., 3) against the terrain's
    tangent plane under them (JAX ``_hf_point``)."""
    h, n = hfield_height_normal(m, point[..., 0], point[..., 1])
    q = torch.stack([point[..., 0], point[..., 1], h], -1)
    dist = (n * (point - q)).sum(-1) - radius
    return dist, point - n * (radius + 0.5 * dist)[..., None], n


def _k_hfield_sphere(m):
    def kernel(p1, R1, s1, p2, R2, s2):
        d, pos, n = _hf_point(m, p2, s2[:, 0])
        return d[..., None], pos[:, :, None], n[:, :, None]
    return kernel


def _k_hfield_capsule(m):
    """The capsule's two end caps against the terrain. (B, P, 2, ...)."""
    def kernel(p1, R1, s1, p2, R2, s2):
        ends = torch.stack(_segment(p2, R2, s2[:, 1:2]), 2)   # (B, P, 2, 3)
        return _hf_point(m, ends, s2[:, 0:1])
    return kernel


def _k_hfield_ellipsoid(m):
    """The ellipsoid's support point against the tangent plane under its
    centre. (B, P, 1, ...)."""
    def kernel(p1, R1, s1, p2, R2, s2):
        h, n = hfield_height_normal(m, p2[..., 0], p2[..., 1])
        r, p_loc = _support(R2, s2, n)
        q = torch.stack([p2[..., 0], p2[..., 1], h], -1)
        d = (n * (p2 - q)).sum(-1) - r
        pos = p2 + _mat_vec(R2, p_loc) - 0.5 * d[..., None] * n
        return d[..., None], pos[:, :, None], n[:, :, None]
    return kernel


# heightfield kernels are made per call from the model: its data may be
# the env batch's own
_HFIELD_KERNELS = {(M.HFIELD, M.SPHERE): _k_hfield_sphere,
                   (M.HFIELD, M.CAPSULE): _k_hfield_capsule,
                   (M.HFIELD, M.ELLIPSOID): _k_hfield_ellipsoid}

_KERNELS = {(M.PLANE, M.SPHERE): _k_plane_sphere,
            (M.PLANE, M.CAPSULE): _k_plane_capsule,
            (M.PLANE, M.BOX): _k_plane_box,
            (M.PLANE, M.ELLIPSOID): _k_plane_ellipsoid,
            (M.SPHERE, M.SPHERE): _k_sphere_sphere,
            (M.SPHERE, M.CAPSULE): _k_sphere_capsule,
            (M.SPHERE, M.BOX): _k_sphere_box,
            (M.CAPSULE, M.CAPSULE): _k_capsule_capsule,
            (M.CAPSULE, M.BOX): _k_capsule_box,
            (M.BOX, M.BOX): _k_box_box}


def detect(m: M.Model, geom_xpos, geom_xmat,
           pairs: List[Tuple[int, int]]) -> Contact:
    """Evaluate all candidate pairs -> Contact with C rows in pair order.

    Pairs are grouped by geom-type combination and each group is one
    batched evaluation; the rows go back into the candidate order (each
    pair's points contiguous), as the JAX ``detect`` emits them."""
    keys = [(m.geom_type[g1], m.geom_type[g2]) for g1, g2 in pairs]

    def build():
        npts = [_PAIR_POINTS[k] for k in keys]
        offsets = np.concatenate([[0], np.cumsum(npts)[:-1]])
        groups = {}
        for i, k in enumerate(keys):
            groups.setdefault(k, []).append(i)
        idx = lambda a: torch.as_tensor(np.asarray(a, np.int64),
                                        device=m.device)
        evals, rows = [], []
        for key, members in groups.items():
            ga = np.array([pairs[i][0] for i in members])
            gb = np.array([pairs[i][1] for i in members])
            evals.append((key, idx(ga), idx(gb), m.geom_size[ga],
                          m.geom_size[gb]))
            rows += [offsets[i] + q for i in members
                     for q in range(_PAIR_POINTS[key])]
        # output row j comes from row order[j] of the grouped evaluation
        order = idx(np.argsort(np.asarray(rows)))
        row_pair = np.repeat(np.arange(len(pairs)), npts)
        friction, solref, solimp = _combine_batched(
            m, np.array([g1 for g1, _ in pairs]),
            np.array([g2 for _, g2 in pairs]))
        return (evals, order, tuple(pairs[i][0] for i in row_pair),
                tuple(pairs[i][1] for i in row_pair), friction[row_pair],
                solref[row_pair], solimp[row_pair])

    (evals, order, geom1, geom2, friction, solref,
     solimp) = M.cached(m, ('detect', tuple(pairs)), build)
    B = geom_xpos.shape[0]
    dist, pos, nrm = [], [], []
    for key, ga, gb, s1, s2 in evals:
        fn = (_HFIELD_KERNELS[key](m) if key in _HFIELD_KERNELS
              else _KERNELS[key])
        d, p, n = fn(geom_xpos[:, ga], geom_xmat[:, ga], s1,
                     geom_xpos[:, gb], geom_xmat[:, gb], s2)
        dist.append(d.reshape(B, -1))
        pos.append(p.reshape(B, -1, 3))
        nrm.append(n.reshape(B, -1, 3))
    if len(evals) == 1:
        dist, pos, nrm = dist[0], pos[0], nrm[0]
    else:
        dist = torch.cat(dist, 1)[:, order]
        pos = torch.cat(pos, 1)[:, order]
        nrm = torch.cat(nrm, 1)[:, order]
    t1, t2 = _tangent_frame(nrm)
    return Contact(dist=dist, pos=pos, frame=torch.stack([nrm, t1, t2], 2),
                   geom1=geom1, geom2=geom2, friction=friction,
                   solref=solref, solimp=solimp)
