"""Camera-posed rendering by analytic ray casting, batched over envs.

Port of mujoco_mbrl_tpu/utils/raycast.py (plain ``jnp`` there, with no
Pallas kernel; plain PyTorch here): every pixel ray is intersected
analytically with spheres / capsules / boxes / ellipsoids / cylinders /
planes and the nearest hit wins. The env batch is the leading dimension:
(B, H * W) rays go against each geom in turn, so a frame of every env is
one pass over the geoms on the data's device.

Conventions follow MuJoCo: the camera looks along its -Z axis, +X right,
+Y up; ``fovy`` is the vertical field of view in degrees. ``depth``
returns metric distance along the camera's forward axis;
``segmentation`` the winning geom id per pixel, -1 for background.
Heightfield geoms are not ray-cast (the rasterizer, utils.render, draws
those scenes).
"""

from __future__ import annotations

import numpy as np
import torch

from ..physics import model as M
from .render import _BACKGROUND, _PALETTE

_INF = 1e9


def _quat_mat(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def _rows_times(v, R):
    """v @ R for row vectors v (..., N, 3) and R (..., 3, 3), as three
    products summed in order (no matmul precision mode to depend on)."""
    return (v[..., 0:1] * R[..., None, 0, :] + v[..., 1:2] * R[..., None, 1, :]
            + v[..., 2:3] * R[..., None, 2, :])


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _where_hit(hit, t):
    return torch.where(hit, t, torch.full_like(t, _INF))


def _ray_sphere(o, d, r):
    """o, d: (..., 3) local; returns (t, normal) with t = INF on a miss."""
    b = _dot(o, d)
    c = _dot(o, o) - r * r
    disc = b * b - c
    t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    t = _where_hit((disc >= 0) & (t > 1e-6), t)
    return t, o + t[..., None] * d


def _ray_plane(o, d):
    """Infinite z = 0 plane, hit from above."""
    dz = d[..., 2]
    t = -o[..., 2] / torch.where(torch.abs(dz) < 1e-9,
                                 torch.full_like(dz, 1e-9), dz)
    t = _where_hit((t > 1e-6) & (o[..., 2] > 0) & (dz < 0), t)
    n = torch.zeros_like(o)
    n[..., 2] = 1.0
    return t, n


def _side(o, d, r):
    """The near intersection with the infinite cylinder x^2 + y^2 = r^2."""
    a = d[..., 0] ** 2 + d[..., 1] ** 2
    b = o[..., 0] * d[..., 0] + o[..., 1] * d[..., 1]
    c = o[..., 0] ** 2 + o[..., 1] ** 2 - r * r
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = (-b - sq) / torch.where(a < 1e-12, torch.full_like(a, 1e-12), a)
    return t, disc, a


def _ray_capsule(o, d, r, h):
    """Capsule along z with half-length h, radius r."""
    t_cyl, disc, a = _side(o, d, r)
    z = o[..., 2] + t_cyl * d[..., 2]
    t_cyl = _where_hit((disc >= 0) & (t_cyl > 1e-6) & (torch.abs(z) <= h)
                       & (a > 1e-12), t_cyl)
    ez = torch.zeros(3, dtype=o.dtype, device=o.device)
    ez[2] = 1.0
    t_top, _ = _ray_sphere(o - ez * h, d, r)
    t_bot, _ = _ray_sphere(o + ez * h, d, r)
    t = torch.minimum(t_cyl, torch.minimum(t_top, t_bot))
    p = o + t[..., None] * d
    n_cyl = p * (1.0 - ez)
    n_cap = p - ez * torch.sign(p[..., 2:3]) * h
    n = torch.where((t == t_cyl)[..., None], n_cyl, n_cap)
    return _where_hit(t < _INF, t), n


def _ray_box(o, d, s):
    """Axis-aligned box with half-sizes s (3,): slab method."""
    inv = 1.0 / torch.where(torch.abs(d) < 1e-12, torch.full_like(d, 1e-12),
                            d)
    t1 = (-s - o) * inv
    t2 = (s - o) * inv
    tmin = torch.amax(torch.minimum(t1, t2), -1)
    tmax = torch.amin(torch.maximum(t1, t2), -1)
    t = _where_hit((tmax >= tmin) & (tmax > 1e-6) & (tmin > 1e-6), tmin)
    p = o + t[..., None] * d
    # face normal: axis of largest |p| / s
    axis = torch.argmax(torch.abs(p) / s, -1)
    n = (torch.nn.functional.one_hot(axis, 3).to(o.dtype)
         * torch.sign(torch.gather(p, -1, axis[..., None])))
    return t, n


def _ray_ellipsoid(o, d, s):
    os_, ds = o / s, d / s
    a = _dot(ds, ds)
    b = _dot(os_, ds)
    c = _dot(os_, os_) - 1.0
    disc = b * b - a * c
    t = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / torch.clamp(a,
                                                                    min=1e-12)
    t = _where_hit((disc >= 0) & (t > 1e-6), t)
    p = o + t[..., None] * d
    return t, p / (s * s)


def _ray_cylinder(o, d, r, h):
    t_side, disc, _ = _side(o, d, r)
    z = o[..., 2] + t_side * d[..., 2]
    t_side = _where_hit((disc >= 0) & (t_side > 1e-6) & (torch.abs(z) <= h),
                        t_side)
    # end disks
    dz = torch.where(torch.abs(d[..., 2]) < 1e-9,
                     torch.full_like(d[..., 2], 1e-9), d[..., 2])
    t_disk = torch.stack([(h - o[..., 2]) / dz, (-h - o[..., 2]) / dz], -1)
    p_xy = o[..., None, :2] + t_disk[..., None] * d[..., None, :2]
    disk_ok = (t_disk > 1e-6) & ((p_xy ** 2).sum(-1) <= r * r)
    t_disk = _where_hit(disk_ok, t_disk).amin(-1)
    t = torch.minimum(t_side, t_disk)
    p = o + t[..., None] * d
    ez = torch.zeros(3, dtype=o.dtype, device=o.device)
    ez[2] = 1.0
    n_side = p * (1.0 - ez)
    n_disk = torch.cat([torch.zeros_like(p[..., :2]),
                        torch.sign(p[..., 2:3])], -1)
    n = torch.where((t == t_side)[..., None], n_side, n_disk)
    return _where_hit(t < _INF, t), n


def cast(m: M.Model, data, origins: torch.Tensor, dirs: torch.Tensor):
    """Intersect rays with every geom of every env.

    origins / dirs: world rays (B, N, 3), or (N, 3) / (1, N, 3) shared by
    the envs. Returns (t (B, N), geom_id (B, N) int32, normal (B, N, 3)
    world); t = INF and id = -1 where nothing is hit.
    """
    gx, gR = data.geom_xpos, data.geom_xmat
    B, dt, dev = gx.shape[0], gx.dtype, gx.device
    origins = origins.reshape((-1,) + tuple(origins.shape[-2:]))
    dirs = dirs.reshape((-1,) + tuple(dirs.shape[-2:]))
    N = dirs.shape[-2]
    best_t = torch.full((B, N), _INF, dtype=dt, device=dev)
    best_id = torch.full((B, N), -1, dtype=torch.int32, device=dev)
    best_n = torch.zeros((B, N, 3), dtype=dt, device=dev)
    for g in range(m.ngeom):
        R = gR[:, g]                                       # local -> world
        o = _rows_times(origins - gx[:, g, None], R)       # world -> local
        d = _rows_times(dirs, R)
        size = m.geom_size[g]
        gtype = m.geom_type[g]
        if gtype == M.PLANE:
            t, n = _ray_plane(o, d)
        elif gtype == M.SPHERE:
            t, n = _ray_sphere(o, d, size[0])
        elif gtype == M.CAPSULE:
            t, n = _ray_capsule(o, d, size[0], size[1])
        elif gtype == M.BOX:
            t, n = _ray_box(o, d, size)
        elif gtype == M.ELLIPSOID:
            t, n = _ray_ellipsoid(o, d, size)
        elif gtype == M.CYLINDER:
            t, n = _ray_cylinder(o, d, size[0], size[1])
        else:                                              # HFIELD
            continue
        n_world = _rows_times(n, R.transpose(-1, -2))
        closer = t < best_t
        best_t = torch.where(closer, t, best_t)
        best_id = torch.where(closer, torch.full_like(best_id, g), best_id)
        best_n = torch.where(closer[..., None], n_world, best_n)
    norm = torch.linalg.vector_norm(best_n, dim=-1, keepdim=True)
    return best_t, best_id, best_n / torch.clamp(norm, min=1e-9)


def _subtree_coms(m: M.Model, data):
    """(B, nbody, 3) mass-weighted subtree CoM per body (for trackcom
    cameras): membership is static (body_parent), so it is one
    (nbody, nbody) masked matmul over the envs."""
    def build():
        nb = m.nbody
        sub = np.zeros((nb, nb), np.float32)   # sub[b, c] = c in subtree(b)
        for child in range(nb):
            anc = child
            while True:
                sub[anc, child] = 1.0
                if anc == 0:
                    break
                anc = m.body_parent[anc]
        msub = torch.as_tensor(sub, dtype=m.dtype,
                               device=m.device) * m.body_mass[None, :]
        return msub, torch.clamp(msub.sum(-1), min=1e-9)
    msub, total = M.cached(m, 'subtree_com_mask', build)
    return (msub @ data.xipos) / total[:, None]


def _pixel_dirs(height, width, fovy_deg, dtype, device):
    """(H * W, 3) unit pixel directions in the camera frame."""
    tan = np.tan(np.deg2rad(fovy_deg) / 2)
    aspect = width / height
    ys = torch.linspace(tan, -tan, height, dtype=dtype, device=device)
    xs = torch.linspace(-tan * aspect, tan * aspect, width, dtype=dtype,
                        device=device)
    Y, X = torch.meshgrid(ys, xs, indexing='ij')
    d = torch.stack([X, Y, -torch.ones_like(X)], -1)        # looks along -z
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return d.reshape(-1, 3)


class Camera:
    """dm_control-style camera facade (engine.py:515 Camera), batched.

    ``Camera(env, height, width, camera_id).render(data)`` returns RGB
    (B, H, W, 3); ``depth=True`` metric depth (B, H, W);
    ``segmentation=True`` geom ids. camera_id may be an index or a
    camera name.
    """

    def __init__(self, env_or_model, height: int = 240, width: int = 320,
                 camera_id=0):
        m = getattr(env_or_model, 'model', env_or_model)
        self._m = m
        if isinstance(camera_id, str):
            camera_id = m.names['camera'][camera_id]
        if m.ncam == 0:
            raise ValueError('model has no cameras')
        self._cam = int(camera_id)
        self.height = height
        self.width = width

    def rays(self, data):
        """(origins (B, 1, 3), dirs (B or 1, H * W, 3), camera frame R_c
        (B or 1, 3, 3)) in world coordinates."""
        m, c = self._m, self._cam
        body = m.cam_body[c]
        dt, dev = data.xpos.dtype, data.xpos.device
        d_cam = _pixel_dirs(self.height, self.width, m.cam_fovy[c], dt, dev)
        R_local = _quat_mat(m.cam_quat[c])
        if m.cam_mode[c] == 'trackcom':
            # position tracks the subtree CoM; orientation fixed in world
            pos = _subtree_coms(m, data)[:, body] + m.cam_pos[c]
            R_c = R_local[None]
        else:
            R_b = data.ximat[:, body]
            pos = data.xpos[:, body] + (R_b * m.cam_pos[c]).sum(-1)
            R_c = _rows_times(R_b, R_local)
        dirs = _rows_times(d_cam, R_c.transpose(-1, -2))
        return pos[:, None, :], dirs, R_c

    def render(self, data, depth: bool = False,
               segmentation: bool = False, reward=None):
        """Render every env; with ``reward`` (B,) in [0, 1], tint body
        geoms toward the highlight green by ``reward**4`` (the
        visualize_reward contract, reference suite/base.py:105-112, on
        this renderer's palette; the world's geoms keep their color)."""
        origins, dirs, R_c = self.rays(data)
        t, gid, n = cast(self._m, data, origins, dirs)
        B, H, W = t.shape[0], self.height, self.width
        if depth:
            fwd = -R_c[..., :, 2]
            z = t * _dot(dirs, fwd[:, None, :])
            return torch.where(t >= _INF, torch.full_like(z, float('inf')),
                               z).reshape(B, H, W)
        if segmentation:
            return gid.reshape(B, H, W)
        const = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                          dtype=t.dtype, device=t.device)
        palette = const(_PALETTE)
        g0 = torch.clamp(gid, min=0).long()
        colors = palette[g0 % palette.shape[0]]
        if reward is not None:
            # geoms on moving bodies get the reward tint (blend_coef =
            # reward**4 for color distinction near high reward)
            body_geom = const(np.asarray(self._m.geom_body) > 0)
            coef = torch.clamp(torch.as_tensor(reward, dtype=t.dtype,
                                               device=t.device),
                               0.0, 1.0) ** 4
            blend = (coef.reshape(-1, 1) * body_geom[g0])[..., None]
            colors = blend * const([0.0, 0.5, 0.3]) + (1.0 - blend) * colors
        light = const([0.4, 0.2, 0.8])
        light = light / torch.linalg.vector_norm(light)
        lam = torch.clamp(_dot(n, light), 0.0, 1.0) * 0.7 + 0.3
        rgb = torch.where((gid < 0)[..., None], const(_BACKGROUND),
                          colors * lam[..., None])
        return rgb.reshape(B, H, W, 3)


class MovableCamera(Camera):
    """Free camera posed by (lookat, distance, azimuth, elevation) — the
    MovableCamera surface (engine.py:786-828), MuJoCo's free-camera
    convention: azimuth rotates about world +z (degrees, 0 = looking
    along +x), elevation tilts below the horizon (negative looks down).
    One pose for every env of the batch.
    """

    def __init__(self, env_or_model, height: int = 240, width: int = 320,
                 lookat=(0.0, 0.0, 0.0), distance: float = 3.0,
                 azimuth: float = 90.0, elevation: float = -30.0,
                 fovy: float = 45.0):
        m = getattr(env_or_model, 'model', env_or_model)
        self._m = m
        self.height = height
        self.width = width
        self._fovy_deg = float(fovy)
        self.set_pose(lookat, distance, azimuth, elevation)

    def get_pose(self):
        return (self._lookat, self._distance, self._azimuth,
                self._elevation)

    def set_pose(self, lookat, distance, azimuth, elevation):
        self._lookat = np.asarray(lookat, np.float64)
        self._distance = float(distance)
        self._azimuth = float(azimuth)
        self._elevation = float(elevation)

    def rays(self, data):
        az = np.deg2rad(self._azimuth)
        el = np.deg2rad(self._elevation)
        # camera forward: from camera toward lookat
        fwd = np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                        np.sin(el)])
        pos = self._lookat - self._distance * fwd
        # camera frame: x right, y up, camera looks along -z
        right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
        nr = np.linalg.norm(right)
        right = np.array([1.0, 0.0, 0.0]) if nr < 1e-9 else right / nr
        up = np.cross(right, fwd)
        dt, dev = data.xpos.dtype, data.xpos.device
        R_c = torch.as_tensor(np.stack([right, up, -fwd], axis=1),
                              dtype=dt, device=dev)[None]
        d_cam = _pixel_dirs(self.height, self.width, self._fovy_deg, dt, dev)
        dirs = _rows_times(d_cam, R_c.transpose(-1, -2))
        return (torch.as_tensor(pos, dtype=dt, device=dev).reshape(1, 1, 3),
                dirs, R_c)
