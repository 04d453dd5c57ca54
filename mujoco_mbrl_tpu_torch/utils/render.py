"""Software renderer: orthographic SDF rasterization of geoms, batched.

Port of mujoco_mbrl_tpu/utils/render.py, the debug rasterizer for rollout
videos and pixel observations of models without a camera: geoms render
as projected disks / thick segments / half-spaces on a pixel grid,
z-buffered. The env batch is the leading dimension of everything: one
call renders (B, H, W, 3) on the data's device. The palette is this
package's own copy of the JAX module's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..physics import model as M

# distinct pseudo-colors per geom (cycled)
_PALETTE = np.array([
    [0.90, 0.40, 0.25], [0.25, 0.60, 0.90], [0.40, 0.80, 0.40],
    [0.85, 0.75, 0.25], [0.70, 0.45, 0.85], [0.30, 0.80, 0.75],
    [0.85, 0.45, 0.60], [0.55, 0.65, 0.30],
], dtype=np.float32)
_BACKGROUND = np.array([0.12, 0.14, 0.18], dtype=np.float32)
_FLOOR = np.array([0.25, 0.28, 0.32], dtype=np.float32)


def render(m: M.Model, data, height: int = 64, width: int = 64,
           center: Optional[Tuple[float, float]] = None,
           extent: float = 2.0, plane: str = 'xz') -> torch.Tensor:
    """Render each env's configuration to (B, height, width, 3) float RGB
    in [0, 1].

    Orthographic projection onto `plane` ('xz' for the planar suite,
    'xy' for top-down tasks like point_mass / swimmer); the third axis is
    depth for the z-buffer. ``center`` None follows the first moving body.
    """
    ax_u, ax_v, ax_d = {'xz': (0, 2, 1), 'xy': (0, 1, 2)}[plane]
    xpos = data.geom_xpos
    B, dt, dev = xpos.shape[0], xpos.dtype, xpos.device
    if center is None:
        root = min(2, m.nbody - 1)
        cu, cv = data.xpos[:, root, ax_u], data.xpos[:, root, ax_v]
    else:
        cu = torch.full((B,), float(center[0]), dtype=dt, device=dev)
        cv = torch.full((B,), float(center[1]), dtype=dt, device=dev)
    us = cu[:, None] + torch.linspace(-extent / 2, extent / 2, width,
                                      dtype=dt, device=dev)
    vs = cv[:, None] + torch.linspace(extent / 2, -extent / 2, height,
                                      dtype=dt, device=dev)
    U = us[:, None, :].expand(B, height, width)
    V = vs[:, :, None].expand(B, height, width)

    const = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    img = const(_BACKGROUND).expand(B, height, width, 3)
    zbuf = torch.full((B, height, width), float('inf'), dtype=dt, device=dev)
    col = lambda v: v[:, None, None]                # (B,) -> (B, 1, 1)

    for g in range(m.ngeom):
        gtype = m.geom_type[g]
        pos = xpos[:, g]
        R = data.geom_xmat[:, g]
        size = m.geom_size[g]
        color = const(_PALETTE[g % len(_PALETTE)])

        if gtype == M.PLANE:
            # half-space below the plane's surface line in the view plane
            n = R[:, :, 2]
            sdf = ((U - col(pos[:, ax_u])) * col(n[:, ax_u])
                   + (V - col(pos[:, ax_v])) * col(n[:, ax_v]))
            depth = torch.full_like(sdf, 1e3)       # always behind
            color = const(_FLOOR)
        elif gtype in (M.SPHERE, M.BOX, M.ELLIPSOID):
            r = (size[0] if gtype == M.SPHERE
                 else torch.linalg.vector_norm(size))
            du = U - col(pos[:, ax_u])
            dv = V - col(pos[:, ax_v])
            sdf = torch.sqrt(du * du + dv * dv) - r
            depth = col(pos[:, ax_d]).expand_as(sdf)
        else:   # capsule / cylinder: thick segment along local z
            half = size[1]
            a = pos - half * R[:, :, 2]
            b = pos + half * R[:, :, 2]
            au, av = col(a[:, ax_u]), col(a[:, ax_v])
            eu, ev = col(b[:, ax_u]) - au, col(b[:, ax_v]) - av
            ee = eu * eu + ev * ev
            t = torch.clamp(((U - au) * eu + (V - av) * ev)
                            / torch.clamp(ee, min=1e-12), 0.0, 1.0)
            du = U - (au + t * eu)
            dv = V - (av + t * ev)
            sdf = torch.sqrt(du * du + dv * dv) - size[0]
            depth = col(pos[:, ax_d]).expand_as(sdf)

        visible = (sdf < 0) & (depth < zbuf)
        # soft edge shading from the SDF
        shade = torch.clamp(-sdf / torch.clamp(torch.abs(size[0]) + 1e-6,
                                               min=1e-6), 0.2, 1.0)
        pixel = color * shade[..., None]
        img = torch.where(visible[..., None], pixel, img)
        zbuf = torch.where(visible, depth, zbuf)

    return img


def render_to_uint8(img: torch.Tensor) -> np.ndarray:
    return torch.clamp(img * 255, 0, 255).to(torch.uint8).cpu().numpy()
