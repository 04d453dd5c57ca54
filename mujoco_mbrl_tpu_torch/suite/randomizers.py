"""Episode-initialization randomizers on ``torch.Generator``s.

Port of mujoco_mbrl_tpu/suite/randomizers.py for hinge, slide and free
joints: limited joints ~ Uniform(range), unlimited hinges ~ Uniform(-pi,
pi), unlimited slides untouched, an unlimited free joint's quaternion
uniform on S^3 (a normalized 4-d normal draw; its position untouched).
The draws differ from ``jax.random``'s; the distribution is the same.
"""

from __future__ import annotations

import numpy as np
import torch

from ..physics import model as M


def randomize_limited_and_rotational_joints(
        model: M.Model, qpos: torch.Tensor,
        generator: torch.Generator) -> torch.Tensor:
    """qpos (B, nq) with each env's joints randomized independently."""
    out = qpos.clone()
    B = qpos.shape[0]
    rng = model.jnt_range.cpu().numpy()
    for j in range(model.njnt):
        jtype, adr = model.jnt_type[j], model.jnt_qposadr[j]
        if jtype not in (M.HINGE, M.SLIDE, M.FREE):
            raise NotImplementedError(
                'ball joint randomization is not ported (mujoco_mbrl_tpu'
                '.suite.randomizers.randomize_limited_and_rotational_joints)')
        if jtype == M.FREE:
            if not model.jnt_limited[j]:
                q = torch.randn((B, 4), generator=generator,
                                dtype=qpos.dtype, device=generator.device)
                q = q / torch.clamp(torch.linalg.vector_norm(
                    q, dim=-1, keepdim=True), min=1e-12)
                out[:, adr + 3:adr + 7] = q.to(qpos.device)
            continue
        if model.jnt_limited[j]:
            lo, hi = float(rng[j, 0]), float(rng[j, 1])
        elif jtype == M.HINGE:
            lo, hi = -np.pi, np.pi
        else:
            continue
        u = torch.rand((B,), generator=generator, dtype=qpos.dtype,
                       device=generator.device)
        out[:, adr] = (lo + (hi - lo) * u).to(qpos.device)
    return out
