"""Episode-initialization randomizers on ``torch.Generator``s.

Port of mujoco_mbrl_tpu/suite/randomizers.py: limited hinges and slides ~
Uniform(range), unlimited hinges ~ Uniform(-pi, pi), unlimited slides
untouched; a limited ball joint turns by an angle ~ Uniform(0, range[1])
about an axis uniform on S^2 (``random_limited_quaternion``); an
unlimited ball joint's quaternion, and an unlimited free joint's (its
position untouched), is uniform on S^3 (a normalized 4-d normal draw).
The draws differ from ``jax.random``'s; the distribution is the same.
``first_collision_free`` is the lockstep rejection rule of the humanoid,
finger, ball_in_cup, manipulator and stacker resets (attempt 0 where none
is free) and of humanoid_cmu's (the last attempt).
"""

from __future__ import annotations

import numpy as np
import torch

from ..physics import collision, smooth
from ..physics import model as M


def _unit_normal(B: int, d: int, generator: torch.Generator, dtype):
    """(B, d) normal draws normalized to unit length (uniform on S^(d-1))."""
    q = torch.randn((B, d), generator=generator, dtype=dtype,
                    device=generator.device)
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                           min=1e-12)


def random_limited_quaternion(B: int, limit: float,
                              generator: torch.Generator,
                              dtype=torch.float32) -> torch.Tensor:
    """(B, 4) rotations by an angle ~ Uniform(0, limit) about an axis
    uniform on S^2, on the generator's device."""
    axis = _unit_normal(B, 3, generator, dtype)
    angle = torch.rand((B, 1), generator=generator, dtype=dtype,
                       device=generator.device) * limit
    return torch.cat([torch.cos(angle / 2), axis * torch.sin(angle / 2)], -1)


def randomize_limited_and_rotational_joints(
        model: M.Model, qpos: torch.Tensor,
        generator: torch.Generator) -> torch.Tensor:
    """qpos (B, nq) with each env's joints randomized independently."""
    out = qpos.clone()
    B = qpos.shape[0]
    rng = model.jnt_range.cpu().numpy()
    for j in range(model.njnt):
        jtype, adr = model.jnt_type[j], model.jnt_qposadr[j]
        if jtype == M.BALL:
            q = (random_limited_quaternion(B, float(rng[j, 1]), generator,
                                           qpos.dtype)
                 if model.jnt_limited[j]
                 else _unit_normal(B, 4, generator, qpos.dtype))
            out[:, adr:adr + 4] = q.to(qpos.device)
            continue
        if jtype == M.FREE:
            if not model.jnt_limited[j]:
                out[:, adr + 3:adr + 7] = _unit_normal(
                    B, 4, generator, qpos.dtype).to(qpos.device)
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


def first_collision_free_index(model: M.Model, qposes: torch.Tensor,
                               fallback: int = 0,
                               include_geom_geom: bool = True
                               ) -> torch.Tensor:
    """(B,) the attempt each env keeps of qposes (A, B, nq): its first
    with no penetrating contact, else attempt ``fallback`` (0: JAX
    humanoid.py:185-205, finger.py:77-94, ball_in_cup.py:77-96,
    manipulator.py:298-301, stacker.py:107-110; -1, the last:
    humanoid_cmu.py:285-305). Penetration is tested over
    ``collision.candidate_pairs(model, include_geom_geom)``: humanoid_cmu
    passes its ``opt.enable_geom_geom_contacts``, as JAX's reset does.
    One kinematics and one detect cover all A x B configurations."""
    A, B, nq = qposes.shape
    pairs = M.cached(model, f'reset_pairs_{bool(include_geom_geom)}',
                     lambda: collision.candidate_pairs(
                         model, include_geom_geom=include_geom_geom))
    kin = smooth.kinematics(model, qposes.reshape(A * B, nq),
                            smooth.tree_meta(model))
    dist = collision.detect(model, kin[3], kin[4], pairs).dist
    ok = ~(dist < 0).any(-1).reshape(A, B)
    return torch.where(ok.any(0), ok.to(torch.int8).argmax(0),
                       fallback % A)


def first_collision_free(model: M.Model, qposes: torch.Tensor,
                         fallback: int = 0,
                         include_geom_geom: bool = True) -> torch.Tensor:
    """qpos (B, nq) from attempts qposes (A, B, nq), each env's
    ``first_collision_free_index``."""
    idx = first_collision_free_index(model, qposes, fallback,
                                     include_geom_geom)
    return qposes[idx, torch.arange(qposes.shape[1], device=qposes.device)]
