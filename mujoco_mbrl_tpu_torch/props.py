"""Reusable prop entities: primitives and a position detector, batched.

Port of mujoco_mbrl_tpu/props.py (the reference's
``entities/props/primitive.py:28-112`` and ``position_detector.py:
45-262``): a :class:`Primitive` is a single free-floating geom exposing
pose and velocity observables; a :class:`PositionDetector` is an
axis-aligned box region reporting which registered entities are inside
it. Detection is a pure function of ``(model, data)`` over the env
batch: ``detections`` is (B, n) with one flag per registered entity.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import composer
from .physics import builder

_GEOM_SIZES = {  # geom_type -> number of size parameters (MJCF spec)
    'sphere': 1, 'capsule': 2, 'cylinder': 2, 'ellipsoid': 3, 'box': 3,
}


class Primitive(composer.Entity):
    """A single free-floating primitive geom (primitive.py:28).

    Observables mirror ``PrimitiveObservables`` (primitive.py:94-112):
    position, orientation (quaternion), linear and angular velocity.
    """

    def _build(self, geom_type: str = 'sphere',
               size: Sequence[float] = (0.05,),
               rgba: Sequence[float] = (0.5, 0.5, 0.5, 1.0),
               pos: Sequence[float] = (0.0, 0.0, 0.0),
               mass: Optional[float] = None,
               friction: Optional[Sequence[float]] = None,
               name: str = 'prop'):
        if geom_type not in _GEOM_SIZES:
            raise ValueError(f'unsupported primitive geom type {geom_type!r}')
        if len(size) != _GEOM_SIZES[geom_type]:
            raise ValueError(
                f'{geom_type} takes {_GEOM_SIZES[geom_type]} size '
                f'parameters, got {len(size)}')
        self._body_name = name
        root = builder.RootElement(model=name)
        body = root.worldbody.add('body', name=name, pos=list(pos))
        body.add('joint', name=f'{name}_root', type='free', limited=False)
        geom_attrs = dict(name=name, type=geom_type, size=list(size),
                          rgba=list(rgba))
        if mass is not None:
            geom_attrs['mass'] = mass
        if friction is not None:
            geom_attrs['friction'] = list(friction)
        body.add('geom', **geom_attrs)
        return root

    # -- static index helpers ---------------------------------------------
    def body_id(self, model) -> int:
        return model.names['body'][self.name(self._body_name)]

    def joint_qposadr(self, model) -> int:
        j = model.names['joint'][self.name(f'{self._body_name}_root')]
        return int(model.jnt_qposadr[j])

    def set_pose(self, model, qpos, pos=None, quat=None):
        """qpos (B, nq) with this prop's free-joint pose written: `pos`
        (3,) or (B, 3), `quat` (4,) or (B, 4)."""
        adr = self.joint_qposadr(model)
        qpos = qpos.clone()
        if pos is not None:
            qpos[:, adr:adr + 3] = torch.as_tensor(
                pos, dtype=qpos.dtype, device=qpos.device)
        if quat is not None:
            qpos[:, adr + 3:adr + 7] = torch.as_tensor(
                quat, dtype=qpos.dtype, device=qpos.device)
        return qpos

    # -- observables (primitive.py:94-112) ---------------------------------
    @composer.observable
    def position(self, model, phys, data):
        return data.xpos[:, self.body_id(model)]

    @composer.observable
    def orientation(self, model, phys, data):
        return data.xquat[:, self.body_id(model)]

    @composer.observable
    def linear_velocity(self, model, phys, data):
        b = self.body_id(model)
        # cvel is a world-origin spatial velocity; the body CoM point p
        # moves at lin + ang x p (suite.sensors.subtree_linvel's rule)
        return data.cvel[:, b, 3:] + torch.linalg.cross(data.cvel[:, b, :3],
                                                        data.xipos[:, b])

    @composer.observable
    def angular_velocity(self, model, phys, data):
        return data.cvel[:, self.body_id(model), :3]


class PositionDetector(composer.Entity):
    """Axis-aligned box region reporting registered entities inside it
    (position_detector.py:45).

    Detects in 2 or 3 dimensions after ``len(size)``; ``inverted`` flags
    entities while *outside*. The zone is centred on the detector site's
    run-time position, so an attached or offset zone moves with its frame.
    """

    def _build(self, pos: Sequence[float], size: Sequence[float],
               inverted: bool = False,
               rgba: Sequence[float] = (1, 0, 0, 0.25),
               name: str = 'detector'):
        if not 2 <= len(size) <= 3:
            raise ValueError('size must have 2 (planar) or 3 entries')
        self._site_name = name
        self._size = np.asarray(size, np.float64)
        self._dims = len(size)
        self._inverted = bool(inverted)
        self._registered = []
        root = builder.RootElement(model=name)
        pos3 = list(pos) + [0.0] * (3 - len(pos)) if len(pos) < 3 \
            else list(pos)
        root.worldbody.add('site', name=name, pos=pos3, rgba=list(rgba))
        return root

    # -- registration (position_detector.py:194-206) -----------------------
    def register_entities(self, *entities: Primitive) -> None:
        self._registered.extend(entities)

    def deregister_entities(self) -> None:
        self._registered = []

    @property
    def registered_entities(self):
        return tuple(self._registered)

    # -- detection ---------------------------------------------------------
    def site_id(self, model) -> int:
        return model.names['site'][self.name(self._site_name)]

    def zone(self, model, data):
        """(lower, upper) corners (B, dims) of the detection box, world
        frame."""
        mid = data.site_xpos[:, self.site_id(model), :self._dims]
        half = torch.as_tensor(self._size[:self._dims], dtype=mid.dtype,
                               device=mid.device)
        return mid - half, mid + half

    def detections(self, model, data) -> torch.Tensor:
        """(B, n) bool, one flag per registered entity: inside the zone
        (position_detector.py:220-238's _update_detection, pure)."""
        B = data.xpos.shape[0]
        if not self._registered:
            return torch.zeros((B, 0), dtype=torch.bool,
                               device=data.xpos.device)
        lower, upper = self.zone(model, data)
        ids = [e.body_id(model) for e in self._registered]
        p = data.xpos[:, ids, :self._dims]                  # (B, n, dims)
        inside = ((p >= lower[:, None]) & (p <= upper[:, None])).all(-1)
        return inside ^ self._inverted

    def activated(self, model, data) -> torch.Tensor:
        """(B,) True where any registered entity is detected."""
        return self.detections(model, data).any(-1)

    @composer.observable
    def detected(self, model, phys, data):
        return self.detections(model, data).to(torch.float32)
