"""Arenas: floor and corridor entities (port of
mujoco_mbrl_tpu/locomotion/arenas.py)."""

from __future__ import annotations

from .. import composer
from ..physics import builder


class Floor(composer.Entity):
    """An open plane arena (locomotion/arenas/floors.py Floor)."""

    def _build(self, size=(8.0, 8.0), timestep=0.005):
        root = builder.RootElement(model='floor_arena')
        root.option(timestep=timestep)
        root.worldbody.add('geom', name='groundplane', type='plane',
                           size=[size[0], size[1], 0.1], friction=[1.0])
        return root


class Corridor(composer.Entity):
    """A walled corridor along +x (locomotion/arenas/corridors.py
    EmptyCorridor): ground plane plus two side walls, ``zaxis`` planes;
    the running direction is +x, the corridor `width` wide."""

    def _build(self, length=40.0, width=4.0, wall_height=2.0,
               timestep=0.005):
        self.length = length
        self.width = width
        root = builder.RootElement(model='corridor_arena')
        root.option(timestep=timestep)
        wb = root.worldbody
        wb.add('geom', name='groundplane', type='plane',
               size=[length, width, 0.1], friction=[1.0])
        half_w = width / 2
        wb.add('geom', name='wall_left', type='plane',
               pos=[0, half_w, wall_height / 2], zaxis=[0, -1, 0],
               size=[length, wall_height, 0.1])
        wb.add('geom', name='wall_right', type='plane',
               pos=[0, -half_w, wall_height / 2], zaxis=[0, 1, 0],
               size=[length, wall_height, 0.1])
        return root
