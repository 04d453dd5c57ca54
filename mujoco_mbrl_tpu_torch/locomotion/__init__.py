"""Locomotion-lite: composer-built walkers, arenas, tasks and soccer.

Port of mujoco_mbrl_tpu/locomotion (the reference's
``dm_control/locomotion`` stack, scoped to the pieces with MBRL value):

* :mod:`arenas` — floor and walled-corridor arenas.
* :mod:`walkers` — a planar walker and the CMU humanoid with egocentric
  observables.
* :mod:`tasks` — :class:`tasks.RunThroughCorridor` and
  :class:`tasks.GoToTarget`, with per-episode spawn / target variation.
* :mod:`soccer` — n-vs-n soccer on a walled pitch; ``soccer.load``.

Everything compiles to the port's batched environment, on ``cuda``
unless the caller passes ``device='cpu'``.
"""

from . import arenas, soccer, tasks, walkers
from .tasks import GoToTarget, RunThroughCorridor

__all__ = ['arenas', 'soccer', 'tasks', 'walkers', 'GoToTarget',
           'RunThroughCorridor']
