"""Logger, metrics writer, checkpoints (the port's ``save_tree`` and the
JAX package's ``save_pytree`` layout), the rollout recorder, the Jacobian
helper and the renderers (``render``: the orthographic rasterizer;
``raycast``: the camera ray caster); ``profiling`` holds the trace and
phase timers."""

from . import render
from .checkpoint import load_pytree, load_tree, save_pytree, save_tree
from .jacobian import compute_jacobian
from .logger import logger
from .metrics import MetricsWriter
from .recorder import Recorder

__all__ = ['MetricsWriter', 'Recorder', 'compute_jacobian', 'load_pytree',
           'load_tree', 'logger', 'render', 'save_pytree', 'save_tree']
