"""Logger, metrics writer, checkpoints, the rollout recorder and the
renderers (``render``: the orthographic rasterizer; ``raycast``: the
camera ray caster); ``profiling`` holds the trace and phase timers."""

from . import render
from .checkpoint import load_tree, save_tree
from .logger import logger
from .metrics import MetricsWriter
from .recorder import Recorder

__all__ = ['MetricsWriter', 'Recorder', 'load_tree', 'logger', 'render',
           'save_tree']
