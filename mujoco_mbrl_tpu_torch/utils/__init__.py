"""Logger, metrics writer and checkpoints."""

from .checkpoint import load_tree, save_tree
from .logger import logger
from .metrics import MetricsWriter

__all__ = ['MetricsWriter', 'load_tree', 'logger', 'save_tree']
