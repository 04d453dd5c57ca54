"""Checkpoints: a tree of tensors, ints, floats, lists and dicts.

The port's own format (the JAX package writes ``.npz`` + a treedef):
``save_tree(path, tree)`` writes ``<path>.pt`` with ``torch.save``;
``load_tree`` reads it back with ``weights_only=True``, so a checkpoint
holds data and no code.
"""

from __future__ import annotations

import os
from typing import Any

import torch


def save_tree(path: str, tree: Any) -> None:
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    torch.save(tree, path + '.pt')


def load_tree(path: str, map_location=None) -> Any:
    return torch.load(path + '.pt', map_location=map_location,
                      weights_only=True)
