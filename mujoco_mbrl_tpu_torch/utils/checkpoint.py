"""Checkpoints: a tree of tensors, ints, floats, lists and dicts.

Two formats. The port's own: ``save_tree(path, tree)`` writes
``<path>.pt`` with ``torch.save``; ``load_tree`` reads it back with
``weights_only=True``, so a checkpoint holds data and no code. The JAX
package's (mujoco_mbrl_tpu/utils/checkpoint.py): ``save_pytree(path,
tree)`` writes ``<path>.npz`` with one array ``leaf_i`` per leaf in JAX's
flatten order (dict keys sorted, ``None`` holding no leaf) and
``<path>.tree.json`` with the tree's structure as JAX prints it;
``load_pytree(path, like)`` fills the structure of ``like`` with the
``.npz``'s leaves. A tree saved by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Iterator, List

import numpy as np
import torch


def save_tree(path: str, tree: Any) -> None:
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    torch.save(tree, path + '.pt')


def load_tree(path: str, map_location=None) -> Any:
    return torch.load(path + '.pt', map_location=map_location,
                      weights_only=True)


def _children(node):
    """The subtrees of a container in JAX's flatten order, or None for a
    leaf."""
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(node)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [getattr(node, f.name) for f in dataclasses.fields(node)]
    return None


def _flatten(tree) -> List[Any]:
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in _flatten(kid)]


def _treedef(tree) -> str:
    """The structure as ``str`` of a JAX treedef prints it."""
    if tree is None:
        return 'None'
    if isinstance(tree, dict):
        return '{' + ', '.join(f'{k!r}: {_treedef(tree[k])}'
                               for k in sorted(tree)) + '}'
    if isinstance(tree, tuple) and not hasattr(tree, '_fields'):
        inner = ', '.join(_treedef(x) for x in tree)
        return f'({inner},)' if len(tree) == 1 else f'({inner})'
    kids = _children(tree)
    if kids is None:
        return '*'
    inner = ', '.join(_treedef(x) for x in kids)
    if isinstance(tree, list):
        return f'[{inner}]'
    return f'{type(tree).__name__}[{inner}]'


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree: Any) -> None:
    """Save a tree of tensors or arrays to `<path>.npz` + treedef json."""
    leaves = _flatten(tree)
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    np.savez(path + '.npz', **{f'leaf_{i}': _to_numpy(leaf)
                               for i, leaf in enumerate(leaves)})
    with open(path + '.tree.json', 'w') as f:
        json.dump({'treedef': f'PyTreeDef({_treedef(tree)})',
                   'n_leaves': len(leaves)}, f)


def _unflatten(like, leaves: Iterator[np.ndarray]):
    if like is None:
        return None
    if isinstance(like, dict):
        filled = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: filled[k] for k in like}
    if isinstance(like, (list, tuple)):
        kids = [_unflatten(x, leaves) for x in like]
        return (type(like)(*kids) if hasattr(like, '_fields')
                else type(like)(kids))
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: _unflatten(getattr(like, f.name), leaves)
            for f in dataclasses.fields(like)})
    arr = next(leaves)
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(arr).to(like.device)
    return torch.from_numpy(arr)


def load_pytree(path: str, like: Any) -> Any:
    """Restore a tree saved by save_pytree (in either package), using
    `like` for its structure; each leaf comes back as a tensor, on the
    device of `like`'s leaf where that is a tensor."""
    with np.load(path + '.npz') as data:
        leaves = [data[f'leaf_{i}'] for i in range(len(data.files))]
    return _unflatten(like, iter(leaves))
