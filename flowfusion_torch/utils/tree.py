"""Trees of tensors: the port's models as the JAX package's pytrees.

A model of the port is a frozen dataclass whose tensors sit in its fields,
in dicts and in lists.  These helpers walk such a tree the way JAX walks the
same model: dataclass fields in declaration order, dict keys sorted, list
and tuple items in order; ``None`` holds no leaf, and a leaf is a tensor or
a numpy array (configs, SDEs, flags and strings are structure, as JAX's
static fields are).  A leaf's path name joins JAX's key-path strings with
``/``: ``.field``, ``['key']``, ``[i]`` — e.g. ``.params/['layers']/[0]/['w']``
— so the npz archives of ``utils.checkpoint.save_npz`` carry the same names
as the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

import numpy as np
import torch

__all__ = ["is_leaf", "leaves_with_paths", "map_with_path"]


def is_leaf(node: Any) -> bool:
    return isinstance(node, (torch.Tensor, np.ndarray))


def _children(node: Any):
    """(path part, child) pairs of a branch node; None for anything else."""
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f".{f.name}", getattr(node, f.name)) for f in dataclasses.fields(node)]
    if isinstance(node, dict):
        return [(f"['{k}']", node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def leaves_with_paths(tree: Any) -> List[Tuple[str, Any]]:
    """``(path name, leaf)`` for every leaf, in JAX's flattening order."""
    out: List[Tuple[str, Any]] = []

    def walk(node, prefix):
        if is_leaf(node):
            out.append(("/".join(prefix), node))
            return
        for part, child in _children(node) or ():
            walk(child, prefix + [part])

    walk(tree, [])
    return out


def map_with_path(fn: Callable[[str, Any], Any], tree: Any) -> Any:
    """The same tree with every leaf replaced by ``fn(path name, leaf)``;
    dataclasses are rebuilt with ``dataclasses.replace``, everything that
    is not a leaf or a branch is kept as it is."""

    def walk(node, prefix):
        if is_leaf(node):
            return fn("/".join(prefix), node)
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            changes = {}
            for f in dataclasses.fields(node):
                value = getattr(node, f.name)
                new = walk(value, prefix + [f".{f.name}"])
                if new is not value:
                    changes[f.name] = new
            return dataclasses.replace(node, **changes) if changes else node
        if isinstance(node, dict):
            return {k: walk(v, prefix + [f"['{k}']"]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            items = [walk(v, prefix + [f"[{i}]"]) for i, v in enumerate(node)]
            return type(node)(items) if isinstance(node, tuple) else items
        return node

    return walk(tree, [])
