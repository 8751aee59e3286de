"""Tree helpers shared by the solvers.

Counterpart of the JAX package's ``ops/integrate/fixed.py``; only the
``_tree_axpy`` helper the adaptive solver imports so far (the fixed-step
solvers are ROADMAP.md queue 1, item 8).  A state "tree" is a tensor or a
tuple of tensors.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = ["tree_map", "tree_leaves"]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over a tensor or a tuple/list of tensors."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    return tuple(fn(*leaves) for leaves in zip(tree, *rest))


def tree_leaves(tree: Any) -> list:
    return [tree] if isinstance(tree, torch.Tensor) else list(tree)


def _tree_axpy(y: Any, scale, x: Any) -> Any:
    """y + scale * x, leafwise."""
    return tree_map(lambda a, b: a + scale * b, y, x)
