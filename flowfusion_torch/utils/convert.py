"""The weight carrier between the JAX package and the port.

Both packages hold a score net as the same tree: ``{"W": (E/2,), "layers":
[{"w": (in, out), "b": (out,)}, ...]}``.  ``params_from_numpy`` turns that
tree — from a loaded npz (``utils.checkpoint.load_npz``) or from
``jax.tree.map(np.asarray, params)`` — into the port's parameters, so both
packages compute with the same weights.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .._device import DeviceLike, resolve_device

__all__ = ["params_from_numpy"]


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """Same tree, numpy leaves as contiguous tensors on ``device``."""
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        return torch.as_tensor(np.ascontiguousarray(node)).to(dev).contiguous()

    return convert(tree)

