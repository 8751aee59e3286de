"""Weights into the port: the JAX package's npz trees and reference checkpoints.

Both packages hold a score net as the same tree: ``{"W": (E/2,), "layers":
[{"w": (in, out), "b": (out,)}, ...]}``.  ``params_from_numpy`` turns that
tree — from a loaded npz (``utils.checkpoint.load_npz``) or from
``jax.tree.map(np.asarray, params)`` — into the port's parameters, so both
packages compute with the same weights.

The ``*_from_torch`` converters are the migration path for users of the
reference (PyTorch) flowfusion library, counterparts of the JAX package's
``utils/convert.py``: a reference ``state_dict`` (tensors on any device, or
a mapping of numpy arrays) becomes the port's parameter tree.  Input
orderings of every net match the reference's (``models/nets.py``); a torch
Linear stores its weight as (out, in) and the port as (in, out), so weights
are transposed, and every leaf is made contiguous, as the kernels read it.
The wrappers' standardization statistics are buffers of the reference
checkpoints too: :func:`standardization_from_torch` extracts them for the
model constructors, without which a converted model standardizes with the
0/1 defaults.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device

__all__ = [
    "params_from_numpy",
    "score_mlp_from_torch",
    "velocity_mlp_from_torch",
    "symplectic_mlp_from_torch",
    "standardization_from_torch",
]


def _place(leaf, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A numpy array or a tensor as a new contiguous tensor on ``device``
    (cast to ``dtype`` when given, in one rounding)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
    else:
        t = torch.as_tensor(np.ascontiguousarray(leaf))
    return t.to(device=device, dtype=dtype, memory_format=torch.contiguous_format, copy=True)


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """Same tree, numpy leaves as contiguous tensors on ``device``."""
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        return _place(node, dev)

    return convert(tree)


def _transposed(v):
    return v.detach().T if isinstance(v, torch.Tensor) else np.asarray(v).T


def _linear(sd: Mapping, prefix: str, dtype, dev) -> dict:
    return {
        "w": _place(_transposed(sd[f"{prefix}.weight"]), dev, dtype),
        "b": _place(sd[f"{prefix}.bias"], dev, dtype),
    }


def _layer_indices(sd: Mapping, prefix: str) -> list:
    """Linear-layer indices under an ``nn.Sequential`` prefix, sorted as
    integers (``NN.10`` after ``NN.8``).

    Activations hold no parameters, so the ``{prefix}.{j}.weight`` keys
    are exactly the Linear layers.  Raises when nothing matches: a silent
    empty layer list would make the net a pass-through.
    """
    depth = len(prefix.split("."))
    idxs = sorted(
        {int(k.split(".")[depth]) for k in sd if k.startswith(prefix + ".") and k.endswith(".weight")}
    )
    if not idxs:
        raise KeyError(
            f"no '{prefix}.{{i}}.weight' keys in the state_dict — wrong "
            f"model or a wrapper prefix? (keys look like: {sorted(sd)[:4]}...)"
        )
    return idxs


def score_mlp_from_torch(
    sd: Mapping, n_layers: Optional[int] = None, dtype=torch.float32, device: DeviceLike = None
) -> dict:
    """Reference ``MLP`` state_dict -> ``init_score_mlp``-style params.

    Keys: ``NN.{i}.weight/bias`` and ``W``.  Layer indices are read from
    the keys; ``n_layers``, if given, is checked against the checkpoint
    (an undersized count would silently truncate the net).
    """
    dev = resolve_device(device)
    idxs = _layer_indices(sd, "NN")
    if n_layers is not None and n_layers != len(idxs):
        raise ValueError(
            f"n_layers={n_layers} but the checkpoint has {len(idxs)} "
            f"Linear layers (NN.{{{', '.join(map(str, idxs))}}})"
        )
    return {
        "W": _place(sd["W"], dev, dtype),
        "layers": [_linear(sd, f"NN.{i}", dtype, dev) for i in idxs],
    }


def velocity_mlp_from_torch(sd: Mapping, dtype=torch.float32, device: DeviceLike = None) -> dict:
    """Reference ``ODEFlow``/``ConditionalODEFlow`` velocity net: an
    ``nn.Sequential`` of alternating Linear and activation, so the Linear
    layers are the keys ``velocity.{j}.weight`` for even j.  The
    checkpoint also carries ``target_shift``/``target_scale`` (and
    conditional) buffers: see :func:`standardization_from_torch`."""
    dev = resolve_device(device)
    return {"layers": [_linear(sd, f"velocity.{j}", dtype, dev) for j in _layer_indices(sd, "velocity")]}


def symplectic_mlp_from_torch(sd: Mapping, dtype=torch.float32, device: DeviceLike = None) -> dict:
    """Reference ``SymplecticMLP``: two Sequentials ``mlp_q_dynamics`` /
    ``mlp_p_dynamics`` plus the frozen ``W``."""
    dev = resolve_device(device)

    def seq(prefix):
        return [_linear(sd, f"{prefix}.{j}", dtype, dev) for j in _layer_indices(sd, prefix)]

    return {
        "W": _place(sd["W"], dev, dtype),
        "q_layers": seq("mlp_q_dynamics"),
        "p_layers": seq("mlp_p_dynamics"),
    }


_STAT_NAMES = (
    "shift",
    "scale",
    "target_shift",
    "target_scale",
    "conditional_shift",
    "conditional_scale",
)


def standardization_from_torch(
    sd: Mapping, prefix: str = "", dtype=torch.float32, device: DeviceLike = None
) -> dict:
    """The wrappers' standardization buffers of a reference checkpoint.

    Returns whichever of ``shift/scale`` (diffusion and symplectic
    wrappers), ``target_shift/target_scale`` (flow) and
    ``conditional_shift/conditional_scale`` exist under ``prefix``; pass
    them to the model constructor so the converted model standardizes
    like the original.  0-d and empty buffers are skipped.
    """
    dev = resolve_device(device)
    out = {}
    for name in _STAT_NAMES:
        key = f"{prefix}{name}" if prefix else name
        if key in sd:
            v = sd[key]
            shape = tuple(v.shape) if isinstance(v, torch.Tensor) else np.shape(v)
            if len(shape) > 0 and int(np.prod(shape)) > 0:
                out[name] = _place(v, dev, dtype)
    return out
