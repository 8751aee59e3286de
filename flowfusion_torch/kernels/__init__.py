"""Hand-written CUDA kernels for Hopper (sources in ``../csrc``), each with
its plain PyTorch version beside it.  CUDA tensors launch the kernel, CPU
tensors run the plain version.

The package's public names are the JAX package's ``kernels`` names: the
RHS kernel's wrappers and envelope predicates and the EM sampler.  They
resolve on first use, since the kernel modules import the models, which
import the kernel modules."""

import importlib

_HOME = {
    "fusable_config": "fused_mlp",
    "fused_drift": "fused_mlp",
    "fused_drift_reference": "fused_mlp",
    "fused_em_sample": "em_sampler",
    "fused_velocity": "fused_mlp",
    "pad_to_lanes": "fused_mlp",
    "paddable_config": "fused_mlp",
    "supports_config": "fused_mlp",
}

__all__ = sorted(_HOME)


def __getattr__(name):
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_HOME[name]}", __name__), name)
