"""Device policy shared by every entry point of the port.

The port runs on a CUDA card unless the caller asks for the CPU: an
explicit ``device="cpu"`` or CPU tensors handed in.  With no card visible
and no explicit request, entry points raise instead of carrying on
quietly on the CPU.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch

__all__ = ["resolve_device", "resolve_device_or_exit", "same_device", "strict_fp32_matmul"]

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "flowfusion_torch runs on a CUDA card by default and no CUDA "
            "device is visible; pass device='cpu' (or CPU tensors) to run "
            "the plain PyTorch path on the CPU"
        )
    return torch.device("cuda")


def resolve_device_or_exit(device: DeviceLike = None) -> torch.device:
    """:func:`resolve_device` for a command line (the CLI, the examples):
    with no card visible and no device asked for, exit with the reason and
    the flag that runs the plain path on the CPU."""
    try:
        return resolve_device(device)
    except RuntimeError as err:
        raise SystemExit(f"{err} (the CLI flag: --device cpu)")


@contextlib.contextmanager
def strict_fp32_matmul() -> Iterator[None]:
    """Turn TF32 off for float32 matrix products and convolutions inside
    the block, and restore the caller's settings after it.

    TF32 keeps ~3 decimal digits — enough to inflate adaptive step counts
    (the same trap as a single bf16 pass inside a Pallas kernel,
    the JAX package's kernels/fused_mlp.py:534-545).  The float32 compute
    mode's matmuls on the card (the plain path's, and the embedding fold
    beside the kernel) run inside this block.

    While ``torch.export`` or ``torch.compile`` traces, the block changes
    nothing: a traced program does not record the flags, and setting
    globals inside a traced loop body is a side effect the tracer refuses.
    Whoever runs the program sets them around the call
    (``utils.serving``)."""
    if torch.compiler.is_compiling():
        yield
        return
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def same_device(*tensors: Optional[torch.Tensor]) -> torch.device:
    """The one device all given tensors live on (None entries skipped)."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors live on different devices: {sorted(map(str, devs))}")
    return devs.pop()
