"""Device profiling helpers: traces, annotations, memory stats (counterpart
of the JAX package's ``utils/profiling.py``).

Solver-level counters live in ``ops.integrate.SolverStats`` and
``utils.diagnostics``; this module is the hardware side: capture a
``torch.profiler`` trace of any region, annotate solver phases so they are
findable in the timeline, and read each card's memory use.

Usage::

    from flowfusion_torch.utils import profiling

    with profiling.trace("runs/trace"):        # Chrome/Perfetto JSON
        with profiling.annotate("strict-solve"):
            lp, _ = model.log_prob(x)

    profiling.device_memory()                  # {"cuda:0": {...}}
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

from .._device import DeviceLike, resolve_device
from .diagnostics import profiler_trace, trace_annotation

__all__ = ["trace", "annotate", "device_memory", "format_device_memory"]


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_trace: bool = False) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the enclosed region into
    ``log_dir`` (``diagnostics.profiler_trace``).  A torch trace is
    already Chrome/Perfetto JSON, so ``create_perfetto_trace`` changes
    nothing; it keeps the JAX package's signature."""
    with profiler_trace(log_dir):
        yield


# the same span under the JAX package's second name
annotate = trace_annotation


def _cuda_stats(index: int) -> dict:
    """torch's allocator stats of one card, with the JAX package's three
    keys beside them."""
    stats = dict(torch.cuda.memory_stats(index))
    stats["bytes_in_use"] = stats.get("allocated_bytes.all.current", 0)
    stats["peak_bytes_in_use"] = stats.get("allocated_bytes.all.peak", 0)
    stats["bytes_limit"] = torch.cuda.get_device_properties(index).total_memory
    return stats


def device_memory(device: DeviceLike = None) -> dict:
    """Memory statistics (bytes) keyed by device string.

    With ``device=None`` every visible CUDA card (``"cuda:i"``; with no
    card this raises, as every entry point does); a CUDA device gives its
    own entry, and ``"cpu"`` gives ``{"cpu": {}}``, as the JAX package
    maps a backend without stats.  A card's entry holds
    ``bytes_in_use``, ``peak_bytes_in_use`` and ``bytes_limit`` (the
    card's total memory) beside ``torch.cuda.memory_stats``.
    """
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {str(dev): {}}
    if device is None:
        indices = range(torch.cuda.device_count())
    else:
        indices = [dev.index if dev.index is not None else torch.cuda.current_device()]
    return {f"cuda:{i}": _cuda_stats(i) for i in indices}


def format_device_memory(device: DeviceLike = None) -> str:
    """One line a device: in use / peak / limit."""

    def gb(n):
        return f"{n / 2**30:.2f} GiB"

    lines = []
    for name, s in device_memory(device).items():
        if not s:
            lines.append(f"{name}: (no memory stats on this backend)")
            continue
        in_use = s.get("bytes_in_use")
        peak = s.get("peak_bytes_in_use")
        limit = s.get("bytes_limit")
        parts = [f"in use {gb(in_use)}" if in_use is not None else None,
                 f"peak {gb(peak)}" if peak is not None else None,
                 f"limit {gb(limit)}" if limit is not None else None]
        lines.append(f"{name}: " + ", ".join(p for p in parts if p))
    return "\n".join(lines)
