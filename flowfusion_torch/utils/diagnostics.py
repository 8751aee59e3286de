"""Observability: profiler spans and traces, solver-stat summaries, timers
and finite checks (counterpart of the JAX package's ``utils/diagnostics.py``).

The solvers return their own counters (``SolverStats``); this module adds
the host-side conveniences around them.  Spans are
``torch.profiler.record_function`` regions, and on a CUDA card also NVTX
ranges; a trace is a ``torch.profiler`` capture of CPU and (with a card)
CUDA activity, written as Chrome/Perfetto JSON.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Iterator

import numpy as np
import torch

from .tree import leaves_with_paths

__all__ = [
    "trace_annotation",
    "profiler_trace",
    "summarize_stats",
    "Timer",
    "assert_all_finite",
]


@contextlib.contextmanager
def trace_annotation(name: str) -> Iterator[None]:
    """Named region in a ``torch.profiler`` trace and, on a CUDA card, an
    NVTX range; usable as a decorator too."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


@contextlib.contextmanager
def profiler_trace(log_dir: str) -> Iterator[None]:
    """Profile the enclosed block (CPU activity, and CUDA activity when a
    card is visible) and write its trace under ``log_dir`` on exit.  The
    profiler synchronises the card when it stops, so the trace holds the
    block's kernels."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)
    ):
        yield


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def summarize_stats(stats) -> Dict[str, Any]:
    """SolverStats -> plain dict of Python numbers.

    Handles batch-global stats (int or 0-d counters, from ``odeint``) and
    the per-sample (B,) stats of the per-sample solvers
    (``log_prob_per_sample`` / ``odeint_per_sample``); the latter are
    summarized as totals plus per-sample min/mean/max.
    """
    if stats is None:
        return {}
    nfe = _host(stats.n_func_evals)
    acc = _host(stats.n_accepted)
    rej = _host(stats.n_rejected)
    ok = _host(stats.succeeded)
    if nfe.ndim == 0:
        return {
            "n_func_evals": int(nfe),
            "n_accepted": int(acc),
            "n_rejected": int(rej),
            "reject_fraction": float(int(rej) / max(1, int(acc) + int(rej))),
            "succeeded": bool(ok),
        }
    return {
        "n_samples": int(nfe.shape[0]),
        "n_func_evals_total": int(nfe.sum()),
        "n_func_evals_per_sample": {
            "min": int(nfe.min()), "mean": float(nfe.mean()), "max": int(nfe.max())
        },
        "n_accepted_total": int(acc.sum()),
        "n_rejected_total": int(rej.sum()),
        "reject_fraction": float(rej.sum() / max(1, acc.sum() + rej.sum())),
        "succeeded": bool(ok.all()),
        "n_failed_samples": int((~ok.astype(bool)).sum()),
    }


@dataclasses.dataclass
class Timer:
    """Wall-clock timer that waits for the card's work.

    with Timer() as t:
        out = fn(...)
        t.block_on(out)
    print(t.seconds)
    """

    seconds: float = 0.0
    _t0: float = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def block_on(self, x):
        """Synchronise the CUDA device of every tensor leaf of ``x``, so
        the timed window covers their computation; CPU leaves need
        nothing."""
        devices = {leaf.device for _, leaf in leaves_with_paths(x)
                   if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda"}
        for d in devices:
            torch.cuda.synchronize(d)
        return x

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return False


def assert_all_finite(tree: Any, name: str = "value") -> None:
    """Finite check over every leaf of ``tree``; raises
    ``FloatingPointError`` naming the leaf's path (``utils.tree``'s
    spelling) and the count of non-finite elements."""
    for path, leaf in leaves_with_paths(tree):
        if isinstance(leaf, torch.Tensor):
            bad, size = int((~torch.isfinite(leaf)).sum()), leaf.numel()
        else:
            bad, size = int(np.size(leaf) - np.isfinite(leaf).sum()), int(np.size(leaf))
        if bad:
            raise FloatingPointError(f"{name}{path}: {bad}/{size} non-finite elements")
