"""Utilities: checkpoints (read and written), trees of tensors, weight
conversion, toy data, two-sample statistics, diagnostics and profiling, the
native batch loader and the serving artifacts."""

from . import checkpoint, convert, data, diagnostics, native_loader, profiling, stats, tree

__all__ = ["checkpoint", "convert", "data", "diagnostics", "native_loader", "profiling", "stats", "tree"]
