"""ctypes bridge to the native (C++) shuffled-batch prefetcher (counterpart
of the JAX package's ``utils/native_loader.py``).

``csrc/dataloader.cpp`` is built on first use with the host compiler
(``kernels/_build.py::build_host``, into ``build/flowfusion_torch/``) and
exposed as an iterator of numpy batches.  ``NativeBatchLoader.available()``
says whether the library built; the constructor raises with the
compiler's message when it did not.  ``numpy_batch_iterator`` is a
pure-NumPy iterator with the same epoch-shuffle semantics, for the caller
to choose; nothing swaps it in quietly.

Typical use (million-row conditional-density training):

    loader = NativeBatchLoader("thetas_conds.f32", n_cols=9, batch=65536)
    for _ in range(steps):
        batch = torch.from_numpy(loader.next()).to("cuda")  # (batch, n_cols)
        x, c = batch[:, :6], batch[:, 6:]
"""

from __future__ import annotations

import ctypes
import threading
from typing import Iterator, Optional

import numpy as np

from ..kernels import _build

__all__ = ["NativeBatchLoader", "write_f32", "numpy_batch_iterator"]

_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_ERR: Optional[str] = None


def _build_and_load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_ERR
    with _LIB_LOCK:
        if _LIB is not None or _LIB_ERR is not None:
            return _LIB
        try:
            lib = ctypes.CDLL(str(_build.build_host("dataloader")))
            lib.ffdl_open.restype = ctypes.c_void_p
            lib.ffdl_open.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_uint64,
            ]
            lib.ffdl_next.restype = ctypes.c_int
            lib.ffdl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
            lib.ffdl_n_rows.restype = ctypes.c_int64
            lib.ffdl_n_rows.argtypes = [ctypes.c_void_p]
            lib.ffdl_n_cols.restype = ctypes.c_int64
            lib.ffdl_n_cols.argtypes = [ctypes.c_void_p]
            lib.ffdl_close.argtypes = [ctypes.c_void_p]
            lib.ffdl_last_error.restype = ctypes.c_char_p
            _LIB = lib
        except Exception as e:  # no compiler, or the build failed
            _LIB_ERR = str(e)
            _LIB = None
        return _LIB


class NativeBatchLoader:
    """Threaded shuffled minibatches from a row-major float32 binary file."""

    def __init__(
        self,
        path: str,
        n_cols: int,
        batch: int,
        prefetch_depth: int = 4,
        seed: int = 0,
    ):
        lib = _build_and_load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_LIB_ERR}")
        self._lib = lib
        self._handle = lib.ffdl_open(
            path.encode(), n_cols, batch, prefetch_depth, seed
        )
        if not self._handle:
            raise RuntimeError(lib.ffdl_last_error().decode())
        self.batch = batch
        self.n_cols = n_cols
        self.n_rows = lib.ffdl_n_rows(self._handle)

    @staticmethod
    def available() -> bool:
        """Whether the C++ library built (or was already built)."""
        return _build_and_load() is not None

    def next(self) -> np.ndarray:
        """Blocking fetch of the next prefetched (batch, n_cols) array."""
        if getattr(self, "_handle", None) is None:
            raise RuntimeError("native loader is closed")
        out = np.empty((self.batch, self.n_cols), np.float32)
        rc = self._lib.ffdl_next(
            self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        )
        if rc != 0:
            raise RuntimeError("native loader stopped")
        return out

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            yield self.next()

    def close(self) -> None:
        """Stop the prefetch thread and release the mmap."""
        if getattr(self, "_handle", None):
            self._lib.ffdl_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def write_f32(path: str, array: np.ndarray) -> None:
    """Write a row-major float32 binary dataset file."""
    np.ascontiguousarray(array, np.float32).tofile(path)


def numpy_batch_iterator(
    x: np.ndarray, batch: int, seed: int = 0
) -> Iterator[np.ndarray]:
    """Pure-NumPy iterator with the same epoch-shuffle semantics."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    while True:
        perm = rng.permutation(n)
        for i in range(0, n - batch + 1, batch):
            yield x[perm[i : i + batch]]
