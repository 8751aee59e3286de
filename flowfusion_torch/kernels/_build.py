"""Build the port's CUDA sources with ``nvcc`` at first use, load with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/flowfusion_torch/lib<name>-<hash>.so``
under the repository root, keyed on a hash of the source text, every
header in ``csrc/`` (the sources share ``mlp_tile.cuh``) and the compiler
flags, so an edited source or header rebuilds and an unchanged one loads
the library already built.  The sources have a plain C interface (no
PyTorch headers), which keeps a build to seconds.  A source listed in
``VARIANTS`` is built once a variant, each with its own ``-D`` define
(``lib<name>-<variant>-<hash>.so``), so that its instantiations compile in
parallel: ``fused_sketch.cu`` once a compute mode.  ``build_host`` builds a
host C++ source, ``csrc/<name>.cpp`` (the native batch loader), the same
way with the host compiler (``$CXX``, else ``g++``, else ``c++``).
Nothing here runs at import time; a failed build raises.  ``count_launch``
is the wrappers' one launch counter.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional

__all__ = ["SOURCES", "build", "build_all", "build_host", "load"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "flowfusion_torch"
SOURCES = ("fused_mlp", "em_sampler", "fused_sketch", "fused_train")
# Sources built once a variant: name -> (the macro, its values by variant).
VARIANTS = {"fused_sketch": ("FF_SKETCH_PRECISION", {"float32": 0, "highf32": 1, "bfloat16": 2})}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_loaded: Dict[tuple, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from source at first use"
    )


def _defines(name: str, variant: Optional[str]) -> tuple:
    """The ``-D`` flag of ``variant`` of a source in ``VARIANTS`` (its first
    variant when None), else none."""
    if name not in VARIANTS:
        return ()
    macro, values = VARIANTS[name]
    return (f"-D{macro}={values[variant or next(iter(values))]}",)


def _library_path(name: str, variant: Optional[str] = None) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + _defines(name, variant)).encode())
    tag = f"{name}-{variant or next(iter(VARIANTS[name][1]))}" if name in VARIANTS else name
    return BUILD_DIR / f"lib{tag}-{h.hexdigest()[:16]}.so"


def _compile(compiler: list, source: Path, out: Path) -> Path:
    """Run ``compiler ... -o <tmp> source`` unless ``out`` exists, then
    move the result to ``out``."""
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([*compiler, "-o", tmp, str(source)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{os.path.basename(compiler[0])} failed to build {source.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: concurrent builds see whole files
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build(name: str, variant: Optional[str] = None) -> Path:
    """Compile ``csrc/<name>.cu`` (``variant`` of a source in ``VARIANTS``,
    its first when None) unless the library for this source exists."""
    return _compile([_nvcc(), *NVCC_FLAGS, *_defines(name, variant)], CSRC / f"{name}.cu",
                    _library_path(name, variant))


def jobs(names=SOURCES) -> list:
    """``(name, variant)`` of every library of ``names``: one a source, one
    a variant for the sources in ``VARIANTS``."""
    return [(n, v) for n in names for v in (VARIANTS[n][1] if n in VARIANTS else (None,))]


def _cxx() -> str:
    for candidate in (os.environ.get("CXX"), "g++", "c++"):
        found = candidate and shutil.which(candidate)
        if found:
            return found
    raise RuntimeError("no host C++ compiler found ($CXX, g++, c++)")


def _host_library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes())
    h.update(" ".join(HOST_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_host(name: str) -> Path:
    """Compile the host source ``csrc/<name>.cpp`` with the host compiler
    unless the library for this source exists."""
    return _compile([_cxx(), *HOST_FLAGS], CSRC / f"{name}.cpp", _host_library_path(name))


def build_all() -> None:
    """Build every library, one nvcc each (a source, or a variant of one),
    all started together."""
    todo = jobs()
    with ThreadPoolExecutor(max_workers=len(todo)) as pool:
        for fut in [pool.submit(build, *job) for job in todo]:
            fut.result()


def load(name: str, variant: Optional[str] = None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (``variant`` of a source
    in ``VARIANTS``), building it if needed."""
    lib = _loaded.get((name, variant))
    if lib is None:
        lib = ctypes.CDLL(str(build(name, variant)))
        _loaded[(name, variant)] = lib
    return lib


_COUNT_LOCK = threading.Lock()


def count_launch(counter, **by) -> None:
    """One launch on a wrapper's counts: ``counter.launches`` and, for each
    keyword, ``counter.<name>[value]`` (e.g. ``launches_by_mode=mode``).
    Under a lock: routed shards launch from one thread a card, and ``+=``
    is not atomic across threads."""
    with _COUNT_LOCK:
        counter.launches += 1
        for name, key in by.items():
            getattr(counter, name)[key] += 1
