"""Build the port's CUDA sources with ``nvcc`` at first use, load with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/flowfusion_torch/lib<name>-<hash>.so``
under the repository root, keyed on a hash of the source text, every
header in ``csrc/`` (the sources share ``mlp_tile.cuh``) and the compiler
flags, so an edited source or header rebuilds and an unchanged one loads
the library already built.  The sources have a plain C interface (no
PyTorch headers), which keeps a build to seconds.  Nothing here runs at
import time; a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

__all__ = ["SOURCES", "build", "build_all", "load"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "flowfusion_torch"
SOURCES = ("fused_mlp", "em_sampler", "fused_sketch", "fused_train")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}


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


def _library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the library for this source exists."""
    out = _library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: concurrent builds see whole files
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_all() -> None:
    """Build every source, one nvcc per source, all started together."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        for fut in [pool.submit(build, n) for n in SOURCES]:
            fut.result()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib
