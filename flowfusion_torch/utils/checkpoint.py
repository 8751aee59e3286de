"""Reader of the JAX package's npz checkpoint format, in numpy alone.

The format (the JAX package's ``utils/checkpoint.py::save_npz``) is one .npz
archive: a ``__meta__`` entry holding JSON (leaf path names, dtypes,
shapes and caller-owned ``extra`` metadata) and one ``leaf_i`` array per
pytree leaf.  Leaves of dtypes numpy cannot store natively (bf16, f8) are
raw bytes with their dtype recorded in the metadata.

Leaf paths are JAX key paths joined by ``/``: ``.name`` is a dataclass
field, ``['key']`` a dict key and ``[i]`` a list index, e.g.
``.params/['layers']/[0]/['w']`` (a ScoreModel) or
``.score_model/.params/['W']`` and ``.shift`` (a population wrapper).
``load_npz`` rebuilds them into nested dicts and lists.  The writer is
not ported yet (ROADMAP.md queue 1, item 14).
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List

import numpy as np

__all__ = ["load_npz", "load_npz_leaves", "read_npz_extra"]

_PART = re.compile(r"^(?:\.(?P<attr>\w+)|\['(?P<key>[^']*)'\]|\[(?P<idx>\d+)\])$")


def _read(path: str):
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        raw = [data[f"leaf_{i}"] for i in range(meta["n"])]
    return meta, raw


def read_npz_extra(path: str) -> dict:
    """The caller-owned metadata saved with the checkpoint (``extra=``)."""
    meta, _ = _read(path)
    return meta.get("extra", {})


def load_npz_leaves(path: str) -> Dict[str, np.ndarray]:
    """Leaf path name -> array, in the archive's leaf order."""
    meta, raw = _read(path)
    dtypes = meta.get("dtypes")
    shapes = meta.get("shapes")
    leaves = {}
    for i, (name, arr) in enumerate(zip(meta["names"], raw)):
        if dtypes is not None and arr.dtype == np.uint8 and dtypes[i] != "uint8":
            try:
                dtype = np.dtype(dtypes[i])
            except TypeError as err:
                raise ValueError(
                    f"leaf {name} has dtype {dtypes[i]!r}, which numpy "
                    "cannot represent here"
                ) from err
            arr = np.frombuffer(arr.tobytes(), dtype).reshape(shapes[i])
        leaves[name] = arr
    return leaves


def _parse(name: str) -> List[Any]:
    keys = []
    for part in name.split("/"):
        m = _PART.match(part)
        if m is None:
            raise ValueError(f"unrecognised leaf path component {part!r} in {name!r}")
        if m.group("idx") is not None:
            keys.append(int(m.group("idx")))
        else:
            keys.append(m.group("attr") or m.group("key"))
    return keys


def _listify(node):
    """Turn dicts keyed 0..n-1 (list levels) into lists, recursively."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        if sorted(node) != list(range(len(node))):
            raise ValueError(f"list indices {sorted(node)} are not 0..{len(node) - 1}")
        return [node[i] for i in range(len(node))]
    return node


def load_npz(path: str) -> Dict[str, Any]:
    """The checkpoint as a nested tree of dicts, lists and numpy arrays.

    A flagship ScoreModel checkpoint gives ``{"params": {"W", "layers":
    [{"w", "b"}, ...]}}``; a population wrapper gives ``{"score_model":
    {"params": ...}, "shift", "scale", "conditional_shift",
    "conditional_scale"}``.
    """
    root: Dict[Any, Any] = {}
    for name, arr in load_npz_leaves(path).items():
        keys = _parse(name)
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr
    return _listify(root)
