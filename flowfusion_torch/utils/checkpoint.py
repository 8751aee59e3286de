"""The JAX package's npz checkpoint format, read and written in numpy alone.

The format (the JAX package's ``utils/checkpoint.py::save_npz``) is one .npz
archive: a ``__meta__`` entry holding JSON (leaf path names, dtypes,
shapes and caller-owned ``extra`` metadata) and one ``leaf_i`` array per
pytree leaf.  Leaves of dtypes numpy cannot store natively (bf16, f8) are
raw bytes with their dtype recorded in the metadata.

Leaf paths are JAX key paths joined by ``/``: ``.name`` is a dataclass
field, ``['key']`` a dict key and ``[i]`` a list index, e.g.
``.params/['layers']/[0]/['w']`` (a ScoreModel) or
``.score_model/.params/['W']`` and ``.shift`` (a population wrapper).
``load_npz`` rebuilds them into nested dicts and lists; ``save_npz`` writes
a tree of the port (a model, or any dataclass/dict/list of tensors) under
the names the JAX package gives the same tree (``utils.tree``), so either
package reads what the other wrote.

``save_dcp`` / ``load_dcp`` are the counterpart of the JAX package's
``save_orbax`` / ``load_orbax``: a directory checkpoint of the same trees
through ``torch.distributed.checkpoint``, which ships with torch (orbax
needs JAX).  The npz format stays the one the two packages share.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .tree import leaves_with_paths, map_with_path

__all__ = ["save_npz", "load_npz", "load_npz_leaves", "read_npz_extra", "restore", "save_dcp", "load_dcp"]

_PART = re.compile(r"^(?:\.(?P<attr>\w+)|\['(?P<key>[^']*)'\]|\[(?P<idx>\d+)\])$")


def _read(path: str):
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        raw = [data[f"leaf_{i}"] for i in range(meta["n"])]
    return meta, raw


def save_npz(path: str, tree: Any, extra: Optional[dict] = None) -> None:
    """Write every leaf of ``tree`` to one .npz archive, atomically (a
    temporary file, then ``os.replace``: an interrupted save never
    truncates an earlier checkpoint).  ``extra`` is JSON metadata kept
    inside the archive.  Tensors are copied to the host; every leaf must
    have a dtype numpy stores natively (the float32 state of the port)."""
    named = leaves_with_paths(tree)
    arrays, dtypes, shapes = {}, [], []
    for i, (name, leaf) in enumerate(named):
        try:
            a = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        except TypeError as err:  # bfloat16 and the other dtypes numpy lacks
            raise ValueError(f"leaf {name} has dtype {leaf.dtype}, which numpy cannot store") from err
        if a.dtype.kind == "V" or a.dtype.name not in np.sctypeDict:
            raise ValueError(f"leaf {name} has dtype {a.dtype}, which numpy cannot store")
        arrays[f"leaf_{i}"] = a
        dtypes.append(str(a.dtype))
        shapes.append(list(a.shape))
    meta = json.dumps({
        "names": [name for name, _ in named], "n": len(named), "dtypes": dtypes,
        "shapes": shapes, "extra": extra or {},
    })
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __meta__=np.frombuffer(meta.encode(), dtype=np.uint8), **arrays)
    os.replace(tmp, path)


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
    return _nest(load_npz_leaves(path))


def _nest(leaves: Dict[str, Any]) -> Dict[str, Any]:
    """Leaf path name -> leaf, as a nested tree of dicts and lists (a tree
    that is one leaf has the empty name)."""
    if "" in leaves:
        return leaves[""]
    root: Dict[Any, Any] = {}
    for name, arr in leaves.items():
        keys = _parse(name)
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr
    return _listify(root)


def restore(template: Any, tree: Any) -> Any:
    """``template`` with every leaf replaced by the array at the same path
    of ``tree`` (a nested tree as ``load_npz`` returns it, of arrays or
    tensors), as a tensor of
    the template leaf's dtype on its device.  Raises when a path is missing
    or a shape differs."""

    def leaf(name: str, cur):
        node = tree
        try:
            for key in (_parse(name) if name else []):
                node = node[key]
        except (KeyError, IndexError, TypeError) as err:
            raise ValueError(f"checkpoint has no leaf {name!r}") from err
        arr = node if isinstance(node, torch.Tensor) else torch.as_tensor(np.asarray(node))
        if tuple(arr.shape) != tuple(cur.shape):
            raise ValueError(
                f"shape mismatch at {name}: checkpoint {tuple(arr.shape)} vs template {tuple(cur.shape)}")
        return arr.to(device=cur.device, dtype=cur.dtype)

    return map_with_path(leaf, template)


def save_dcp(path: str, tree: Any) -> None:
    """A ``torch.distributed.checkpoint`` directory of every leaf of
    ``tree`` (the trees ``save_npz`` takes), keyed by its path name; an
    existing checkpoint at ``path`` is overwritten, as the JAX package's
    ``save_orbax`` does.  Runs in one process without a process group."""
    import torch.distributed.checkpoint as dcp

    state = {name: leaf.detach() if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))
             for name, leaf in leaves_with_paths(tree)}
    dcp.save(state, storage_writer=dcp.FileSystemWriter(os.path.abspath(path), overwrite=True), no_dist=True)


def load_dcp(path: str, template: Any) -> Any:
    """``template`` filled from a ``save_dcp`` checkpoint (the JAX
    package's ``load_orbax``): every leaf a tensor of the template leaf's
    dtype on its device.  A path the checkpoint lacks or a shape that
    differs raises ``ValueError``, as ``restore`` does."""
    import torch.distributed.checkpoint as dcp

    reader = dcp.FileSystemReader(os.path.abspath(path))
    saved = reader.read_metadata().state_dict_metadata
    state = {name: torch.empty(tuple(m.size), dtype=m.properties.dtype) for name, m in saved.items()}
    dcp.load(state, storage_reader=reader, no_dist=True)
    return restore(template, _nest(state))
