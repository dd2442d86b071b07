"""Atomic numpy checkpoints with auto-resume, and restore onto another
device or dtype.

Layout, as the reference's (src/repro/training/checkpoint.py):
<dir>/step_<n>/ arrays.npz + tree.json, one array per leaf under its
`/`-joined key path (``params/layers/wq``, ``opt_state/.m/layers/wq``: a
named tuple's field is ``.name``, as JAX prints its attribute key), so a
checkpoint either package wrote restores in the other. Writes go to a
temporary directory and an atomic rename, so a crash mid-write never
corrupts the latest checkpoint. numpy has no bf16: a bf16 leaf is stored
as f32, which holds it exactly, and `restore` casts every leaf to the dtype
of its counterpart in `like`. `restore(..., device=)` places the leaves on
another device (saved on the card, restored on the host, or the other
way), and `restore(..., mesh=, placements=)` onto a mesh: the elastic
path, where a checkpoint saved on one mesh (or none) resumes on another.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import Placement

from repro_torch.distributed.sharding import distribute
from repro_torch.params import nested


def _items(tree) -> Iterator[Tuple[str, Any]]:
    """The children of one node of a tree under their key path parts: a
    mapping's sorted keys (as JAX orders a dict), `ModelParams` leaves, a
    named tuple's fields as ``.name``."""
    if hasattr(tree, "leaves"):                            # ModelParams
        return iter(tree.leaves().items())
    if isinstance(tree, Mapping):
        return ((str(k), tree[k]) for k in sorted(tree))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return ((f".{name}", getattr(tree, name)) for name in tree._fields)
    raise TypeError(f"not a tree node: {type(tree).__name__}")


def _is_placements(x) -> bool:
    return isinstance(x, (list, tuple)) and bool(x) and \
        all(isinstance(p, Placement) for p in x)


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{key path: leaf} of a tree of mappings, named tuples and
    `ModelParams` whose leaves are tensors or placement sequences."""
    if isinstance(tree, torch.Tensor) or _is_placements(tree):
        return {prefix: tree}
    flat = {}
    for key, child in _items(tree):
        flat.update(_flatten(child, f"{prefix}/{key}" if prefix else key))
    return flat


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.float()                           # exact: numpy has no bf16
    return x.cpu().numpy()


def save(directory: str, step: int, tree: Any, keep: int = 3,
         async_write: bool = False) -> str:
    """Atomic checkpoint write of `tree` as step `step`, keeping the newest
    `keep` steps. The leaves reach the host before this returns; with
    `async_write` a daemon thread writes them. Returns the checkpoint
    path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    flat = {k: _to_numpy(x) for k, x in _flatten(tree).items()}

    def _write():
        tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_")
        try:
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            with open(os.path.join(tmp, "tree.json"), "w") as f:
                json.dump({"step": step, "keys": list(flat)}, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        finally:
            if os.path.exists(tmp):
                shutil.rmtree(tmp, ignore_errors=True)
        _gc(directory, keep)

    if async_write:
        threading.Thread(target=_write, daemon=True).start()
    else:
        _write()
    return final


def _gc(directory: str, keep: int) -> None:
    steps = list_steps(directory)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def list_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def _rebuild(like, leaves: Dict[str, Any], prefix: str = ""):
    """A tree shaped like `like` whose leaves are `leaves[key path]`."""
    if isinstance(like, torch.Tensor):
        return leaves[prefix]
    kids = {key: _rebuild(child, leaves, f"{prefix}/{key}" if prefix
                          else key) for key, child in _items(like)}
    if hasattr(like, "leaves"):                            # ModelParams
        trainable = any(p.requires_grad for p in like.leaves().values())
        return type(like)(nested(kids), trainable=trainable)
    if isinstance(like, Mapping):
        return {k: kids[str(k)] for k in like}
    return type(like)(*(kids[f".{n}"] for n in like._fields))


def restore(directory: str, step: int, like: Any, *, device=None,
            mesh=None, placements: Any = None) -> Any:
    """Restore step `step` into the structure of `like`: each leaf takes
    the dtype of its counterpart in `like` and its device, or `device`
    where given (the elastic case: save on one device, resume on another).
    With `mesh` and `placements` (a tree shaped like `like` whose leaves
    are placement sequences, one per mesh dim: `tree_placements` for the
    params), each leaf is loaded whole on `device` (or the mesh's device
    type) and distributed onto the mesh, each rank keeping its own block:
    the counterpart of the reference's `shardings=`. Raises on a missing
    key or a shape that differs."""
    path = os.path.join(directory, f"step_{step:08d}")
    place = _flatten(placements) if placements is not None else {}
    if place and device is None:
        device = mesh.device_type
    out = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key, leaf in _flatten(like).items():
            arr = data[key]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"{key}: saved {arr.shape}, expected "
                                 f"{tuple(leaf.shape)}")
            t = torch.from_numpy(arr).to(device=device or leaf.device,
                                         dtype=leaf.dtype)
            out[key] = distribute(t, mesh, place[key]) if place else t
    return _rebuild(like, out)
