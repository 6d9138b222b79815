"""Checkpointing: npz arrays + JSON manifest, atomic commit, async writer,
restore onto a device. The port of ``repro/checkpoint/checkpoint.py``, with
the same on-disk format, so a checkpoint written by either package restores
in the other.

Layout:
  <dir>/step_<N>.tmp/            (written)
  <dir>/step_<N>/                (atomic rename = commit)
    manifest.json                {step, keys, shapes, dtypes, extra}
    arrays.npz                   one entry per leaf, under its "/"-joined path

A leaf's key joins its dict keys and list indices with "/" (dict keys in
sorted order, as the JAX package's pytree paths), so a tree of the same
structure gets the same keys in both packages. numpy has no bfloat16: it is
stored as its uint16 bits, with "bfloat16" as the leaf's dtype in the
manifest (float8 likewise as uint8).

Fault-tolerance contract: a crash mid-write leaves only a .tmp directory;
``latest_step`` ignores it, so a restart resumes from the last COMMITTED
step.

Over a mesh of processes (``launch.mesh.DistMesh``) a checkpoint holds
every leaf whole, in the same layout: ``save(..., mesh=, spec_tree=)``
gathers every rank's blocks (``launch.shardings.gather_tree``) and rank 0
of the mesh writes them while the others wait at a barrier, and
``restore(..., mesh=, spec_tree=)`` gives each rank its block of every
leaf. A mesh of another size than the one that saved restores the same
way: the elastic re-mesh after a node is lost.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch import shardings
from repro_torch.tree import leaves_with_paths, map_with_paths, path_key

# the dtypes numpy cannot hold, kept as raw bits: logical name -> (torch
# dtype, a torch integer dtype of its width, the numpy dtype stored)
_VIEW_DTYPES = {
    "bfloat16": (torch.bfloat16, torch.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8),
}
_VIEW_NAMES = {dtype: name for name, (dtype, _, _) in _VIEW_DTYPES.items()}


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A tensor leaf as stored (a host copy of its bits) and its logical dtype."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype in _VIEW_NAMES:
        name = _VIEW_NAMES[t.dtype]
        _, bits, store = _VIEW_DTYPES[name]
        return t.view(bits).numpy().view(store), name
    arr = t.numpy()
    return arr, str(arr.dtype)


def _host_tree(tree) -> Dict[str, Tuple[np.ndarray, str]]:
    """key -> (numpy array as stored, logical dtype) for every leaf."""
    return {path_key(path): _to_host(leaf) for path, leaf in leaves_with_paths(tree)}


def _save_host(flat: Dict[str, Tuple[np.ndarray, str]], directory: str, step: int, extra: Optional[Dict]) -> str:
    tmp = os.path.join(directory, f"step_{step}.tmp")
    final = os.path.join(directory, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **{k: a for k, (a, _) in flat.items()})
    manifest = {
        "step": step,
        "keys": sorted(flat.keys()),
        "shapes": {k: list(a.shape) for k, (a, _) in flat.items()},
        "dtypes": {k: dt for k, (_, dt) in flat.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)            # atomic commit
    return final


def save(tree, directory: str, step: int, *, extra: Optional[Dict] = None, mesh=None,
         spec_tree=None) -> Optional[str]:
    """Synchronous atomic save.  Returns the committed path. With a
    DistMesh, ``tree`` is this rank's blocks under ``spec_tree``: every
    rank of the mesh calls this, rank 0 of the mesh writes the whole
    leaves and returns the path, the others None once it is committed."""
    if mesh is None:
        return _save_host(_host_tree(tree), directory, step, extra)
    tree = shardings.gather_tree(tree, spec_tree, mesh)
    path = None
    if mesh.axis_index(mesh.axis_names) == 0:
        path = _save_host(_host_tree(tree), directory, step, extra)
    mesh.barrier()
    return path


class AsyncCheckpointer:
    """Overlaps checkpoint IO with compute: ``save`` returns once the tree is
    copied to host memory, and a writer thread persists the copy, so the
    train loop may update the tensors in place meanwhile. ``wait()`` joins
    the write in flight (call it before exit; the next ``save`` does)."""

    def __init__(self, directory: str):
        self.directory = directory
        self._thread: Optional[threading.Thread] = None
        self.last_committed: Optional[str] = None

    def save(self, tree, step: int, *, extra=None):
        self.wait()
        flat = _host_tree(tree)           # device -> host snapshot, before the thread starts

        def _write():
            self.last_committed = _save_host(flat, self.directory, step, extra)

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _to_tensor(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical in _VIEW_DTYPES:
        dtype, bits, _ = _VIEW_DTYPES[logical]
        as_bits = arr.view(torch.empty((), dtype=bits).numpy().dtype)
        return torch.from_numpy(as_bits).view(dtype)
    return torch.from_numpy(arr)


def restore(directory: str, step: int, like_tree, *, device=None, mesh=None,
            spec_tree=None) -> Any:
    """Load a checkpoint into the structure of ``like_tree``, whose leaves
    (tensors, on any device, ``meta`` included) give each leaf's dtype.
    Each leaf lands on ``device``, or on its like-leaf's device if None.
    With a DistMesh and ``spec_tree`` each rank gets its own block of every
    leaf (a copy of that block alone), whatever mesh saved it."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        flat = {k: data[k] for k in data.files}

    specs = None if mesh is None else shardings.specs_by_path(like_tree, spec_tree)

    def load(p, like):
        key = path_key(p)
        arr = flat[key]
        if specs is not None:      # this rank's block, a copy of its own
            arr = np.array(shardings.block_of(arr, specs[p], mesh), order="C")
        t = _to_tensor(arr, manifest["dtypes"][key])
        return t.to(device=like.device if device is None else device, dtype=like.dtype)

    return map_with_paths(load, like_tree)
