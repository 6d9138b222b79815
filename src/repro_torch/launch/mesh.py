"""Meshes for the port: the counterpart of ``repro.launch.mesh``.

The JAX package's mesh spreads its ``model`` axis over devices, and one
process drives them all (``shard_map``). The port keeps that single
controller on one card: :func:`make_local_mesh` returns a mesh whose
``model`` axis is a set of shards held by this process on one device. The
sequence-sharded decode (``models.attention.attn_decode_sharded``) gives
each shard a view of its sequence range of the cache, launches the partials
kernel once per shard and combines their softmax partials on that device.
Spreading the shards over processes and cards (``torch.distributed``) is
not ported yet.

``make_production_mesh`` (the 256- and 512-chip pods) waits for the port of
the dry-run tooling.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import torch


@dataclass(frozen=True)
class LocalMesh:
    """A (data, model) mesh of shards held by one process on one device."""
    shape: Dict[str, int]
    device: torch.device
    axis_names: Tuple[str, ...] = field(default=("data", "model"))


def make_local_mesh(model_parallel: int = 1, device="cuda") -> LocalMesh:
    """A mesh of ``model_parallel`` sequence shards on ``device``."""
    if model_parallel < 1:
        raise ValueError(f"model_parallel must be >= 1, got {model_parallel}")
    return LocalMesh(shape={"data": 1, "model": model_parallel}, device=torch.device(device))


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], str]:
    """(batch_axes, model_axis) for a production-style mesh."""
    names = mesh.axis_names
    if "pod" in names:
        return ("pod", "data"), "model"
    return ("data",), "model"


def mesh_counts(mesh) -> Tuple[int, int]:
    """(n_batch, n_model)."""
    batch_axes, model_axis = mesh_axes(mesh)
    nb = 1
    for a in batch_axes:
        nb *= mesh.shape[a]
    return nb, mesh.shape[model_axis]
