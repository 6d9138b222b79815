"""Error-feedback int8 gradient compression for the cross-pod (DCN) axis:
the port of ``repro/training/compression.py``.

On a multi-pod mesh the gradient all-reduce crosses the slow inter-pod link
once per step. This module compresses that sync: each pod quantizes its
gradient to int8 with a per-tensor scale, keeping the quantization
residual in an error-feedback buffer so that the bias vanishes over steps
(1-bit-Adam style), all-gathers the int8 payloads and the scales over the
``pod`` axis (S (n - 1) / n bytes a pod against 2 S (n - 1) / n for a
bf16 ring all-reduce: 4x fewer DCN bytes), and sums the dequantized
payloads locally.

Usage (opt-in), on a ``launch.mesh.DistMesh`` with a ``pod`` axis
(``make_dist_mesh(..., pod=n)``)::

    err = init_error_feedback(grads)
    grads, err = compressed_grad_sync(grads, err, mesh, axis="pod")

The payloads of all leaves travel together: one all-gather of the int8
values and one of the f32 scales a sync. Each pod then sums the pods'
dequantized leaves in pod order, so every pod ends with the same mean.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.tree import leaves, leaves_with_paths, map_with_paths, tree_map


def init_error_feedback(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def quantize_ef(g: torch.Tensor, err: torch.Tensor):
    """Error-feedback int8 quantization.  Returns (q int8, scale f32
    scalar, new_err)."""
    v = g.float() + err
    scale = torch.clamp(v.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
    new_err = v - q.float() * scale
    return q, scale, new_err


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_grad_sync(grads, err_tree, mesh, axis: str = "pod"):
    """Sync gradients across ``axis`` with int8 + error feedback.

    ``grads`` enter as this pod's (local) average and leave as the mean over
    the pods, in their dtypes; returns (grads, new error-feedback tree)."""
    n = mesh.axis_size(axis)
    paths = [p for p, _ in leaves_with_paths(grads)]
    flat_g, flat_e = leaves(grads), leaves(err_tree)
    quant = [quantize_ef(g, e) for g, e in zip(flat_g, flat_e, strict=True)]
    q_all = mesh.all_gather(torch.cat([q.reshape(-1) for q, _, _ in quant]), axis)   # (n, M)
    s_all = mesh.all_gather(torch.stack([s for _, s, _ in quant]), axis)             # (n, leaves)
    synced, start = [], 0
    for i, g in enumerate(flat_g):
        size = g.numel()
        total = dequantize(q_all[0, start:start + size], s_all[0, i])
        for pod in range(1, n):
            total = total + dequantize(q_all[pod, start:start + size], s_all[pod, i])
        synced.append((total / n).reshape(g.shape).to(g.dtype))
        start += size
    new_g = dict(zip(paths, synced, strict=True))
    new_e = dict(zip(paths, (e for _, _, e in quant), strict=True))
    return (map_with_paths(lambda p, _: new_g[p], grads),
            map_with_paths(lambda p, _: new_e[p], err_tree))


def dcn_bytes(grads, n_pods: int) -> Tuple[int, int]:
    """(compressed, bf16-allreduce) DCN bytes per pod per step."""
    elems = sum(int(g.numel()) for g in leaves(grads))
    compressed = elems * 1 * (n_pods - 1) // n_pods + 4 * (n_pods - 1)
    bf16_ar = 2 * elems * 2 * (n_pods - 1) // n_pods
    return compressed, bf16_ar
