"""AdamW with global-norm clipping and a warmup-cosine schedule: the port of
``repro/training/optimizer.py``.

The optimizer state mirrors the parameter tree (fp32 ``m``/``v``) plus an
int32 0-d ``step``. :func:`apply_updates` keeps the JAX package's order of
arithmetic: the clip scale from the global norm, bias corrections from
``step + 1``, decoupled weight decay on the fp32 parameter, the result cast
back to the parameter's dtype. Unlike the JAX package, which returns new
arrays, it updates the parameters, ``m`` and ``v`` in place (a full-width
model's training state would not fit twice) and returns them. It runs under
``torch.no_grad()`` on the parameters' device and reads nothing back to the
host: the learning rate and the bias corrections are tensors computed from
``step``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.tree import leaves, tree_map


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def init_opt_state(params) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = next(iter(leaves(params))).device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def lr_at(step: torch.Tensor, c: AdamWConfig) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), f32."""
    warm = c.lr * torch.clamp((step + 1) / max(c.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - c.warmup_steps) / max(c.total_steps - c.warmup_steps, 1), 0.0, 1.0)
    cos = c.lr * (c.min_lr_frac + (1 - c.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < c.warmup_steps, warm, cos).float()


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(x.float() ** 2) for x in leaves(tree)))


def _assign(dst: torch.Tensor, value: torch.Tensor) -> None:
    """dst.copy_(value); a DTensor value (the dry-run's, whose layout the
    arithmetic may have changed: ZeRO-sharded moments beside a
    tensor-parallel gradient) is laid out as ``dst`` first, as GSPMD lays
    out the JAX package's updated state by its out_shardings."""
    if isinstance(value, DTensor):
        value = value.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(value)


@torch.no_grad()
def apply_updates(params, grads, opt_state, c: AdamWConfig, *, gnorm=None):
    """One AdamW step, in place. Returns (params, opt_state, metrics) with
    the same ``params``, ``m`` and ``v`` tensors, updated, and a new
    ``step``. ``gnorm`` is the gradient's global norm where the caller
    computes it (over a mesh, where this rank holds part of the gradient);
    ``global_norm(grads)`` if None."""
    step = opt_state["step"]
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(c.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_at(step, c)
    stepf = step.float() + 1
    b1t = 1 - torch.pow(c.b1, stepf)
    b2t = 1 - torch.pow(c.b2, stepf)

    def upd(p, g, m, v):
        g = g.float() * scale
        _assign(m, c.b1 * m + (1 - c.b1) * g)
        _assign(v, c.b2 * v + (1 - c.b2) * g * g)
        mhat = m / b1t
        vhat = v / b2t
        pf = p.float()
        step_p = mhat / (torch.sqrt(vhat) + c.eps) + c.weight_decay * pf
        _assign(p, (pf - lr * step_p).to(p.dtype))

    tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    new_state = {"m": opt_state["m"], "v": opt_state["v"], "step": step + 1}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
