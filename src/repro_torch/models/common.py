"""Shared model components: RMSNorm, RoPE, the weight initializers, and
the explicit reshards of a DTensor (``launch.dryrun``) where DTensor refuses
a layout change that GSPMD makes silently."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with fp32 accumulation. On a DTensor (the dry-run) the mean
    square is a sum reduced over the shards of the normed dim, divided: the
    partition GSPMD makes of a norm over a sharded dim (the Mamba2 block's
    gated norm over the model-sharded d_inner), where DTensor's mean would
    gather the dim whole on some meshes."""
    if isinstance(x, DTensor):
        xf = x.float()
        var = reduce_partial((xf * xf).sum(dim=-1, keepdim=True)) / x.shape[-1]
        return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * weight.float()
    return out.to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies (head_dim//2,)."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding in the half-split form.  x (..., S, H, D), positions (..., S)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, device=x.device)               # (D/2,)
    angles = positions[..., None].float() * inv               # (..., S, D/2)
    sin = torch.sin(angles)[..., None, :]                     # (..., S, 1, D/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def dense_init(generator: torch.Generator, shape: Sequence[int], *, in_axis: int = 0,
               dtype: torch.dtype = torch.bfloat16, scale: float = 1.0,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """Truncated-normal (+-2 sigma) fan-in init."""
    std = scale * (shape[in_axis] ** -0.5)
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * std).to(dtype)


def embed_init(generator: torch.Generator, shape: Sequence[int], *,
               dtype: torch.dtype = torch.bfloat16,
               device: Optional[torch.device] = None) -> torch.Tensor:
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    w.normal_(0.0, 0.02, generator=generator)
    return w.to(dtype)


def whole_groups(t: torch.Tensor, n_groups: int) -> torch.Tensor:
    """``t`` (..., n_groups * w), its last dim ``n_groups`` groups of w
    columns (the kv heads of attention, each with its query heads), ready
    to be split into them.

    A plain tensor is returned as it is. A DTensor whose last dim is split
    over mesh dims whose ranks do not each hold whole groups (2 kv heads
    over 4 ranks, or 28 query heads in 4 GQA groups over 16) is first
    replicated over those mesh dims: DTensor cannot view a dim split
    mid-group, where GSPMD reshards silently. The attention that follows
    then runs every head of its batch rows on each rank of those mesh
    dims."""
    if not isinstance(t, DTensor):
        return t
    last = t.dim() - 1
    split = [i for i, pl in enumerate(t.placements)
             if isinstance(pl, Shard) and pl.dim == last]
    parts = 1
    for i in split:
        parts *= t.device_mesh.size(i)
    if n_groups % parts == 0:
        return t
    placements = [Replicate() if i in split else pl for i, pl in enumerate(t.placements)]
    return t.redistribute(t.device_mesh, placements)


class _WholeGroupsGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, n_groups):
        ctx.n_groups = n_groups
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return whole_groups(g, ctx.n_groups), None


def merge_heads(o: torch.Tensor, n_groups: int) -> torch.Tensor:
    """o (..., H, hd) -> (..., H * hd). The gradient of a DTensor's result
    goes through :func:`whole_groups` before it is split back into heads (a
    row-sharded ``wo`` hands it back split over the model axis, mid-group
    where the groups do not divide)."""
    flat = o.reshape(*o.shape[:-2], -1)
    if isinstance(o, DTensor) and torch.is_grad_enabled() and o.requires_grad:
        return _WholeGroupsGrad.apply(flat, n_groups)
    return flat


class _ReducedGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return reduce_partial(g)


def reduced_grad(t: torch.Tensor) -> torch.Tensor:
    """``t`` unchanged; in the backward pass a DTensor's gradient has its
    pending sums over the mesh carried out first (the all-reduce that the
    backward of a tensor-parallel region's input needs, as GSPMD places
    it), before the gradient reaches the op that made ``t``. A plain tensor,
    or one outside autograd, is returned as it is."""
    if not (isinstance(t, DTensor) and torch.is_grad_enabled() and t.requires_grad):
        return t
    return _ReducedGrad.apply(t)


def reduce_partial(t: torch.Tensor) -> torch.Tensor:
    """``t`` with every pending (partial) reduction of a DTensor carried out
    (an all-reduce over those mesh dims); a plain tensor is returned as it
    is. At the output projection of a block (a row-sharded ``wo``,
    ``w_down`` or ``out_proj`` leaves a partial sum) this keeps the residual
    stream whole over the model axis, the all-reduce GSPMD places there,
    where DTensor would otherwise pick a reduce-scatter and drag the stream
    through every later op sharded on its features. After a gather along a
    sharded dim (the label's logit from vocab-sharded logits) it reduces the
    gathered values, whose pending reduction DTensor cannot carry through a
    later view."""
    if not isinstance(t, DTensor) or not any(pl.is_partial() for pl in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if pl.is_partial() else pl
                                          for pl in t.placements])


def kept_shards(t: DTensor, dims) -> list:
    """The placements of ``t`` that keep its shards of the tensor dims in
    ``dims`` ({dim of t: dim of the tensor to lay out}), renumbered, and
    replicate it over every other mesh dim (a pending sum is reduced, a
    shard of another dim gathered)."""
    return [Shard(dims[pl.dim]) if isinstance(pl, Shard) and pl.dim in dims else Replicate()
            for pl in t.placements]


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def blocks(placements, *ts):
    """Each DTensor of ``ts`` laid out by ``placements`` (one list for all,
    or one per tensor), as this rank's block; None stays None. The gradient
    a block hands back is made contiguous: DTensor views the local blocks of
    gradients, and an op computed on the block may return one strided."""
    if placements and not isinstance(placements[0], (list, tuple)):
        placements = [placements] * len(ts)
    out = []
    for t, pl in zip(ts, placements, strict=True):
        if t is not None:
            t = t.redistribute(t.device_mesh, pl).to_local()
            if torch.is_grad_enabled() and t.requires_grad:
                t = _ContiguousGrad.apply(t)
        out.append(t)
    return out


def local_block(t: DTensor, placements) -> torch.Tensor:
    """This rank's block of the DTensor ``t`` laid out by ``placements``:
    the input of a ``shard_map`` body. Its gradient is summed over the mesh
    dims it is replicated on (the body's part of the whole, as JAX
    transposes a replicated input of a shard_map)."""
    t = t.redistribute(t.device_mesh, placements)
    return t.to_local(grad_placements=[Partial() if isinstance(pl, Replicate) else pl
                                       for pl in placements])


def from_block(local: torch.Tensor, mesh, placements, reduce) -> DTensor:
    """A DTensor of the blocks ``local`` of a ``shard_map`` body's output,
    laid out by ``placements``, with the mesh dims of ``reduce`` ({mesh dim:
    "sum" or "avg"}) reduced over (``psum`` / ``pmean``)."""
    pending = [Partial(reduce[i]) if i in reduce else pl for i, pl in enumerate(placements)]
    return DTensor.from_local(local, mesh, pending, run_check=False).redistribute(
        mesh, list(placements))
