"""Train / serve step functions: the port of ``repro/training/steps.py``.

Gradients come from ``torch.autograd`` through ``models.model.forward``: on
the card through the hand-written kernels, forward and backward, of
attention (``kernels.flash_attention.FlashAttentionFn``) and, for the SSM
and hybrid families, of the SSD scan (``kernels.ssd_scan.SsdScanFn``); on
the CPU through the plain versions. ``train_step`` updates the parameters and the optimizer state in
place (``optimizer.apply_updates``) and returns them.

Over a mesh of processes (``mesh_info`` over a ``launch.mesh.DistMesh``)
a train step is data parallel over the batch axes and computes what the
JAX package's ``train_step`` under that mesh computes on the global batch.
Every rank is given the global batch and takes its rows of each
microbatch; its MoE blocks take the model axis (``models.moe``). Each rank
backpropagates its share of the global loss: its mean cross-entropy
weighted by its valid labels over the global count (labels outside the
vocabulary are masked, so the ranks' counts differ), plus its load-balance
loss over the number of batch shards, since the JAX package, too, takes
that loss per batch shard and averages the shards. The gradients are then
summed over the batch axes in rank order (an all-gather, then a sum in f32
in a fixed order), so every rank holds the same gradient and applies the
same update; the global norm adds the squares of leaves sharded over the
model axis across it.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import shardings
from repro_torch.launch.mesh import on_ranks
from repro_torch.models import model as model_mod
from repro_torch.models.common import kept_shards, reduce_partial
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.loss import softmax_xent
from repro_torch.tree import leaves_with_paths, map_with_paths, tree_map


def loss_fn(params, cfg: ModelConfig, batch, mesh_info=None):
    """(total loss, metrics) of ``batch``. Under a DistMesh, ``batch`` is
    this rank's rows, and the total and the metrics are this rank's shares
    of the global batch's: summed over the batch axes they are the global
    loss, mean load-balance loss and label count."""
    logits, aux = model_mod.forward(params, cfg, batch, mesh_info)
    loss, n = softmax_xent(logits, batch["labels"], cfg.vocab_size)
    if not on_ranks(mesh_info):
        return loss + 0.01 * aux, {"loss": loss, "aux_loss": aux, "n_tokens": n}
    labels = batch["labels"]
    n_mine = ((labels >= 0) & (labels < cfg.vocab_size)).sum()
    n_all = mesh_info.mesh.psum(n_mine, mesh_info.batch_axes)
    loss = loss * (n_mine / torch.clamp(n_all, min=1))
    aux = aux / mesh_info.n_batch
    return loss + 0.01 * aux, {"loss": loss, "aux_loss": aux, "n_tokens": n_mine}


def loss_and_grads(params, cfg: ModelConfig, batch, mesh_info=None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(total loss, metrics, gradients in the parameters' tree and dtypes),
    as ``jax.value_and_grad(loss_fn, has_aux=True)`` gives them. A parameter
    that does not reach the loss (the embedding of a model fed embeddings)
    gets a zero gradient. Under a DistMesh, this rank's share (:func:`loss_fn`)."""
    live = {path: leaf.detach().requires_grad_() for path, leaf in leaves_with_paths(params)}
    total, metrics = loss_fn(map_with_paths(lambda path, _: live[path], params), cfg, batch,
                             mesh_info)
    # a DTensor loss summed over batch shards is reduced first: seeded while
    # still partial, its backward would run on every rank at the whole batch
    total = reduce_partial(total)
    grads = torch.autograd.grad(total, list(live.values()), allow_unused=True)
    grad_at = {path: torch.zeros_like(p) if g is None else _laid_out_as(g, p)
               for (path, p), g in zip(live.items(), grads, strict=True)}
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            map_with_paths(lambda path, _: grad_at[path], params))


def _laid_out_as(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient in its parameter's layout, its pending sums over
    the batch shards reduced once (a reduce-scatter or an all-reduce), as
    GSPMD lays out the JAX package's gradients; a plain gradient as it is."""
    if not isinstance(g, DTensor):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def _micro(batch: Dict[str, torch.Tensor], i: int, n: int) -> Dict[str, torch.Tensor]:
    """Microbatch i of n: the slices JAX's scan takes, a (n, B/n, ...) reshape."""
    return {k: a.reshape((n, a.shape[0] // n) + tuple(a.shape[1:]))[i] for k, a in batch.items()}


def _my_rows(batch: Dict[str, torch.Tensor], mesh_info) -> Dict[str, torch.Tensor]:
    """This rank's rows of a (micro)batch, its block over the batch axes."""
    b, nb = next(iter(batch.values())).shape[0], mesh_info.n_batch
    if b % nb:
        raise ValueError(f"a batch of {b} rows does not split over {nb} batch shards")
    start = mesh_info.mesh.axis_index(mesh_info.batch_axes) * (b // nb)
    return {k: a[start:start + b // nb] for k, a in batch.items()}


def _sum_over_batch(grads, metrics, mesh_info):
    """Gradients (in f32) and metrics summed over the batch axes, in rank
    order, leaf by leaf: the same sums on every rank."""
    mesh, axes = mesh_info.mesh, mesh_info.batch_axes

    def total(t):
        parts = mesh.all_gather(torch.as_tensor(t, device=mesh.device), axes)
        out = parts[0].float()
        for part in parts[1:]:
            out = out + part.float()
        return out

    return tree_map(total, grads), {k: total(v) for k, v in metrics.items()}


def _global_norm(grads, cfg: ModelConfig, mesh_info) -> torch.Tensor:
    """The norm of the whole gradient: the squares of the leaves this rank
    holds a block of (``shardings.rank_param_specs``) summed over the model
    axis."""
    specs = shardings.specs_by_path(grads, shardings.rank_param_specs(cfg, mesh_info.mesh))
    zero = torch.zeros((), device=mesh_info.mesh.device)
    whole, split = zero, zero
    for path, g in leaves_with_paths(grads):
        sq = torch.sum(g.float() ** 2)
        if any(a is not None for a in specs[path]):
            split = split + sq
        else:
            whole = whole + sq
    return torch.sqrt(whole + mesh_info.mesh.psum(split, mesh_info.model_axis))


def step_grads(params, cfg: ModelConfig, batch, mesh_info=None, microbatches: int = 1):
    """(gradients, metrics) of one step: over ``microbatches`` (f32
    gradients summed in order, then divided, with the metrics, by their
    number) and, under a DistMesh, summed over the batch axes from this
    rank's rows of the global ``batch``: the global batch's, on every rank."""
    split = on_ranks(mesh_info)

    def rows(mb):
        return _my_rows(mb, mesh_info) if split else mb

    if microbatches == 1:
        _, metrics, grads = loss_and_grads(params, cfg, rows(batch), mesh_info)
    else:
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                         params)
        metrics: Dict[str, Any] = {"loss": 0.0, "aux_loss": 0.0, "n_tokens": 0}
        for i in range(microbatches):
            _, m_i, g_i = loss_and_grads(params, cfg, rows(_micro(batch, i, microbatches)),
                                         mesh_info)
            tree_map(lambda a, g: a.add_(g.float()), grads, g_i)
            metrics = {k: metrics[k] + m_i[k] for k in metrics}
    if split:
        grads, metrics = _sum_over_batch(grads, metrics, mesh_info)
    if microbatches > 1:
        grads = tree_map(lambda g: g / microbatches, grads)
        metrics = {k: v / microbatches for k, v in metrics.items()}
    return grads, metrics


def train_step(
    params, opt_state, batch, *, cfg: ModelConfig,
    opt_cfg: opt_mod.AdamWConfig, mesh_info=None, microbatches: int = 1,
):
    """One optimizer step on :func:`step_grads`' gradients. Returns
    (params, opt_state, metrics), the first two updated in place. Under a
    DistMesh ``batch`` is the global batch and the step is data parallel
    (see the module's docstring)."""
    grads, metrics = step_grads(params, cfg, batch, mesh_info, microbatches)
    gnorm = _global_norm(grads, cfg, mesh_info) if on_ranks(mesh_info) else None
    new_params, new_opt, om = opt_mod.apply_updates(params, grads, opt_state, opt_cfg,
                                                    gnorm=gnorm)
    return new_params, new_opt, {**metrics, **om}


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """The argmax over the vocab (B, Vp) -> (B,) int32. DTensor logits (the
    dry-run's, vocab-sharded) are gathered whole over the vocab first, the
    rows as they are held: DTensor's argmax over a sharded dim fails where a
    rank holds one row."""
    if isinstance(logits, DTensor):
        logits = logits.redistribute(logits.device_mesh, kept_shards(logits, {0: 0}))
    return torch.argmax(logits, dim=-1).to(torch.int32)


@torch.no_grad()
def serve_step(params, cache, tokens, *, cfg: ModelConfig, mesh_info=None):
    """One decode step: greedy next-token.  tokens (B,) -> (next (B,), logits, cache)."""
    logits, cache = model_mod.decode_step(params, cfg, cache, tokens, mesh_info=mesh_info)
    nxt = _greedy(logits)
    return nxt, logits, cache


@torch.no_grad()
def prefill_step(params, batch, *, cfg: ModelConfig, max_len: int, mesh_info=None):
    """Prompt ingestion: returns (first sampled token (B,), cache)."""
    logits, cache = model_mod.prefill(params, cfg, batch, max_len, mesh_info)
    nxt = _greedy(logits)
    return nxt, cache

