"""Train / serve step functions: the port of ``repro/training/steps.py``.

Gradients come from ``torch.autograd`` through ``models.model.forward``: on
the card through the hand-written kernels, forward and backward, of
attention (``kernels.flash_attention.FlashAttentionFn``) and, for the SSM
and hybrid families, of the SSD scan (``kernels.ssd_scan.SsdScanFn``); on
the CPU through the plain versions. ``train_step`` updates the parameters and the optimizer state in
place (``optimizer.apply_updates``) and returns them.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_mod
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.loss import softmax_xent
from repro_torch.tree import leaves_with_paths, map_with_paths, tree_map

_MESH_NOT_PORTED = ("training over a mesh is not ported yet (ROADMAP Queue 1 item 8: "
                    "multi-device)")


def loss_fn(params, cfg: ModelConfig, batch, mesh_info=None):
    if mesh_info is not None:
        raise NotImplementedError(_MESH_NOT_PORTED)
    logits, aux = model_mod.forward(params, cfg, batch)
    loss, n = softmax_xent(logits, batch["labels"], cfg.vocab_size)
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux_loss": aux, "n_tokens": n}


def loss_and_grads(params, cfg: ModelConfig, batch, mesh_info=None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(total loss, metrics, gradients in the parameters' tree and dtypes),
    as ``jax.value_and_grad(loss_fn, has_aux=True)`` gives them. A parameter
    that does not reach the loss (the embedding of a model fed embeddings)
    gets a zero gradient."""
    live = {path: leaf.detach().requires_grad_() for path, leaf in leaves_with_paths(params)}
    total, metrics = loss_fn(map_with_paths(lambda path, _: live[path], params), cfg, batch,
                             mesh_info)
    grads = torch.autograd.grad(total, list(live.values()), allow_unused=True)
    grad_at = {path: torch.zeros_like(p) if g is None else g
               for (path, p), g in zip(live.items(), grads, strict=True)}
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            map_with_paths(lambda path, _: grad_at[path], params))


def _micro(batch: Dict[str, torch.Tensor], i: int, n: int) -> Dict[str, torch.Tensor]:
    """Microbatch i of n: the slices JAX's scan takes, a (n, B/n, ...) reshape."""
    return {k: a.reshape((n, a.shape[0] // n) + tuple(a.shape[1:]))[i] for k, a in batch.items()}


def train_step(
    params, opt_state, batch, *, cfg: ModelConfig,
    opt_cfg: opt_mod.AdamWConfig, mesh_info=None, microbatches: int = 1,
):
    """One optimizer step; optional gradient accumulation over microbatches
    (f32 gradients summed in order, then divided, with the metrics, by
    ``microbatches``). Returns (params, opt_state, metrics), the first two
    updated in place."""
    if mesh_info is not None:
        raise NotImplementedError(_MESH_NOT_PORTED)
    if microbatches == 1:
        _, metrics, grads = loss_and_grads(params, cfg, batch)
    else:
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                         params)
        metrics: Dict[str, Any] = {"loss": 0.0, "aux_loss": 0.0, "n_tokens": 0}
        for i in range(microbatches):
            _, m_i, g_i = loss_and_grads(params, cfg, _micro(batch, i, microbatches))
            tree_map(lambda a, g: a.add_(g.float()), grads, g_i)
            metrics = {k: metrics[k] + m_i[k] for k in metrics}
        grads = tree_map(lambda g: g / microbatches, grads)
        metrics = {k: v / microbatches for k, v in metrics.items()}

    new_params, new_opt, om = opt_mod.apply_updates(params, grads, opt_state, opt_cfg)
    metrics = dict(metrics)
    metrics.update(om)
    return new_params, new_opt, metrics


@torch.no_grad()
def serve_step(params, cache, tokens, *, cfg: ModelConfig, mesh_info=None):
    """One decode step: greedy next-token.  tokens (B,) -> (next (B,), logits, cache)."""
    logits, cache = model_mod.decode_step(params, cfg, cache, tokens, mesh_info=mesh_info)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    return nxt, logits, cache


@torch.no_grad()
def prefill_step(params, batch, *, cfg: ModelConfig, max_len: int, mesh_info=None):
    """Prompt ingestion: returns (first sampled token (B,), cache)."""
    logits, cache = model_mod.prefill(params, cfg, batch, max_len, mesh_info)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    return nxt, cache

