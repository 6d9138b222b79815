"""Analytic per-device HBM-traffic model for the roofline memory term.

Why analytic: the CPU backend legalizes bf16 to f32 (a convert storm and 2×
buffer sizes that do not exist on TPU), so HLO-parsed byte traffic from the
CPU-compiled module overstates the TPU memory term by >10×.  The compute
and collective terms come from the compiled HLO (dtype-independent dot
FLOPs; explicit collective ops); the memory term comes from this model.
The HLO-parsed bytes are still recorded as a diagnostic.

Traffic model (per device, bytes):
  train:
    weights      3·P                  (fwd + remat-refwd + bwd reads)
    optimizer    13·P                 (grad w/r fp32, m/v r+w fp32, param w)
    activations  24·L·H_act           (fwd 8 r/w + bwd/refwd 16; H_act =
                                       B_loc·S·D·2B; MoE adds dispatch bufs)
    attention    L·(S/block_q)·KV_loc·S·hd·2·2   (flash KV re-streaming)
    head         4·B_loc·S·V_loc·4    (logits fp32 r/w in xent + bwd)
  prefill: weights P + activations 8·L·H_act + attention stream + cache write
  decode:  weights P + cache read (the step streams the whole cache) +
           cache write (1 token) + activations (S=1) + logits
All arrays are the per-device shards (already divided by mesh extents).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig

BLOCK_Q = 128  # flash attention q-block used for KV re-stream accounting


def _div(n: int, k: int) -> float:
    return n / k if k else n


def traffic_model(
    cfg: ModelConfig,
    shape: ShapeConfig,
    n_batch: int,
    n_model: int,
    param_bytes: int,
    cache_bytes: int = 0,
) -> Dict[str, float]:
    B, S = shape.global_batch, shape.seq_len
    D, L = cfg.d_model, cfg.n_layers
    b_loc = max(1.0, _div(B, n_batch))
    v_loc = _div(cfg.padded_vocab, n_model)
    kv_loc = max(1.0, _div(cfg.n_kv_heads, n_model)) if cfg.n_kv_heads else 0.0
    hd = cfg.resolved_head_dim
    h_act = b_loc * S * D * 2.0

    out: Dict[str, float] = {}
    if shape.kind == "train":
        out["weights"] = 3.0 * param_bytes
        out["optimizer"] = 13.0 * param_bytes
        act = 24.0 * L * h_act
        if cfg.moe is not None:
            act += 6.0 * L * (cfg.moe.top_k * cfg.moe.capacity_factor) * h_act
        out["activations"] = act
        if not cfg.is_attention_free:
            n_attn = L if not cfg.attn_every else cfg.n_layers // cfg.attn_every
            window = min(cfg.sliding_window or S, S)
            out["attention_stream"] = (
                n_attn * (S / BLOCK_Q) * b_loc * kv_loc * min(window, S) * hd * 2.0 * 2.0
            )
        out["head"] = 4.0 * b_loc * S * v_loc * 4.0
    elif shape.kind == "prefill":
        out["weights"] = 1.0 * param_bytes
        out["activations"] = 8.0 * L * h_act
        if not cfg.is_attention_free:
            n_attn = L if not cfg.attn_every else cfg.n_layers // cfg.attn_every
            window = min(cfg.sliding_window or S, S)
            out["attention_stream"] = (
                n_attn * (S / BLOCK_Q) * b_loc * kv_loc * min(window, S) * hd * 2.0 * 2.0
            )
        out["cache_write"] = float(cache_bytes)
        out["head"] = 2.0 * b_loc * v_loc * 4.0
    else:  # decode
        out["weights"] = 1.0 * param_bytes
        out["cache_read"] = float(cache_bytes)
        out["cache_write"] = 2.0 * b_loc * (kv_loc * hd * 2.0) * (
            L if cfg.family in ("dense", "vlm", "audio", "moe") else
            (cfg.n_layers // cfg.attn_every if cfg.attn_every else 0)
        )
        out["activations"] = 8.0 * L * b_loc * D * 2.0
        out["head"] = 2.0 * b_loc * v_loc * 4.0
    out["total"] = sum(out.values())
    return out
