"""Model FLOPs of a Zamba2 hybrid (``zamba2.mfu``), counted in full.

``roofline.model_flops`` counts a hybrid's shared attention as d_model wide
with no MLP, which is the Zamba-style block. A Zamba2 site also runs the
2 d_model-wide QKV input, the gated MLP, its LoRA and its projection. Per
token, 2 operations a weight of every product: each Mamba2 layer's in and
out projections, and at each site the QKV (2d x 3 H hd), the output
(H hd x d), gate_up (d x 2 F), down (F x d), the LoRA (d x r, r x 2 F) and
the projection (d x d); plus the attention and the scan as ``roofline``
counts them, and the LM head where the program computes logits (a
prefill's last position, every decode row). The configuration comes from
the file's ``model`` group (``bench.model_config``).
"""
from __future__ import annotations

from typing import Dict, Sequence

from portbench.roofline import (decode_counts, effective_lengths, flash_counts,
                                ssd_counts, ssd_dims)


def matmul_params(cfg) -> int:
    """Weights that enter a matrix product for every token."""
    d, s = cfg.d_model, cfg.ssm
    di, nh, gn = s.d_inner(d), s.n_heads(d), s.n_groups * s.d_state
    n = cfg.n_layers * (d * (2 * di + 2 * gn + nh) + di * d)
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    f, r = cfg.d_ff, cfg.shared_lora_rank
    site = (2 * d * (h + 2 * kv) * hd + h * hd * d + d * 2 * f + f * d
            + r * (d + 2 * f) + d * d)
    return n + len(cfg.hybrid_sites) * site


def prefill_flops(cfg, s: int) -> float:
    nh, p, g, n = ssd_dims(cfg)
    return (2.0 * matmul_params(cfg) * s + 2.0 * cfg.d_model * cfg.vocab_size
            + len(cfg.hybrid_sites) * flash_counts(s, cfg.n_heads, cfg.n_kv_heads,
                                                   cfg.resolved_head_dim)[0]
            + cfg.n_layers * ssd_counts(s, nh, p, g, n)[0])


def decode_flops(cfg, lens: Sequence[int]) -> float:
    nh, p, g, n = ssd_dims(cfg)
    return (len(lens) * (2.0 * matmul_params(cfg) + 2.0 * cfg.d_model * cfg.vocab_size)
            + len(cfg.hybrid_sites) * decode_counts(lens, cfg.n_heads, cfg.n_kv_heads,
                                                    cfg.resolved_head_dim)[0]
            + cfg.n_layers * len(lens) * ssd_counts(1, nh, p, g, n)[0])


def model_flops(cfg, shapes: Dict[str, list], smax: int) -> float:
    """FLOPs of the authoritative prefills and decode rows logged over a
    traced window (speculative work left out), as ``roofline.model_flops``."""
    f = sum(prefill_flops(cfg, s) for s, spec in shapes["prefill"] if not spec)
    for lengths, auth in shapes["step"]:
        rows = [n for n, a in zip(effective_lengths(lengths, smax), auth, strict=True) if a]
        if rows:
            f += decode_flops(cfg, rows)
    return f
