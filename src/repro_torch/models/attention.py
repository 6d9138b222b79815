"""GQA attention block: init + full-sequence/prefill/decode application.

Ported: the plain (bf16 or f32) KV cache, with or without a sliding window
that fits the cache. Not ported yet, and raising NotImplementedError: the
rolling-buffer sliding-window cache, the int8 KV cache, head padding and
the sequence-sharded split-KV decode (``attn_decode_sharded``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope, dense_init


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the attention variants this package does not have yet."""
    if cfg.head_pad_multiple:
        raise NotImplementedError("attention head padding is not ported")
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError("the int8 KV cache is not ported")
    if cfg.sharded_decode_attn:
        raise NotImplementedError("sequence-sharded decode attention is not ported")


def init_attn_params(generator: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
                     device) -> dict:
    check_supported(cfg)
    D, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": dense_init(generator, (D, H * hd), dtype=dtype, device=device),
        "wk": dense_init(generator, (D, KV * hd), dtype=dtype, device=device),
        "wv": dense_init(generator, (D, KV * hd), dtype=dtype, device=device),
        "wo": dense_init(generator, (H * hd, D), dtype=dtype, device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((KV * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((KV * hd,), dtype=dtype, device=device)
    return p


def _qkv(p: dict, x: torch.Tensor, cfg: ModelConfig):
    b, s, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q.reshape(b, s, H, hd), k.reshape(b, s, KV, hd), v.reshape(b, s, KV, hd)


def _roped_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig):
    q, k, v = _qkv(p, x, cfg)
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    return apply_rope(q, pos, cfg.rope_theta), apply_rope(k, pos, cfg.rope_theta), v


def attn_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, *, impl: str) -> torch.Tensor:
    """Full-sequence causal attention. x (B,S,D)."""
    check_supported(cfg)
    b, s, _ = x.shape
    q, k, v = _roped_qkv(p, x, cfg)
    o = ops.flash_attention(q, k, v, causal=True, window=cfg.sliding_window, impl=impl)
    return o.reshape(b, s, -1) @ p["wo"]


def attn_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig, smax: int, *, impl: str
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill: returns (out (B,S,D), k_cache, v_cache (B,Smax,KV,hd))."""
    check_supported(cfg)
    b, s, _ = x.shape
    if cfg.sliding_window is not None and smax < s:
        raise NotImplementedError("the rolling-buffer sliding-window cache is not ported")
    q, k, v = _roped_qkv(p, x, cfg)
    o = ops.flash_attention(q, k, v, causal=True, window=cfg.sliding_window, impl=impl)
    out = o.reshape(b, s, -1) @ p["wo"]
    pad = (0, 0, 0, 0, 0, smax - s)
    return out, torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)


def attn_decode(
    p: dict, x: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    lengths: torch.Tensor, cfg: ModelConfig, *, impl: str,
    active: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One-token decode.  x (B,1,D); cache (B,Smax,KV,hd); lengths (B,) int32 =
    tokens already in the cache.  Returns out (B,1,D).

    The caches are updated in place: each sequence's new K/V row is written
    at its length (clamped to Smax-1), and where the bool mask ``active``
    (B,) is given, only active sequences' rows change."""
    check_supported(cfg)
    b = x.shape[0]
    smax = k_cache.shape[1]
    if cfg.sliding_window is not None and smax <= cfg.sliding_window:
        raise NotImplementedError("the rolling-buffer sliding-window cache is not ported")
    q, k, v = _qkv(p, x, cfg)                     # (B,1,H,hd)/(B,1,KV,hd)
    q = apply_rope(q, lengths[:, None], cfg.rope_theta)
    k = apply_rope(k, lengths[:, None], cfg.rope_theta)
    slot = torch.clamp(lengths, max=smax - 1).long()
    bidx = torch.arange(b, device=x.device)
    k_new, v_new = k[:, 0], v[:, 0]
    if active is not None:
        keep = active[:, None, None]
        k_new = torch.where(keep, k_new, k_cache[bidx, slot])
        v_new = torch.where(keep, v_new, v_cache[bidx, slot])
    k_cache[bidx, slot] = k_new
    v_cache[bidx, slot] = v_new
    o = ops.decode_attention(q[:, 0].contiguous(), k_cache, v_cache, lengths + 1,
                             window=cfg.sliding_window, impl=impl)
    return o.reshape(b, 1, -1) @ p["wo"]
