"""Public attention entry points with implementation dispatch.

impl selection:
  'auto'   -> the hand-written CUDA kernel for a CUDA tensor (it runs or
              raises; nothing falls back), the plain version for a CPU tensor
  'kernel' -> the CUDA kernel; raises for a CPU tensor
  'plain'  -> the plain PyTorch version beside the kernel (streaming softmax)
  'ref'    -> the materialized oracle from ref.py

Signatures and layouts follow ``repro.kernels.ops``: BSHD for prefill,
q (B,H,D) against a (B,Smax,KV,D) cache for decode.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref

IMPLS = ("auto", "kernel", "plain", "ref")


def _resolve(impl: str, x: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        return "kernel" if x.is_cuda else "plain"
    return impl


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Multi-head GQA attention. q (B,S,H,D), k/v (B,S,KV,D) -> (B,S,H,D)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    impl = _resolve(impl, q)
    if impl == "ref":
        return _ref.mha_reference(q, k, v, causal=causal, window=window, scale=scale)
    if impl == "plain":
        return _fa.flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
    return _fa.flash_attention_kernel(q, k, v, causal=causal, window=window, scale=scale)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Flash-decode. q (B,H,D), cache (B,Smax,KV,D), lengths (B,) -> (B,H,D)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    impl = _resolve(impl, q)
    if impl == "ref":
        return _ref.decode_attention_reference(
            q, k_cache, v_cache, lengths, scale=scale, window=window)
    if impl == "plain":
        return _da.decode_attention_plain(
            q, k_cache, v_cache, lengths, scale=scale, window=window)
    return _da.decode_attention_kernel(
        q, k_cache, v_cache, lengths, scale=scale, window=window)
