"""Public attention and SSD entry points with implementation dispatch.

impl selection:
  'auto'   -> the hand-written CUDA kernel for a CUDA tensor (it runs or
              raises; nothing falls back), the plain version for a CPU tensor
  'kernel' -> the CUDA kernel; raises for a CPU tensor
  'plain'  -> the plain PyTorch version beside the kernel (streaming softmax,
              chunked SSD)
  'ref'    -> the materialized or sequential oracle from ref.py

Under autograd (grad mode on and an input that requires grad):
  attention  on a CUDA tensor, 'auto' and 'kernel' run
             ``flash_attention.FlashAttentionFn``: the forward kernel, which
             keeps its log-sum-exp, and the hand-written backward kernel;
             with no grad the forward kernel runs alone, as in serving. On
             a CPU tensor 'auto' is the plain version, and autograd through
             it is the CPU training path. 'plain' and 'ref' are autograd
             through those versions on either device.
  ssd_scan   on a CUDA tensor, 'auto' and 'kernel' run
             ``ssd_scan.SsdScanFn``: the forward kernel, which also writes
             the state entering each chunk, and the hand-written backward
             kernel; with no grad the forward kernel runs alone, as in
             serving. On a CPU tensor 'auto' is the plain version, and
             autograd through it is the CPU training path. 'plain' and
             'ref' are autograd through those versions on either device.
  decode     serving only: the decode kernels have no backward (the
             reference has none either), so on a CUDA tensor 'auto' and
             'kernel' raise NotImplementedError under autograd instead of
             returning an output with no history. 'plain' and 'ref' stay
             differentiable on either device.

Signatures and layouts follow ``repro.kernels.ops``: BSHD for prefill,
q (B,H,D) against a (B,Smax,KV,D) cache (or a slice of one, for the
split-KV partials) for decode, x (B,S,H,P) with
B/C (B,S,G,N) for the SSD scan. ``ssm_decode_step`` is plain PyTorch: the
JAX package computes it outside any Pallas kernel too.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd_scan as _ssd

IMPLS = ("auto", "kernel", "plain", "ref")


def _resolve(impl: str, x: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        return "kernel" if x.is_cuda else "plain"
    return impl


def _needs_grad(*ts: Optional[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


def _refuse_decode_grad(name: str, q: torch.Tensor, *ts: torch.Tensor) -> None:
    if q.is_cuda and _needs_grad(q, *ts):
        raise NotImplementedError(
            f"{name} is serving-only: its kernel has no backward, and its output would have "
            "no gradient; under autograd on a CUDA tensor use impl='plain' or 'ref'")


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
    if _needs_grad(q, k, v):
        return _fa.FlashAttentionFn.apply(q, k, v, causal, window, scale)
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
    _refuse_decode_grad("decode_attention", q, k_cache, v_cache)
    return _da.decode_attention_kernel(
        q, k_cache, v_cache, lengths, scale=scale, window=window)


def decode_attention_partials(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split-KV flash-decode partials over a local cache slice:
    (acc (B,KV,G,D) f32 unnormalized, m (B,KV,G), l (B,KV,G)).

    ``lengths`` is the effective length measured against this slice (0 for
    a slice wholly past the sequence); the caller combines the slices'
    partials (models.attention.attn_decode_sharded). The slice may be a view
    of a larger cache: the kernel reads it in place."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    impl = _resolve(impl, q)
    if impl == "ref":
        return _ref.decode_attention_partials_reference(
            q, k_cache, v_cache, lengths, scale=scale, window=window)
    if impl == "plain":
        return _da.decode_attention_partials_plain(
            q, k_cache, v_cache, lengths, scale=scale, window=window)
    _refuse_decode_grad("decode_attention_partials", q, k_cache, v_cache)
    return _da.decode_attention_partials_kernel(
        q, k_cache, v_cache, lengths, scale=scale, window=window)


def ssd_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor,
    *,
    chunk: int = 128,
    impl: str = "auto",
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD. Returns (y (B,S,H,P), final_state (B,H,P,N) fp32)."""
    impl = _resolve(impl, x)
    if impl == "ref":
        return _ref.ssd_reference(x, dt, A, B, C, D, initial_state=initial_state)
    if impl == "plain":
        return _ssd.ssd_scan_plain(x, dt, A, B, C, D, chunk=chunk, initial_state=initial_state)
    if _needs_grad(x, dt, A, B, C, D, initial_state):
        return _ssd.SsdScanFn.apply(x, dt, A, B, C, D, initial_state, chunk)
    return _ssd.ssd_scan_kernel(x, dt, A, B, C, D, chunk=chunk, initial_state=initial_state)


def ssm_decode_step(x, dt, A, B, C, D, state):
    """One recurrent SSM step (decode).  x (B,H,P), dt (B,H), B/C (B,G,N),
    state (B,H,P,N) fp32 -> (y (B,H,P) in x's dtype, new_state fp32)."""
    h = x.shape[1]
    g = B.shape[1]
    Bh = torch.repeat_interleave(B.float(), h // g, dim=1)
    Ch = torch.repeat_interleave(C.float(), h // g, dim=1)
    xf, dtf = x.float(), dt.float()
    decay = torch.exp(dtf * A[None, :])
    upd = dtf[..., None, None] * xf[..., :, None] * Bh[:, :, None, :]
    new_state = decay[..., None, None] * state + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch) + D[None, :, None] * xf
    return y.to(x.dtype), new_state
