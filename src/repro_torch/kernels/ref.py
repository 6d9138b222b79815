"""Plain PyTorch reference oracles for the attention and SSD kernels.

The simplest correct versions (materialized score matrices, a sequential
SSM recurrence), the counterparts of ``repro.kernels.ref``.  Kernel and
model tests compare against them; the serving path never calls them.

Layout conventions (public API, shared with ops.py):
  q, k, v : (B, S, H, D) / (B, S, KV, D)   -- "BSHD"
  decode q: (B, H, D), cache: (B, Smax, KV, D); partials (acc (B,KV,G,D), m, l (B,KV,G))
  SSD     : x (B, S, H, P), dt (B, S, H), B/C (B, S, G, N), state (B, H, P, N)
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def _gqa_expand(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, KV, D) -> (B, S, H, D) by repeating each kv head."""
    kv = k.shape[2]
    if kv == n_heads:
        return k
    assert n_heads % kv == 0
    return torch.repeat_interleave(k, n_heads // kv, dim=2)


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain softmax attention oracle.  q (B,S,H,D), k/v (B,S,KV,D)."""
    sq, h, d = q.shape[1], q.shape[2], q.shape[3]
    sk = k.shape[1]
    k = _gqa_expand(k, h)
    v = _gqa_expand(v, h)
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)  # right-aligned
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def decode_attention_reference(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Single-token decode attention oracle.

    q (B, H, D); k_cache/v_cache (B, Smax, KV, D); lengths (B,) = #valid
    tokens (the query attends to positions [0, lengths)).
    """
    h, d = q.shape[1], q.shape[2]
    smax = k_cache.shape[1]
    kk = _gqa_expand(k_cache, h)
    vv = _gqa_expand(v_cache, h)
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bhd,bkhd->bhk", q, kk).float() * scale
    kpos = torch.arange(smax, device=q.device)[None, None, :]
    lens = lengths.to(q.device)[:, None, None]
    mask = kpos < lens
    if window is not None:
        mask &= kpos >= (lens - window)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", probs.to(vv.dtype), vv)


def decode_attention_partials_reference(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split-KV decode partials oracle over a (slice of a) cache, the
    materialized twin of the JAX package's jnp path of
    ``ops.decode_attention_partials``: returns (acc (B,KV,G,D) unnormalized,
    m (B,KV,G), l (B,KV,G)), all float32. lengths are measured against the
    slice; a slice of length 0 gives m = -1e30, l = 0, acc = 0."""
    b, h, d = q.shape
    smax, kv = k_cache.shape[1], k_cache.shape[2]
    grp = h // kv
    scale = scale if scale is not None else d ** -0.5
    qf = (q.float() * scale).reshape(b, kv, grp, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float())
    kpos = torch.arange(smax, device=q.device)[None, :]
    lens = lengths.to(q.device)[:, None]
    mask = kpos < lens
    if window is not None:
        mask &= kpos >= (lens - window)
    mask = mask[:, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]) * mask
    return torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float()), m, p.sum(dim=-1)


def ssd_reference(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor,
    *,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential Mamba2 SSD recurrence oracle, in float32.

    x (B,S,H,P), dt (B,S,H) (post-softplus), A (H,) (negative), B/C (B,S,G,N),
    D (H,).  Heads are grouped: head h reads group h // (H/G).
    Returns (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) float32).
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    reps = h // g
    Bh = torch.repeat_interleave(B.float(), reps, dim=2)   # (B,S,H,N)
    Ch = torch.repeat_interleave(C.float(), reps, dim=2)
    xf, dtf, Af = x.float(), dt.float(), A.float()
    state = (initial_state.float() if initial_state is not None
             else torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device))
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * Af[None, :])                              # (B,H)
        upd = dtf[:, t, :, None, None] * xf[:, t, :, :, None] * Bh[:, t, :, None, :]
        state = decay[..., None, None] * state + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    y = torch.stack(ys, dim=1) + D.float()[None, None, :, None] * xf
    return y.to(x.dtype), state
