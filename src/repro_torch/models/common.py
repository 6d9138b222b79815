"""Shared model components: RMSNorm, RoPE and the weight initializers."""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with fp32 accumulation."""
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
