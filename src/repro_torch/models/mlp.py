"""The MLP blocks: SwiGLU, and the gated GELU of Zamba2's shared blocks."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, reduce_partial, reduced_grad


def init_mlp_params(generator: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
                    device) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    return {
        "w_gate": dense_init(generator, (D, Fd), dtype=dtype, device=device),
        "w_up": dense_init(generator, (D, Fd), dtype=dtype, device=device),
        "w_down": dense_init(generator, (Fd, D), dtype=dtype, device=device),
    }


def mlp_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    x = reduced_grad(x)
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return reduce_partial(h @ p["w_down"])


def init_gelu_mlp_params(generator: torch.Generator, d: int, d_ff: int, dtype: torch.dtype,
                         device) -> dict:
    """Zamba2's MLP: gate and up in one (d, 2 d_ff) matrix, as published."""
    return {
        "w_gate_up": dense_init(generator, (d, 2 * d_ff), dtype=dtype, device=device),
        "w_down": dense_init(generator, (d_ff, d), dtype=dtype, device=device),
    }


def gelu_mlp_forward(p: dict, x: torch.Tensor, lora: dict) -> torch.Tensor:
    """gelu(gate) * up (the exact, erf GELU), gate and up the halves of
    x @ w_gate_up, to which ``lora`` (a site's ``lora_a`` (d, r) and
    ``lora_b`` (r, 2 d_ff)) adds (x @ lora_a) @ lora_b; then w_down."""
    gu = x @ p["w_gate_up"] + (x @ lora["lora_a"]) @ lora["lora_b"]
    gate, up = gu.chunk(2, dim=-1)
    return (F.gelu(gate) * up) @ p["w_down"]
