"""SwiGLU MLP block."""
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
