"""The control's precision: fp8 (e4m3), one step below the bf16 the
configurations state.

``Fp8.weight`` rounds a weight matrix (in, out) to e4m3 with one scale an
output column; ``Fp8.act`` rounds activations with one scale a row (a
token, or a token's head), as a dynamic fp8 serving path quantizes them.
Products of the rounded operands are then taken in f32, as fp8 tensor-core
products accumulate. The reference put in the program's place, computed so,
must fail the check.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def _round(x: torch.Tensor, dim: int) -> torch.Tensor:
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Fp8:
    def weight(self, w: torch.Tensor) -> torch.Tensor:
        return _round(w.float(), 0)

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return _round(x.float(), -1)
