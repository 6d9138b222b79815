"""What the references share: the sequences to score, RMSNorm, the products
(in f32, or in fp8 for the control) and the LM head."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch


@dataclass
class Seqs:
    """Sequences that share their first ``trunk`` tokens, and for each the
    positions whose tokens are scored (each >= 1: the logits at position
    p - 1 predict token p)."""
    tokens: List[List[int]]
    positions: List[List[int]]
    trunk: int
    device: object = "cpu"

    def pieces(self) -> List[torch.Tensor]:
        """The trunk's ids, then each sequence's ids after the trunk."""
        def t(ids):
            return torch.tensor(ids, dtype=torch.int64, device=self.device)
        return [t(self.tokens[0][:self.trunk])] + [t(s[self.trunk:]) for s in self.tokens]


def common_prefix(seqs: List[List[int]]) -> int:
    if not seqs:
        return 0
    n = min(map(len, seqs))
    first = seqs[0]
    for s in seqs[1:]:
        i = 0
        while i < n and s[i] == first[i]:
            i += 1
        n = i
    return n


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def mm(x: torch.Tensor, w: torch.Tensor, quant=None) -> torch.Tensor:
    """x @ w in f32, or with both operands rounded as ``quant`` rounds them."""
    if quant is None:
        return x @ w
    return quant.act(x) @ quant.weight(w)


def lm_logits(params, cfg, hs: List[torch.Tensor], seqs: Seqs, quant=None) -> List[torch.Tensor]:
    """The logits at the rows before each scored position, over the real
    vocabulary (the port pads it; the padding is no token)."""
    norm = params["final_norm"].float()
    head = params["lm_head"].float()
    out = []
    for i, pos in enumerate(seqs.positions):
        rows = []
        for p in pos:
            r = p - 1
            rows.append(hs[0][r] if r < seqs.trunk else hs[i + 1][r - seqs.trunk])
        if not rows:
            out.append(torch.empty((0, cfg.vocab_size), device=head.device))
            continue
        h = rms(torch.stack(rows), norm, cfg.norm_eps)
        out.append(mm(h, head, quant)[:, :cfg.vocab_size])
    return out


def no_tf32():
    """A context in which f32 products are f32, not TF32."""
    return _Precision()


class _Precision:
    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                      torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         prec) = self.saved
        torch.set_float32_matmul_precision(prec)
        return None
