"""Cross-entropy LM loss (fp32, padded-vocab aware): the port of
``repro/training/loss.py``."""
from __future__ import annotations

from typing import Tuple

import torch


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 vocab_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (B,S,Vp) fp32, labels (B,S) int.  Returns (loss, n_tokens).

    Labels outside [0, vocab_size) are masked out; the loss is the mean
    over the valid ones (over max(valid, 1))."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    index = labels.long().clamp(0, logits.shape[-1] - 1)   # a masked label reads any column
    ll = torch.gather(logits, -1, index[..., None])[..., 0]
    valid = (labels >= 0) & (labels < vocab_size)
    nll = torch.where(valid, lse - ll, 0.0)
    n = torch.clamp(valid.sum(), min=1)
    return nll.sum() / n, n
