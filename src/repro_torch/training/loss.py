"""Cross-entropy LM loss (fp32, padded-vocab aware): the port of
``repro/training/loss.py``."""
from __future__ import annotations

from typing import Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.common import reduce_partial


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 vocab_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (B,S,Vp) fp32, labels (B,S) int.  Returns (loss, n_tokens).

    Labels outside [0, vocab_size) are masked out; the loss is the mean
    over the valid ones (over max(valid, 1))."""
    logits = logits.float()
    lse = _lse_dtensor(logits) if isinstance(logits, DTensor) else torch.logsumexp(logits, dim=-1)
    index = labels.long().clamp(0, logits.shape[-1] - 1)   # a masked label reads any column
    ll = reduce_partial(torch.gather(logits, -1, index[..., None]))[..., 0]
    valid = (labels >= 0) & (labels < vocab_size)
    nll = torch.where(valid, lse - ll, 0.0)
    n = torch.clamp(valid.sum(), min=1)
    return nll.sum() / n, n


def _lse_dtensor(logits: DTensor) -> DTensor:
    """logsumexp over the last dim of DTensor logits sharded on it (the
    vocab over the model axis): the max and the sum of exponentials reduced
    over the shards, (B,S) values where ``torch.logsumexp`` would make
    DTensor gather the (B,S,Vp) logits. The vocab-parallel cross-entropy
    that GSPMD makes of the JAX package's loss."""
    m = reduce_partial(logits.detach().amax(dim=-1, keepdim=True))
    return (m + torch.log(reduce_partial(torch.exp(logits - m).sum(dim=-1, keepdim=True))))[..., 0]
