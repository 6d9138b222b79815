"""Deterministic, shardable, resumable synthetic LM data pipeline.

Batches are a pure function of (seed, step, host_index) — resumability after
restart or elastic re-meshing is by construction (no iterator state to
checkpoint), and every host materializes only its own shard.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    seq_len: int = 512
    global_batch: int = 8
    n_hosts: int = 1
    host_index: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


def batch_at(cfg: ModelConfig, dc: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Markov-chain synthetic tokens (stationary bigram structure so the loss
    actually decreases during training, unlike iid noise)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([dc.seed, step, dc.host_index])
    )
    b, s = dc.host_batch, dc.seq_len
    v = cfg.vocab_size
    # bigram transition: next = (3 * cur + noise) mod v, small noise
    start = rng.integers(0, v, size=(b, 1))
    noise = rng.integers(0, 7, size=(b, s))
    toks = np.zeros((b, s), np.int64)
    toks[:, 0] = start[:, 0]
    for i in range(1, s):
        toks[:, i] = (3 * toks[:, i - 1] + noise[:, i]) % v
    tokens = toks[:, :-1].astype(np.int32)
    labels = toks[:, 1:].astype(np.int32)
    batch = {"labels": labels}
    if cfg.frontend == "tokens":
        batch["tokens"] = tokens
    else:
        # frontend stub: embeddings are a FIXED random codebook lookup of the
        # token stream, so labels stay predictable from the inputs
        d = cfg.d_model
        code_rng = np.random.default_rng(np.random.SeedSequence([dc.seed, 999]))
        codebook = code_rng.standard_normal((cfg.vocab_size, d)).astype(np.float32) * 0.05
        batch["embeds"] = codebook[tokens]
    return batch


def data_iterator(cfg: ModelConfig, dc: DataConfig, start_step: int = 0) -> Iterator:
    step = start_step
    while True:
        yield batch_at(cfg, dc, step)
        step += 1
