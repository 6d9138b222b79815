"""The plain references against the port at a tiny size, on the CPU, and
the control: the same reference in fp8 misses the limit that the program's
own served tokens meet."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from portbench.bench import model_config
from portbench.check import Chain, chains, sample, served_gaps
from portbench.loop import Turn
from portbench.reference import module
from portbench.reference.common import Seqs, common_prefix, no_tf32
from portbench.reference.mamba2 import ssd
from portbench.weights import make_params

from conftest import TINY_CONFIGS


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(name):
    conf = TINY_CONFIGS[name]
    cfg = dataclasses.replace(model_config(conf), dtype="float32")
    return conf, cfg, make_params(cfg, 4, "cpu", tie_embeddings=conf["tie_embeddings"])


@pytest.mark.parametrize("name", list(TINY_CONFIGS))
def test_reference_matches_the_port_in_f32(name):
    from repro_torch.models import model as model_mod

    conf, cfg, params = _f32(name)
    rng = np.random.default_rng(0)
    toks = rng.integers(2, cfg.vocab_size - 1, 70).tolist()
    with torch.no_grad():
        want = model_mod.forward(params, cfg, {"tokens": torch.tensor([toks])})[0][0]
        got, = module(conf["reference"]).logits(
            params, cfg, Seqs([toks], [list(range(1, 70))], 0))
    np.testing.assert_allclose(got.numpy(), want[:-1, :cfg.vocab_size].numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", list(TINY_CONFIGS))
def test_a_shared_trunk_is_the_same_as_separate_sequences(name):
    conf, cfg, params = _f32(name)
    rng = np.random.default_rng(1)
    trunk = rng.integers(2, cfg.vocab_size - 1, 45).tolist()
    seqs = [trunk + rng.integers(2, cfg.vocab_size - 1, n).tolist() for n in (3, 20, 61)]
    pos = [list(range(40, len(s))) for s in seqs]
    ref = module(conf["reference"])
    with torch.no_grad():
        shared = ref.logits(params, cfg, Seqs(seqs, pos, common_prefix(seqs)))
        alone = [ref.logits(params, cfg, Seqs([s], [p], 0))[0] for s, p in zip(seqs, pos)]
    assert common_prefix(seqs) == 45
    for a, b in zip(shared, alone):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_chunked_ssd_against_the_recurrence():
    g = torch.Generator().manual_seed(0)
    s, h, p, n = 300, 4, 8, 6
    x = torch.randn(s, h, p, generator=g)
    dt = torch.rand(s, h, generator=g) * 0.1
    A = -torch.rand(h, generator=g) * 4 - 0.5
    B, C = torch.randn(s, 2, n, generator=g), torch.randn(s, 2, n, generator=g)
    st0 = torch.randn(h, p, n, generator=g)
    y, st = ssd(x, dt, A, B, C, st0)
    state = st0.clone()
    want = torch.empty_like(x)
    for t in range(s):
        Bh, Ch = B[t].repeat_interleave(2, 0), C[t].repeat_interleave(2, 0)
        state = torch.exp(dt[t] * A)[:, None, None] * state \
            + dt[t][:, None, None] * x[t][:, :, None] * Bh[:, None, :]
        want[t] = torch.einsum("hpn,hn->hp", state, Ch)
    torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st, state, rtol=1e-4, atol=1e-4)


def _served(name, seed):
    """A tiny engine's greedy tokens for three prompts that share a trunk."""
    from repro_torch.serving.engine import ServingEngine

    conf = TINY_CONFIGS[name]
    cfg = model_config(conf)
    params = make_params(cfg, seed, "cpu", tie_embeddings=conf["tie_embeddings"])
    eng = ServingEngine(cfg, params, max_batch=3, max_len=128, eos_id=conf["eos_token_id"],
                        device="cpu")
    rng = np.random.default_rng(seed)
    trunk = rng.integers(2, cfg.vocab_size - 1, 40).tolist()
    prompts = [trunk + rng.integers(2, cfg.vocab_size - 1, n).tolist() for n in (5, 17, 30)]
    slots = [eng.add_request(pr, request_id=i + 1) for i, pr in enumerate(prompts)]
    for _ in range(15):
        eng.step()
    picked = []
    for pr, s in zip(prompts, slots):
        toks = eng.slots[s].tokens + [int(eng.pending_tokens[s])]
        picked.append(Chain(toks, list(range(len(pr), len(toks)))))
    return conf, cfg, params, picked


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("name", list(TINY_CONFIGS))
def test_the_control_misses_the_limit_the_program_meets(name, seed):
    conf, cfg, params, picked = _served(name, seed)
    with no_tf32():
        out = served_gaps(params, cfg, conf["reference"], picked, "cpu", control=True)
    limit = conf["check"]["served_logit_gap"]
    assert out["tokens_checked"] == 3 * 16
    assert out["served_logit_gap"] <= limit < out["control_logit_gap"]


def test_chains_join_turns_that_extend_each_other():
    a = Turn(0, 0, 1.0, [5, 6, 7], 2, end=2.0, served=[8, 9])
    b = Turn(0, 0, 3.0, [5, 6, 7, 8, 9, 4, 4], 2, end=4.0, served=[1, 2])
    c = Turn(0, 0, 5.0, [5, 6, 7, 4, 4, 1, 2, 3], 1, end=6.0, served=[7])   # truncated
    d = Turn(1, 2, 1.5, [5, 6], 1, end=None)                                # unfinished
    out = chains([c, a, b, d])
    assert [(x.tokens, x.positions) for x in out] == [
        ([5, 6, 7, 8, 9, 4, 4, 1, 2], [3, 4, 7, 8]), ([5, 6, 7, 4, 4, 1, 2, 3, 7], [8])]
    picked = sample(out, 1, seed=3)
    assert picked == [out[0]]                    # the longest is always drawn
    assert len(sample(out, 5, seed=3)) == 2
