"""The port's Zamba2 order (Zamba2-7B's shared blocks) against the plain f32
reference of the benchmark (``portbench/reference/zamba2.py``), on a tiny
config of its own: 9 Mamba2 layers of d_model 64 (2 groups of d_state 16,
8 heads of 16), sites at layers 2, 4 and 7 taken by 2 shared blocks in
turn (attention of 4 heads of 32 on concat(h, e), scaled by 16^-0.5, then a
gated-GELU MLP of 96), a LoRA of rank 4 and a projection a site. Weights
are drawn by the benchmark's ``make_params``. No JAX: the JAX package has
no Zamba2 order.

CPU: the forward, and a prefill followed by decode steps, against the
reference; every shared block, LoRA and projection reaching the logits; the
residual skipping the shared block; the engine serving the model; the
``model.shared_block`` spans; the config's checks; the grouped gated norm.
Card (``cuda``): the head_dim-224 kernels at the cell's shapes against
SDPA, their ptxas report (the flash kernel spills nothing), and a replayed
decode step bit for bit equal to eager at full width with 2 sites.

    PYTHONPATH=src python -m pytest -q tests/test_torch_zamba2.py
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from portbench.bench import model_config  # noqa: E402
from portbench.reference import zamba2 as ref  # noqa: E402
from portbench.reference.common import Seqs  # noqa: E402
from portbench.weights import make_params  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig, SSMConfig  # noqa: E402
from repro_torch.configs.zamba2_7b import CONFIG as ZAMBA2_7B  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models.common import rms_norm  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

TINY = {"name": "tiny-zamba2", "family": "hybrid", "n_layers": 9, "d_model": 64,
        "n_heads": 4, "n_kv_heads": 4, "head_dim": 32, "d_ff": 96, "vocab_size": 500,
        "rope_theta": 10000.0, "norm_eps": 1e-5, "attn_every": 3, "hybrid_sites": [2, 4, 7],
        "n_shared_blocks": 2, "shared_lora_rank": 4, "tie_embeddings": True,
        "dtype": "float32", "remat": False,
        "ssm": {"d_state": 16, "d_conv": 4, "expand": 2, "n_groups": 2, "head_dim": 16,
                "chunk": 32, "dt_min": 0.001, "dt_max": 0.1}}
TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32(v) for v in tree]
    return tree.float()


@pytest.fixture(scope="module")
def tiny():
    """The tiny config in f32, its weights drawn in bf16 as a benchmark run
    draws them (``make_params`` draws a normal bf16 buffer) and widened."""
    cfg = model_config({"model": TINY})
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    return cfg, _f32(make_params(bf16, 7, "cpu", tie_embeddings=True))


def _ids(n, seed=0, vocab=500):
    return np.random.default_rng(seed).integers(2, vocab - 1, n).tolist()


def _logits(params, cfg, toks):
    with torch.no_grad():
        return M.forward(params, cfg, {"tokens": torch.tensor([toks])})[0][0, :, :cfg.vocab_size]


def test_forward_matches_the_reference(tiny):
    cfg, params = tiny
    toks = _ids(70)
    with torch.no_grad():
        want, = ref.logits(params, cfg, Seqs([toks], [list(range(1, 70))], 0))
    torch.testing.assert_close(_logits(params, cfg, toks)[:-1], want, rtol=TOL, atol=TOL)


def test_prefill_then_decode_matches_the_reference(tiny):
    cfg, params = tiny
    toks = _ids(48, seed=1)
    with torch.no_grad():
        want, = ref.logits(params, cfg, Seqs([toks], [list(range(30, 48))], 0))
        logits, cache = M.prefill(params, cfg, {"tokens": torch.tensor([toks[:30]])}, 64)
        got = [logits[0]]
        for t in toks[30:47]:
            logits, cache = M.decode_step(params, cfg, cache, torch.tensor([t]))
            got.append(logits[0])
    assert cache["lengths"].tolist() == [47]
    assert cache["k"].shape == (3, 1, 64, 4, 32)           # one K/V a site
    torch.testing.assert_close(torch.stack(got)[:, :cfg.vocab_size], want, rtol=TOL, atol=TOL)


def _leaf_paths(params):
    out = [("shared_blocks", b, part, w) for b in range(2)
           for part, ws in (("attn", ("wq", "wk", "wv", "wo")), ("mlp", ("w_gate_up", "w_down")))
           for w in ws]
    return out + [("sites", k, w) for k in range(3) for w in ("lora_a", "lora_b", "proj")]


@pytest.mark.parametrize("path", _leaf_paths({}), ids=lambda p: ".".join(map(str, p)))
def test_every_block_lora_and_projection_reaches_the_logits(tiny, path):
    cfg, params = tiny
    toks = _ids(40, seed=2)
    base = _logits(params, cfg, toks)
    leaf = params
    for k in path[:-1]:
        leaf = leaf[k]
    saved = leaf[path[-1]]
    leaf[path[-1]] = torch.zeros_like(saved)
    try:
        changed = _logits(params, cfg, toks)
    finally:
        leaf[path[-1]] = saved
    assert (changed - base).abs().max() > 1e-3


def test_the_residual_skips_the_shared_block(tiny, monkeypatch):
    """With every Mamba2 mixer's output zeroed, the shared blocks still run,
    but their outputs only enter the Mamba2 inputs: the residual stays the
    embeddings, and the logits are those of the embeddings."""
    cfg, params = tiny
    toks = _ids(30, seed=3)
    calls = []
    real = M._shared_block

    def counted(*a, **kw):
        calls.append(a[2])
        return real(*a, **kw)

    monkeypatch.setattr(M, "_shared_block", counted)
    monkeypatch.setattr(ssm_mod, "ssm_forward",
                        lambda p, x, cfg, **kw: torch.zeros_like(x))
    got = _logits(params, cfg, toks)
    with torch.no_grad():
        want = M.lm_logits(params, cfg, params["embed"][torch.tensor(toks)])[:, :cfg.vocab_size]
    assert calls == [0, 1, 2]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_the_engine_serves_the_model(tiny):
    """Greedy tokens of two batched requests equal the full forward's argmax
    over each prompt and its served tokens."""
    cfg, params = tiny
    eng = ServingEngine(cfg, params, max_batch=3, max_len=64, eos_id=-1, device="cpu")
    prompts = [_ids(20, seed=4), _ids(11, seed=5)]
    slots = [eng.add_request(p, request_id=i + 1) for i, p in enumerate(prompts)]
    for _ in range(8):
        eng.step()
    for p, s in zip(prompts, slots, strict=True):
        toks = eng.slots[s].tokens + [int(eng.pending_tokens[s])]
        assert len(toks) == len(p) + 9
        best = _logits(params, cfg, toks[:-1]).argmax(-1)
        assert toks[len(p):] == best[len(p) - 1:].tolist()


def test_spans_are_recorded_with_their_attributes(tiny):
    cfg, params = tiny
    eng = ServingEngine(cfg, params, max_batch=2, max_len=64, eos_id=-1, device="cpu")
    obs.record(True)
    try:
        eng.add_request(_ids(12), request_id=1)
        eng.add_request(_ids(5, seed=1), request_id=2)
        eng.step()
    finally:
        obs.record(False)
    spans = obs.spans()
    shared = [s for s in spans if s.name == "model.shared_block"]
    assert [s.attrs for s in shared] == (
        [{"site": k, "block": k % 2, "tokens": 12} for k in range(3)]
        + [{"site": k, "block": k % 2, "tokens": 5} for k in range(3)]
        + [{"site": k, "block": k % 2, "tokens": 2} for k in range(3)])
    parents = [spans[s.parent].name for s in shared]
    assert parents == ["serving.prefill"] * 6 + ["serving.step.model"] * 3
    step, = [s for s in spans if s.name == "serving.step"]
    assert step.attrs == {"rows": 2, "spec_rows": 0}


def test_spans_cost_nothing_when_off(tiny, monkeypatch):
    cfg, params = tiny

    def boom(*a, **kw):
        raise AssertionError("a span was opened with recording off")

    monkeypatch.setattr(obs.RECORDER, "span", boom)
    assert not obs.recording()
    _logits(params, cfg, _ids(10))


def test_config_checks_the_sites():
    kw = {k: v for k, v in TINY.items() if k != "ssm"}
    kw["ssm"] = SSMConfig(**TINY["ssm"])
    cfg = ModelConfig(**kw)
    assert cfg.hybrid_sites == (2, 4, 7) and hash(cfg)
    assert M.hybrid_split(cfg)[0] == len(cfg.hybrid_sites)
    for bad in ([2, 4], [4, 2, 7], [2, 4, 9]):
        with pytest.raises(ValueError, match="hybrid_sites"):
            ModelConfig(**dict(kw, hybrid_sites=bad))
    with pytest.raises(ValueError, match="needs hybrid_sites"):
        ModelConfig(**dict(kw, hybrid_sites=None))
    assert ZAMBA2_7B.hybrid_sites == (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77)
    assert M.hybrid_split(ZAMBA2_7B) == (13, 6, 3)
    assert ZAMBA2_7B.attn_scale == 112 ** -0.5


def test_the_defaults_keep_the_zamba_style_block():
    """zamba2-1.2b: no site, one attention-only block after every 6th
    layer, its scale the head_dim's, as before the Zamba2 fields."""
    cfg = get_config("zamba2-1.2b").reduced()
    assert cfg.hybrid_sites is None and M._sites(cfg) == {}
    assert cfg.attn_scale == cfg.resolved_head_dim ** -0.5 == 32 ** -0.5
    params = M.init_params(cfg, device="meta")
    assert "shared_attn" in params and "shared_blocks" not in params
    assert [M._shared_attn_index(cfg, i) for i in range(6)] == [None] * 5 + [0]


@pytest.mark.parametrize("groups", [1, 2])
def test_the_gated_norm_is_taken_per_group(groups):
    cfg = dataclasses.replace(get_config("mamba2-2.7b").reduced(), dtype="float32")
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, n_groups=groups))
    g = torch.Generator().manual_seed(groups)
    y, z = torch.randn(2, 5, 256, generator=g), torch.randn(2, 5, 256, generator=g)
    w = torch.rand(256, generator=g) + 0.5
    got = ssm_mod._gated_norm(y, z, w, cfg)
    u = y * torch.nn.functional.silu(z)
    if groups == 1:          # the plain norm over d_inner, bit for bit
        assert torch.equal(got, rms_norm(u, w, cfg.norm_eps))
        return
    for a in range(0, 256, 128):
        part = u[..., a:a + 128]
        want = part * torch.rsqrt(part.pow(2).mean(-1, keepdim=True) + cfg.norm_eps) * w[a:a + 128]
        torch.testing.assert_close(got[..., a:a + 128], want, rtol=1e-6, atol=1e-6)
    assert not torch.allclose(got, rms_norm(u, w, cfg.norm_eps))


# -- the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels and the decode graph run only there")
    return torch.device("cuda")


def _sdpa(q, k, v, scale, causal):
    o = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2).float(), k.transpose(1, 2).float(), v.transpose(1, 2).float(),
        is_causal=causal, scale=scale)
    return o.transpose(1, 2)


@pytest.mark.cuda
def test_flash_d224_at_the_cells_prefill(cuda_device):
    from repro_torch.kernels import ops

    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((1, 4096, 32, 224), generator=g, device=cuda_device,
                           dtype=torch.bfloat16) for _ in range(3))
    got = ops.flash_attention(q, k, v, scale=112 ** -0.5, impl="kernel")
    want = _sdpa(q, k, v, 112 ** -0.5, True)
    torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_decode_d224_at_the_cells_step(cuda_device):
    from repro_torch.kernels import ops

    g = torch.Generator(device=cuda_device).manual_seed(1)
    lens = torch.randint(1, 4097, (34,), generator=g, device=cuda_device, dtype=torch.int32)
    lens[:3] = torch.tensor([1, 4096, 2177], dtype=torch.int32)
    q = torch.randn((34, 32, 224), generator=g, device=cuda_device, dtype=torch.bfloat16)
    kc, vc = (torch.randn((34, 4096, 32, 224), generator=g, device=cuda_device,
                          dtype=torch.bfloat16) for _ in range(2))
    got = ops.decode_attention(q, kc, vc, lens, scale=112 ** -0.5, impl="kernel")
    for b in range(34):
        n = int(lens[b])
        want = _sdpa(q[b:b + 1, None], kc[b:b + 1, :n], vc[b:b + 1, :n], 112 ** -0.5, False)
        torch.testing.assert_close(got[b].float(), want[0, 0], atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_the_d224_flash_kernel_spills_nothing(cuda_device):
    """nvcc's -Xptxas -v report of the four instantiations at 224 (printed;
    PERF.md states them): the bf16 flash kernel spills nothing. The decode
    kernel's bf16 body sits at 255 registers with a spill (its 112
    accumulator floats a lane), which PERF.md records."""
    from repro_torch.kernels import _build

    logs = _build.build(("flash_attention", "decode_attention"))
    rows = [r for name in logs for r in _build.ptxas_report(logs[name]) if "224" in r["fn"]]
    assert len(rows) == 4, rows     # flash bf16 and f32; decode bf16 and f32 (plain entry)
    print("d224 instantiations [kernel, registers, spill bytes]:",
          [[r["fn"], r.get("registers"), r.get("spill_bytes", 0)] for r in rows])
    flash, = [r for r in rows if r["fn"] == "flash_attention_bf16_kernel<224>"]
    assert flash.get("spill_bytes", 0) == 0, rows


@pytest.mark.cuda
def test_replay_matches_eager_at_full_width_with_two_sites(cuda_device):
    """Zamba2-7B's widths over 12 layers and 2 sites: every replayed step's
    logits, tokens and cache leaves bit for bit equal to eager
    ``decode_step`` on a copy of the cache."""
    from test_torch_decode_graph import _serve_script

    cfg = dataclasses.replace(ZAMBA2_7B, n_layers=12, hybrid_sites=(6, 11))
    params = make_params(cfg, 11, cuda_device, tie_embeddings=True)
    eng = ServingEngine(cfg, params, max_batch=4, max_len=64, eos_id=-1, device=cuda_device)
    assert _serve_script(eng) >= 20
    assert eng.graph is not None and eng.graph_replays == eng.steps_executed >= 20
