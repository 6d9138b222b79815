"""The Zamba2-7B cell's pieces on the CPU: the fp8 control against the
limit that the program's served tokens meet (a tiny Zamba2 of its own), the
full FLOP count, the cell's readers on a made-up record, and the cell as the
benchmark finds it."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import roofline as rl
from portbench import zamba2_flops as zf
from portbench.bench import find_cell, metric_reader, model_config
from portbench.check import Chain, served_gaps
from portbench.reference.common import no_tf32
from portbench.weights import make_params

ROOT = Path(__file__).resolve().parents[2]
CELL = "zamba2-7b.agent-spec-4k"
TINY = {"name": "tiny-zamba2", "family": "hybrid", "n_layers": 9, "d_model": 64,
        "n_heads": 4, "n_kv_heads": 4, "head_dim": 32, "d_ff": 96, "vocab_size": 500,
        "rope_theta": 10000.0, "norm_eps": 1e-5, "attn_every": 3, "hybrid_sites": [2, 4, 7],
        "n_shared_blocks": 2, "shared_lora_rank": 4, "tie_embeddings": True,
        "dtype": "bfloat16", "remat": False,
        "ssm": {"d_state": 16, "d_conv": 4, "expand": 2, "n_groups": 2, "head_dim": 16,
                "chunk": 32, "dt_min": 0.001, "dt_max": 0.1}}
# the tiny model served in bf16 reads 0.003-0.016 over seeds 0-5 on the CPU,
# its fp8 control 0.18-0.43
TINY_LIMIT = 0.05


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _served(seed):
    """A tiny engine's greedy tokens for three prompts that share a trunk."""
    from repro_torch.serving.engine import ServingEngine

    cfg = model_config({"model": TINY})
    params = make_params(cfg, seed, "cpu", tie_embeddings=True)
    eng = ServingEngine(cfg, params, max_batch=3, max_len=128, eos_id=2, device="cpu")
    rng = np.random.default_rng(seed)
    trunk = rng.integers(3, cfg.vocab_size - 1, 40).tolist()
    prompts = [trunk + rng.integers(3, cfg.vocab_size - 1, n).tolist() for n in (5, 17, 30)]
    slots = [eng.add_request(pr, request_id=i + 1) for i, pr in enumerate(prompts)]
    for _ in range(15):
        eng.step()
    picked = []
    for pr, s in zip(prompts, slots, strict=True):
        toks = eng.slots[s].tokens + [int(eng.pending_tokens[s])]
        picked.append(Chain(toks, list(range(len(pr), len(toks)))))
    return cfg, params, picked


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_the_control_misses_the_limit_the_program_meets(seed):
    cfg, params, picked = _served(seed)
    with no_tf32():
        out = served_gaps(params, cfg, "zamba2", picked, "cpu", control=True)
    assert out["tokens_checked"] == 3 * 16
    assert out["served_logit_gap"] <= TINY_LIMIT < out["control_logit_gap"]


def test_the_reference_refuses_the_zamba_style_hybrid():
    from portbench.reference import zamba2
    from repro_torch.configs import get_config

    with pytest.raises(ValueError, match="Zamba2 reference"):
        zamba2.check_cfg(get_config("zamba2-1.2b"))


def _cfg():
    return model_config(json.loads((ROOT / "portbench/configs/zamba2-7b.json").read_text()))


def test_flops_count_every_product_of_a_site():
    cfg = _cfg()
    mamba = 81 * (3584 * (2 * 7168 + 2 * 128 + 112) + 7168 * 3584)
    site = (7168 * 21504 + 7168 * 3584 + 3584 * 28672 + 14336 * 3584
            + 3584 * 128 + 128 * 28672 + 3584 * 3584)
    assert zf.matmul_params(cfg) == mamba + 13 * site
    assert 10.8e9 < zf.matmul_params(cfg) < 11.0e9     # 4.56 G of it at the 13 sites
    s = 1000
    nh, p, g, n = rl.ssd_dims(cfg)
    assert zf.prefill_flops(cfg, s) == (2.0 * zf.matmul_params(cfg) * s + 2.0 * 3584 * 32000
                                        + 13 * rl.flash_counts(s, 32, 32, 224)[0]
                                        + 81 * rl.ssd_counts(s, nh, p, g, n)[0])
    lens = [10, 4096]
    assert zf.decode_flops(cfg, lens) == (2 * (2.0 * zf.matmul_params(cfg) + 2.0 * 3584 * 32000)
                                          + 13 * rl.decode_counts(lens, 32, 32, 224)[0]
                                          + 81 * 2 * rl.ssd_counts(1, nh, p, g, n)[0])
    shapes = {"prefill": [(s, False), (300, True)], "step": [([9, 4095, 0], [True, True, False])]}
    assert zf.model_flops(cfg, shapes, 4096) == zf.prefill_flops(cfg, s) + zf.decode_flops(
        cfg, [10, 4096])
    # the roofline's count of the shared attention stays the kernels' 13 sites
    assert rl.attention_layers(cfg) == 13 and rl.ssd_layers(cfg) == 81


def _record(shapes, device_s, busy=10.0, window=12.0):
    trace = SimpleNamespace(device_s_by_kernel=device_s, busy_s=busy, window_s=window)
    cfg = _cfg()
    return SimpleNamespace(mix={"max_len": 4096}, loop=SimpleNamespace(shapes=shapes),
                           trace=trace, least_s=rl.kernel_least_seconds(cfg, shapes, 4096),
                           model_flops=rl.model_flops(cfg, shapes, 4096))


def test_the_readers_on_a_made_up_record():
    shapes = {"prefill": [(3000, False)], "step": [([2500] * 34, [True] * 34)]}
    rec = _record(shapes, {"flash_attention": 0.01, "decode_attention": 0.02, "ssd_scan": 1.0})
    read = {m: metric_reader(m, ROOT)(rec) for m in (
        "flash_attention_roofline", "decode_attention_roofline",
        "zamba2.attention_device_share", "zamba2.mfu")}
    assert read["flash_attention_roofline"] == pytest.approx(
        100 * rec.least_s["flash_attention"] / 0.01)
    assert read["decode_attention_roofline"] == pytest.approx(
        100 * rec.least_s["decode_attention"] / 0.02)
    assert read["zamba2.attention_device_share"] == pytest.approx(100 * 0.03 / 10.0)
    assert read["zamba2.mfu"] == pytest.approx(
        100 * zf.model_flops(_cfg(), shapes, 4096) / (12.0 * rl.PEAK_FLOPS_BF16))
    assert read["zamba2.mfu"] > 100 * rec.model_flops / (12.0 * rl.PEAK_FLOPS_BF16)
    empty = _record({"prefill": [], "step": []}, {})
    empty.trace = None
    assert all(metric_reader(m, ROOT)(empty) is None for m in read)
    # a record of another configuration: zamba2.mfu reads nothing there
    other = _record(shapes, {"flash_attention": 0.01})
    other.model_flops = rl.model_flops(model_config({"model": TINY}), shapes, 4096)
    assert metric_reader("zamba2.mfu", ROOT)(other) is None


def test_the_cell_as_the_benchmark_finds_it():
    cell = find_cell(CELL, ROOT)
    assert cell.chips == 1 and cell.config["reference"] == "zamba2"
    assert [m["name"] for m in cell.per_layer] == [
        "spec.prefill_token_share", "spec.promoted_share", "engine.step_ms",
        "engine.prefill_ms_per_ktok", "model.decode_device_ms",
        "model.prefill_device_ms_per_ktok", "flash_attention_roofline",
        "decode_attention_roofline", "ssd_scan_roofline", "device.idle_share",
        "zamba2.attention_device_share", "zamba2.mfu"]
    mix = cell.mix
    assert (mix["system_prompt_tokens"], mix["max_len"], mix["observation_tokens"]["max"]) \
        == (2048, 4096, 1024)
    # a turn's prompt (system, task, the last reasoning and the longest
    # observation) and its reasoning fit the loop's limit with no turn dropped
    reason = mix["reasoning_tokens"]["max"]
    prompt = (mix["system_prompt_tokens"] + mix["task_tokens"] + reason
              + mix["observation_tokens"]["max"])
    assert prompt <= mix["max_len"] - 2 - reason
    cfg = model_config(cell.config)
    assert cfg.hybrid_sites == tuple(cell.config["hybrid_layer_ids"])
    assert (cfg.n_layers, cfg.d_model, cfg.resolved_head_dim, cfg.d_ff,
            cfg.shared_lora_rank, cfg.ssm.n_groups) == (81, 3584, 224, 14336, 128, 2)


def test_what_the_cell_adds_imports_no_jax():
    for path in ("portbench/reference/zamba2.py", "portbench/zamba2_flops.py",
                 "portbench/metrics/zamba2.mfu.py"):
        src = (ROOT / path).read_text()
        assert "import jax" not in src and "from repro." not in src and "repro_torch" not in src
    spec = importlib.util.find_spec("portbench.reference.zamba2")
    assert spec is not None
