"""A tiny benchmark tree for the CPU tests: the real metric readers and
reference, a reduced dense and a reduced Mamba2 configuration, and a mix of
a few agents with tool latencies of tens of milliseconds."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]

TINY_CONFIGS = {
    "tiny-dense": {
        "name": "tiny-dense", "eos_token_id": 1, "reference": "dense", "tie_embeddings": False,
        "model": {"name": "tiny-dense", "family": "dense", "n_layers": 2, "d_model": 64,
                  "n_heads": 4, "n_kv_heads": 2, "head_dim": 16, "d_ff": 128,
                  "vocab_size": 512, "qkv_bias": True, "rope_theta": 10000.0,
                  "norm_eps": 1e-6, "dtype": "bfloat16", "remat": False},
        "check": {"served_logit_gap": 0.007, "min_tokens_checked": 10},
    },
    "tiny-ssm": {
        "name": "tiny-ssm", "eos_token_id": 0, "reference": "mamba2", "tie_embeddings": True,
        "model": {"name": "tiny-ssm", "family": "ssm", "n_layers": 2, "d_model": 64,
                  "n_heads": 0, "n_kv_heads": 0, "d_ff": 0, "vocab_size": 500,
                  "tie_embeddings": True, "norm_eps": 1e-5, "dtype": "bfloat16",
                  "remat": False,
                  "ssm": {"d_state": 16, "d_conv": 4, "expand": 2, "n_groups": 1,
                          "head_dim": 16, "chunk": 32, "dt_min": 0.001, "dt_max": 0.1}},
        "check": {"served_logit_gap": 0.007, "min_tokens_checked": 10},
    },
}


def tiny_mix(name: str, spec_slots: int) -> dict:
    real = json.loads((HERE / "traffic" / "agent-spec.json").read_text())
    return dict(real, name=name, agents=3, episodes_per_agent=3, system_prompt_tokens=40,
                task_tokens=8,
                observation_tokens={"median": 12, "sigma": 0.5, "min": 4, "max": 30},
                reasoning_tokens={"median": 6, "sigma": 0.4, "min": 3, "max": 10},
                tool_latency_s={k: 0.01 + 0.004 * v
                                for k, v in real["tool_latency_s"].items()},
                max_len=256, max_batch=3 + spec_slots, spec_budget_slots=spec_slots,
                drain_cap_s=20, trace_seconds=0, check={"chains": 3})


def write_tree(root: Path) -> Path:
    """A benchmark tree at ``root`` with tiny cells, the real readers."""
    pb = root / "portbench"
    (pb / "configs").mkdir(parents=True)
    (pb / "traffic").mkdir()
    shutil.copytree(HERE / "metrics", pb / "metrics")
    workloads, configs = [], []
    for name, cfg in TINY_CONFIGS.items():
        path = f"portbench/configs/{name}.json"
        (root / path).write_text(json.dumps(cfg))
        configs.append({"name": name, "source": "tiny", "file": path, "reduced": [],
                        "why": "a CPU test"})
        for mix in ("tiny-spec", "tiny-serial"):
            workloads.append({"name": f"{name}.{mix}", "config": name, "traffic": mix,
                              "chips": 1, "why": "a CPU test"})
    for mix, slots in (("tiny-spec", 2), ("tiny-serial", 0)):
        (pb / "traffic" / f"{mix}.json").write_text(json.dumps(tiny_mix(mix, slots)))
    real = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench = dict(real, configs=configs, workloads=workloads,
                 per_layer=[{k: v for k, v in m.items() if k != "workloads"}
                            for m in real["per_layer"]])
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return write_tree(tmp_path)
