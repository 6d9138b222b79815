"""The traffic: reproducible by seed, the same work for every seed, found by
name, and the frozen episode generator pinned."""
from __future__ import annotations

import hashlib
import json

import pytest

from portbench import agents
from portbench.bench import find_cell
from portbench.traffic import load_mix, make_traffic, observation, script_pool

from conftest import HERE, write_tree

MIX = json.loads((HERE / "traffic" / "agent-spec.json").read_text())


def _digest(episodes) -> str:
    text = repr([(e.eid, e.kind, [(s.tool, sorted(s.args.items()), sorted(s.result.items()))
                                  for s in e.steps]) for e in episodes])
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def test_frozen_episodes_are_pinned():
    """The frozen copy draws what ``repro_torch.core.workload.make_episodes``
    drew when it was copied (seed 1, 40 episodes: 258 steps); the digest
    holds it there whatever the program's copy becomes."""
    eps = agents.make_episodes(1, 40, (("fix_bug", 0.5), ("research", 0.3), ("setup", 0.2)))
    assert {e.kind for e in eps} == {"fix_bug", "research", "setup", "audit"}
    assert sum(len(e.steps) for e in eps) == 258
    assert _digest(eps) == "741c057ff5ee5b59"


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 3_000_000_101])
def test_traffic_reproducible_by_seed(seed):
    a = make_traffic(MIX, seed, 152064, 151643)
    b = make_traffic(MIX, seed, 152064, 151643)
    assert a.system == b.system and a.tasks == b.tasks and a.salt == b.salt
    assert [[e.reasoning for e in s] for s in a.scripts] == \
        [[e.reasoning for e in s] for s in b.scripts]
    assert len(a.system) == MIX["system_prompt_tokens"] and len(a.scripts) == MIX["agents"]
    assert all(2 <= t < 152064 - 1 and t != 151643 for t in a.system)
    call = a.scripts[0][0].calls[0]
    assert observation(a, call, 152064) == observation(b, call, 152064)
    assert len(observation(a, call, 152064)) == call.obs_len


def test_every_seed_offers_the_same_work():
    """Seeds deal the same scripts in another order: the multiset of every
    turn's reasoning, observation and latency is the seed's alone."""
    def work(t):
        return sorted((tuple(e.reasoning), tuple((c.obs_len, round(c.latency, 9)) for c in e.calls))
                      for s in t.scripts for e in s)

    a, b = make_traffic(MIX, 1, 50277, 0), make_traffic(MIX, 99, 50277, 0)
    assert work(a) == work(b)
    assert a.system != b.system


def test_pool_sizes_follow_the_mix():
    pool = script_pool(MIX)
    obs = [c.obs_len for s in pool for e in s for c in e.calls]
    reason = [r for s in pool for e in s for r in e.reasoning]
    spec = MIX["observation_tokens"]
    assert spec["min"] <= min(obs) and max(obs) <= spec["max"]
    assert 0.6 * spec["median"] < sorted(obs)[len(obs) // 2] < 1.5 * spec["median"]
    rs = MIX["reasoning_tokens"]
    assert rs["min"] <= min(reason) and max(reason) <= rs["max"]
    lat = [c.latency / MIX["tool_latency_s"][c.tool] for s in pool for e in s for c in e.calls]
    assert 0.4 < min(lat) and max(lat) < 2.5


def test_a_new_mix_is_found_by_name_without_editing_a_file(tmp_path):
    """A later change adds a mix as a data file and a cell as an entry."""
    root = write_tree(tmp_path)
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    mix = dict(json.loads((root / "portbench" / "traffic" / "tiny-spec.json").read_text()),
               name="dummy-mix", agents=2, system_prompt_tokens=17)
    (root / "portbench" / "traffic" / "dummy-mix.json").write_text(json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny-dense.dummy-mix", "config": "tiny-dense",
                               "traffic": "dummy-mix", "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = find_cell("tiny-dense.dummy-mix", root)
    assert cell.mix["agents"] == 2 and cell.mix["system_prompt_tokens"] == 17
    assert load_mix(root / "portbench" / "traffic" / "dummy-mix.json") == mix
    assert all(p.read_bytes() == b for p, b in before.items())
    t = make_traffic(cell.mix, 5, 512, 1)
    assert len(t.scripts) == 2 and len(t.system) == 17


def test_benchmark_cells_resolve():
    for cell in ("qwen2-7b.agent-spec", "mamba2-2.7b.agent-spec", "qwen2-7b.agent-serial",
                 "mamba2-2.7b.agent-serial"):
        c = find_cell(cell)
        assert c.chips == 1 and c.end_to_end and c.per_layer
        assert {m["name"] for m in c.end_to_end} >= {"ttna_p50_ms", "ttna_p90_ms",
                                                      "turns_per_s", "setup_s"}
