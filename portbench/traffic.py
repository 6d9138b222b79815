"""The one traffic generator: closed-loop agent sessions from a mix file.

A mix (``traffic/<name>.json``) holds only parameters: the number of agent
sessions, the episode mix, the lengths of the system prompt, the task, each
observation and each turn's reasoning, the tools' latencies, the engine's
``max_batch`` / ``max_len`` and the speculative budget. Every size and
latency is drawn once from the mix's own ``pool_seed``, so every run of a
cell offers the same work; ``--seed`` decides which agent runs which
script, the token ids of every prompt, and the weights. Seeds then change
the order of the work and not its amount.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

from portbench import agents


@dataclass
class ToolCall:
    tool: str
    args: Dict[str, Any]
    result: Dict[str, Any]
    obs_len: int
    latency: float


@dataclass
class EpisodeScript:
    kind: str
    calls: List[ToolCall]
    reasoning: List[int]            # tokens decoded in each turn: len(calls) + 1 turns


@dataclass
class Traffic:
    scripts: List[List[EpisodeScript]]   # per agent, its episodes in order
    system: List[int]
    tasks: List[List[List[int]]]         # per agent, per episode: the task's ids
    salt: int                            # mixed into every observation's ids


def load_mix(path: Path) -> Dict[str, Any]:
    mix = json.loads(Path(path).read_text())
    if mix.get("kind") != "closed_loop_agents":
        raise ValueError(f"{path}: unknown traffic kind {mix.get('kind')!r}")
    return mix


def _lognormal(rng, spec, n) -> np.ndarray:
    v = spec["median"] * np.exp(rng.normal(0.0, spec["sigma"], n))
    return np.clip(np.rint(v), spec["min"], spec["max"]).astype(int)


def script_pool(mix: Dict[str, Any]) -> List[List[EpisodeScript]]:
    """Every agent's episodes with their sizes and latencies, drawn from
    the mix's ``pool_seed`` alone: the same for every ``--seed``."""
    n_agents, per = mix["agents"], mix["episodes_per_agent"]
    eps = agents.make_episodes(mix["pool_seed"], n_agents * per,
                               tuple((k, float(w)) for k, w in mix["mix"].items()),
                               mix["variation"])
    rng = np.random.default_rng(mix["pool_seed"] + 1)
    lat = mix["tool_latency_s"]
    pool = []
    for a in range(n_agents):
        mine = []
        for ep in eps[a * per:(a + 1) * per]:
            n = len(ep.steps)
            obs = _lognormal(rng, mix["observation_tokens"], n)
            jitter = np.exp(rng.normal(0.0, mix["tool_latency_sigma"], n))
            reason = _lognormal(rng, mix["reasoning_tokens"], n + 1)
            calls = [ToolCall(s.tool, s.args, s.result, int(o), float(lat[s.tool] * j))
                     for s, o, j in zip(ep.steps, obs, jitter, strict=True)]
            mine.append(EpisodeScript(ep.kind, calls, [int(r) for r in reason]))
        pool.append(mine)
    return pool


def make_traffic(mix: Dict[str, Any], seed: int, vocab_size: int, eos_id: int) -> Traffic:
    """The cell's traffic for ``seed``: the pool's scripts dealt to the
    agents in an order drawn from the seed, and the token ids of the system
    prompt and of every task drawn from it (never ``eos_id``, 0 or 1)."""
    rng = np.random.default_rng(seed)
    pool = script_pool(mix)
    order = rng.permutation(len(pool))
    scripts = [pool[i] for i in order]

    def ids(n):
        t = rng.integers(2, vocab_size - 1, n)
        return np.where(t == eos_id, eos_id + 1 if eos_id + 1 < vocab_size - 1 else 2, t)

    system = ids(mix["system_prompt_tokens"]).tolist()
    tasks = [[ids(mix["task_tokens"]).tolist() for _ in s] for s in scripts]
    return Traffic(scripts, system, tasks, int(rng.integers(0, 2**62)))


def observation(traffic: Traffic, call: ToolCall, vocab_size: int) -> List[int]:
    """The tokens a tool's result renders to."""
    return agents.render_observation(call.tool, call.args, call.result, vocab_size,
                                     call.obs_len, salt=traffic.salt)
