"""Agent workload generator: ReAct-style scripted episodes over the paper's
recurring motifs (edit-verify, locate-examine, search-visit, setup).

Episodes are fully scripted at construction (tool semantics are
deterministic over state, so the ground-truth action stream — including
late-bound arguments — is computable ahead of time).  Every scheduler
(serial / PASTE / B-PASTE / naive-parallel) replays the SAME episodes, so
end-to-end comparisons are exact.  The runtime only ever sees the next
action after the preceding model step completes — the execution graph is
revealed online, per the paper's core premise.

Each motif carries seeded *variant* steps (examine-before-edit, fetch
instead of visit, deep-dive read, retry-after-failed-test) with
probabilities scaled by ``WorkloadConfig.variation``: agent control flow
shares prefixes but diverges, so the mined conditional tables have fan-out
>1 — the regime where tree-shaped hypotheses and multi-root beam fill pay
off (and real ReAct traces live, per PASTE's characterization).  Set
``variation=0`` for the fully deterministic legacy streams.

Paper anchor: §2/§8 (ReAct agent workloads, recurring motifs), §9's
evaluation regimes (concurrency, staggered arrivals, shared corpora).
Upstream: events.py tools, executor.py semantics (steps are scripted by
actually executing them).  Downstream: runtime.py (episodes to serve),
patterns.py (offline mining traces via ``episodes_to_traces``),
model_service.py (per-step ``batchable`` metadata).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.events import DEFAULT_TOOLS, Event
from repro_torch.core.executor import StateFacade, execute_tool
from repro_torch.core.sandbox import AgentState


@dataclass
class Step:
    model_work: float            # reasoning latency preceding the action
    tool: str
    args: Dict[str, Any]
    batchable: bool = True       # may this step's reasoning coalesce into a
                                 # micro-batched model invocation
                                 # (model_service.py)?  False pins the step
                                 # to a solo dispatch — the escape hatch for
                                 # latency-critical steps that must not pay
                                 # the batch admission window (linger)


@dataclass
class Episode:
    eid: int
    kind: str
    steps: List[Step]
    arrival: float = 0.0          # tenant arrival time (0 = present at t=0);
                                  # the runtime launches an episode no
                                  # earlier than its arrival

    def serial_latency(self, tools=DEFAULT_TOOLS) -> float:
        return sum(s.model_work + tools[s.tool].det_latency(s.args) for s in self.steps)


def _model_work(rng) -> float:
    return float(np.clip(rng.normal(2.5, 0.5), 1.0, 5.0))


def _script_fix_bug(eid: int, rng, var: float = 1.0,
                    ident: Optional[str] = None) -> List[Step]:
    """locate-examine + edit-verify motif."""
    ident = str(eid) if ident is None else ident
    st = AgentState()
    fac = StateFacade(st)
    steps: List[Step] = []

    def act(tool, **args):
        steps.append(Step(_model_work(rng), tool, dict(args), batchable=True))
        return execute_tool(tool, args, fac)

    r = act("grep", pattern=f"bug_{ident}")
    path = r["path"]
    act("read", path=path)
    if var > 0 and rng.random() < 0.35 * var:
        act("parse", path=path)            # examine variant before editing
    n_attempts = int(rng.integers(1, 4))
    for j in range(n_attempts - 1):
        act("edit", path=path, change=f"attempt{j}")
        act("test", target=path)
        if var > 0 and rng.random() < 0.25 * var:
            act("read", path=path)         # re-examine after a failed attempt
    act("edit", path=path, change="fix")
    act("test", target=path)
    return steps


def _script_research(eid: int, rng, var: float = 1.0,
                     ident: Optional[str] = None) -> List[Step]:
    """search-visit motif."""
    ident = str(eid) if ident is None else ident
    st = AgentState()
    fac = StateFacade(st)
    steps: List[Step] = []

    def act(tool, **args):
        steps.append(Step(_model_work(rng), tool, dict(args), batchable=True))
        return execute_tool(tool, args, fac)

    n_rounds = int(rng.integers(1, 4))
    for k in range(n_rounds):
        r = act("search", query=f"topic_{ident}_{k}")
        if var > 0 and rng.random() < 0.3 * var:
            r2 = act("fetch", url=r["top"])    # bulk-fetch variant
        else:
            r2 = act("visit", url=r["top"])
        act("parse", path=r2["path"])
        if var > 0 and rng.random() < 0.25 * var:
            act("read", path=r2["path"])       # deep-dive variant
    return steps


def _script_setup(eid: int, rng, var: float = 1.0,
                  ident: Optional[str] = None) -> List[Step]:
    """environment setup motif (Level-2 heavy: exercises transformed
    speculation + staged writes)."""
    ident = str(eid) if ident is None else ident
    st = AgentState()
    fac = StateFacade(st)
    steps: List[Step] = []

    def act(tool, **args):
        steps.append(Step(_model_work(rng), tool, dict(args), batchable=True))
        return execute_tool(tool, args, fac)

    act("pip_install", pkg=f"dep_{ident}")
    if var > 0 and rng.random() < 0.3 * var:
        act("pip_install", pkg=f"extra_{ident}")  # second dependency variant
    act("build")
    r = act("grep", pattern=f"entry_{ident}")
    act("test", target=r["path"])
    if var > 0 and rng.random() < 0.25 * var:
        act("edit", path=r["path"], change="fix")   # post-setup patch variant
        act("test", target=r["path"])
    return steps


def _script_audit(eid: int, rng, var: float = 1.0,
                  ident: Optional[str] = None) -> List[Step]:
    """cross-cutting review motif: locate-examine interleaved with research
    before an edit-verify tail.  Passes THROUGH the other motifs' contexts
    with different continuations (e.g. grep,read -> search instead of edit;
    visit,parse -> edit instead of search), so shared-prefix fan-out shows
    up in the mined tables."""
    ident = str(eid) if ident is None else ident
    st = AgentState()
    fac = StateFacade(st)
    steps: List[Step] = []

    def act(tool, **args):
        steps.append(Step(_model_work(rng), tool, dict(args), batchable=True))
        return execute_tool(tool, args, fac)

    r = act("grep", pattern=f"audit_{ident}")
    act("read", path=r["path"])
    s = act("search", query=f"ref_{ident}")
    v = act("visit", url=s["top"])
    act("parse", path=v["path"])
    act("edit", path=r["path"], change="fix")
    act("test", target=r["path"])
    return steps


KINDS = {
    "fix_bug": _script_fix_bug,
    "research": _script_research,
    "setup": _script_setup,
    "audit": _script_audit,
}


@dataclass
class WorkloadConfig:
    seed: int = 0
    n_episodes: int = 20
    mix: Tuple[Tuple[str, float], ...] = (
        ("fix_bug", 0.5), ("research", 0.3), ("setup", 0.2),
    )
    variation: float = 1.0        # scales motif-variant probabilities;
                                  # 0 = deterministic legacy streams
    arrival_stagger: float = 0.0  # mean inter-arrival gap (exponential) for
                                  # staggered multi-tenant serving; 0 = all
                                  # tenants present at t=0 (legacy, and the
                                  # draw-for-draw reproduction guarantee:
                                  # no extra rng draws happen when off)
    shared_frac: float = 0.0      # probability an episode works on a SHARED
                                  # subject (drawn from a small global pool)
                                  # instead of its private one: tenants then
                                  # overlap on queries/paths/packages — the
                                  # corpus-overlap regime cross-tenant result
                                  # caching targets.  0 = fully tenant-
                                  # private (legacy, draw-for-draw: no rng
                                  # draw is taken when off)
    shared_pool: int = 4          # number of distinct shared subjects
    open_loop_rate: float = 0.0   # offered load (episodes/sec) for OPEN-LOOP
                                  # serving: every episode (including eid 0)
                                  # arrives after an additional exponential
                                  # gap with mean 1/rate, independent of how
                                  # fast the box drains.  Composes with
                                  # arrival_stagger (gaps add).  0 = closed
                                  # loop (legacy, draw-for-draw: no rng draw
                                  # is taken when off)


def open_loop_source(cfg: WorkloadConfig) -> Iterator[Episode]:
    """Lazy episode stream with nondecreasing arrivals.

    ``list(open_loop_source(cfg)) == make_episodes(cfg)`` draw-for-draw:
    the runtime can pull episodes one at a time mid-run (open-loop serving)
    while tests and closed-loop callers materialise the identical roster
    up front.  Arrival gaps are drawn AFTER each episode's own draws so
    every legacy stream reproduces exactly when both knobs are off."""
    rng = np.random.default_rng(cfg.seed)
    kinds, probs = zip(*cfg.mix, strict=True)
    t_arrive = 0.0
    for eid in range(cfg.n_episodes):
        kind = str(rng.choice(kinds, p=np.array(probs) / sum(probs)))
        # the cross-cutting audit motif rides on variation so that
        # variation=0 reproduces the legacy streams draw-for-draw
        if cfg.variation > 0 and "audit" not in dict(cfg.mix) \
                and rng.random() < 0.25 * cfg.variation:
            kind = "audit"
        # shared-corpus draw (serving workloads): some tenants work the same
        # subject, so identical (tool, args) invocations recur ACROSS
        # episodes — drawn only when the knob is on (legacy reproduction)
        ident = None
        if cfg.shared_frac > 0 and rng.random() < cfg.shared_frac:
            ident = f"shared{int(rng.integers(0, max(cfg.shared_pool, 1)))}"
        steps = KINDS[kind](eid, rng, cfg.variation, ident=ident)
        # Poisson-ish open arrivals: cumulative exponential gaps, drawn
        # AFTER the episode's own draws so arrival_stagger=0 keeps every
        # legacy stream draw-for-draw (no draw is taken when off)
        if cfg.arrival_stagger > 0 and eid > 0:
            t_arrive += float(rng.exponential(cfg.arrival_stagger))
        # open-loop offered load: an independent exponential inter-arrival
        # with mean 1/rate, charged to EVERY episode (the first tenant of a
        # sustained stream does not arrive at t=0).  Gaps add on top of any
        # stagger so the two processes compose.
        if cfg.open_loop_rate > 0:
            t_arrive += float(rng.exponential(1.0 / cfg.open_loop_rate))
        yield Episode(eid, kind, steps, arrival=t_arrive)


def make_episodes(cfg: WorkloadConfig) -> List[Episode]:
    return list(open_loop_source(cfg))


def episodes_to_traces(episodes: Sequence[Episode]) -> List[List[Event]]:
    """Offline mining traces: serially execute each episode and record events
    with real results (timestamps synthetic; mining is time-free)."""
    traces: List[List[Event]] = []
    for ep in episodes:
        st = AgentState()
        fac = StateFacade(st)
        t = 0.0
        trace: List[Event] = []
        for s in ep.steps:
            t += s.model_work
            res = execute_tool(s.tool, s.args, fac)
            dur = DEFAULT_TOOLS[s.tool].base_latency
            trace.append(Event("tool", s.tool, dict(s.args), res, t, t + dur, ep.eid))
            t += dur
        traces.append(trace)
    return traces
