"""Event model: tools, event signatures, traces.

PASTE's key observation is that agent traces exhibit stable *application
level* control-flow patterns over **event signatures** — the (tool, arg
schema) skeleton of an invocation, NOT its high-variance textual payload.
B-PASTE mines short-horizon motifs over these signature streams and uses
them to assemble branch hypotheses.

Paper anchor: §3 (event signatures), §7 (SafetyLevel execution classes),
Eq. 2/4 (ResourceVector ρ — per-tool multi-resource demand).
Upstream: nothing (this is the shared vocabulary).  Downstream: everything
— mining/patterns consume signatures, hypothesis/scoring consume ToolSpec
ρ/latency, workload scripts episodes of Events, runtime executes them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np


class SafetyLevel(IntEnum):
    """Paper §7 execution levels."""
    PREP_ONLY = 0        # warm-up, session establishment
    READ_ONLY = 1        # pure fetch/grep/parse — replayable prefix
    STAGED_WRITE = 2     # mutating; branch-local only, commit barrier
    NON_SPECULATIVE = 3  # never speculate


@dataclass(frozen=True)
class ResourceVector:
    """Multi-resource demand/capacity ρ: (cpu cores, mem GB/s, io MB/s, accel slots)."""
    cpu: float = 0.0
    mem_bw: float = 0.0
    io: float = 0.0
    accel: float = 0.0

    def as_array(self) -> np.ndarray:
        return np.array([self.cpu, self.mem_bw, self.io, self.accel], np.float64)

    def __add__(self, o: "ResourceVector") -> "ResourceVector":
        return ResourceVector(
            self.cpu + o.cpu, self.mem_bw + o.mem_bw, self.io + o.io, self.accel + o.accel
        )

    def fits(self, cap: "ResourceVector") -> bool:
        return bool(np.all(self.as_array() <= cap.as_array() + 1e-9))


RESOURCE_DIMS = 4


@dataclass(frozen=True)
class ToolSpec:
    """Registered tool: safety class, resource profile, latency model, and a
    *declared* state footprint.

    ``reads``/``writes`` are glob patterns over namespaced state keys
    (``M:``/``F:``/``E:`` prefixes, fnmatch semantics) describing what the
    executor implementation may touch.  They are the contract the static
    analyzer (core/analysis.py rule R1) and the runtime sanitizer (S4) check
    the *tracked* per-call footprints against: a PREP_ONLY/READ_ONLY tool
    whose implementation writes outside its declaration is exactly the kind
    of mis-classification that lets a speculative run leak side effects."""
    name: str
    level: SafetyLevel
    rho: ResourceVector
    base_latency: float           # seconds, before interference
    latency_jitter: float = 0.2   # lognormal sigma
    transformed: Optional[str] = None  # speculative transform (e.g. dry-run)
    reads: Tuple[str, ...] = ()   # declared read footprint (glob patterns)
    writes: Tuple[str, ...] = ()  # declared write footprint (glob patterns)

    def sample_latency(self, rng: np.random.Generator) -> float:
        return float(self.base_latency * np.exp(rng.normal(0.0, self.latency_jitter)))

    def det_latency(self, args: Dict[str, Any]) -> float:
        """Deterministic latency for a concrete invocation: the same
        (tool, args) always takes the same time, so speculative and
        authoritative executions of one action agree exactly and scheduler
        modes are compared on identical ground truth."""
        import hashlib
        key = f"{self.name}|{sorted(args.items())!r}"
        seed = int(hashlib.sha1(key.encode()).hexdigest()[:8], 16)
        g = np.random.default_rng(seed)
        return float(self.base_latency * np.exp(g.normal(0.0, self.latency_jitter)))


# ----------------------------------------------------------------------
# Default edge-agent tool registry (Thor-class profiles).
# Latencies/profiles follow PASTE's characterization: tool execution is a
# substantial fraction of end-to-end latency; motifs like edit-verify,
# locate-examine, search-visit recur.
# ----------------------------------------------------------------------

DEFAULT_TOOLS: Dict[str, ToolSpec] = {
    t.name: t
    for t in [
        # Latency profile follows PASTE's characterization: tool execution
        # is a substantial (~50-60%) fraction of end-to-end agent latency.
        # ``reads``/``writes`` declare the executor footprint (checked by
        # core/analysis.py R1 against a tracked dry-run).  visit/fetch are
        # READ_ONLY yet declare an F: write: the read-through cache write is
        # an L1-safe idempotent materialization, declared so the analyzer
        # can tell it from an *undeclared* side effect.
        ToolSpec("search", SafetyLevel.READ_ONLY, ResourceVector(0.2, 0.5, 5, 0), 2.5),
        ToolSpec("visit", SafetyLevel.READ_ONLY, ResourceVector(0.3, 1.0, 20, 0), 4.0,
                 writes=("F:*",)),
        ToolSpec("fetch", SafetyLevel.READ_ONLY, ResourceVector(0.2, 1.0, 30, 0), 3.0,
                 writes=("F:*",)),
        ToolSpec("grep", SafetyLevel.READ_ONLY, ResourceVector(1.0, 4.0, 50, 0), 1.5),
        ToolSpec("read", SafetyLevel.READ_ONLY, ResourceVector(0.3, 2.0, 20, 0), 0.8,
                 reads=("F:*",)),
        ToolSpec("parse", SafetyLevel.READ_ONLY, ResourceVector(1.0, 2.0, 5, 0), 2.0,
                 reads=("F:*",)),
        ToolSpec("edit", SafetyLevel.STAGED_WRITE, ResourceVector(0.5, 1.0, 10, 0), 1.2,
                 writes=("F:*",)),
        ToolSpec("test", SafetyLevel.STAGED_WRITE, ResourceVector(2.0, 6.0, 30, 0), 8.0,
                 reads=("F:*",)),
        ToolSpec("build", SafetyLevel.STAGED_WRITE, ResourceVector(3.0, 8.0, 60, 0), 10.0,
                 writes=("E:built",)),
        ToolSpec("pip_install", SafetyLevel.STAGED_WRITE,
                 ResourceVector(1.0, 2.0, 40, 0), 8.0, transformed="pip_download",
                 writes=("E:pkg:*",)),
        ToolSpec("pip_download", SafetyLevel.READ_ONLY, ResourceVector(0.5, 1.0, 40, 0), 5.0,
                 writes=("F:cache/*",)),
        ToolSpec("session_init", SafetyLevel.PREP_ONLY, ResourceVector(0.5, 1.0, 5, 0), 1.0,
                 writes=("E:warm:*",)),
        ToolSpec("env_warmup", SafetyLevel.PREP_ONLY, ResourceVector(1.0, 2.0, 10, 0), 2.0,
                 writes=("E:warm:*",)),
        ToolSpec("deploy", SafetyLevel.NON_SPECULATIVE, ResourceVector(1.0, 2.0, 20, 0), 4.0,
                 writes=("E:deployed",)),
        # model reasoning step as a pseudo-tool (runs on the accelerator)
        ToolSpec("model_step", SafetyLevel.READ_ONLY, ResourceVector(0.5, 2.0, 0, 1), 2.5),
    ]
}


@dataclass
class Event:
    """One step of an agent trace."""
    kind: str                     # 'tool' | 'model'
    tool: str
    args: Dict[str, Any] = field(default_factory=dict)
    result: Any = None
    t_start: float = 0.0
    t_end: float = 0.0
    request_id: int = 0

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start


def arg_schema(args: Dict[str, Any]) -> Tuple[str, ...]:
    """Structural argument skeleton (sorted key:type), payload-free."""
    return tuple(f"{k}:{type(v).__name__}" for k, v in sorted(args.items()))


def signature(ev: Event) -> Tuple[str, str, Tuple[str, ...]]:
    """Payload-free event signature: (kind, tool, arg schema)."""
    return (ev.kind, ev.tool, arg_schema(ev.args))


def sig_str(ev: Event) -> str:
    return f"{ev.tool}({','.join(arg_schema(ev.args))})"


Trace = List[Event]


def trace_signatures(trace: Trace) -> List[Tuple[str, str, Tuple[str, ...]]]:
    return [signature(e) for e in trace]
