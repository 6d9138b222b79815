"""The program's own spans in a run of a cell.

The port records spans where its serving work happens (``repro_torch.obs``:
``serving.step`` with its children ``serving.step.model`` and
``serving.step.readback``, and ``serving.prefill``). ``harness.run_cell``
turns no recorder on; :func:`run_cell` here runs it with the recorder on in a
traced run, a tracer whose profiler annotates the program's spans, and a
record that carries them as ``program`` (:class:`Program`) to the readers of
``program_metrics.json``'s metrics (``metrics/<name>.py``, as every reader).

    python3 -m portbench.program --workload <cell> --seed <n> --seconds <s> --trace 1

prints the line ``portbench.run`` prints, with those metrics among the
per-layer ones, and logs to standard error the idle device seconds by the
innermost program span the host was in.

The host-side readers read the window's untraced part (:func:`part`): from
its opening to the profiler's start, or to its close where nothing was
traced, the part the harness's own counters cover.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()  # the process's start, for setup_s

import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, List, Optional, Tuple  # noqa: E402

from portbench.tracing import Tracer, _union  # noqa: E402

HERE = Path(__file__).resolve().parent
OUTSIDE = "outside"


@dataclass
class ProgramIdle:
    window_s: float
    idle_s_by_span: Dict[str, float]    # innermost program span -> idle device seconds


@dataclass
class Program:
    """What the program recorded in a run."""
    spans: list                          # repro_torch.obs.Span, on perf_counter_ns
    anchors: List[Tuple[int, int, int]]  # repro_torch.obs.Recorder.anchors, a profiled stretch each
    trace_start_ns: Optional[int]        # perf_counter_ns at the profiler's start; None untraced
    idle: Optional[ProgramIdle] = None   # from the profiler's copies of the spans


def metrics(root: Path = HERE.parent) -> List[Dict[str, Any]]:
    """The metrics that read the program's spans, as per-layer entries."""
    return json.loads((Path(root) / "portbench" / "program_metrics.json").read_text())


# -- the reduction of the profiler's copies ---------------------------------
def _innermost(spans: List[Tuple[int, int, str]]) -> List[Tuple[int, int, str]]:
    """Nested intervals (start, end, name) as disjoint segments, each named
    by the innermost interval over it."""
    segs: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, str]] = []
    t = 0

    def emit(upto):
        nonlocal t
        if stack and upto > t:
            segs.append((t, upto, stack[-1][1]))
        t = max(t, upto)

    for s, e, n in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            emit(stack[-1][0])
            stack.pop()
        emit(s)
        stack.append((e, n))
    while stack:
        emit(stack[-1][0])
        stack.pop()
    return segs


def program_idle(dev, copies, window: Tuple[int, int]) -> ProgramIdle:
    """Idle device time of the window [start_ns, end_ns], each gap between
    the device operations (name, start_ns, end_ns) charged to the innermost
    program span (name, start_ns, end_ns, the profiler's copies) the host
    was in, and the rest to ``outside``."""
    w0, w1 = window
    busy = _union([(max(s, w0), min(e, w1)) for _, s, e in dev if e > w0 and s < w1])
    segs = _innermost([(s, e, n) for n, s, e in copies])
    idle: Dict[str, float] = defaultdict(float)
    edge, j = w0, 0
    for s, e in busy + [(w1, w1)]:
        if s > edge:                     # the gap [edge, s)
            charged = 0
            while j < len(segs) and segs[j][1] <= edge:
                j += 1
            k = j
            while k < len(segs) and segs[k][0] < s:
                over = min(s, segs[k][1]) - max(edge, segs[k][0])
                if over > 0:
                    idle[segs[k][2]] += over * 1e-9
                    charged += over
                k += 1
            idle[OUTSIDE] += (s - edge - charged) * 1e-9
        edge = max(edge, e)
    return ProgramIdle((w1 - w0) * 1e-9,
                       dict(sorted(idle.items(), key=lambda kv: -kv[1])))


# -- what the readers read -----------------------------------------------
def part(rec) -> Optional[Tuple[list, int, int]]:
    """(the program's spans that start in the window's untraced part, its
    start, its end, in perf_counter_ns), or None where nothing was recorded."""
    p = getattr(rec, "program", None)
    if p is None or not p.spans or rec.loop.t_open is None:
        return None
    lo = round(rec.loop.t_open * 1e9)
    hi = p.trace_start_ns if p.trace_start_ns is not None else round(rec.loop.t_close * 1e9)
    return [s for s in p.spans if lo <= s.start_ns < hi], lo, hi


def named(spans, name: str) -> list:
    return [s for s in spans if s.name == name]


def seconds(spans) -> float:
    return sum(s.end_ns - s.start_ns for s in spans) * 1e-9


def turn_prefills(rec, spans) -> list:
    """(turn, its own ``serving.prefill``) for the turns that start in the
    untraced part and began with a prefill (not promoted) and finished: the
    last authoritative prefill into the turn's slot before the turn's end
    (the slot is the turn's from that prefill to its end), at or after its
    start."""
    p = part(rec)
    if p is None:
        return []
    _, lo, hi = p
    by_slot: Dict[int, list] = defaultdict(list)
    for s in named(spans, "serving.prefill"):
        if not s.attrs["speculative"]:
            by_slot[s.attrs["slot"]].append(s)
    out = []
    for t in rec.loop.turns:
        start = round(t.start * 1e9)
        if t.promoted or t.end is None or not lo <= start < hi:
            continue
        end = round(t.end * 1e9)
        mine = [s for s in by_slot.get(t.slot, ()) if start <= s.start_ns < end]
        if mine:
            out.append((t, mine[-1]))
    return out


# -- the run ------------------------------------------------------------------
class ProgramTracer(Tracer):
    """The harness's tracer, annotating the program's spans while its
    profiler runs and reducing their copies once it has stopped."""

    def __init__(self, enabled: bool):
        super().__init__(enabled)
        self.start_ns: Optional[int] = None
        self.idle: Optional[ProgramIdle] = None

    def start(self) -> None:
        from repro_torch import obs

        super().start()
        self.start_ns = time.perf_counter_ns()
        obs.annotate(True)

    def stop(self) -> None:
        from repro_torch import obs

        obs.annotate(False)
        super().stop()

    def raw_events(self):
        from repro_torch import obs

        dev, spans, window = super().raw_events()
        copies = obs.RECORDER.copies(self.prof)
        self.idle = program_idle(dev, [(s.name, a, b) for s, a, b in copies], window)
        return dev, spans, window


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t0: float, root: Path,
             log=print, program_metrics: Optional[List[Dict[str, Any]]] = None
             ) -> Dict[str, Any]:
    """``harness.run_cell`` with the program's recorder on in a traced run,
    its spans annotated under the profiler, and the metrics that read them
    among the per-layer ones (``program_metrics``, or those of
    :func:`metrics` that report ``cell``)."""
    from portbench import harness
    from repro_torch import obs

    made: List[ProgramTracer] = []

    class _Tracer(ProgramTracer):
        def __init__(self, enabled):
            super().__init__(enabled)
            made.append(self)

    @dataclass
    class _Record(harness.Record):
        def __post_init__(self):
            tr = made[-1]
            self.program = Program(obs.spans(), list(obs.RECORDER.anchors), tr.start_ns,
                                   tr.idle)

    if program_metrics is None:
        program_metrics = [m for m in metrics(root)
                           if "workloads" not in m or cell.name in m["workloads"]]
    cell = dataclasses.replace(cell, per_layer=cell.per_layer + program_metrics)
    saved = harness.Tracer, harness.Record
    harness.Tracer, harness.Record = _Tracer, _Record
    obs.record(trace)
    try:
        out = harness.run_cell(cell, seed, seconds, trace, device, t0, root, log=log)
    finally:
        obs.record(False)
        harness.Tracer, harness.Record = saved
    idle = made[-1].idle
    if idle is not None:
        log("program idle: " + ", ".join(f"{n} {s:.3f} s" for n, s in
                                         idle.idle_s_by_span.items())
            + f" of {idle.window_s:.3f} s", file=sys.stderr)
    return out


def main(argv=None) -> int:
    from portbench.run import ROOT, _args, forbidden_modules

    args = _args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    torch.set_num_threads(1)
    from portbench.bench import find_cell

    cell = find_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench.program: the cell needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed % (2**63), args.seconds, bool(args.trace), "cuda", T0, ROOT)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"portbench.program: the run loaded {found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
