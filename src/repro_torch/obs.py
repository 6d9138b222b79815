"""The port's span recorder: host-side spans where the serving work happens.

Recording is off unless an operator turns it on (``record(True)``). Off,
``span(name)`` returns one shared null context: it reads no clock and
keeps nothing, and callers compute a span's attributes only while
``recording()`` is true. On, each span is kept in memory as a
:class:`Span` (name, start and end on ``time.perf_counter_ns``, the index
of the span it is nested in, attributes); nothing is written anywhere.

``annotate(True)`` also opens a ``torch.profiler.record_function`` of the
same name with each span, so that a running profiler places the span on
its own clock beside the device operations. The span's clock is read once
the annotation has opened and once it has closed, each some microseconds
after the profiler's own stamp: the part of an annotation's entry or exit
that precedes the profiler's stamp varies more than the part after it.
The stretch of spans annotated between ``annotate(True)`` and
``annotate(False)`` is tied to the profiler's clock by one anchor:
:meth:`Recorder.copies` reads the profiler's copies of the stretch's
spans, pairs them with the in-memory spans, and records the median lag of
the copies' starts behind the spans' and, apart from it, that of their
ends. :meth:`Recorder.to_profiler` then maps a span's ``perf_counter_ns``
start, or with ``end=True`` its end, onto the profiler's timeline.

    from repro_torch import obs
    obs.record(True)
    ... serve ...
    steps = [s for s in obs.spans() if s.name == "serving.step"]

The process has one recorder, :data:`RECORDER`; the module's functions
are its methods.
"""
from __future__ import annotations

import contextlib
import statistics
import time
from typing import Any, Dict, List, Optional, Tuple

_NULL = contextlib.nullcontext()


class Span:
    """One recorded span; ``parent`` is the index of the enclosing span in
    the recorder's list, or -1."""
    __slots__ = ("name", "start_ns", "end_ns", "parent", "attrs")

    def __init__(self, name: str, start_ns: int, parent: int, attrs: Dict[str, Any]):
        self.name = name
        self.start_ns = start_ns
        self.end_ns: Optional[int] = None
        self.parent = parent
        self.attrs = attrs

    def __repr__(self) -> str:
        return f"Span{(self.name, self.start_ns, self.end_ns, self.parent, self.attrs)!r}"


class _Open:
    """The context of one span while recording; ``__enter__`` returns the
    :class:`Span`, whose ``attrs`` the caller may fill in."""
    __slots__ = ("rec", "name", "attrs", "span", "rf")

    def __init__(self, rec: "Recorder", name: str, attrs: Dict[str, Any]):
        self.rec, self.name, self.attrs = rec, name, attrs
        self.rf = None

    def __enter__(self) -> Span:
        rec = self.rec
        parent = rec._stack[-1] if rec._stack else -1
        rec._stack.append(len(rec._spans))
        span = self.span = Span(self.name, 0, parent, self.attrs)
        rec._spans.append(span)
        if rec._annotating:
            import torch

            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        span.start_ns = time.perf_counter_ns()
        return span

    def __exit__(self, *exc) -> None:
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.span.end_ns = time.perf_counter_ns()
        self.rec._stack.pop()


class Recorder:
    """Spans in memory, and the anchors that tie annotated stretches of them
    to a profiler's clock."""

    def __init__(self):
        self._on = False
        self._annotating = False
        self._spans: List[Span] = []
        self._stack: List[int] = []
        self._stretches: List[List[int]] = []   # [first, end) span indices, annotated
        # (perf_counter_ns, profiler ns, exit lag ns), a stretch each
        self.anchors: List[Tuple[int, int, int]] = []

    def record(self, on: bool) -> None:
        """Turn recording on (with an empty record) or off (what was
        recorded stays readable until recording is turned on again)."""
        if on:
            self._spans, self._stack, self._stretches, self.anchors = [], [], [], []
        else:
            self.annotate(False)
        self._on = bool(on)

    def recording(self) -> bool:
        return self._on

    def annotate(self, on: bool) -> None:
        """Also open a profiler annotation inside each span, while recording."""
        on = bool(on) and self._on
        if on and not self._annotating:
            self._stretches.append([len(self._spans), len(self._spans)])
        elif self._annotating and not on:
            self._stretches[-1][1] = len(self._spans)
        self._annotating = on

    def span(self, name: str, **attrs):
        if not self._on:
            return _NULL
        return _Open(self, name, attrs)

    def spans(self) -> List[Span]:
        return self._spans

    def copies(self, prof) -> List[Tuple[Span, int, int]]:
        """The profiler's copies of the spans annotated in the last (closed)
        stretch, each as (in-memory span, profiler start_ns, profiler
        end_ns) in the order the spans opened, read from a stopped
        ``torch.profiler`` session ``prof``. Records that stretch's anchor:
        its first span's ``perf_counter_ns`` start beside that start on the
        profiler's clock, shifted by the median lag of the copies' starts
        behind their spans' (negative: the span's start is read once the
        annotation has opened), and the median lag of the copies' ends
        behind their spans' ends beyond it."""
        if not self._stretches:
            return []
        first, end = self._stretches[-1]
        mine = self._spans[first:end]
        names = {s.name for s in mine}
        found: Dict[str, List[Tuple[int, int]]] = {n: [] for n in names}
        for e in prof.profiler.kineto_results.events():
            if e.device_type().name == "CPU" and e.is_user_annotation() and e.name() in names:
                found[e.name()].append((e.start_ns(), e.end_ns()))
        for times in found.values():
            times.sort()
        taken = {n: 0 for n in names}
        out = []
        for s in mine:
            i = taken[s.name]
            if i < len(found[s.name]):
                out.append((s, *found[s.name][i]))
            taken[s.name] = i + 1
        if out:
            lag = round(statistics.median(a - s.start_ns for s, a, _ in out))
            exit_lag = round(statistics.median(b - s.end_ns - lag for s, _, b in out))
            self.anchors.append((out[0][0].start_ns, out[0][0].start_ns + lag, exit_lag))
        return out

    def to_profiler(self, t_ns: int, end: bool = False) -> Optional[int]:
        """A span's ``perf_counter_ns`` start (or, with ``end``, its end) on
        the profiler's clock, through the last anchor; None before any."""
        if not self.anchors:
            return None
        perf, prof, exit_lag = self.anchors[-1]
        return prof + (t_ns - perf) + (exit_lag if end else 0)


RECORDER = Recorder()
record = RECORDER.record
recording = RECORDER.recording
annotate = RECORDER.annotate
span = RECORDER.span
spans = RECORDER.spans
