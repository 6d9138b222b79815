"""The traced run: spans around the harness's calls, and what the profiler
saw on the device.

With ``--trace 1`` the loop's calls into each layer run under
``torch.profiler.record_function`` spans (``engine.step``,
``engine.add_request``, ``spec.admit``, ``spec.promote``, ``hyp.build``,
``loop.tool_wait``), and ``torch.profiler`` records the last
``trace_seconds`` of the window: every device op, and on the host only
those spans (no aten op), which keeps the host nearer its untraced pace;
the harness logs the traced and the untraced step's host time.
:func:`summarize` reads the raw events once (no Chrome trace is
written): every device operation (kernels, copies, sets) with its
interval, and the spans. Each ``add_request`` and
``step`` ends by reading a token back to the host, so every kernel a span
launches runs inside the span's interval; a kernel is the span's that its
start falls in. Idle device time is charged to the spans the host was in
meanwhile, and host time outside every span to ``loop.other``.
"""
from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

SPANS = ("engine.step", "engine.add_request", "spec.admit", "spec.promote", "hyp.build",
         "loop.tool_wait")
OTHER = "loop.other"


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_s_by_span: Dict[str, float] = field(default_factory=dict)
    spans: Dict[str, int] = field(default_factory=dict)          # span name -> count
    device_s_by_kernel: Dict[str, float] = field(default_factory=dict)
    kernels_by_kernel: Dict[str, int] = field(default_factory=dict)
    idle_s_by_span: Dict[str, float] = field(default_factory=dict)
    top_ops: List[Tuple[str, float]] = field(default_factory=list)


class Tracer:
    """Spans and the profiler of one run; inert where ``enabled`` is off."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    def start(self) -> None:
        """Start the profiler with the host side cut to the spans: the
        callbacks that record each aten op, the larger part of its cost a
        launch, are left out, while CUPTI still records every device op."""
        import torch
        import torch.autograd.profiler as autograd_profiler
        from torch._C._profiler import RecordScope
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        enable = autograd_profiler._enable_profiler
        autograd_profiler._enable_profiler = \
            lambda config, activities: enable(config, activities, {RecordScope.USER_SCOPE})
        try:
            self.prof.start()
        finally:
            autograd_profiler._enable_profiler = enable

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.prof.stop()

    def raw_events(self):
        """(device ops [(name, start_ns, end_ns)], spans [(name, start_ns,
        end_ns)], the window (first and last host event) in the same clock)."""
        dev, spans = [], []
        lo, hi = None, None
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            s, t = e.start_ns(), e.end_ns()
            if e.device_type().name == "CPU":
                lo = s if lo is None else min(lo, s)
                hi = t if hi is None else max(hi, t)
                if name in SPANS and e.is_user_annotation():
                    spans.append((name, s, t))
            elif not e.is_user_annotation() and name not in SPANS:
                dev.append((name, s, t))
        return dev, spans, (lo or 0, hi or 0)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def summarize(dev, spans, window: Tuple[int, int], kernel_of, top: int = 10) -> TraceSummary:
    """Reduce the raw events of a window [start_ns, end_ns] to per-span and
    per-kernel device time, busy time (the union of the device ops'
    intervals), idle time by the span the host was in, and the ops that
    took most time. ``kernel_of(name)`` names a kernel of the port, or None."""
    w0, w1 = window
    dev = [(n, max(s, w0), min(e, w1)) for n, s, e in dev if e > w0 and s < w1]
    spans = sorted((s, e, n) for n, s, e in spans)
    starts = [s for s, _, _ in spans]

    def span_at(t):
        i = bisect.bisect_right(starts, t) - 1
        return spans[i][2] if i >= 0 and spans[i][1] >= t else OTHER

    by_span, by_kernel, count_kernel, by_op = (defaultdict(float), defaultdict(float),
                                               defaultdict(int), defaultdict(float))
    for name, s, e in dev:
        sec = (e - s) * 1e-9
        by_span[span_at(s)] += sec
        by_op[name] += sec
        k = kernel_of(name)
        if k is not None:
            by_kernel[k] += sec
            count_kernel[k] += 1
    busy = _union([(s, e) for _, s, e in dev])
    idle = defaultdict(float)

    def charge(g0, g1):         # an idle gap, split by the spans the host was in
        i = max(bisect.bisect_right(starts, g0) - 1, 0)
        t = g0
        while t < g1:
            while i < len(spans) and spans[i][1] <= t:
                i += 1
            if i < len(spans) and spans[i][0] <= t:
                end = min(spans[i][1], g1)
                idle[spans[i][2]] += (end - t) * 1e-9
            else:
                end = min(spans[i][0], g1) if i < len(spans) else g1
                idle[OTHER] += (end - t) * 1e-9
            t = end

    edge = w0
    for s, e in busy + [(w1, w1)]:
        if s > edge:
            charge(edge, s)
        edge = max(edge, e)
    counts = defaultdict(int)
    for _, _, n in spans:
        counts[n] += 1
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    return TraceSummary(
        window_s=(w1 - w0) * 1e-9,
        busy_s=sum(e - s for s, e in busy) * 1e-9,
        device_s_by_span=dict(by_span), spans=dict(counts),
        device_s_by_kernel=dict(by_kernel), kernels_by_kernel=dict(count_kernel),
        idle_s_by_span=dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        top_ops=[(n[:160], s) for n, s in ops])
