"""Per-episode Gantt/timeline recording for the event-driven scheduler.

A :class:`GanttRecorder` plugs into ``Simulator(recorder=...)`` (or
``RuntimeConfig(trace=...)``) and turns the simulator's job lifecycle
callbacks into timeline ROWS — one per contiguous execution segment:

    {"job": name, "jid": int, "tenant": eid-or-None, "tenants": [eids],
     "t_start": float, "t_end": float, "speculative": bool,
     "batch": batch-id-or-None, "outcome": "finish|preempt|cancel|open"}

A job that is preempted and resumed produces one row per segment (the
Gantt truth: the machine ran it twice, with a gap).  Batched model steps
carry the dispatch-sequence ``batch`` id from model_service and list every
member tenant in ``tenants`` — the attribution a pooled log line can't
give you at c=1024, where printf debugging dies.

This is the opt-in FULL recorder: ``Simulator.log`` stays the bounded
cheap default (and can be disabled outright with ``record_log=False``);
the Gantt dump is what you attach when you need to see the schedule.

Downstream: ``examples/trace_timeline.py`` renders the rows as an ASCII
timeline; ``dump()`` writes them as JSON for external tooling.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional


class GanttRecorder:
    """Callable recorder: ``recorder(sim, kind, job)`` for kind in
    start/finish/preempt/cancel.  Rows are closed in event order; jobs
    still running when recording stops are flushed by :meth:`close` with
    outcome="open"."""

    def __init__(self, skip_timers: bool = True):
        self.rows: List[Dict[str, Any]] = []
        self.skip_timers = skip_timers
        self._open: Dict[int, tuple] = {}      # jid -> (t_start, job)

    def __call__(self, sim, kind: str, job) -> None:
        if self.skip_timers and job.meta.get("timer"):
            return                              # zero-demand bookkeeping
        if kind == "start":
            self._open[job.jid] = (sim.now, job)
            return
        seg = self._open.pop(job.jid, None)
        if seg is None:
            return                              # e.g. cancel of a queued job
        self.rows.append(self._row(job, seg[0], sim.now, kind))

    def _row(self, job, t0: float, t1: float, outcome: str) -> Dict[str, Any]:
        eids = job.meta.get("eids")
        if eids is None:
            eid = job.meta.get("eid")
            eids = [eid] if eid is not None else []
        # speculative reasoning-step passengers riding a batch's idle
        # slots: meta["eids"] stays authoritative-only (QoS fans over it),
        # so the free riders surface through meta["spec_eids"]
        spec_eids = list(job.meta.get("spec_eids") or ())
        return {
            "job": job.name,
            "jid": job.jid,
            "tenant": eids[0] if eids else None,
            "tenants": list(eids),
            "spec_tenants": spec_eids,
            "t_start": t0,
            "t_end": t1,
            "speculative": bool(job.speculative),
            "batch": job.meta.get("batch"),
            "outcome": outcome,
        }

    def close(self, now: float) -> None:
        """Flush still-open segments (jobs running at simulation end)."""
        for _jid, (t0, job) in sorted(self._open.items()):
            self.rows.append(self._row(job, t0, now, "open"))
        self._open.clear()

    # ------------------------------------------------------------------
    def dump(self, path: str) -> None:
        """Write the timeline as a JSON array of row dicts."""
        with open(path, "w") as f:
            json.dump(self.rows, f, indent=1)

    def by_tenant(self) -> Dict[Optional[int], List[Dict[str, Any]]]:
        """Rows grouped per tenant (batched jobs appear under EVERY member
        tenant — each of them occupied the accelerator for that span;
        speculative passengers count too, they rode the same dispatch)."""
        out: Dict[Optional[int], List[Dict[str, Any]]] = {}
        for r in self.rows:
            members = list(r["tenants"]) + [e for e in r.get(
                "spec_tenants", ()) if e not in r["tenants"]]
            for eid in (members or [None]):
                out.setdefault(eid, []).append(r)
        return out


def render_ascii(rows: List[Dict[str, Any]], width: int = 72,
                 max_lanes: int = 40) -> str:
    """Seconds-scale ASCII Gantt: one lane per row (capped), ``=`` for
    authoritative segments, ``~`` for speculative ones, ``%`` for batched
    dispatches whose idle slots carry speculative reasoning-step
    passengers (the label appends ``+Ns``), ``x`` marking a preempted
    end.  Good enough to eyeball overlap structure in a terminal; the
    JSON dump is the machine-readable artifact."""
    if not rows:
        return "(empty timeline)"
    t1 = max(r["t_end"] for r in rows)
    t0 = min(r["t_start"] for r in rows)
    span = max(t1 - t0, 1e-9)
    lanes = sorted(rows, key=lambda r: (r["t_start"], r["jid"]))[:max_lanes]
    label_w = max(len(_label(r)) for r in lanes) + 1
    out = []
    for r in lanes:
        a = int((r["t_start"] - t0) / span * (width - 1))
        b = max(int((r["t_end"] - t0) / span * (width - 1)), a + 1)
        if r.get("spec_tenants"):
            ch = "%"
        else:
            ch = "~" if r["speculative"] else "="
        bar = [" "] * width
        for x in range(a, b):
            bar[x] = ch
        if r["outcome"] == "preempt":
            bar[b - 1] = "x"
        out.append(f"{_label(r):<{label_w}}|{''.join(bar)}|")
    hdr = f"{'':<{label_w}} t={t0:.2f}s {'·' * (width - 18)} t={t1:.2f}s"
    if len(rows) > max_lanes:
        out.append(f"... ({len(rows) - max_lanes} more rows)")
    return "\n".join([hdr] + out)


def _label(r: Dict[str, Any]) -> str:
    tag = f"e{r['tenant']}" if r["tenant"] is not None else "--"
    if r["batch"] is not None:
        tag = f"b{r['batch']}"
    if r.get("spec_tenants"):
        tag += f"+{len(r['spec_tenants'])}s"
    return f"{tag} {r['job'][:28]}"
