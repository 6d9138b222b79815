"""Speculation-safety static analyzer + runtime sanitizer.

The paper's correctness story (§7 execution levels, commit barriers, Eq. 1's
σ) rests on invariants the codebase enforces implicitly and in scattered
places, and the event-driven scheduler added a second class — epoch-
guarded caches, dirty-set completeness, counter-group slack — whose only
check was a 4-config event≡dense equivalence test.  This module makes both
classes explicit and checkable:

**Static rules** (pure; run at ``BPasteRuntime`` construction and by
``python -m repro.analysis`` in CI):

  R1-footprint      policy–footprint consistency: dry-run every tool with
                    tracked ``StateFacade`` footprints and diff against the
                    ToolSpec's *declared* read/write glob patterns.  An
                    undeclared write by a PREP_ONLY/READ_ONLY tool is an
                    error (speculation may run it outside a sandbox); an
                    undeclared staged write is a warning (sandboxed, but the
                    declaration the race matrix relies on is stale).
  R2-nonspec-reach  NON_SPECULATIVE tools without a usable transform that
                    are reachable in the mined pattern tables: tree assembly
                    inserts them into hypothesis interiors where they bound
                    every descendant — speculation silently stalls there.
  R3-write-race     cross-branch write–write conflict matrix: speculation-
                    eligible, pattern-reachable tools whose declared write
                    footprints collide on an exact (non-glob) key could be
                    co-admitted in one shared admission pass and stage
                    divergent writes to the same state.  Glob-level overlaps
                    are recorded in ``report.meta["write_conflicts"]`` only
                    (two tools writing distinct keys under ``F:*`` is not a
                    race).  The runtime can additionally thread this as a
                    conflict mask into admission (``RuntimeConfig.race_mask``).
  R4-barrier        commit-barrier placement on REAL assembled beams: every
                    Level-2+ TOOL node must have a BARRIER as its immediate
                    parent (hypothesis.barrier_violations) — the §7
                    insertion invariant, checked instead of trusted.

**Runtime sanitizer** (``RuntimeConfig.sanitize=True``; cross-checks on a
sampled tick schedule, findings through the same report type):

  S1-stale-cache    epoch-guarded per-NodeRun caches (resolved args, memo
                    key, servability verdict) vs fresh recomputation.
  S2-dirty-set      dirty-set completeness: recompute every NON-dirty
                    episode's cached frontiers/active-counts/pool entries
                    with a side-effect-free walk — any divergence means a
                    state change escaped its ``_mark_dirty`` and the event
                    scheduler is serving a stale cache (hard finding).
  S3-slack-drift    counter-group ``running_demand``/``slack`` vs a dense
                    re-sum over the running set.
  S4-footprint      tracked executor footprints vs declared ToolSpec
                    patterns at every real execution (authoritative,
                    speculative, and commit-replay) — R1's dry-run contract
                    enforced on live traffic.
  S5-store-index    ResultStore derived indices (read index, per-tool
                    counts) vs the entry table.

Paper anchor: §7 (execution levels, operator policy), Eq. 1's σ, §4.1/§6.3
(barrier insertion).  Upstream: events.py (declared footprints), safety.py
(policy semantics), executor.py (dry-run), hypothesis.py
(barrier_violations), memo.py (check_integrity), simulator.py
(dense_running_demand).  Downstream: runtime.py (construction-time static
pass + sanitizer hooks), repro/analysis.py (the CLI), CI.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from fnmatch import fnmatchcase
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.events import SafetyLevel, ToolSpec
from repro_torch.core.executor import dry_run_footprint
from repro_torch.core.hypothesis import BranchHypothesis, barrier_violations
from repro_torch.core.memo import memo_key
from repro_torch.core.safety import EligibilityPolicy

SEVERITIES = ("error", "warn", "info")


@dataclass(frozen=True)
class Finding:
    """One typed analyzer/sanitizer finding."""
    rule: str       # "R1-footprint" | ... | "S5-store-index"
    severity: str   # "error" | "warn" | "info"
    site: str       # where: tool name, "hyp 12 node 3", cache name, ...
    detail: str     # human-readable explanation

    def __str__(self) -> str:
        return f"[{self.severity}] {self.rule} @ {self.site}: {self.detail}"


@dataclass
class AnalysisReport:
    findings: List[Finding] = field(default_factory=list)
    meta: Dict[str, Any] = field(default_factory=dict)

    def add(self, rule: str, severity: str, site: str, detail: str) -> Finding:
        assert severity in SEVERITIES, severity
        f = Finding(rule, severity, site, detail)
        self.findings.append(f)
        return f

    def by_rule(self, rule: str) -> List[Finding]:
        return [f for f in self.findings if f.rule == rule]

    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def ok(self) -> bool:
        return not self.findings

    def extend(self, other: "AnalysisReport") -> None:
        self.findings.extend(other.findings)
        self.meta.update(other.meta)

    def render(self) -> str:
        if not self.findings:
            return "analysis: clean (0 findings)"
        lines = [f"analysis: {len(self.findings)} finding(s)"]
        lines += [f"  {f}" for f in self.findings]
        return "\n".join(lines)

    def to_json(self) -> Dict[str, Any]:
        return {
            "findings": [
                {"rule": f.rule, "severity": f.severity, "site": f.site,
                 "detail": f.detail}
                for f in self.findings
            ],
            "meta": {k: v for k, v in self.meta.items()},
        }

    def __len__(self) -> int:
        return len(self.findings)


def exit_code(report: AnalysisReport, strict: bool = False) -> int:
    """Shared CLI exit convention (``repro.analysis``/``repro.staticcheck``):
    0 clean, 1 findings, 2 under strict when any finding is an error."""
    if strict and report.errors():
        return 2
    return 0 if report.ok else 1


class AnalysisError(RuntimeError):
    """Raised by BPasteRuntime under ``analysis="strict"`` on error findings."""

    def __init__(self, report: AnalysisReport):
        self.report = report
        super().__init__(report.render())


# ======================================================================
# footprint pattern helpers
# ======================================================================

def _covered(key: str, patterns: Iterable[str]) -> bool:
    """Does the namespaced state key match any declared glob pattern?"""
    return any(fnmatchcase(key, p) for p in patterns)


def _is_exact(pattern: str) -> bool:
    """A declared pattern with no glob metacharacters names ONE key."""
    return not any(c in pattern for c in "*?[")


def _glob_prefix(pattern: str) -> str:
    """Literal prefix of a glob pattern (up to the first metacharacter)."""
    for i, c in enumerate(pattern):
        if c in "*?[":
            return pattern[:i]
    return pattern


def _patterns_overlap(a: str, b: str) -> bool:
    """Conservative may-overlap test between two declared patterns: their
    literal prefixes must be prefix-comparable.  Exact vs exact degenerates
    to equality; exact vs glob to fnmatch."""
    if _is_exact(a) and _is_exact(b):
        return a == b
    if _is_exact(a):
        return fnmatchcase(a, b)
    if _is_exact(b):
        return fnmatchcase(b, a)
    pa, pb = _glob_prefix(a), _glob_prefix(b)
    return pa.startswith(pb) or pb.startswith(pa)


# ======================================================================
# R1: policy–footprint consistency
# ======================================================================

def check_footprints(policy: EligibilityPolicy,
                     report: Optional[AnalysisReport] = None) -> AnalysisReport:
    """Dry-run every registered tool through ``StateFacade`` tracking and
    diff the observed per-call footprint against the ToolSpec declaration.

    An undeclared WRITE by a tool whose effective level is PREP_ONLY or
    READ_ONLY is an **error**: the runtime may execute it speculatively
    outside any sandbox-commit discipline (READ_ONLY results serve
    "direct"), so a hidden side effect leaks.  An undeclared staged write is
    a **warn** (sandbox + barrier still contain it, but R3's race matrix is
    blind to it).  Undeclared reads are **warn** at any level: the memo
    store keys validity on reads, so a stale declaration misdescribes what
    an entry depends on."""
    report = report if report is not None else AnalysisReport()
    for name, spec in sorted(policy.tools.items()):
        try:
            reads, write_values = dry_run_footprint(name)
        except KeyError:
            report.add("R1-footprint", "info", name,
                       "no executor implementation; declared footprint unchecked")
            continue
        lvl = policy.level(name)
        for nk in sorted(write_values):
            if _covered(nk, spec.writes):
                continue
            sev = "error" if lvl <= SafetyLevel.READ_ONLY else "warn"
            report.add(
                "R1-footprint", sev, name,
                f"undeclared write to {nk!r} (effective level {lvl.name}, "
                f"declared writes {list(spec.writes)!r})")
        for nk in sorted(reads):
            if _covered(nk, spec.reads) or _covered(nk, spec.writes):
                continue
            report.add(
                "R1-footprint", "warn", name,
                f"undeclared read of {nk!r} (declared reads "
                f"{list(spec.reads)!r})")
    return report


# ======================================================================
# R2: non-speculative reachability
# ======================================================================

def _reachable_tools(engine) -> List[str]:
    """Tools reachable in hypothesis interiors: every mined pattern tuple's
    target tool (the builder grows trees exclusively from these)."""
    pats = getattr(engine, "patterns", None) or []
    return sorted({pt.tool for pt in pats})


def check_nonspec_reachability(policy: EligibilityPolicy, engine,
                               report: Optional[AnalysisReport] = None
                               ) -> AnalysisReport:
    """NON_SPECULATIVE tools (no usable transform) reachable in the mined
    pattern tables.  Tree assembly happily inserts such a node into a
    hypothesis interior, where it bounds its whole subtree — every
    descendant silently stops speculating.  A tool the pattern tables
    reference but the registry doesn't know is an error (assembly would
    KeyError at build time)."""
    report = report if report is not None else AnalysisReport()
    for tool in _reachable_tools(engine):
        if tool not in policy.tools:
            report.add("R2-nonspec-reach", "error", tool,
                       "pattern tables reference a tool missing from the "
                       "registry; hypothesis assembly would fail")
            continue
        if policy.level(tool) != SafetyLevel.NON_SPECULATIVE:
            continue
        if policy.speculative_form(tool) is not None:
            continue
        report.add(
            "R2-nonspec-reach", "warn", tool,
            "NON_SPECULATIVE without a usable transform, yet reachable in "
            "mined patterns: hypothesis interiors containing it stall "
            "speculation for every descendant")
    return report


# ======================================================================
# R3: cross-branch write–write race matrix
# ======================================================================

def check_write_races(policy: EligibilityPolicy, engine,
                      report: Optional[AnalysisReport] = None
                      ) -> AnalysisReport:
    """Static conflict matrix over co-admittable speculative writers.

    Candidate set: the *run forms* of pattern-reachable tools (transforms
    included — the transform target is what actually executes).  Two
    distinct run tools conflict when their declared write footprints
    may overlap; the full may-overlap matrix lands in
    ``report.meta["write_conflicts"]``.  Only an **exact-key** collision
    (both patterns literal and equal) is a finding: both tools staging
    writes to the same key in one shared admission pass genuinely race,
    while a glob-level overlap (two tools under ``F:*``) usually writes
    distinct keys.  Same-tool pairs are excluded — identical invocations
    dedup through the result store, and a deterministic tool rewrites the
    same value."""
    report = report if report is not None else AnalysisReport()
    run_forms: Dict[str, ToolSpec] = {}
    for tool in _reachable_tools(engine):
        form = policy.speculative_form(tool)
        if form is None:
            continue
        run_tool, _ = form
        spec = policy.tools.get(run_tool)
        if spec is not None and spec.writes:
            run_forms[run_tool] = spec
    conflicts: List[List[str]] = []
    names = sorted(run_forms)
    for i, t1 in enumerate(names):
        for t2 in names[i + 1:]:
            for p1 in run_forms[t1].writes:
                for p2 in run_forms[t2].writes:
                    if not _patterns_overlap(p1, p2):
                        continue
                    conflicts.append([t1, t2, p1, p2])
                    if _is_exact(p1) and _is_exact(p2):
                        report.add(
                            "R3-write-race", "warn", f"{t1}+{t2}",
                            f"both declare the exact write key {p1!r} and "
                            f"are co-admittable in one shared admission "
                            f"pass: staged writes race across branches")
    report.meta["write_conflicts"] = conflicts
    return report


# ======================================================================
# R4: commit-barrier placement on real beams
# ======================================================================

def check_barriers(hyps: Iterable[BranchHypothesis],
                   report: Optional[AnalysisReport] = None) -> AnalysisReport:
    """Verify hypothesis.py's insertion invariant on assembled trees: every
    Level-2+ TOOL node's immediate parent is a BARRIER node."""
    report = report if report is not None else AnalysisReport()
    n = 0
    for h in hyps:
        n += 1
        for idx in barrier_violations(h):
            node = next(nd for nd in h.nodes if nd.idx == idx)
            report.add(
                "R4-barrier", "error", f"hyp {h.hid} node {idx}",
                f"STAGED_WRITE tool {node.tool!r} has no BARRIER parent: "
                f"staged effects could commit past an unconfirmed prefix")
    report.meta["barrier_checked_hyps"] = n
    return report


def analyze_static(policy: EligibilityPolicy, engine=None,
                   hyps: Optional[Iterable[BranchHypothesis]] = None
                   ) -> AnalysisReport:
    """The full static pass: R1 always; R2/R3 when a pattern engine is
    supplied; R4 when assembled beams are supplied (the CLI builds beams
    from real workload trace prefixes; the runtime constructor skips R4 —
    beams do not exist yet and building them would consume hypothesis ids)."""
    report = AnalysisReport()
    check_footprints(policy, report)
    if engine is not None:
        check_nonspec_reachability(policy, engine, report)
        check_write_races(policy, engine, report)
    if hyps is not None:
        check_barriers(hyps, report)
    return report


# ======================================================================
# Runtime sanitizer (RuntimeConfig.sanitize=True)
# ======================================================================

class RuntimeSanitizer:
    """Per-tick cross-checker for a live ``BPasteRuntime``.

    Every ``every``-th tick (after the phase loop) it recomputes, from
    scratch and side-effect-free, the values the event scheduler serves from
    caches — and records a finding for every divergence.  Execution-time
    footprint checks (S4) are event-driven: the runtime calls
    :meth:`check_footprint` from its execution completion hooks.

    The sanitizer never mutates runtime state: dirty sets, epochs, caches,
    the store, and the simulator are read-only here, so ``sanitize=True``
    changes wall time but not one scheduling decision."""

    def __init__(self, rt, every: int = 7):
        self.rt = rt
        self.every = max(1, int(every))
        self.report = AnalysisReport()
        self._tick_no = 0

    @property
    def findings(self) -> List[Finding]:
        return self.report.findings

    def _add(self, rule: str, severity: str, site: str, detail: str) -> None:
        self.report.add(rule, severity, site, detail)
        self.rt.metrics.sanitize_findings += 1

    # -- tick entry point ----------------------------------------------
    def on_tick(self) -> None:
        self._tick_no += 1
        if self._tick_no % self.every:
            return
        self.check_all()

    def check_all(self) -> None:
        self.check_epoch_caches()
        self.check_dirty_sets()
        self.check_demand_counters()
        self.check_store_integrity()

    # -- S1: epoch-guarded caches --------------------------------------
    def check_epoch_caches(self) -> None:
        rt = self.rt
        memo_on = rt._memo_on
        tool_pubs = rt.store.tool_pubs
        inval = rt.store.invalidations
        for es in rt.episodes:
            epoch = es.epoch
            for hr in es.hyp_runs:
                if hr.status != "active":
                    continue
                for i, nr in enumerate(hr.node_runs):
                    site = f"e{es.ep.eid} h{hr.hyp.hid} n{i}"
                    fresh_args = None
                    if nr.args_epoch == epoch and nr.args_cache is not None:
                        fresh_args = rt._resolve_node_args(es, hr, i)
                        if fresh_args != nr.args_cache:
                            self._add(
                                "S1-stale-cache", "error", site,
                                f"args cache {nr.args_cache!r} != fresh "
                                f"resolution {fresh_args!r} at epoch {epoch}")
                    if nr.mkey_epoch == epoch and nr.mkey_cache is not None:
                        if nr.node.bindings:
                            if fresh_args is None:
                                fresh_args = rt._resolve_node_args(es, hr, i)
                            args = fresh_args
                        else:
                            args = nr.resolved_args
                        if memo_key(nr.run_tool, args) != nr.mkey_cache:
                            self._add(
                                "S1-stale-cache", "error", site,
                                f"memo-key cache {nr.mkey_cache!r} diverged "
                                f"from fresh key at epoch {epoch}")
                    if memo_on and nr.serv_epoch == epoch:
                        tp = tool_pubs.get(nr.run_tool, 0)
                        guard = (nr.serv_pubs == tp
                                 and (not nr.serv_ok or nr.serv_inval == inval))
                        if guard and self._fresh_servable(es, hr, i,
                                                          fresh_args) != nr.serv_ok:
                            self._add(
                                "S1-stale-cache", "error", site,
                                f"servability verdict cache {nr.serv_ok} "
                                f"contradicts fresh validation at epoch "
                                f"{epoch}")

    def _fresh_servable(self, es, hr, i, fresh_args) -> bool:
        """Recompute the _memo_terms pass-1 verdict side-effect-free."""
        rt = self.rt
        nr = hr.node_runs[i]
        if not rt.store.has_tool(nr.run_tool):
            return False
        if nr.node.bindings:
            args = (fresh_args if fresh_args is not None
                    else rt._resolve_node_args(es, hr, i))
            if len(args) < len(nr.node.bindings):
                return False
        else:
            args = nr.resolved_args
        entry = rt.store.entries.get(memo_key(nr.run_tool, args))
        if entry is None or not entry.valid:
            return False
        return rt.store.validate(entry, hr.sandbox, track=False)

    # -- S2: dirty-set completeness ------------------------------------
    def check_dirty_sets(self) -> None:
        """Recompute every NON-dirty episode's phase-4 caches with a
        side-effect-free frontier walk.  A divergence on an episode the
        scheduler believes clean is the hard bug class the dirty-set design
        defends against: some state change skipped its ``_mark_dirty`` and
        admission is consuming a stale frontier.  Dirty episodes are
        legitimately stale (their rebuild is pending) and are skipped."""
        rt = self.rt
        if not rt._event:
            return
        for es in rt.episodes:
            i = es.idx
            if i < 0 or i in rt._dirty:
                continue
            frs: List[Tuple[Any, List[int]]] = []
            contrib = []
            nact = 0
            if es.phase in ("reasoning", "executing") and es.history:
                for hr in es.hyp_runs:
                    if hr.status != "active":
                        continue
                    nact += 1
                    fr = rt._launch_frontier(es, hr, settle_warm=False)
                    if not fr:
                        continue
                    frs.append((hr, fr))
                    if not any(nr.status == "running" for nr in hr.node_runs):
                        contrib.append((es, hr, fr))
            site = f"e{es.ep.eid}"
            if nact != rt._nact.get(i, 0):
                self._add("S2-dirty-set", "error", site,
                          f"active-branch count drifted: cached "
                          f"{rt._nact.get(i, 0)} != fresh {nact} on a "
                          f"non-dirty episode")
            cached_frs = rt._frontiers.get(i, [])
            if ([(id(hr), fr) for hr, fr in frs]
                    != [(id(hr), fr) for hr, fr in cached_frs]):
                self._add("S2-dirty-set", "error", site,
                          f"launch frontiers drifted: cached "
                          f"{[(hr.hyp.hid, fr) for hr, fr in cached_frs]} != "
                          f"fresh {[(hr.hyp.hid, fr) for hr, fr in frs]} on "
                          f"a non-dirty episode")
            cached_con = rt._contrib.get(i, [])
            if ([(id(hr), fr) for _, hr, fr in contrib]
                    != [(id(hr), fr) for _, hr, fr in cached_con]):
                self._add("S2-dirty-set", "error", site,
                          "admission-pool contribution drifted on a "
                          "non-dirty episode")

    # -- S3: counter-group demand / slack ------------------------------
    def check_demand_counters(self) -> None:
        sim = self.rt.sim
        for spec in (None, True, False):
            fast = sim.running_demand(speculative=spec)
            dense = sim.dense_running_demand(speculative=spec)
            if not np.allclose(fast, dense, rtol=1e-9, atol=1e-6):
                self._add(
                    "S3-slack-drift", "error", f"running_demand({spec})",
                    f"counter-group demand {fast.tolist()} != dense re-sum "
                    f"{dense.tolist()}")
        slack = sim.slack()
        dense_slack = np.maximum(sim.cap - sim.dense_running_demand(), 0.0)
        if not np.allclose(slack, dense_slack, rtol=1e-9, atol=1e-6):
            self._add("S3-slack-drift", "error", "slack",
                      f"slack {slack.tolist()} != dense recompute "
                      f"{dense_slack.tolist()}")

    # -- S4: execution-time footprint contract -------------------------
    def check_footprint(self, tool: str, fac, site: str) -> None:
        """Called by the runtime after every real ``execute_tool``
        (authoritative, speculative, commit replay) with the call's tracked
        facade: the dry-run contract of R1, enforced on live traffic (live
        args can reach state R1's samples never touched)."""
        spec = self.rt.tools.get(tool)
        if spec is None:
            return
        for nk in fac.write_values:
            if not _covered(nk, spec.writes):
                sev = ("error" if spec.level <= SafetyLevel.READ_ONLY
                       else "warn")
                self._add("S4-footprint", sev, f"{tool} @ {site}",
                          f"runtime write to {nk!r} outside declared "
                          f"footprint {list(spec.writes)!r}")
        for nk in fac.reads:
            if not (_covered(nk, spec.reads) or _covered(nk, spec.writes)):
                self._add("S4-footprint", "warn", f"{tool} @ {site}",
                          f"runtime read of {nk!r} outside declared "
                          f"footprint {list(spec.reads)!r}")

    # -- S5: result-store index integrity ------------------------------
    def check_store_integrity(self) -> None:
        for problem in self.rt.store.check_integrity():
            self._add("S5-store-index", "error", "ResultStore", problem)
