"""Discrete-event simulator: virtual clock, multi-resource machine,
interference-stretched preemptible jobs — event-driven core.

Progress model: a job j with solo work W_j progresses at rate 1/slow_j(S)
where slow_j is the bottleneck-model stretch of the *current* co-run set S
(interference.py).  Rates change only when the run set changes (start /
finish / preempt / cancel) — progress is piecewise linear, completion
times exact.

The pre-event implementation re-derived every job's rate and re-scanned
all running jobs for the minimum completion time at every step (O(n) per
event, O(n^2) across a drain).  This core replaces that with:

* an **indexed event queue** — a heap of projected completion times
  ``(t_proj, seq, jid)`` with lazy invalidation: a stale entry (the job's
  rate changed, or the job left the run set) is skipped on pop instead of
  being searched for and removed;
* **lazy settlement** — a job's ``remaining``/``executed_solo_seconds``
  are brought forward to ``now`` only when something needs them (its rate
  changes, it completes, it is preempted, or a caller asks via
  :meth:`settled_remaining`), not for every running job at every event;
* **incremental demand accounting** — ``running_demand``/``slack`` read
  O(#distinct demand vectors) group counters maintained on start/stop,
  instead of O(n) re-sums (counters, not +=/-= accumulators, so there is
  no drift to accumulate and the recomputed-slack invariant holds
  exactly);
* **selective rate recomputation** — on a run-set change only the
  per-dimension utilizations that actually moved are propagated, and only
  jobs *using* a moved dimension get a new rate + fresh queue entry.  In
  the common under-capacity regime (all utilizations <= 1) no rate ever
  changes and a job touches the queue exactly once.

The runtime (runtime.py) plugs in as a ``tick(sim)`` callback invoked
after every state change; preemption keeps remaining work so jobs resume
without losing progress (paper §6: speculative work must be immediately
preemptible and reclaimable).

Observability: ``record_log=False`` disables the event log (an unbounded
list is a memory blowup at c=1024 — benches turn it off); ``slow_samples``
is a bounded ring buffer that skips zero-demand bookkeeping timers; an
optional ``recorder`` hook (see trace.py) receives every
start/finish/preempt/cancel for Gantt/timeline dumps.

Paper anchor: §5–6 (slack, preemptibility), Eq. 4 via interference.py.
Upstream: interference.Machine (capacities, slowdown model).  Downstream:
runtime.py (every authoritative/speculative job and timer),
model_service.py (batched model invocations + linger timers).
"""
from __future__ import annotations

import heapq
import itertools
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.events import RESOURCE_DIMS
from repro_torch.core.interference import Machine

EPS = 1e-9

# ring-buffer capacity for co-run slowdown samples: diagnostics only, and
# an unbounded list grew without limit on long serving sweeps
SLOW_SAMPLE_CAP = 65536


@dataclass
class SimJob:
    jid: int
    name: str
    demand: np.ndarray            # (R,)
    work: float                   # solo seconds
    speculative: bool
    priority: int = 0             # 0 = authoritative, 1 = speculative
    remaining: float = -1.0
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    preempt_count: int = 0
    executed_solo_seconds: float = 0.0   # work actually burned (for waste metric)
    on_complete: Optional[Callable[["Simulator", "SimJob"], None]] = None
    meta: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.remaining < 0:
            self.remaining = self.work


class Simulator:
    def __init__(self, machine: Machine, tick: Callable[["Simulator"], None],
                 *, record_log: bool = True, recorder=None):
        self.machine = machine
        self.cap = machine.cap_array()
        self.now = 0.0
        self.running: Dict[int, SimJob] = {}
        self.tick = tick
        self._jid = itertools.count()
        self.record_log = record_log
        self.log: List[tuple] = []
        # co-run slowdown ratio samples (diagnostics): bounded ring buffer,
        # appended when a job's rate is (re)priced — zero-demand bookkeeping
        # timers are excluded (they always sample 1.0 and polluted the ring)
        self.slow_samples: deque = deque(maxlen=SLOW_SAMPLE_CAP)
        self.truncated: Optional[str] = None  # "max_time"|"max_steps" when
                                              # run() stopped before drain
        # optional per-event observer: recorder(sim, kind, job) with kind in
        # {"start","finish","preempt","cancel"} — trace.GanttRecorder plugs
        # in here for the opt-in full timeline dump
        self.recorder = recorder
        # optional consumer hook for run(): () -> bool, True while the tick
        # callback still holds parked work that needs another tick pass even
        # though the event queue is empty (see the drain loop in run())
        self.drain_probe: Optional[Callable[[], bool]] = None

        # ---- event-queue core state --------------------------------------
        self._heap: List[tuple] = []          # (t_proj, entry_seq, jid)
        self._live: Dict[int, int] = {}       # jid -> valid entry_seq
        self._eseq = itertools.count()        # heap entry sequence
        self._rate: Dict[int, float] = {}     # jid -> current progress rate
        self._last: Dict[int, float] = {}     # jid -> last settlement time
        self._sord: Dict[int, int] = {}       # jid -> start order (callback
                                              # ordering for same-time batches)
        self._sseq = itertools.count()
        # demand groups: demand-vector bytes -> [vec, n_total, n_speculative].
        # Counters (exact integers) times the group vector reconstruct the
        # running demand in O(#groups) with zero accumulated float drift.
        self._groups: Dict[bytes, list] = {}
        self._by_dim: List[set] = [set() for _ in range(RESOURCE_DIMS)]
        self._slow = np.ones(RESOURCE_DIMS)   # clipped per-dim utilization
        # memoized running_demand per speculative-class flag, invalidated on
        # any counter change (start/remove/class flip).  The launch retry
        # loop reads demand once per candidate per tick — recomputing the
        # O(#groups) sum each time was measurable at c≫1.  Values are
        # recomputed from the same counters, so cached == recomputed exactly.
        self._demand_cache: Dict[Optional[bool], np.ndarray] = {}

    # ------------------------------------------------------------------
    def new_job(self, name: str, demand: np.ndarray, work: float, *,
                speculative: bool, on_complete=None, meta=None) -> SimJob:
        return SimJob(
            jid=next(self._jid), name=name, demand=np.asarray(demand, float),
            work=work, speculative=speculative,
            priority=1 if speculative else 0,
            on_complete=on_complete, meta=meta or {},
        )

    def start(self, job: SimJob):
        if job.started_at is None:
            job.started_at = self.now
        self.running[job.jid] = job
        self._sord[job.jid] = next(self._sseq)
        self._last[job.jid] = self.now
        key = job.demand.tobytes()
        g = self._groups.get(key)
        if g is None:
            g = self._groups[key] = [job.demand.copy(), 0, 0]
        g[1] += 1
        if job.speculative:
            g[2] += 1
        self._demand_cache.clear()
        for d in range(RESOURCE_DIMS):
            if job.demand[d] > 0.0:
                self._by_dim[d].add(job.jid)
        if self.record_log:
            self.log.append((self.now, "start", job.name, job.jid, job.speculative))
        if self.recorder is not None:
            self.recorder(self, "start", job)
        self._reprice(touch=job.jid)

    def preempt(self, jid: int) -> Optional[SimJob]:
        job = self.running.get(jid)
        if job is None:
            return None
        self._settle(job)
        self._remove(job)
        job.preempt_count += 1
        if self.record_log:
            self.log.append((self.now, "preempt", job.name, job.jid, job.speculative))
        if self.recorder is not None:
            self.recorder(self, "preempt", job)
        self._reprice()
        return job

    def cancel(self, jid: int) -> Optional[SimJob]:
        """Remove a bookkeeping job (e.g. a batch-linger or arrival timer)
        without the preemption bookkeeping: no preempt_count bump and no
        "preempt" log line — cancelling a timer is not a scheduling decision
        and must not read as one in the logs or waste accounting.  The job's
        ``on_complete`` never fires."""
        job = self.running.get(jid)
        if job is None:
            return None
        self._settle(job)
        self._remove(job)
        if self.record_log:
            self.log.append((self.now, "cancel", job.name, job.jid, job.speculative))
        if self.recorder is not None:
            self.recorder(self, "cancel", job)
        self._reprice()
        return job

    def set_speculative(self, job: SimJob, speculative: bool) -> None:
        """Flip a job's speculative/authoritative class in place (Phase-1
        promotion).  Keeps the incremental auth/spec demand split coherent —
        mutating ``job.speculative`` directly would silently corrupt
        ``running_demand(speculative=...)``.  Rates are class-blind, so no
        repricing is needed."""
        if job.speculative == speculative:
            return
        job.speculative = speculative
        job.priority = 1 if speculative else 0
        if job.jid in self.running:
            g = self._groups[job.demand.tobytes()]
            g[2] += 1 if speculative else -1
            self._demand_cache.clear()

    def running_demand(self, *, speculative: Optional[bool] = None) -> np.ndarray:
        cached = self._demand_cache.get(speculative)
        if cached is not None:
            return cached.copy()          # callers may accumulate in place
        tot = np.zeros(RESOURCE_DIMS)
        for vec, n, ns in self._groups.values():
            k = n if speculative is None else (ns if speculative else n - ns)
            if k:
                tot += k * vec
        self._demand_cache[speculative] = tot
        return tot.copy()

    def slack(self) -> np.ndarray:
        return np.maximum(self.cap - self.running_demand(), 0.0)

    def dense_running_demand(self, *, speculative: Optional[bool] = None) -> np.ndarray:
        """Brute-force O(n) re-sum over ``self.running`` — the pre-event
        implementation of :meth:`running_demand`.  The runtime sanitizer
        (core/analysis.py check S3) diffs the counter-group value against
        this on a sampled schedule; it is NOT for hot paths."""
        tot = np.zeros(RESOURCE_DIMS)
        for job in self.running.values():
            if speculative is None or job.speculative == speculative:
                tot += job.demand
        return tot

    # ------------------------------------------------------------------
    # event-queue internals
    # ------------------------------------------------------------------
    def _settle(self, job: SimJob) -> None:
        """Bring the job's progress forward to ``now`` under its current
        (piecewise-constant) rate."""
        dt = self.now - self._last[job.jid]
        if dt > 0.0:
            adv = dt * self._rate[job.jid]
            job.remaining -= adv
            job.executed_solo_seconds += adv
        self._last[job.jid] = self.now

    def settled_remaining(self, job: SimJob) -> float:
        """The job's remaining solo work as of ``now`` (settling it first if
        it is running — lazy settlement means the raw field can be stale)."""
        if job.jid in self.running:
            self._settle(job)
        return job.remaining

    def _remove(self, job: SimJob) -> None:
        del self.running[job.jid]
        self._live.pop(job.jid, None)         # lazy heap invalidation
        self._rate.pop(job.jid, None)
        self._last.pop(job.jid, None)
        self._sord.pop(job.jid, None)
        g = self._groups[job.demand.tobytes()]
        g[1] -= 1
        if job.speculative:
            g[2] -= 1
        self._demand_cache.clear()
        for d in range(RESOURCE_DIMS):
            if job.demand[d] > 0.0:
                self._by_dim[d].discard(job.jid)

    def _push(self, job: SimJob) -> None:
        seq = next(self._eseq)
        self._live[job.jid] = seq
        t_proj = self.now + job.remaining / self._rate[job.jid]
        heapq.heappush(self._heap, (t_proj, seq, job.jid))

    def _job_slow(self, job: SimJob) -> float:
        s = 1.0
        for d in range(RESOURCE_DIMS):
            if job.demand[d] > 0.0 and self._slow[d] > s:
                s = self._slow[d]
        return s

    def _reprice(self, touch: Optional[int] = None) -> None:
        """Recompute per-dimension utilization after a run-set change and
        re-rate ONLY the jobs whose bottleneck actually moved (plus the
        newly started ``touch`` job, which has no rate yet).  Each re-rated
        job is settled under its old rate first, then gets a fresh event
        queue entry; its old entry goes stale in place."""
        tot = np.zeros(RESOURCE_DIMS)
        for vec, n, _ns in self._groups.values():
            if n:
                tot += n * vec
        u = np.maximum(tot / self.cap, 1.0)
        affected: set = set()
        for d in range(RESOURCE_DIMS):
            if u[d] != self._slow[d]:
                affected |= self._by_dim[d]
        self._slow = u
        if touch is not None:
            affected.add(touch)
        for jid in affected:
            job = self.running.get(jid)
            if job is None:
                continue
            if jid in self._rate:
                self._settle(job)
            slow = self._job_slow(job)
            self._rate[jid] = 1.0 / slow
            if not job.speculative and np.any(job.demand > 0.0):
                self.slow_samples.append(float(slow))
            self._push(job)

    # ------------------------------------------------------------------
    def step(self) -> bool:
        """Advance to the next completion.  Returns False when idle."""
        if not self.running:
            return False
        heap = self._heap
        while heap and self._live.get(heap[0][2]) != heap[0][1]:
            heapq.heappop(heap)               # skip stale entries
        if not heap:
            return False                      # defensive: shouldn't happen
        t_next = heap[0][0]
        # pop every event in the completion window: exact ties plus FP dust
        # (the <= EPS remaining-work criterion below matches the pre-event
        # done test, so near-simultaneous completions batch identically)
        popped: List[SimJob] = []
        while heap and heap[0][0] <= t_next + EPS:
            t, seq, jid = heapq.heappop(heap)
            if self._live.get(jid) == seq:
                popped.append(self.running[jid])
        self.now = t_next
        done: List[SimJob] = []
        for job in popped:
            self._settle(job)
            if job.remaining <= EPS:
                done.append(job)
            else:
                self._push(job)               # not actually finished: re-arm
        # completion callbacks fire in start order — the dict-insertion
        # order the dense scan produced for same-instant batches
        done.sort(key=lambda j: self._sord[j.jid])
        for job in done:
            self._remove(job)
            job.finished_at = self.now
            if self.record_log:
                self.log.append((self.now, "finish", job.name, job.jid,
                                 job.speculative))
            if self.recorder is not None:
                self.recorder(self, "finish", job)
        if done:
            self._reprice()
        for job in done:
            if job.on_complete:
                job.on_complete(self, job)
        return True

    def run(self, max_time: float = 1e7, max_steps: int = 2_000_000) -> bool:
        """Drive to quiescence.  Returns True when the simulation drained
        (no runnable jobs left); False when it hit ``max_time``/``max_steps``
        with work still outstanding — the stop reason lands in
        ``self.truncated`` and a warning fires, so downstream makespans can't
        silently report a truncated clock as a completed run."""
        self.truncated = None
        self.tick(self)
        steps = 0
        while True:
            if self.now >= max_time:
                self.truncated = "max_time"
                break
            if steps >= max_steps:
                self.truncated = "max_steps"
                break
            if not self.step():
                # Queue empty — but a completion cascade can park new work
                # with no event left to carry it (e.g. an instant
                # store-serve chained into a validate-on-arrival spec-step
                # acceptance leaves a pending action that only the NEXT
                # tick dispatches, and that dispatch can itself resolve
                # instantly and park another).  Grant drain ticks while the
                # consumer's ``drain_probe`` reports parked work — each
                # tick consumes it, so this terminates — and exit the
                # moment nothing is runnable and nothing is parked, so
                # ordinary runs keep their exact tick count.
                if not (self.drain_probe is not None
                        and self.drain_probe()):
                    break
            self.tick(self)
            steps += 1
        if self.truncated is not None and not self.running:
            self.truncated = None        # cap hit exactly at drain — complete
        if self.truncated is not None:
            warnings.warn(
                f"Simulator.run stopped on {self.truncated} at t={self.now:.1f} "
                f"with {len(self.running)} job(s) still running; makespan is "
                f"a lower bound", RuntimeWarning, stacklevel=2)
        return self.truncated is None
