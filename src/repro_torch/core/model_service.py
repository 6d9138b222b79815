"""Batched model-step service: the authoritative model-step queue as a
first-class, continuously-batched resource.

Paper anchor: B-PASTE's core invariant is that speculation may only spend
*slack* — it must never tax the latency-critical authoritative path (§5–6,
Eq. 5's ``min(R_slack, B)`` admission limit).  On an accel=1 edge box the
authoritative path IS the model-step queue: with c concurrent episodes, c
reasoning steps contend for one accelerator slot and every scheduler
converges on the serial model-step floor (the serving bench's ``serving/thor_c8``
rows) — there is no slack for any tool-level mechanism to exploit.  The
only lever left is the model side itself: coalescing concurrent episodes'
reasoning steps into one batched model invocation (the same sublinearity
SPORK and Speculative Actions exploit for inference) compresses the queue,
and the reclaimed accelerator time becomes exactly the slack speculation
needs.

Mechanism (continuous-batching semantics over the discrete-event sim):

* ``submit`` enqueues a :class:`ModelStepRequest` instead of spawning a
  solo simulator job (``runtime._start_model_step`` is the only producer).
* Requests coalesce into micro-batches: a batch DISPATCHES when it reaches
  ``max_batch`` members, or when the ``linger`` admission window — opened
  by the batch's first member — expires (a zero-demand timer job; expiry
  with a single member dispatches a singleton batch).
* A dispatched batch runs as ONE simulator job on ONE accelerator slot
  with latency ``interference.batched_step_latency(works, marginal)`` =
  ``max(w) + marginal·(Σw − max(w))`` — sublinear but not free — and
  completes every member's continuation callback at once.
* ``max_batch=1`` (the pinned baseline) bypasses the queue entirely: the
  request dispatches synchronously with its legacy job name, demand, and
  work, so the pre-service runtime is reproduced bit-identically and every
  equivalence/regression test keeps pinning today's behavior.

Scheduling feedback: :meth:`expected_unlock_delay` exposes the wait a model
step landing NOW would see (remaining linger of the forming batch, or a
fresh window).  The runtime threads it into the EU unlock term ΔU
(``scoring.static_gain_terms(model_delay=...)``): a speculative branch
whose payoff is unlocking the next reasoning step early is worth less when
that step would sit in an already-forming batch window anyway.

Upstream: runtime.py (sole producer, Phase-less — batches are
authoritative jobs, protected by Phase 2 like any other).  Downstream:
simulator.py (batch + linger-timer jobs), interference.py (latency curve),
runtime.Metrics (occupancy / queue-delay / batched-vs-solo accounting,
per-tenant attribution).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from repro_torch.core.events import RESOURCE_DIMS
from repro_torch.core.interference import batched_step_latency
from repro_torch.core.simulator import SimJob, Simulator


@dataclass
class ModelStepRequest:
    """One episode's pending reasoning step.

    ``name`` is the legacy solo-job name (``model[e{eid}.{step}]``) so the
    ``max_batch=1`` fast path reproduces the pre-service simulator log
    verbatim; ``on_done`` is the episode-continuation callback the runtime
    would have hung on the solo job.  ``batchable`` carries the workload's
    per-step metadata (``Step.batchable``): a non-batchable step (e.g. a
    latency-critical final answer) always dispatches solo."""
    eid: int
    name: str
    work: float
    on_done: Callable[[Simulator, SimJob], None]
    enqueued_at: float = 0.0
    batchable: bool = True


@dataclass
class SpecStepTicket:
    """One speculative reasoning step riding an idle slot of a forming batch.

    Passengers are strictly lower priority than authoritative fill: they
    never open an admission window, never trigger dispatch, never extend
    linger, and the lowest-EU passenger is EVICTED (``on_evict``) — never
    the batch delayed — when an authoritative request needs the slot.  A
    dispatched passenger rides FREE: batch duration is computed from the
    authoritative members' works only, so authoritative timing is
    bit-identical to a run without passengers (zero marginal latency up to
    ``max_batch``).  ``on_done`` fires after the authoritative members'
    continuations when the batch completes; the runtime validates the
    speculated outcome against authoritative history on arrival."""
    eid: int
    work: float
    eu: float
    on_done: Callable[[Simulator, SimJob], None]
    on_evict: Callable[[], None]
    dispatched: Optional[SimJob] = None


class ModelStepService:
    """Owns the model-step queue for one runtime.

    Parameters
    ----------
    sim : the runtime's simulator (batches become jobs on it).
    rho : demand vector of ONE model invocation — a batch occupies one
        accelerator slot regardless of occupancy; that compression is the
        entire point.
    max_batch : micro-batch size cap.  1 = pinned pre-service baseline
        (synchronous solo dispatch, bit-identical).
    linger : admission window (sim seconds) a forming batch holds open for
        more members, counted from its FIRST member.  Batching across
        asynchronously-arriving episodes needs linger > 0; the window is a
        latency tax on the first member, which is why it must be short and
        why ``expected_unlock_delay`` reports it to admission scoring.
    marginal : per-extra-member cost fraction of
        ``interference.batched_step_latency``.
    metrics : runtime ``Metrics`` object to book occupancy / queue-delay /
        batched-vs-solo counts into (optional — the service works bare).
    """

    def __init__(self, sim: Simulator, rho: np.ndarray, *,
                 max_batch: int = 1, linger: float = 1.0,
                 marginal: float = 0.3, metrics=None,
                 adaptive: bool = False):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if linger < 0:
            raise ValueError(f"linger must be >= 0, got {linger}")
        self.sim = sim
        self.rho = np.asarray(rho, float)
        self.max_batch = int(max_batch)
        self.linger = float(linger)
        self.marginal = float(marginal)
        self.metrics = metrics
        self.adaptive = bool(adaptive)
        self._forming: List[ModelStepRequest] = []
        self._spec_forming: List[SpecStepTicket] = []
        self._linger_job: Optional[SimJob] = None
        self._linger_deadline: float = 0.0
        self._batch_seq = 0
        # adaptive-linger load signal: EMA of batchable-submit inter-arrival
        # gaps (only maintained when ``adaptive`` — the fixed-linger path
        # stays untouched)
        self._last_arrival: Optional[float] = None
        self._ema_gap: Optional[float] = None

    # ------------------------------------------------------------------
    def submit(self, req: ModelStepRequest) -> None:
        """Enqueue one reasoning step.  Solo fast path (``max_batch=1``,
        non-batchable steps, or a zero linger window that can never coalesce
        asynchronous arrivals) dispatches synchronously — same job name,
        demand, and work as the pre-service runtime.  Otherwise the request
        joins the forming batch: dispatch fires on fill (cancelling the
        linger timer) or on linger expiry."""
        req.enqueued_at = self.sim.now
        if self.max_batch == 1 or not req.batchable or self.linger <= 0.0:
            self._dispatch([req])
            return
        if self.adaptive:
            if self._last_arrival is not None:
                gap = max(self.sim.now - self._last_arrival, 0.0)
                self._ema_gap = gap if self._ema_gap is None else (
                    0.7 * self._ema_gap + 0.3 * gap)
            self._last_arrival = self.sim.now
        self._forming.append(req)
        # authoritative fill always wins: when the new member would overflow
        # the batch past speculative passengers, the lowest-EU passenger is
        # evicted — the batch is never delayed and never dispatched over-full
        while (self._spec_forming
               and len(self._forming) + len(self._spec_forming) > self.max_batch):
            victim = min(self._spec_forming, key=lambda t: t.eu)
            self._spec_forming.remove(victim)
            victim.on_evict()
        if len(self._forming) >= self.max_batch:
            if self._linger_job is not None:
                self.sim.cancel(self._linger_job.jid)
                self._linger_job = None
            self._dispatch_forming()
            return
        if self._linger_job is None:
            self._open_window()

    # ------------------------------------------------------------------
    # speculative slot-fill (strictly lower priority than authoritative)
    def submit_speculative(self, ticket: SpecStepTicket) -> bool:
        """Offer a speculative reasoning step an idle slot of the CURRENTLY
        forming batch.  Returns False (nothing enqueued) unless a window is
        open with a free slot — passengers never open windows, never trigger
        dispatch, and never extend linger."""
        if self.max_batch == 1 or self.linger <= 0.0:
            return False
        if self._linger_job is None:
            return False
        if len(self._forming) + len(self._spec_forming) >= self.max_batch:
            return False
        self._spec_forming.append(ticket)
        return True

    def withdraw_spec(self, ticket: SpecStepTicket) -> bool:
        """Remove a still-forming passenger (squash before dispatch).  False
        if it already dispatched or was evicted."""
        if ticket in self._spec_forming:
            self._spec_forming.remove(ticket)
            return True
        return False

    def promote_spec(self, ticket: SpecStepTicket,
                     req: ModelStepRequest) -> None:
        """A still-forming passenger validated by the authoritative arrival:
        it becomes a regular member of the same forming batch (normal
        ``submit`` path — may fill-trigger dispatch)."""
        self.withdraw_spec(ticket)
        self.submit(req)

    @property
    def spec_slot_free(self) -> bool:
        """True iff a speculative step submitted NOW would ride free: a
        window is open with an idle slot.  Admission threads this into the
        slot-marginal-cost term (a hypothesis whose MODEL step lands in a
        forming under-full batch carries near-zero model-step cost in ΔI)."""
        return (self.max_batch > 1 and self.linger > 0.0
                and self._linger_job is not None
                and len(self._forming) + len(self._spec_forming) < self.max_batch)

    def _open_window(self) -> None:
        """Zero-demand timer job holding the admission window open.  Zero
        demand ⇒ no interference and no QoS-sample pollution (the ``timer``
        meta flag excludes it from slowdown attribution, like the arrival
        timer); the event-driven sim would otherwise never wake at the
        deadline when nothing else completes in the window."""
        win = self._window_len()
        self._linger_deadline = self.sim.now + win

        def fire(sim: Simulator, job: SimJob):
            self._linger_job = None
            self._dispatch_forming()

        self._linger_job = self.sim.new_job(
            "model_batch_linger", np.zeros(RESOURCE_DIMS),
            max(win, 1e-9), speculative=False, on_complete=fire,
            meta={"timer": True},
        )
        self.sim.start(self._linger_job)

    def _window_len(self) -> float:
        """Admission-window length for the batch being opened NOW.  Fixed
        ``linger`` unless ``adaptive``, which is load-aware in three
        regimes keyed on the EMA inter-arrival gap of batchable submits:

        * dense (gap ≤ linger): arrivals land inside the fixed window —
          keep it (restoration under burst fill falls out of the EMA
          pulling back down).
        * moderate (linger < gap ≤ 2·linger): the expected next arrival
          lands just PAST the fixed window — every batch would dispatch
          solo having paid the full linger tax for nothing.  Stretch to
          1.25× the expected gap (capped at 2·linger) so the window
          actually catches the next tenant: this is what buys batch
          occupancy at low open-loop rates.
        * trickle (gap > 2·linger): coalescing is a lost cause — shrink
          proportionally and stop paying the admission tax."""
        if not self.adaptive or not self._ema_gap or self._ema_gap <= 0.0:
            return self.linger
        g = self._ema_gap
        if g <= self.linger:
            return self.linger
        if g <= 2.0 * self.linger:
            return min(1.25 * g, 2.0 * self.linger)
        return max(self.linger * (self.linger / g), 1e-9)

    def _dispatch_forming(self) -> None:
        batch, self._forming = self._forming, []
        spec, self._spec_forming = self._spec_forming, []
        if batch:
            self._dispatch(batch, queued=True, spec=spec)
        else:
            # a window is only ever opened by an authoritative member, so
            # passenger-only expiry is unreachable today; evict defensively
            # rather than dispatch a batch speculation would have to pay for
            for t in spec:
                t.on_evict()

    def _dispatch(self, batch: List[ModelStepRequest],
                  queued: bool = False,
                  spec: Optional[List[SpecStepTicket]] = None) -> None:
        """Run one micro-batch as a single simulator job.  Batch demand is
        ONE model invocation's ρ (one accelerator slot — occupancy rides
        inside the job, not on the resource vector); duration follows the
        ``base + marginal·(b−1)`` curve.  Completion fires every member's
        continuation in submission order — the same order solo completions
        at one instant would have fired.  Speculative passengers ride FREE:
        duration is computed from the authoritative works only, ``eids``
        stays authoritative-only (QoS attribution fans over it), and
        passengers' ``on_done`` fire after every authoritative member's."""
        b = len(batch)
        works = [r.work for r in batch]
        dur = batched_step_latency(works, self.marginal)
        name = batch[0].name if b == 1 else (
            f"model_batch[b{self._batch_seq}x{b}]")
        batch_id = self._batch_seq
        self._batch_seq += 1
        self._book_dispatch(batch, queued)
        spec = spec or []

        def done(sim: Simulator, job: SimJob):
            for r in batch:
                r.on_done(sim, job)
            for t in spec:
                t.on_done(sim, job)

        meta = {"eid": batch[0].eid, "eids": [r.eid for r in batch],
                "batch_size": b, "batch": batch_id}
        if spec:
            meta["spec_eids"] = [t.eid for t in spec]
        job = self.sim.new_job(
            name, self.rho, dur, speculative=False, on_complete=done,
            meta=meta,
        )
        for t in spec:
            t.dispatched = job
        if spec and self.metrics is not None:
            self.metrics.spec_slot_fill_samples.append(len(spec))
        self.sim.start(job)

    def _book_dispatch(self, batch: List[ModelStepRequest],
                       queued: bool) -> None:
        m = self.metrics
        if m is None:
            return
        b = len(batch)
        m.model_batches += 1
        m.model_batch_occupancy_samples.append(b)
        if b == 1:
            m.model_solo_steps += 1
        else:
            m.model_batched_steps += b
        for r in batch:
            wait = max(self.sim.now - r.enqueued_at, 0.0)
            if queued:
                # every member that went THROUGH the admission window gets a
                # delay sample — including the fill-triggering member's 0.0
                # — so mean_model_queue_delay is a true per-queued-step mean
                # (solo fast-path dispatches never entered the window and
                # book nothing)
                m.model_queue_delay_samples.append(wait)
            # queue delay is attributed to the tenant that WAITED — the
            # member that opened the window pays the linger, late joiners
            # pay less; per-batch pooling would smear one tenant's latency
            # tax across the whole batch
            if wait > 0.0:
                m.model_queue_delay_seconds += wait
                m.tenant_model_queue_delay[r.eid] = (
                    m.tenant_model_queue_delay.get(r.eid, 0.0) + wait)

    # ------------------------------------------------------------------
    def expected_unlock_delay(self) -> float:
        """Expected wait a model step landing NOW would see before its batch
        even starts: the remaining linger of the forming batch it would join
        (a full window if none is open and batching is on; 0 under the
        ``max_batch=1`` baseline — keeping baseline EU scoring bit-identical).
        Admission threads this into ΔU: unlocking the next reasoning step
        early is worth at most the part of the unlock the batch window does
        not swallow (DESIGN.md, model-step-service section)."""
        if self.max_batch == 1 or self.linger <= 0.0:
            return 0.0
        if self._linger_job is not None:
            # a live window is always joinable: submit() dispatches and
            # clears the forming batch the instant it reaches max_batch, so
            # a full-but-undispatched window state cannot exist
            return max(self._linger_deadline - self.sim.now, 0.0)
        return self._window_len()

    @property
    def forming_size(self) -> int:
        """Members currently waiting in the open admission window."""
        return len(self._forming)
