"""B-PASTE runtime: Algorithm 1 (beam-aware opportunistic speculative
scheduling) over the discrete-event simulator.

Per tick (any job start/finish/preempt):
  Phase 1  Confirm/Promote — match arriving authoritative invocations
           against speculative branch nodes: completed → reuse result (+
           commit the branch's state snapshot up to that node); running →
           promote to authoritative (non-preemptible); completed prefix →
           reuse prefix state and continue from the boundary.
  Phase 2  Protect — if authoritative demand exceeds capacity, preempt
           speculative jobs in ascending admission-EU order.
  Phase 3  Run authoritative jobs (primary FIFO policy, untouched).
  Phase 4  Opportunistic branch scheduling — refresh each active episode's
           beam, pool the idle candidates from ALL episodes into one shared
           cross-episode beam, score EU (Eq. 3) with per-tenant fairness
           weights, and greedily admit the highest-value branch *prefixes*
           under min(R_slack, B) in ONE fused pass per tick (per-episode
           passes each saw slack that ignored demand a sibling episode had
           just admitted but not launched — cross-tenant double-booking);
           admitted prefixes run as preemptible speculative jobs inside CoW
           sandboxes.

Modes:
  "bpaste"   — full system (beam of branch hypotheses, EU objective)
  "paste"    — single-invocation speculation, expected-saved-latency rank
               (the PASTE baseline per [1])
  "parallel" — naive concurrency: admit everything that fits, probability
               order, no EU/no preemption priority (the strawman §9 argues
               against)
  "serial"   — no speculation

Paper anchor: Algorithm 1 (the phase loop), §5–6 (slack-only speculation,
authoritative protection), Eq. 5 admission limit.
Upstream: workload.py (episodes), patterns/hypothesis (beam supply),
scoring/admission (EU + admitted set), safety.py (eligibility policy).
Downstream: simulator.py (every job), sandbox/executor (state effects),
memo.py (cache-served commits), model_service.py (the authoritative
model-step queue — ``_start_model_step`` enqueues there; batches are
authoritative jobs protected by Phase 2 like any other).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

import time

from repro_torch.core.admission import (
    _fit_limit,
    admission_signature,
    bucket_k,
    fused_admit,
    greedy_admit,
)
from repro_torch.core.analysis import AnalysisError, RuntimeSanitizer, analyze_static
from repro_torch.core.scoring import tenant_fairness_weights
from repro_torch.core.events import (
    DEFAULT_TOOLS, RESOURCE_DIMS, Event, ResourceVector, SafetyLevel, ToolSpec,
    signature,
)
from repro_torch.core.executor import StateFacade, execute_tool
from repro_torch.core.hypothesis import (
    COLD_TOOLS, BranchHypothesis, HypothesisBuilder, Node, NodeKind,
)
from repro_torch.core.interference import Machine
from repro_torch.core.memo import MemoEntry, ResultStore, memo_key
from repro_torch.core.model_service import (
    ModelStepRequest, ModelStepService, SpecStepTicket,
)
from repro_torch.core.patterns import PatternEngine
from repro_torch.core.safety import EligibilityPolicy, FULL_POLICY
from repro_torch.core.sandbox import AgentState, Sandbox
from repro_torch.core.scoring import PackedBeam, Scorer, pack_beam, prefix_rho
from repro_torch.core.simulator import SimJob, Simulator
from repro_torch.core.workload import Episode


@dataclass
class NodeRun:
    node: Node
    resolved_args: Dict[str, Any]
    status: str = "pending"       # pending|running|done|reused|promoted
    job: Optional[SimJob] = None
    result: Any = None
    run_tool: str = ""            # actual (possibly transformed) tool
    transformed: bool = False
    snapshot: Optional[Dict[str, Dict[str, Any]]] = None  # cumulative overlay
    waiting: bool = False         # subscribed to an in-flight twin in the
                                  # result store (launch deduped)
    served: bool = False          # result came from the store at zero cost
                                  # (no job, no burn — not "invested" work)
    args_epoch: int = -1          # EpisodeState.epoch the cached resolution
    args_cache: Optional[Dict[str, Any]] = None  # below was computed at
    mkey_epoch: int = -1          # same guard for the canonical memo key
    mkey_cache: Any = None
    # memo-mask servability verdict cache (_memo_terms pass 1).  A verdict
    # can only change if the episode's epoch moved (args / sandbox / node
    # state), the node's tool saw a NEW publish (store.tool_pubs — the only
    # way an unservable key becomes servable), or — for a positive verdict
    # — any invalidation fired (the only way a servable entry retracts
    # without a republish).
    serv_epoch: int = -1
    serv_pubs: int = -1
    serv_inval: int = -1
    serv_ok: bool = False


@dataclass
class HypRun:
    hyp: BranchHypothesis
    eid: int
    sandbox: Sandbox
    node_runs: List[NodeRun]
    eu: float
    parents: Dict[int, Tuple[int, ...]] = field(default_factory=dict)
    base_len: int = 0             # len(history) the hypothesis was built on:
                                  # late bindings resolve against THIS prefix
                                  # (mined offsets are relative to the build
                                  # context, not whatever history grew into)
    status: str = "active"        # active|done|squashed
    used: bool = False            # any node reused/promoted (waste metric)

    def path_to(self, i: int) -> List[int]:
        """Root-to-node index path, via the cached parent map."""
        return self.hyp.path_to(i, self.parents)


@dataclass
class EpisodeState:
    ep: Episode
    state: AgentState
    history: List[Event] = field(default_factory=list)
    step_idx: int = 0
    phase: str = "init"           # init|reasoning|acting|executing|done
    t_start: float = 0.0
    t_end: float = 0.0
    pending_action: Optional[Tuple[str, Dict[str, Any]]] = None
    inflight: Optional[Tuple[str, Dict[str, Any]]] = None
    matched_hr: Optional["HypRun"] = None
    last_writes: set = field(default_factory=set)
    hyp_runs: List[HypRun] = field(default_factory=list)
    auth_queue: List[SimJob] = field(default_factory=list)
    # env_warmup effect horizon, PER TENANT: warmth lives in the episode's
    # own environment, so one tenant's env_warmup must not discount another
    # tenant's cold tools (a global scalar did exactly that under
    # concurrency > 1)
    warm_until: float = -1.0
    idx: int = -1                 # position in BPasteRuntime.episodes — the
                                  # key the event scheduler's dirty-sets and
                                  # per-episode caches are indexed by
    epoch: int = 0                # bumped on every dirtying event; guards the
                                  # per-NodeRun resolved-args cache (the
                                  # pseudo-history inputs — history prefix,
                                  # inflight, path node results — only change
                                  # through events that mark the episode dirty)


@dataclass
class SpecStep:
    """Lifecycle record of one speculative reasoning step (tentpole of the
    two-segment speculation path).

    ``assumed`` is the ENCODED authoritative history the prediction requires
    at the reasoning boundary it targets: the branch's build context plus a
    materialized prefix of the spine's TOOL results.  The agent reasons
    after EVERY action, so every done-prefix of the spine is a valid
    boundary to draft — a branch may hold several outstanding drafts at
    successive boundaries (``full`` marks the one at the MODEL join itself,
    which is what unlocks segment 2).  Validation on arrival compares
    ``assumed`` against the encoded live history (``_consume_spec_steps``):
    equality is a hit, a strict extension keeps the draft alive (the agent
    has not reached that boundary yet), anything else is a dead prediction
    and squashes.  Exactly one terminal ``outcome`` per submission —
    accepted | squashed | evicted — with waste booked so that every
    ``wasted_solo_seconds`` increment has a matching ``spec_solo_seconds``
    contribution (wasted_frac <= 1 stays an invariant).  A passenger whose
    branch resubmits after eviction counts as a NEW submission."""
    es: "EpisodeState"
    hr: HypRun
    i: int                        # MODEL node index in hr.node_runs
    assumed: List[Tuple]
    work: float                   # speculative model-step solo work
    eu: float                     # branch admission EU (eviction order)
    full: bool = False            # boundary == the MODEL join (whole spine)
    ticket: Optional[SpecStepTicket] = None
    landed: bool = False          # batch completed; predicted outcome exists
    outcome: str = ""             # terminal: accepted|squashed|evicted
    pending_auth: bool = False    # authoritative step matched mid-flight:
                                  # batch completion IS the reasoning step
    pending_saved: float = 0.0    # latency credit to book on that completion

    @property
    def stage(self) -> str:
        if self.landed:
            return "done"
        t = self.ticket
        return "inflight" if (t is not None and t.dispatched is not None) \
            else "forming"


@dataclass
class RuntimeConfig:
    mode: str = "bpaste"
    device: str = "cuda"          # where the scorer and the fused admission
                                  # pass run their tensor paths ("cpu" in
                                  # tests); the host numpy paths ignore it
    admission: str = "fused"      # "fused" (one-dispatch admit_beam kernel)
                                  # | "reference" (per-iteration greedy oracle)
    scheduler: str = "event"      # "event" (dirty-set tick loop: an episode
                                  # is re-examined only when one of its
                                  # wakeup triggers fired — O(dirty) per
                                  # tick) | "dense" (the earlier reference
                                  # loop: every phase scans every episode
                                  # every tick — O(c); decision-identical,
                                  # kept as the equivalence oracle)
    record_log: bool = True       # simulator event log (start/finish/...)
                                  # — an unbounded list; benches at c=1024
                                  # turn it off (trace= is the opt-in full
                                  # recorder)
    trace: Any = None             # optional trace.GanttRecorder (or any
                                  # recorder(sim, kind, job) callable)
                                  # attached to the simulator for
                                  # per-episode timeline dumps
    assembly: str = "tree"        # "tree" (branching subgraphs, multi-root
                                  # fill) | "chain" (pre-tree linear baseline)
    beam_k: int = 12              # multi-root fill needs slots: makespan,
                                  # reuse rate, and occupancy all improve up
                                  # to ~12 slots on the default workload,
                                  # then saturate (benchmarks/bench_beam.py)
    max_nodes: int = 12
    lam: float = 0.5
    mu: float = 1.0
    budget: ResourceVector = ResourceVector(cpu=8, mem_bw=60, io=400, accel=1)
    idle_window: float = 8.0
    max_concurrent_episodes: int = 1
    seed: int = 0
    warm_discount: float = 0.65   # prep-node payoff on cold tools (§4.1)
    warm_ttl: float = 120.0
    fairness_alpha: float = 1.0   # shared-beam fairness: tenants already
                                  # holding speculative capacity get their
                                  # candidates' EU discounted by
                                  # 1/(1+alpha*share); 0 disables
    memo: bool = True             # runtime-global result store: validated
                                  # speculative/authoritative results are
                                  # SERVED to later identical invocations
                                  # (any tenant) instead of re-executed;
                                  # inert in mode="serial"
    # batched model-step service (model_service.py): coalesce concurrent
    # episodes' reasoning steps into micro-batched model invocations.
    # max_batch=1 is the PINNED baseline — the service dispatches solo jobs
    # synchronously and the runtime is bit-identical to the pre-service
    # code, which every equivalence/regression test relies on.  Batching is
    # the model-side lever for the accel-bound edge regime where the
    # model-step queue (not tool work) is the bottleneck.
    host_admit_max: int = 512     # pools at/below this take the host-side
                                  # numpy admit kernel; above it, the one-
                                  # dispatch XLA while_loop.  On CPU a
                                  # single XLA dispatch costs ~1 ms — and
                                  # every fresh bucketed pool shape costs
                                  # an in-run compile — which dwarfs the
                                  # numpy arithmetic up to mid-hundreds of
                                  # candidates (the two kernels are
                                  # decision-identical — the fused-
                                  # admission equivalence suite and the
                                  # pinned end-to-end metrics both gate
                                  # this routing)
    warm_admit: bool = True       # verified admission warm-start: when this
                                  # tick's post-filter admission inputs (hid
                                  # tuple, slack/budget/demand vectors,
                                  # fairness weights, memo terms, model
                                  # delay) are byte-identical to last
                                  # tick's, replay last tick's admitted set
                                  # instead of re-running the greedy/fused
                                  # kernel.  The signature pins EVERY input
                                  # the admission decision is a function of,
                                  # so the replayed decisions are
                                  # bit-identical by construction; any
                                  # deviation falls back to the full pass.
                                  # Guarded by staticcheck C1 + the runtime
                                  # sanitizer + event≡dense equivalence.
    model_max_batch: int = 1
    model_batch_linger: float = 1.5   # admission window (sim s) a forming
                                      # batch stays open from its first
                                      # member; the window is a latency tax
                                      # on that member, so keep it short
    model_batch_marginal: float = 0.3  # per-extra-member cost fraction of
                                       # interference.batched_step_latency
    spec_model_steps: bool = False    # speculative reasoning steps: two-
                                      # segment hypothesis trees continue
                                      # past the MODEL join with the mined
                                      # table's top continuation, and the
                                      # predicted step rides an idle slot of
                                      # a forming under-full batch (strictly
                                      # lower priority than authoritative
                                      # fill; validate-on-arrival, mismatch
                                      # squashes).  Default off = the whole
                                      # path is inert and every decision is
                                      # bit-identical to the flag's absence.
                                      # Needs model_max_batch > 1 (passengers
                                      # only exist where idle slots do).
    adaptive_linger: bool = False     # load-aware batch admission window:
                                      # when batchable submits are trickling
                                      # (EMA inter-arrival gap > linger) the
                                      # window shrinks proportionally, and in
                                      # the moderate regime (gap just past
                                      # the window) it stretches toward the
                                      # expected next arrival — the linger
                                      # tax is paid exactly where coalescing
                                      # is likely.  Default off = fixed-
                                      # linger path untouched.
    shed_alpha: float = 0.0           # load-shedding admission (open-loop
                                      # overload ladder): every candidate's
                                      # ΔO is taxed shed_alpha × the arrival
                                      # backlog (arrived-but-unlaunched
                                      # tenants), so the lowest-EU
                                      # speculation sheds first and at deep
                                      # overload the beam prices itself out
                                      # entirely — idle slack is left for
                                      # the queued authoritative work.  The
                                      # scalar threads through every
                                      # admission path at the same point as
                                      # model_delay/spec_costs and enters
                                      # the warm-start signature.  0 = off
                                      # (bit-identical, closed-loop pins).
    # ---- speculation-safety analysis (core/analysis.py) ----------------
    analysis: str = "warn"        # construction-time static pass (R1-R3)
                                  # over (policy, tool table, patterns):
                                  # "off" skips it, "warn" warnings.warn on
                                  # error findings, "strict" raises
                                  # AnalysisError.  The report is kept at
                                  # ``BPasteRuntime.analysis_report`` either
                                  # way.  Pure — no RNG, no builder ids —
                                  # so decisions are untouched.
    sanitize: bool = False        # runtime sanitizer: every sanitize_every
                                  # ticks, cross-check the event scheduler's
                                  # caches (epoch args/memo-key/servability,
                                  # dirty-set frontiers, counter-group
                                  # demand/slack, store indices) against
                                  # fresh recomputation, plus tracked
                                  # executor footprints vs declared specs on
                                  # every execution.  Read-only: findings
                                  # land in ``BPasteRuntime.sanitizer`` and
                                  # Metrics.sanitize_findings, decisions are
                                  # bit-identical to sanitize=False.
    sanitize_every: int = 7       # sampled tick schedule for the sanitizer
                                  # sweep (footprint checks always run when
                                  # sanitize is on); prime, so the sample
                                  # doesn't alias phase-periodic tick shapes
    race_mask: bool = False       # thread R3's write-conflict detection into
                                  # shared admission as a mask: when two
                                  # co-admitted branches' frontier tools
                                  # declare the same EXACT write key with
                                  # different tools, the lower-EU branch is
                                  # de-admitted this pass (report-only
                                  # detection runs under sanitize without
                                  # masking)


@dataclass
class Metrics:
    makespan: float = 0.0
    episode_latencies: List[float] = field(default_factory=list)
    serial_reference: float = 0.0
    promotions: int = 0
    reuses: int = 0
    prefix_reuses: int = 0
    mis_speculations: int = 0
    wasted_solo_seconds: float = 0.0
    spec_solo_seconds: float = 0.0
    qos_violations: int = 0
    auth_slowdown_samples: List[float] = field(default_factory=list)
    auth_actions: int = 0
    # simulation stopped on max_time/max_steps with work outstanding —
    # makespan/latency figures are lower bounds, not results
    truncated: bool = False
    # per-tenant breakdowns (tenant == episode): service latency (launch ->
    # done), sojourn (ARRIVAL -> done, i.e. queueing delay included — the
    # honest serving metric under staggered arrivals, where a tenant can
    # wait far longer for a slot than it spends in service), the
    # speculation-attributable slowdown samples of the tenant's own
    # authoritative jobs, and its QoS violations — fairness is judged on
    # the WORST tenant, which the pooled means above can hide
    tenant_latency: Dict[int, float] = field(default_factory=dict)
    tenant_sojourn: Dict[int, float] = field(default_factory=dict)
    tenant_slowdown_samples: Dict[int, List[float]] = field(default_factory=dict)
    tenant_qos_violations: Dict[int, int] = field(default_factory=dict)
    # cross-episode result store (memo.py): authoritative actions served
    # from the cache at zero execution cost, speculative launches served
    # into sandboxes, duplicate in-flight launches deduped, entries killed
    # by footprint-intersection invalidation, and the per-tenant latency the
    # serves bought (a tenant at saturation gets hits from a sibling's warm
    # speculation — this is the number that shows it)
    memo_serves: int = 0
    memo_hits: int = 0
    memo_dedups: int = 0
    memo_invalidations: int = 0
    memo_entries: int = 0
    memo_saved_seconds: float = 0.0
    tenant_memo_saved: Dict[int, float] = field(default_factory=dict)
    # batched model-step service (model_service.py): dispatched batch jobs,
    # steps served in size>=2 batches vs solo dispatches, per-batch
    # occupancy at dispatch, and the admission-window queue delay each
    # request actually waited — attributed to the tenant that waited, so
    # the linger tax can never hide inside a pooled mean (the batching
    # analogue of per-tenant QoS attribution)
    model_batches: int = 0
    model_batched_steps: int = 0
    model_solo_steps: int = 0
    model_batch_occupancy_samples: List[int] = field(default_factory=list)
    model_queue_delay_samples: List[float] = field(default_factory=list)
    model_queue_delay_seconds: float = 0.0
    tenant_model_queue_delay: Dict[int, float] = field(default_factory=dict)
    # speculative reasoning steps (RuntimeConfig.spec_model_steps): every
    # submitted passenger terminates in exactly one of accepted / squashed /
    # evicted (submitted == accepted + squashed + evicted at run end — the
    # lifecycle property test pins this); saved-seconds is the authoritative
    # step latency the accepted hits bought, slot-fill is passengers per
    # dispatched batch that carried any
    spec_steps_submitted: int = 0
    spec_steps_accepted: int = 0
    spec_steps_squashed: int = 0
    spec_steps_evicted: int = 0
    spec_step_saved_seconds: float = 0.0
    spec_slot_fill_samples: List[int] = field(default_factory=list)
    # occupied beam slots (active hypotheses, launchable or mid-flight,
    # summed over all active episodes) at each shared admission pass —
    # beam fullness against the per-episode beam_k slot cap, NOT the
    # per-pass candidate count (candidates drain as nodes launch)
    beam_occupancy_samples: List[int] = field(default_factory=list)
    # scheduler self-overhead: wall time burned inside admission per tick
    sched_admit_calls: int = 0
    sched_admit_seconds: float = 0.0
    sched_pack_hits: int = 0
    sched_pack_misses: int = 0
    # admission warm-start (RuntimeConfig.warm_admit): passes replayed from
    # last tick's verified signature vs full kernel passes.  Deliberately
    # NOT in summary(): summaries must stay bit-identical warm on/off.
    sched_warm_hits: int = 0
    sched_warm_misses: int = 0
    # whole-tick scheduler overhead (phases 1-4 + QoS accounting): the
    # number the event-driven refactor is judged on —
    # benchmarks/bench_scheduler.py reports it as us/tick/episode
    sched_ticks: int = 0
    sched_tick_seconds: float = 0.0
    # speculation-safety sanitizer (RuntimeConfig.sanitize): findings
    # recorded by the per-tick cross-checks + footprint contract, and
    # branches de-admitted by the write-race conflict mask
    # (RuntimeConfig.race_mask).  Both stay 0 with the knobs off, so the
    # event≡dense and pinned-metric comparisons are unaffected.
    sanitize_findings: int = 0
    race_masked: int = 0
    # load-shedding admission (RuntimeConfig.shed_alpha): admission passes
    # that ran with a nonzero shed tax, the worst arrival backlog behind
    # one, and the candidates priced out while it was active — the ladder's
    # "speculation sheds first" evidence (all 0 with the knob off, so the
    # closed-loop pinned comparisons are unaffected)
    shed_passes: int = 0
    shed_peak_backlog: int = 0
    shed_rejections: int = 0

    def summary(self) -> Dict[str, float]:
        lat = np.array(self.episode_latencies) if self.episode_latencies else np.zeros(1)
        total_spec = max(self.spec_solo_seconds, 1e-9)
        return {
            "makespan": self.makespan,
            "mean_latency": float(lat.mean()),
            "p95_latency": float(np.percentile(lat, 95)),
            "promotions": self.promotions,
            "reuses": self.reuses,
            "prefix_reuses": self.prefix_reuses,
            "mis_speculations": self.mis_speculations,
            "wasted_frac": self.wasted_solo_seconds / total_spec,
            "spec_solo_seconds": self.spec_solo_seconds,
            "qos_violations": self.qos_violations,
            "reuse_rate": self.reuses / max(self.auth_actions, 1),
            "beam_occupancy": (
                float(np.mean(self.beam_occupancy_samples))
                if self.beam_occupancy_samples else 0.0
            ),
            "mean_auth_slowdown": float(np.mean(self.auth_slowdown_samples))
            if self.auth_slowdown_samples else 1.0,
            "sched_admit_calls": self.sched_admit_calls,
            "sched_us_per_admit": (
                self.sched_admit_seconds * 1e6 / self.sched_admit_calls
                if self.sched_admit_calls else 0.0
            ),
            "sched_pack_hit_rate": (
                self.sched_pack_hits
                / max(self.sched_pack_hits + self.sched_pack_misses, 1)
            ),
            "sched_ticks": self.sched_ticks,
            "sched_us_per_tick": (
                self.sched_tick_seconds * 1e6 / self.sched_ticks
                if self.sched_ticks else 0.0
            ),
            "truncated": float(self.truncated),
            "worst_tenant_latency": (
                max(self.tenant_latency.values()) if self.tenant_latency else 0.0
            ),
            "p95_sojourn": (
                float(np.percentile(list(self.tenant_sojourn.values()), 95))
                if self.tenant_sojourn else 0.0
            ),
            "worst_tenant_sojourn": (
                max(self.tenant_sojourn.values()) if self.tenant_sojourn else 0.0
            ),
            "worst_tenant_slowdown": (
                max(float(np.mean(s)) for s in self.tenant_slowdown_samples.values())
                if self.tenant_slowdown_samples else 1.0
            ),
            "memo_serves": self.memo_serves,
            "memo_hits": self.memo_hits,
            "memo_dedups": self.memo_dedups,
            "memo_invalidations": self.memo_invalidations,
            "memo_saved_seconds": self.memo_saved_seconds,
            "memo_serve_rate": self.memo_serves / max(self.auth_actions, 1),
            "model_batches": self.model_batches,
            "model_batched_steps": self.model_batched_steps,
            "model_solo_steps": self.model_solo_steps,
            "model_batch_occupancy": (
                float(np.mean(self.model_batch_occupancy_samples))
                if self.model_batch_occupancy_samples else 0.0
            ),
            "model_queue_delay_seconds": self.model_queue_delay_seconds,
            "mean_model_queue_delay": (
                float(np.mean(self.model_queue_delay_samples))
                if self.model_queue_delay_samples else 0.0
            ),
            "spec_steps_submitted": self.spec_steps_submitted,
            "spec_steps_accepted": self.spec_steps_accepted,
            "spec_steps_squashed": self.spec_steps_squashed,
            "spec_steps_evicted": self.spec_steps_evicted,
            "spec_step_saved_seconds": self.spec_step_saved_seconds,
            "spec_squash_rate": (
                self.spec_steps_squashed / max(self.spec_steps_submitted, 1)
            ),
            "spec_slot_fill": (
                float(np.mean(self.spec_slot_fill_samples))
                if self.spec_slot_fill_samples else 0.0
            ),
            "sanitize_findings": self.sanitize_findings,
            "race_masked": self.race_masked,
            "shed_passes": self.shed_passes,
            "shed_peak_backlog": self.shed_peak_backlog,
            "shed_rejections": self.shed_rejections,
        }

    def per_tenant(self) -> Dict[int, Dict[str, float]]:
        """Per-tenant serving breakdown: service latency, arrival-inclusive
        sojourn, mean slowdown of the tenant's own authoritative jobs, and
        its QoS violations."""
        eids = (set(self.tenant_latency) | set(self.tenant_slowdown_samples)
                | set(self.tenant_qos_violations))
        return {
            eid: {
                "latency": self.tenant_latency.get(eid, 0.0),
                "sojourn": self.tenant_sojourn.get(eid, 0.0),
                "mean_auth_slowdown": (
                    float(np.mean(self.tenant_slowdown_samples[eid]))
                    if self.tenant_slowdown_samples.get(eid) else 1.0
                ),
                "qos_violations": float(self.tenant_qos_violations.get(eid, 0)),
                "memo_saved": self.tenant_memo_saved.get(eid, 0.0),
                "model_queue_delay": self.tenant_model_queue_delay.get(eid, 0.0),
            }
            for eid in sorted(eids)
        }


class BPasteRuntime:
    def __init__(
        self,
        episodes: List[Episode],
        engine: PatternEngine,
        machine: Optional[Machine] = None,
        policy: EligibilityPolicy = FULL_POLICY,
        rcfg: Optional[RuntimeConfig] = None,
        tools: Dict[str, ToolSpec] = DEFAULT_TOOLS,
        episode_source: Optional[Iterator[Episode]] = None,
    ):
        if machine is None:
            machine = Machine()
        if rcfg is None:
            rcfg = RuntimeConfig()
        if rcfg.admission not in ("fused", "reference"):
            raise ValueError(
                f"RuntimeConfig.admission must be 'fused' or 'reference', "
                f"got {rcfg.admission!r}")
        if rcfg.scheduler not in ("event", "dense"):
            raise ValueError(
                f"RuntimeConfig.scheduler must be 'event' or 'dense', "
                f"got {rcfg.scheduler!r}")
        if rcfg.analysis not in ("off", "warn", "strict"):
            raise ValueError(
                f"RuntimeConfig.analysis must be 'off', 'warn' or 'strict', "
                f"got {rcfg.analysis!r}")
        self.machine = machine
        self.policy = policy
        self.rcfg = rcfg
        self.tools = tools
        self.rng = np.random.default_rng(rcfg.seed)
        self.engine = engine
        # speculative reasoning steps only exist where idle batch slots do:
        # batching must be on, and serial mode is the no-system baseline
        self._spec_on = (rcfg.spec_model_steps and rcfg.mode != "serial"
                         and rcfg.model_max_batch > 1)
        # tree assembly gets the full packed-table budget (rcfg.max_nodes
        # minus the MODEL join; two-segment assembly also reserves the
        # post-MODEL continuation's up-to-3 nodes): siblings must not eat
        # the spine's depth, and total nodes must stay inside the scorer's
        # packed N.  The chain baseline keeps the builder's historical bound.
        if rcfg.assembly == "tree":
            builder_nodes = (max(rcfg.max_nodes - 4, 1) if self._spec_on
                             else rcfg.max_nodes - 1)
        else:
            builder_nodes = HypothesisBuilder.max_nodes
        self.builder = HypothesisBuilder(
            engine, tools=tools, assembly=rcfg.assembly,
            max_nodes=builder_nodes,
            spec_steps=self._spec_on and rcfg.assembly == "tree")
        self.scorer = Scorer(machine, lam=rcfg.lam, mu=rcfg.mu,
                             k_max=rcfg.beam_k, n_max=rcfg.max_nodes,
                             device=rcfg.device)
        self.metrics = Metrics()
        self.episodes = [EpisodeState(ep, AgentState()) for ep in episodes]
        for i, es in enumerate(self.episodes):
            es.idx = i
        self._eid2idx = {es.ep.eid: es.idx for es in self.episodes}
        # ---- event-driven tick state (scheduler="event") -------------
        # Dirty-sets index EPISODES (by es.idx); marks are recorded
        # unconditionally in both modes (set adds are cheap, and an extra
        # mark is always safe — the bug class to defend against is a
        # MISSING mark, which would leave an episode's cached beam /
        # frontier stale while the dense loop would have rebuilt it).
        self._event = rcfg.scheduler == "event"
        self._dirty: set = set()       # beam/frontier caches need rebuild
        self._acting: set = set()      # pending authoritative action to match
        self._auth_idx: set = set()    # non-empty auth_queue
        self._n_serving = 0            # episodes in phases other than
                                       # init/done (replaces the O(c)
                                       # _launch_wave scan)
        # per-episode phase-4 caches, rebuilt only for dirty episodes:
        # _frontiers[i] = [(hr, frontier_indices)] over ALL active branches
        # with a non-empty launch frontier; _contrib[i] = the idle subset
        # formatted as shared-pool entries; _nact[i] = active-branch count
        # (the beam-occupancy contribution)
        self._frontiers: Dict[int, List[Tuple[HypRun, List[int]]]] = {}
        self._contrib: Dict[int, List[Tuple[EpisodeState, HypRun, List[int]]]] = {}
        self._nact: Dict[int, int] = {}
        self._n_active_tot = 0
        self._spec_idx: set = set()    # episodes with cached frontiers
        self._pool_idx: set = set()    # episodes contributing pool candidates
        # runtime-GLOBAL result store: one cache spans every episode/tenant,
        # so a tenant at saturation is served from a sibling's warm
        # speculation (speculative value decoupled from speculative
        # execution).  Inert in serial mode — serial is the no-system
        # baseline, caching is part of the speculation machinery.
        self.store = ResultStore()
        self._memo_on = rcfg.memo and rcfg.mode != "serial"
        self._rho_cache: Dict[int, np.ndarray] = {}   # hid -> static prefix_rho
        self._pack_rows: Dict[int, tuple] = {}        # hid -> pack_beam row set
        # (hid, frozenset(excl)) -> memo-excluded prefix_rho: a pure function
        # of the immutable hypothesis and the exclusion set, so entries never
        # go stale — the memo pass otherwise re-runs the prefix DP for every
        # partially-memoized candidate every tick (top profile entry at c≫1)
        self._rho_excl_cache: Dict[tuple, np.ndarray] = {}
        self._cap = machine.cap_array()               # Machine is frozen
        self._wave_ptr = 0
        # shared-beam incremental packing: ONE PackedBeam cache for the
        # pooled cross-episode candidate beam (hids are globally unique —
        # a single builder numbers every episode's hypotheses)
        self._packed_beam: Optional[PackedBeam] = None
        self._packed_sig: Optional[Tuple] = None
        # admission warm-start (rcfg.warm_admit): the last full pass's
        # decision signature + admitted {hid: eu}.  No explicit
        # invalidation needed — the signature re-verifies every decision
        # input on each pass, so staleness can only produce a miss.
        self._warm_sig: Optional[Tuple] = None
        self._warm_admitted: Optional[Dict[int, float]] = None
        # per-hid static-gain-term cache for the host admission path (the
        # warm-start's sub-signature level: raw terms are hypothesis-
        # intrinsic, so they survive pool-membership churn that misses the
        # full signature).  Values never go stale — hids are unique and
        # hypotheses immutable — so like _pack_rows it is only size-bounded.
        self._static_rows: Dict[int, Tuple] = {}
        self._arrival_timer: Optional[SimJob] = None
        # open-loop episode source: a lazy iterator of Episodes with
        # nondecreasing arrivals (workload.open_loop_source) drained into
        # the roster mid-run — the runtime admits tenants as they ARRIVE
        # instead of from a frozen list.  None (the default) is the frozen
        # closed-loop roster, bit-identical to the pre-source code.
        self._source: Optional[Iterator[Episode]] = (
            iter(episode_source) if episode_source is not None else None)
        self.sim = Simulator(machine, self._tick,
                             record_log=rcfg.record_log,
                             recorder=rcfg.trace)
        self.sim.drain_probe = self._drain_pending
        # batched model-step service: owns the model-step queue (the sole
        # authoritative path on an accel-bound edge box).  max_batch=1 is a
        # synchronous pass-through, bit-identical to spawning solo jobs here.
        self.model_service = ModelStepService(
            self.sim, tools["model_step"].rho.as_array(),
            max_batch=rcfg.model_max_batch, linger=rcfg.model_batch_linger,
            marginal=rcfg.model_batch_marginal, metrics=self.metrics,
            adaptive=rcfg.adaptive_linger,
        )
        # live speculative reasoning steps, keyed by tenant eid — settled
        # (removed) exactly once each via _settle_spec_step
        self._spec_steps: Dict[int, List[SpecStep]] = {}
        # construction-time static safety pass (core/analysis.py R1-R3):
        # pure — dry-runs on throwaway state, no RNG, no hypothesis ids —
        # so it cannot perturb a single scheduling decision.  R4 (barrier
        # placement) needs assembled beams and runs via the CLI instead.
        if rcfg.analysis != "off":
            self.analysis_report = analyze_static(policy, engine)
            errs = self.analysis_report.errors()
            if errs:
                if rcfg.analysis == "strict":
                    raise AnalysisError(self.analysis_report)
                import warnings
                warnings.warn(
                    f"speculation-safety analysis found {len(errs)} error "
                    f"finding(s):\n" + "\n".join(f"  {f}" for f in errs),
                    RuntimeWarning, stacklevel=2)
        else:
            self.analysis_report = None
        self.sanitizer = (RuntimeSanitizer(self, every=rcfg.sanitize_every)
                          if rcfg.sanitize else None)

    # ==================================================================
    def run(self) -> Metrics:
        self._launch_wave()
        self.sim.run()
        self.metrics.truncated = self.sim.truncated is not None
        self.metrics.makespan = self.sim.now
        self.metrics.serial_reference = sum(
            es.ep.serial_latency(self.tools) for es in self.episodes
        )
        # settle branches still alive at simulation end: _squash_one books
        # their burn into spec/wasted exactly once (same path as mid-run
        # squashes), so wasted_frac stays <= 1 by construction
        for es in self.episodes:
            self._squash_all(es)
        self.metrics.memo_invalidations = self.store.invalidations
        self.metrics.memo_entries = len(self.store)
        return self.metrics

    def _mark_dirty(self, es: EpisodeState):
        """Wake an episode for the next phase-4 beam/frontier rebuild.
        Called unconditionally (both schedulers): a stray mark costs one
        set-add, a missing one leaves a stale cache.  Also advances the
        episode's epoch, invalidating every cached arg resolution — a spare
        bump costs one re-resolve, a missing one serves stale args."""
        es.epoch += 1
        if es.idx >= 0:
            self._dirty.add(es.idx)

    def _mark_dirty_eid(self, eid):
        i = self._eid2idx.get(eid)
        if i is not None:
            self._mark_dirty(self.episodes[i])

    def _pump_source(self):
        """Drain the open-loop episode source of every episode that has
        ARRIVED, plus one future head for the arrival timer to park on.
        Arrivals are nondecreasing, so the newest materialized episode
        having a future arrival means every still-lazy one does too — the
        roster then holds the complete arrived-but-unlaunched backlog
        (the load-shedding signal) at all times."""
        while self._source is not None:
            if (self._wave_ptr < len(self.episodes)
                    and self.episodes[-1].ep.arrival > self.sim.now + 1e-9):
                break
            ep = next(self._source, None)
            if ep is None:
                self._source = None
                break
            es = EpisodeState(ep, AgentState())
            es.idx = len(self.episodes)
            self.episodes.append(es)
            self._eid2idx[ep.eid] = es.idx

    def _arrival_backlog(self) -> int:
        """Arrived-but-unlaunched tenants — the overload pressure the
        shedding ladder keys on.  Episodes are in arrival order, so the
        count is a prefix scan from the wave pointer."""
        n = 0
        for i in range(self._wave_ptr, len(self.episodes)):
            if self.episodes[i].ep.arrival > self.sim.now + 1e-9:
                break
            n += 1
        return n

    def _launch_wave(self):
        self._pump_source()
        # incremental serving count (clamped: unit tests drive episodes
        # through _finish_action without ever launching them here)
        active = max(self._n_serving, 0)
        while (active < self.rcfg.max_concurrent_episodes
               and self._wave_ptr < len(self.episodes)):
            es = self.episodes[self._wave_ptr]
            arrival = getattr(es.ep, "arrival", 0.0)
            if arrival > self.sim.now + 1e-9:
                # staggered tenant hasn't arrived yet: park the wave and wake
                # at its arrival time (episodes are in arrival order)
                self._schedule_arrival(arrival)
                break
            self._wave_ptr += 1
            es.t_start = self.sim.now
            es.phase = "reasoning"
            self._n_serving += 1
            self._mark_dirty(es)
            self._start_model_step(es)
            active += 1
        else:
            # open-loop serving at capacity: keep the arrival timer armed on
            # the next FUTURE arrival anyway, so the source keeps
            # materializing (and the backlog signal stays fresh) while every
            # slot is busy.  Closed-loop rosters (no source) take the legacy
            # quiet path — no extra timer jobs, bit-identical schedules.
            if self._source is not None:
                for i in range(self._wave_ptr, len(self.episodes)):
                    arrival = self.episodes[i].ep.arrival
                    if arrival > self.sim.now + 1e-9:
                        self._schedule_arrival(arrival)
                        break

    def _schedule_arrival(self, t: float):
        """Zero-demand wake-up timer for the next pending tenant arrival —
        the event-driven sim would otherwise go quiescent (or never see the
        arrival) whenever no job completion lands between now and ``t``.
        Zero demand means no interference and no QoS sample pollution (the
        ``timer`` meta flag excludes it from slowdown attribution)."""
        if (self._arrival_timer is not None
                and self._arrival_timer.jid in self.sim.running):
            return                        # a timer for this arrival is live
        def fire(sim: Simulator, job: SimJob):
            self._arrival_timer = None
            self._launch_wave()
        self._arrival_timer = self.sim.new_job(
            "arrival_timer", np.zeros(RESOURCE_DIMS),
            max(t - self.sim.now, 1e-9), speculative=False,
            on_complete=fire, meta={"timer": True},
        )
        self.sim.start(self._arrival_timer)

    # ==================================================================
    # episode driving (authoritative path)
    # ==================================================================
    def _start_model_step(self, es: EpisodeState):
        """Enqueue the episode's next reasoning step into the model-step
        service.  Under ``model_max_batch=1`` the service dispatches a solo
        job synchronously (same name/demand/work as the pre-service code);
        with batching on, the step may coalesce with other tenants' steps
        into one micro-batched model invocation.

        Speculative reasoning steps validate ON ARRIVAL here: a live
        speculative step whose assumed history matches the authoritative one
        replaces this submit entirely (its batch already computed — or is
        computing, or will compute — the very step the agent is asking
        for); divergent predictions squash before anything dispatches."""
        step = es.ep.steps[es.step_idx]
        if self._spec_on and self._consume_spec_steps(es, step):
            return

        def done(sim: Simulator, job: SimJob):
            self._on_reasoning_done(es)

        self.model_service.submit(ModelStepRequest(
            eid=es.ep.eid, name=f"model[e{es.ep.eid}.{es.step_idx}]",
            work=step.model_work, on_done=done,
            batchable=step.batchable,
        ))

    def _on_reasoning_done(self, es: EpisodeState):
        step = es.ep.steps[es.step_idx]
        es.pending_action = (step.tool, dict(step.args))
        es.phase = "acting"
        if es.idx >= 0:
            self._acting.add(es.idx)
        self._mark_dirty(es)
        # Phase 1 happens inside the tick that follows this completion.

    # ==================================================================
    # speculative reasoning steps (RuntimeConfig.spec_model_steps)
    # ==================================================================
    @staticmethod
    def _enc_call(tool: str, result) -> Tuple:
        """Canonical encoding of one authoritative tool invocation for
        validate-on-arrival comparison.  Deliberately (tool, result) and
        NOT args: authoritative events carry the step's full argument dict
        while spine nodes resolve only the binding subset the pattern
        mined, so arg equality is unobtainable even on a perfectly
        followed spine.  Tool results embed the arguments that shaped
        them (and on the reuse path the event's result IS the node's
        result object), so (tool, repr(result)) is the discriminating
        fingerprint; a false accept can only mis-credit latency — the
        reasoning outcome itself is read from the authoritative script."""
        return (tool, repr(result))

    def _enc(self, e: Event) -> Tuple:
        return self._enc_call(e.tool, e.result)

    def _submit_spec_step(self, es: EpisodeState, hr: HypRun, i: int) -> bool:
        """Offer a branch's next reasoning boundary to an idle slot of the
        forming batch.

        The agent reasons after EVERY action, so the draft targets the
        deepest boundary the branch can currently vouch for: build context
        plus the longest materialized prefix of the spine (``full`` when
        that prefix is the whole spine — the MODEL join itself, whose
        landing unlocks segment 2).  Fires only when the service reports a
        free slot — passengers never open windows or delay dispatch.  The
        ``assumed`` history is frozen at submit time; everything after is
        validate-on-arrival."""
        nr = hr.node_runs[i]
        if (not self._spec_on or nr.status != "pending"
                or i != hr.hyp.model_idx):
            return False
        if len(es.history) < hr.base_len:
            return False          # build-context action still in flight
        if not self.model_service.spec_slot_free:
            return False
        assumed = [self._enc(e) for e in es.history[:hr.base_len]]
        full = True
        for j in hr.path_to(i)[:-1]:
            p = hr.node_runs[j]
            if p.node.kind != NodeKind.TOOL:
                continue
            if p.status not in ("done", "reused", "promoted"):
                full = False      # prefix ends: result not materialized
                break             # (missing args or a still-running node)
            assumed.append(self._enc_call(p.run_tool, p.result))
        actual = [self._enc(e) for e in es.history]
        n = len(actual)
        if not (len(assumed) > n and assumed[:n] == actual):
            return False          # no unconsumed boundary (or divergent)
        live = self._spec_steps.get(es.ep.eid, ())
        if any(ss.assumed == assumed for ss in live):
            return False          # this boundary is already drafted
        work = self.tools["model_step"].base_latency
        ss = SpecStep(es=es, hr=hr, i=i, assumed=assumed, work=work,
                      eu=hr.eu, full=full)

        def spec_done(sim: Simulator, job: SimJob, ss=ss):
            if ss.outcome:
                return            # settled mid-flight (squash/prune)
            ss.landed = True
            es2 = ss.es
            nr2 = ss.hr.node_runs[ss.i]
            if ss.pending_auth:
                # the authoritative step validated against this passenger
                # while its batch was mid-flight: this completion IS the
                # reasoning step — credit the remaining-work saving
                self._settle_spec_step(ss, "accepted",
                                       saved=ss.pending_saved)
                if ss.full and nr2.status == "pending":
                    nr2.status = "reused"
                self._mark_dirty(es2)
                self._on_reasoning_done(es2)
                return
            if ss.hr.status != "active":
                self._settle_spec_step(ss, "squashed")
                return
            if ss.full and nr2.status == "pending":
                # the MODEL join's own reasoning outcome materialized: the
                # post-MODEL segment becomes launchable (frontier ready on
                # done|reused).  Partial-boundary drafts stay live for
                # validation but never open segment 2 — their context is
                # not the join's.
                nr2.status = "done"
                self._mark_dirty(es2)

        def on_evict(ss=ss):
            self._settle_spec_step(ss, "evicted")

        ticket = SpecStepTicket(eid=es.ep.eid, work=work, eu=hr.eu,
                                on_done=spec_done, on_evict=on_evict)
        ss.ticket = ticket
        if not self.model_service.submit_speculative(ticket):
            return False
        self._spec_steps.setdefault(es.ep.eid, []).append(ss)
        self.metrics.spec_steps_submitted += 1
        # nr.status stays "pending": the node is a reusable drafting handle
        # — deeper boundaries are drafted as more of the spine materializes
        # (the per-boundary dedup above prevents duplicates).
        return True

    def _consume_spec_steps(self, es: EpisodeState, step) -> bool:
        """Validate-on-arrival against the live speculative steps when the
        agent reaches a reasoning step.  Dead predictions (assumed history
        neither equal to nor a strict extension of the authoritative one)
        squash immediately; the best hit — completed beats mid-flight beats
        still-forming — replaces the authoritative submit.  Returns True
        iff the submit was replaced."""
        live = self._spec_steps.get(es.ep.eid)
        if not live:
            return False
        actual = [self._enc(e) for e in es.history]
        n = len(actual)
        rank = {"done": 0, "inflight": 1, "forming": 2}
        hit: Optional[SpecStep] = None
        for ss in list(live):
            if ss.assumed == actual:
                if hit is None or rank[ss.stage] < rank[hit.stage]:
                    hit = ss
            elif not (len(ss.assumed) > n and ss.assumed[:n] == actual):
                self._settle_spec_step(ss, "squashed")
        if hit is None:
            return False
        nr = hit.hr.node_runs[hit.i]
        if hit.stage == "done":
            # the predicted step already computed: zero-latency reuse
            self._settle_spec_step(hit, "accepted", saved=step.model_work)
            if hit.full and nr.status in ("pending", "done"):
                nr.status = "reused"
                self._mark_dirty(es)
            self._on_reasoning_done(es)
            return True
        if hit.stage == "inflight":
            job = hit.ticket.dispatched
            remaining = max(self.sim.settled_remaining(job), 0.0)
            if remaining >= step.model_work:
                # waiting out the batch would cost more than dispatching
                # fresh: not a win — leave the passenger to settle on its
                # own (it goes dead once this step's action lands)
                return False
            hit.pending_auth = True
            hit.pending_saved = step.model_work - remaining
            return True
        # still forming: the passenger becomes a regular member of the SAME
        # forming batch (authoritative submit path — may fill-trigger);
        # nothing was saved, but nothing was wasted either

        def done(sim: Simulator, job: SimJob):
            self._on_reasoning_done(es)

        ticket = hit.ticket
        self._settle_spec_step(hit, "accepted", saved=0.0)
        if hit.full and nr.status == "pending":
            nr.status = "reused"
            self._mark_dirty(es)
        self.model_service.promote_spec(ticket, ModelStepRequest(
            eid=es.ep.eid, name=f"model[e{es.ep.eid}.{es.step_idx}]",
            work=step.model_work, on_done=done,
            batchable=step.batchable,
        ))
        return True

    def _settle_spec_step(self, ss: SpecStep, outcome: str,
                          saved: float = 0.0) -> None:
        """Book one speculative step's terminal outcome exactly once.

        Waste invariant: a dispatched passenger's work enters
        ``spec_solo_seconds`` whatever its fate (it was executed);
        squash-after-dispatch adds the SAME work to ``wasted_solo_seconds``
        — so wasted_frac <= 1 holds by construction.  Forming-stage
        terminals (evicted, or squashed before dispatch) book nothing:
        no cycles were burned."""
        if ss.outcome:
            return
        stage = ss.stage          # capture before mutating
        ss.outcome = outcome
        live = self._spec_steps.get(ss.es.ep.eid)
        if live is not None and ss in live:
            live.remove(ss)
        dispatched = (ss.ticket is not None
                      and ss.ticket.dispatched is not None)
        if outcome == "accepted":
            self.metrics.spec_steps_accepted += 1
            self.metrics.spec_step_saved_seconds += saved
            if dispatched:
                self.metrics.spec_solo_seconds += ss.work
            return
        if outcome == "squashed":
            self.metrics.spec_steps_squashed += 1
            if stage == "forming" and ss.ticket is not None:
                self.model_service.withdraw_spec(ss.ticket)
            elif dispatched:
                self.metrics.spec_solo_seconds += ss.work
                self.metrics.wasted_solo_seconds += ss.work
        else:                     # evicted (service already dropped ticket)
            self.metrics.spec_steps_evicted += 1
        # non-accepted terminal: nothing to revert — the MODEL node stayed
        # "pending" while drafting, so a still-active branch resubmits on
        # the next frontier pass (counted as a new submission).

    def _finish_action(self, es: EpisodeState, result: Any, t_start: float):
        """``t_start`` is the action's WALL start time (``job.started_at``) —
        ``now - solo_work`` understated the start under co-run interference
        (stretched jobs span more wall time than their solo work) and was
        plain wrong for promoted jobs, which started before the agent asked."""
        self._mark_dirty(es)
        step = es.ep.steps[es.step_idx]
        ev = Event("tool", step.tool, dict(step.args), result,
                   t_start, self.sim.now, es.ep.eid)
        es.history.append(ev)
        es.state.history.append(ev)
        es.pending_action = None
        es.inflight = None
        self.metrics.auth_actions += 1
        keep = es.matched_hr
        es.matched_hr = None
        writes = getattr(es, "last_writes", set()) or set()
        self._prune_beam(es, es.history, keep=keep, writes=writes)
        es.last_writes = set()
        es.step_idx += 1
        if es.step_idx >= len(es.ep.steps):
            es.phase = "done"
            self._n_serving = max(0, self._n_serving - 1)
            es.t_end = self.sim.now
            self.metrics.episode_latencies.append(es.t_end - es.t_start)
            self.metrics.tenant_latency[es.ep.eid] = es.t_end - es.t_start
            # sojourn counts from ARRIVAL: a tenant that queued for a slot
            # waited that long too, and the service-only latency above would
            # hide it (dominant under staggered multi-tenant load)
            self.metrics.tenant_sojourn[es.ep.eid] = (
                es.t_end - getattr(es.ep, "arrival", 0.0))
            self._squash_all(es)
            self._launch_wave()
        else:
            es.phase = "reasoning"
            self._start_model_step(es)

    # shared with the builder so PREP insertion and the warm-up discount
    # can never disagree on what counts as a cold tool
    COLD_TOOLS = COLD_TOOLS

    def _start_auth_tool(self, es: EpisodeState, tool: str, args: Dict[str, Any]):
        spec = self.tools[tool]
        es.inflight = (tool, dict(args))
        dur = spec.det_latency(args)
        if tool in self.COLD_TOOLS and self.sim.now <= es.warm_until:
            dur *= self.rcfg.warm_discount    # preparation-node payoff

        def done(sim: Simulator, job: SimJob):
            fac = StateFacade(es.state)
            result = execute_tool(tool, args, fac)
            if self.sanitizer is not None:
                self.sanitizer.check_footprint(tool, fac, f"auth e{es.ep.eid}")
            es.last_writes = set(fac.writes)
            if spec.level >= SafetyLevel.STAGED_WRITE:
                es.state.bump()
            self._publish_result(fac, tool, args, result, es.ep.eid)
            self._finish_action(es, result, job.started_at or 0.0)

        job = self.sim.new_job(
            f"{tool}[e{es.ep.eid}.{es.step_idx}]", spec.rho.as_array(), dur,
            speculative=False, on_complete=done, meta={"eid": es.ep.eid},
        )
        es.auth_queue.append(job)
        if es.idx >= 0:
            self._auth_idx.add(es.idx)
        self._mark_dirty(es)

    # ==================================================================
    # Phase 1: confirm / promote
    # ==================================================================
    def _pseudo_history(self, es: EpisodeState, hr: HypRun, upto: int) -> List[Event]:
        """The build-time history prefix extended with the branch's executed
        TOOL results along the root-to-node path before node index `upto` —
        the view against which late bindings resolve.  Path-based, not
        list-prefix: sibling subtrees are alternative futures and must not
        leak into this node's event stream.  Truncating to ``base_len``
        keeps mined source offsets aligned for carried-over branches (an
        in-flight event at build time lands inside the prefix, so its real
        result materializes; later events must not shift the tail)."""
        hist = list(es.history[:hr.base_len])
        if len(hist) < hr.base_len and es.inflight is not None:
            # the hypothesis was built across an in-flight action that has
            # not landed yet: restore the build-time placeholder so mined
            # offsets stay aligned — bindings that target it resolve None
            # (lazily, post-landing) instead of hitting the wrong event
            t, a = es.inflight
            hist.append(Event("tool", t, dict(a), None))
        for j in hr.path_to(upto)[:-1]:
            p = hr.node_runs[j]
            if p.node.kind == NodeKind.TOOL and p.status in ("done", "reused", "promoted")                     and p.result is not None:
                hist.append(Event("tool", p.run_tool, dict(p.resolved_args), p.result))
        return hist

    def _resolve_node_args(self, es: EpisodeState, hr: HypRun, i: int) -> Dict[str, Any]:
        nr = hr.node_runs[i]
        hist = self._pseudo_history(es, hr, i)
        args = {b.arg_name: b.resolve(hist) for b in nr.node.bindings}
        return {k: v for k, v in args.items() if v is not None}

    def _cached_node_args(self, es: EpisodeState, hr: HypRun, i: int) -> Dict[str, Any]:
        """Epoch-guarded arg resolution: between dirtying events of an
        episode every `_pseudo_history` input is frozen (history prefix is
        append-only under ``base_len``, inflight and path node results only
        change through handlers that ``_mark_dirty``), so the resolution is
        a pure function of (hr, i, es.epoch).  The admission memo pass
        re-resolves every frontier binding every tick — under c≫1 tenants
        this cache turns that from the top profile entry into a dict hit.
        Callers that PERSIST the dict must copy it (the cache owns this one)."""
        nr = hr.node_runs[i]
        if nr.args_epoch == es.epoch and nr.args_cache is not None:
            return nr.args_cache
        args = self._resolve_node_args(es, hr, i)
        nr.args_epoch = es.epoch
        nr.args_cache = args
        return args

    # Phase-1 match preference: a completed speculative result beats a
    # running one beats an unstarted node.  With a wide beam several
    # branches can contain the same tool; first-in-list order would let an
    # early pending match shadow a finished result in a later branch.
    _MATCH_RANK = {"done": 0, "running": 1, "pending": 2}

    def _match_action(self, es: EpisodeState, tool: str, args: Dict[str, Any]):
        best = None
        for hr in es.hyp_runs:
            if hr.status != "active":
                continue
            for i, nr in enumerate(hr.node_runs):
                if nr.node.kind != NodeKind.TOOL or nr.run_tool != tool:
                    continue
                if nr.transformed:
                    continue                      # transformed results aren't a full match
                if nr.status not in self._MATCH_RANK:
                    continue
                prior_done = all(
                    hr.node_runs[j].status in ("done", "reused")
                    for j in hr.path_to(i)[:-1]
                    if hr.node_runs[j].node.kind == NodeKind.TOOL
                )
                if nr.status == "pending":
                    if not prior_done:
                        continue
                    cand_args = self._cached_node_args(es, hr, i)
                    if any(cand_args.get(k) != v for k, v in args.items() if k in cand_args):
                        continue              # resolved args contradict
                elif nr.resolved_args != args:
                    continue
                rank = self._MATCH_RANK[nr.status]
                if best is None or rank < best[0]:
                    best = (rank, hr, i, nr)
                if rank == 0:
                    return hr, i, nr
        if best is None:
            return None
        return best[1], best[2], best[3]

    def _drain_pending(self) -> bool:
        """``Simulator.run`` drain probe: True while some episode holds a
        pending authoritative action that only the next tick's phase 1 can
        dispatch.  A completion cascade can strand one with an EMPTY event
        queue — an instant store-serve chains into a validate-on-arrival
        spec-step acceptance, whose reasoning completes at the same
        timestamp without ever creating a sim job — so quiescence must be
        judged against this parked work, not just the queue."""
        if self._event:
            return bool(self._acting)
        return any(es.phase == "acting" and es.pending_action is not None
                   for es in self.episodes)

    def _phase1(self):
        """Confirm / promote (Algorithm 1 phase 1): match each episode's
        pending authoritative action against its speculative beam.  A DONE
        node is consumed at zero latency (commit the matched path, reuse the
        result); a RUNNING node is promoted to authoritative — unless a
        store entry can serve instantly, in which case the redundant run is
        preempted; a ready PENDING node reuses its prefix state and is
        served or executed from the boundary; a MISS settles its
        consequences (contradiction squash, mis-speculation accounting),
        then serves from the cross-episode store or re-executes.

        Event scheduler: only episodes whose reasoning step completed since
        the last tick (the ``_acting`` wakeup set) are examined — an episode
        can only have a pending action if ``_on_reasoning_done`` fired for
        it, and that is exactly where the set is fed.  Dense mode scans all
        episodes; both orders are ascending episode index, so the match /
        commit / store-serve sequence is identical."""
        if self._event:
            woken = sorted(self._acting)
            self._acting.clear()
            targets = [self.episodes[i] for i in woken]
        else:
            targets = self.episodes
        for es in targets:
            if es.phase != "acting" or es.pending_action is None:
                continue
            self._mark_dirty(es)
            tool, args = es.pending_action
            m = self._match_action(es, tool, args)
            if m is None:
                # beam miss: settle the miss consequences first (contradicted
                # branches squash, mis-speculation accounting, chain-mode
                # beam wipe) — they depend on the ACTION, not on how it gets
                # satisfied — then try the cross-episode result store: a
                # valid entry (any tenant's warm speculation or past
                # authoritative run) serves the action at zero execution
                # cost, else re-execute authoritatively
                self._note_misses(es, tool, args)
                entry = self._try_serve(es, tool, args)
                es.pending_action = None
                es.phase = "executing"
                if entry is not None:
                    self._finish_action(es, entry.result, self.sim.now)
                else:
                    self._start_auth_tool(es, tool, args)
                continue
            hr, i, nr = m
            hr.used = True
            es.matched_hr = hr
            if nr.status == "done":
                # reuse: commit state along the matched path, zero extra latency
                self._commit_path(es, hr, i)
                self.metrics.reuses += 1
                if i > 0:
                    self.metrics.prefix_reuses += 1
                es.phase = "executing"
                es.pending_action = None
                self._finish_action(es, nr.result, self.sim.now)
            elif nr.status == "running" and nr.job is not None:
                # the prefix state is valid either way (promotion would
                # commit it at completion; replay is idempotent) — commit it
                # FIRST so the serve validates against the post-prefix live
                # state its read footprint may depend on.  The honest
                # counterfactual here is PROMOTION, which would only have
                # cost the job's REMAINING solo work — not the full latency
                self._commit_path(es, hr, i, inclusive=False)
                # lazy settlement: the raw ``remaining`` field of a running
                # job is only current as of its last rate change
                entry = self._try_serve(
                    es, tool, args,
                    saved=max(self.sim.settled_remaining(nr.job), 0.0))
                if entry is not None:
                    # a sibling's entry landed while our copy was mid-flight:
                    # serving is instant, so the run is redundant — preempt
                    # it (partial burn settles as waste, same as a squash)
                    # and consume the node coherently
                    job = nr.job
                    self.sim.preempt(job.jid)
                    self.store.abort(job.meta.get("memo_key"), job.jid)
                    self.metrics.spec_solo_seconds += job.executed_solo_seconds
                    self.metrics.wasted_solo_seconds += job.executed_solo_seconds
                    nr.job = None
                    nr.result = entry.result
                    # consumed by the authoritative path: counts as invested
                    # work in carry-over (the prediction was VALIDATED — the
                    # served flag marks unconsumed sandbox serves only)
                    nr.status = "reused"
                    es.phase = "executing"
                    es.pending_action = None
                    self._finish_action(es, entry.result, self.sim.now)
                    continue
                # promote: job becomes authoritative, non-preemptible (via
                # the simulator API so the incremental auth/spec demand
                # split stays coherent)
                self.sim.set_speculative(nr.job, False)
                nr.status = "promoted"
                self.metrics.promotions += 1
                es.phase = "executing"
                es.pending_action = None
                hr_ref, i_ref = hr, i

                def on_promoted(sim: Simulator, job: SimJob, es=es, hr=hr_ref, i=i_ref):
                    nr2 = hr.node_runs[i]
                    self._snapshot(hr, nr2)
                    self._commit_path(es, hr, i)
                    self._finish_action(es, nr2.result, job.started_at or 0.0)

                nr.job.meta["promoted_for"] = es.ep.eid
                # chain our completion behind the existing callback
                orig = nr.job.on_complete

                def chained(sim, job, orig=orig, hook=on_promoted):
                    if orig:
                        orig(sim, job)
                    hook(sim, job)

                nr.job.on_complete = chained
            else:
                # valid path prefix done, node not started: reuse its state
                # and continue authoritatively from the boundary — served
                # from the store when a valid entry exists (the node was
                # predicted but never launched, e.g. at saturation there is
                # no slack to launch with; the entry consumes it coherently
                # so descendants keep their pseudo-history), else executed
                self._commit_path(es, hr, i, inclusive=False)
                self.metrics.prefix_reuses += 1
                es.phase = "executing"
                es.pending_action = None
                entry = self._try_serve(es, tool, args)
                if entry is not None:
                    nr.result = entry.result
                    # consumed: invested for carry-over purposes (validated
                    # prediction), unlike unconsumed sandbox serves
                    nr.status = "reused"
                    self._finish_action(es, entry.result, self.sim.now)
                else:
                    self._start_auth_tool(es, tool, args)

    def _try_serve(self, es: EpisodeState, tool: str, args: Dict[str, Any],
                   saved: Optional[float] = None) -> Optional[MemoEntry]:
        """Cache-serve path: satisfy an authoritative action from a valid
        result-store entry at zero execution cost.  A finished branch match
        always wins over the store (it commits richer path state); a miss
        settles its consequences (``_note_misses``) before serving; a
        matched running/pending node commits its prefix first, then prefers
        the instant serve over promotion / authoritative re-execution —
        at saturation nothing launches, so predicted nodes sit pending and
        the store is the only mechanism that can still satisfy them.

        Safety gating lives in the policy (``EligibilityPolicy.servable``):
        PREP/READ_ONLY entries serve directly; STAGED_WRITE entries serve by
        replaying the stored write overlay through the commit barrier onto
        the live state — version bump, conflict-prune write-set, and
        footprint invalidation exactly as execution would have produced.
        Validation is by VALUE over the entry's read footprint against THIS
        tenant's live state (entries are produced by any tenant; per-key
        value equality is what makes cross-episode serving exact)."""
        if not self._memo_on:
            return None
        how = self.policy.servable(tool)
        if how is None:
            return None
        entry = self.store.peek(tool, args)
        if entry is None:
            return None
        if not self.store.validate(entry, es.state, eid=es.ep.eid):
            return None
        wrote = self.store.apply_writes(entry, es.state)
        spec = self.tools[tool]
        if wrote or spec.level >= SafetyLevel.STAGED_WRITE:
            # served base mutations advance the version like executed ones
            es.state.bump()
        es.last_writes = set(getattr(es, "last_writes", set())) | wrote
        if wrote:
            self.store.note_writes(entry.writes)
        entry.serves += 1
        if saved is None:
            # counterfactual cost of executing this action authoritatively
            # (callers with a cheaper counterfactual — e.g. promotion of a
            # mid-flight run — pass their own ``saved``)
            saved = spec.det_latency(args)
            if tool in self.COLD_TOOLS and self.sim.now <= es.warm_until:
                saved *= self.rcfg.warm_discount
        self.metrics.memo_serves += 1
        self.metrics.memo_saved_seconds += saved
        self.metrics.tenant_memo_saved[es.ep.eid] = (
            self.metrics.tenant_memo_saved.get(es.ep.eid, 0.0) + saved)
        return entry

    def _publish_result(self, fac: StateFacade, run_tool: str,
                        args: Dict[str, Any], result: Any, eid: int,
                        note: bool = True) -> bool:
        """Store bookkeeping after one tool execution: footprint-intersection
        invalidation FIRST (live executions only — sandbox writes are not
        authoritative and must not invalidate anything), then a level-gated
        publish so the fresh entry carries the post-write store version.
        Returns whether an entry was published (pending-entry owners abort
        on False so subscribed twins can re-arm)."""
        if not self._memo_on:
            return False
        spec = self.tools[run_tool]
        if note:
            self.store.note_writes(fac.write_values)
        if result is None or spec.level >= SafetyLevel.NON_SPECULATIVE:
            return False
        self.store.publish(run_tool, dict(args), result,
                           reads=fac.reads, writes=fac.write_values,
                           level=spec.level,
                           solo_work=spec.det_latency(args), eid=eid)
        return True

    def _note_misses(self, es: EpisodeState, tool: str, args):
        if self.builder.assembly == "chain":
            # pre-tree baseline semantics: any miss wipes the whole beam
            # (rebuilt from scratch in Phase 4)
            for hr in es.hyp_runs:
                if hr.status == "active" and not hr.used and any(
                    nr.status in ("done", "running") and not nr.served
                    for nr in hr.node_runs
                ):
                    self.metrics.mis_speculations += 1
            self._squash_all(es)
            return
        # selective pruning: the context moved somewhere unpredicted, but a
        # branch still speculating toward a top prediction for the post-miss
        # context keeps its work (write-set invalidation happens in
        # _finish_action once the authoritative action lands its writes)
        hist = list(es.history) + [Event("tool", tool, dict(args))]
        self._prune_beam(es, hist, missed=(tool, dict(args)),
                         count_misses=True)

    def _prune_beam(self, es: EpisodeState, hist: List[Event],
                    keep: Optional[HypRun] = None, writes: set = frozenset(),
                    missed: Optional[Tuple[str, Dict[str, Any]]] = None,
                    count_misses: bool = False):
        """Shared keep-or-squash policy after the context advances (either an
        authoritative action finished, or a miss is about to start one).

        A branch is squashed when (a) authoritative ``writes`` intersect its
        base read-set (state safety), (b) it executed the ``missed`` tool
        with different args — it speculated this very action wrongly, so its
        invested work is proven garbage — or (c) it is neither built for the
        current context nor still speculating toward a top prediction
        (carry-over horizon matches what the builder would seed: merged
        backoff up to beam_k under tree assembly)."""
        # context tails at every backoff length the builder/engine can key
        # on — 1..engine.context_len, NOT a hard-coded 2: with a different
        # mining context length the builder stamps longer/shorter
        # context_keys, and comparing them against a 2-suffix misclassified
        # every carried-over branch (wrongly squashed or wrongly kept)
        self._mark_dirty(es)
        cl = max(self.engine.context_len, 1)
        tail = tuple(signature(e) for e in hist[-cl:])
        tails = {tail[-n:] for n in range(1, len(tail) + 1)} or {()}
        if self.builder.assembly == "tree":
            pred_pairs = self.engine.predict(hist, top=self.rcfg.beam_k,
                                             backoff="merge")
        else:
            pred_pairs = self.engine.predict(hist,
                                             top=self.builder.branch_factor)
        preds = {pt.tool for pt, _ in pred_pairs}
        for hr in list(es.hyp_runs):
            if hr.status != "active" or hr is keep:
                continue
            conflicted = bool(writes) and bool(hr.sandbox.base_read_set & writes)
            contradicted = missed is not None and any(
                nr.node.kind == NodeKind.TOOL and nr.run_tool == missed[0]
                and nr.status in ("done", "running")
                and nr.resolved_args != missed[1]
                for nr in hr.node_runs
            )
            if not (conflicted or contradicted):
                if hr.hyp.context_key in tails:
                    continue                  # built for this context
                if self._still_predicted(hr, preds):
                    continue
            if count_misses and not hr.used and any(
                nr.status in ("done", "running") and not nr.served
                for nr in hr.node_runs
            ):
                self.metrics.mis_speculations += 1
            self._squash_one(es, hr)
        es.hyp_runs = [hr for hr in es.hyp_runs if hr.status == "active"]

    def _still_predicted(self, hr: HypRun, preds: set) -> bool:
        """Carry-over test: does this branch still speculate toward a
        predicted tool?  Chains check their single next pending tool (the
        pre-tree baseline rule); trees check every un-finished tool node —
        but only branches with *executed* work (done/running/reused nodes)
        are worth a beam slot: a pristine stale branch would crowd out the
        fresh current-context tree that covers the same predictions."""
        pend = [nr for nr in hr.node_runs if nr.node.kind == NodeKind.TOOL
                and nr.status in ("pending", "running")]
        if not pend:
            return False
        if self.builder.assembly == "chain":
            return pend[0].run_tool in preds
        # store-served nodes are NOT investment: they cost nothing, and
        # counting them let pristine stale branches masquerade as invested,
        # crowding fresh current-context hypotheses out of the beam
        invested = any(nr.status in ("done", "running", "reused", "promoted")
                       and not nr.served for nr in hr.node_runs)
        return invested and any(nr.run_tool in preds for nr in pend)

    def _snapshot(self, hr: HypRun, nr: NodeRun):
        nr.snapshot = {
            "M": dict(hr.sandbox.M._overlay),
            "F": dict(hr.sandbox.F._overlay),
            "E": dict(hr.sandbox.E._overlay),
        }

    def _commit_path(self, es: EpisodeState, hr: HypRun, i: int,
                     inclusive: bool = True) -> None:
        """Promotion commit via *replay*: re-derive the executed results and
        staged effects along the matched root-to-node path against the LIVE
        state at zero latency (``inclusive=False`` stops at node i's parent).

        Path-based, not list-prefix: committing a branch must not replay
        sibling subtrees — those are alternative futures the agent did NOT
        take.  Tools are Level-1 replayable or Level-2 deterministic staged
        writes, so replay is exact; it also revalidates results when the
        base state advanced after the speculative run (sandbox.is_stale) —
        the paper's "replayable prefix" reuse semantics without
        stale-snapshot risk."""
        self._mark_dirty(es)          # node statuses flip to reused below
        fac = StateFacade(es.state)
        path = hr.path_to(i)
        if not inclusive:
            path = path[:-1]
        for j in path:
            nr = hr.node_runs[j]
            if nr.node.kind != NodeKind.TOOL or nr.status not in ("done", "promoted", "reused"):
                continue
            fac.begin_call()              # per-node footprint for the store
            try:
                nr.result = execute_tool(nr.run_tool, nr.resolved_args, fac)
            except KeyError:
                pass
            else:
                if self.sanitizer is not None:
                    self.sanitizer.check_footprint(
                        nr.run_tool, fac, f"commit e{es.ep.eid} h{hr.hyp.hid}")
                # the replay just validated this result against the LIVE
                # state — publish it for every tenant
                self._publish_result(fac, nr.run_tool, nr.resolved_args,
                                     nr.result, es.ep.eid)
            # a committed node is consumed by the authoritative path either
            # way; leaving promotions as "promoted" would strand their
            # descendants (the ready/prior-done tests require done|reused)
            if nr.status in ("done", "promoted"):
                nr.status = "reused"
        es.last_writes = set(getattr(es, "last_writes", set())) | set(fac.writes)
        es.state.bump()
        hr.sandbox.base_version = es.state.version

    def _squash_one(self, es: EpisodeState, hr: HypRun):
        """Squash a branch and settle its speculative-work accounting.

        Waste is NODE-granular: a node whose result was consumed by the
        authoritative path carries status reused/promoted; a node still
        "done" (or running) at squash time was executed and never consumed —
        that is wasted work even when a sibling subtree of the same branch
        was followed (tree hypotheses hedge, so branch-level `used` would
        hide the un-taken subtrees' cost).

        Invariant: every wasted_solo_seconds increment has a matching (>=)
        spec_solo_seconds contribution, so wasted_frac <= 1 by construction:
          * done nodes booked job.work into spec_solo at completion; waste
            books the same job.work here;
          * running nodes book their partial burn into BOTH here — their
            completion callback will never fire (accounting happens before
            any status mutation; the old code flipped running->pending first
            and left mid-flight burn out of spec_solo entirely)."""
        self._mark_dirty(es)
        hr.status = "squashed"
        hr.sandbox.squash()
        for nr in hr.node_runs:
            job = nr.job
            if job is None:
                continue
            if nr.status == "running":
                self.sim.preempt(job.jid)
                # the in-flight computation dies with the job: release the
                # store's pending entry so subscribed twins can re-arm
                self.store.abort(job.meta.get("memo_key"), job.jid)
                self.metrics.spec_solo_seconds += job.executed_solo_seconds
                self.metrics.wasted_solo_seconds += job.executed_solo_seconds
                nr.status = "pending"
            elif nr.status == "done":
                self.metrics.wasted_solo_seconds += job.work
            nr.job = None
        # live speculative reasoning steps die with their branch: forming
        # passengers withdraw from the service, dispatched ones settle their
        # burn as waste (their batch completion sees the terminal outcome
        # and ignores them)
        for ss in list(self._spec_steps.get(es.ep.eid, ())):
            if ss.hr is hr:
                self._settle_spec_step(ss, "squashed")

    def _squash_all(self, es: EpisodeState):
        # the compaction below rewrites hyp_runs even when nothing was
        # active to squash, so mark unconditionally (a spare mark costs one
        # set-add + epoch bump; every cached value recomputes identically)
        self._mark_dirty(es)
        for hr in es.hyp_runs:
            if hr.status == "active":
                self._squash_one(es, hr)
        es.hyp_runs = [hr for hr in es.hyp_runs if hr.status == "active"]

    # ==================================================================
    # Phase 2: protect authoritative jobs
    # ==================================================================
    def _phase2(self):
        """Preempt speculative work (ascending EU) on every resource dim that
        is oversubscribed AND where speculation actually contributes — a dim
        the authoritative set alone oversubscribes cannot be relieved by
        preemption, so it never justifies one.

        Event scheduler: queued authoritative jobs can only exist in
        episodes ``_start_auth_tool`` touched (the ``_auth_idx`` wakeup
        set), so the gather is O(|queued|) instead of O(c); index order
        matches the dense scan, so ``need`` sums in the same order."""
        if self._event:
            auth_pending = [j for i in sorted(self._auth_idx)
                            for j in self.episodes[i].auth_queue]
        else:
            auth_pending = [j for es in self.episodes for j in es.auth_queue]
        if not auth_pending:
            return
        need = np.sum([j.demand for j in auth_pending], axis=0)
        running_auth = self.sim.running_demand(speculative=False)
        cap = self._cap
        spec_jobs = sorted(
            (j for j in self.sim.running.values() if j.speculative),
            key=lambda j: j.meta.get("eu", 0.0),
        )
        while spec_jobs:
            spec_total = self.sim.running_demand(speculative=True)
            overload = (running_auth + need + spec_total) > cap + 1e-9
            relievable = overload & (spec_total > 1e-12)
            if not np.any(relievable):
                break
            victim = next(
                (j for j in spec_jobs if np.any(j.demand[relievable] > 0)), None
            )
            if victim is None:
                break
            spec_jobs.remove(victim)
            self.sim.preempt(victim.jid)
            self.store.abort(victim.meta.get("memo_key"), victim.jid)
            # the preempted job's partial burn is discarded (a relaunch
            # starts a fresh job), so settle it now: no completion callback
            # will ever claim it, and discarded progress is wasted work even
            # if the branch is eventually followed
            self.metrics.spec_solo_seconds += victim.executed_solo_seconds
            self.metrics.wasted_solo_seconds += victim.executed_solo_seconds
            # the victim's node reverts to pending: its episode's cached
            # launch frontier changed
            self._mark_dirty_eid(victim.meta.get("eid"))
            nr = victim.meta.get("node_run")
            if nr is not None:
                nr.status = "pending"
                nr.job = None

    # ==================================================================
    # Phase 3: run authoritative jobs (primary policy: FIFO, always fits)
    # ==================================================================
    def _phase3(self):
        """Run authoritative tool jobs (Algorithm 1 phase 3): drain each
        episode's queue FIFO.  Authoritative work always starts — Phase 2
        has already cleared any speculative oversubscription, and the
        interference model stretches rather than blocks.  Model steps do
        NOT pass through here: they are owned by the model-step service
        (``_start_model_step`` → ``ModelStepService.submit``), which
        dispatches solo or micro-batched authoritative jobs directly."""
        if self._event:
            woken = sorted(self._auth_idx)
            self._auth_idx.clear()
            for i in woken:
                es = self.episodes[i]
                while es.auth_queue:
                    self.sim.start(es.auth_queue.pop(0))
            return
        for es in self.episodes:
            while es.auth_queue:
                job = es.auth_queue.pop(0)
                self.sim.start(job)

    # ==================================================================
    # Phase 4: opportunistic branch scheduling
    # ==================================================================
    def _phase4(self):
        """Shared cross-episode admission: refresh every active episode's
        beam, pool the idle candidates, run ONE fused admission pass against
        the machine-global slack/budget.  Per-episode passes inside the same
        tick each measured slack *before* sibling episodes' admissions
        launched, so two tenants could both be admitted against the same
        slack (cross-tenant double-booking); a single pass accumulates the
        admitted demand across tenants inside the greedy loop.

        Event scheduler: beam refresh + frontier walks run only for DIRTY
        episodes (something they subscribe to fired since their last
        rebuild: a job/timer completion, a beam change, a memo publish
        consumed by one of their nodes, an authoritative action landing);
        clean episodes contribute their cached frontiers/pool entries.
        Slack needs no dirty tracking — it is sampled fresh inside every
        admission pass, which runs whenever the pooled beam is non-empty,
        so slack-threshold crossings are seen the tick they happen."""
        if self.rcfg.mode == "serial":
            self._dirty.clear()
            return
        if self._event:
            self._phase4_event()
            return
        pool: List[Tuple[EpisodeState, HypRun, List[int]]] = []
        n_active = 0
        for es in self.episodes:
            if es.phase not in ("reasoning", "executing"):
                continue
            if not es.history:
                continue
            self._refresh_beam(es)
            active = [hr for hr in es.hyp_runs if hr.status == "active"]
            n_active += len(active)
            # admission (re-)scores IDLE branches only: a branch with
            # running nodes was already admitted — its demand conditions
            # this pass via spec_rho, its meta_admitted persists, and
            # _launch_nodes keeps launching its ready siblings without
            # re-admission (scoring it again would double-charge its
            # in-flight demand against the packed prefix rho)
            for hr in active:
                if any(nr.status == "running" for nr in hr.node_runs):
                    continue
                fr = self._launch_frontier(es, hr)
                if fr:
                    pool.append((es, hr, fr))
        self._admit_shared(pool, n_active)
        if self.rcfg.race_mask or self.sanitizer is not None:
            self._check_write_races(pool)
        self._launch_nodes()

    def _phase4_event(self):
        """Dirty-set variant of the shared admission pass: O(dirty) rebuild
        + O(pool) admission instead of O(c) scans.  Per-episode caches
        (active-branch count, launch frontiers, pool candidacy) are rebuilt
        only for woken episodes; the pooled candidate list is then assembled
        from cache in ascending episode index — the exact order the dense
        scan produces, so packing signatures, fairness weights and greedy
        admission see identical inputs."""
        for i in sorted(self._dirty):
            self._rebuild_cache(i)
        self._dirty.clear()
        pool: List[Tuple[EpisodeState, HypRun, List[int]]] = []
        for i in sorted(self._pool_idx):
            pool.extend(self._contrib[i])
        self._admit_shared(pool, self._n_active_tot)
        if self.rcfg.race_mask or self.sanitizer is not None:
            self._check_write_races(pool)
        self._launch_nodes_event()

    def _rebuild_cache(self, i: int):
        """Recompute one episode's phase-4 contribution: refresh its beam,
        walk every active branch's launch frontier once (the walk also
        settles env_warmup no-ops, same as the dense loop's walk), and
        split the result into launchable caches — ALL branches with a
        frontier (``_frontiers``, what _launch_nodes_event retries each
        tick) and the idle subset (``_contrib``, the admission pool)."""
        es = self.episodes[i]
        frs: List[Tuple[HypRun, List[int]]] = []
        contrib: List[Tuple[EpisodeState, HypRun, List[int]]] = []
        nact = 0
        if es.phase in ("reasoning", "executing") and es.history:
            self._refresh_beam(es)
            for hr in es.hyp_runs:
                if hr.status != "active":
                    continue
                nact += 1
                fr = self._launch_frontier(es, hr)
                if not fr:
                    continue
                frs.append((hr, fr))
                if not any(nr.status == "running" for nr in hr.node_runs):
                    contrib.append((es, hr, fr))
        self._n_active_tot += nact - self._nact.get(i, 0)
        self._nact[i] = nact
        if frs:
            self._frontiers[i] = frs
            self._spec_idx.add(i)
        else:
            self._frontiers.pop(i, None)
            self._spec_idx.discard(i)
        if contrib:
            self._contrib[i] = contrib
            self._pool_idx.add(i)
        else:
            self._contrib.pop(i, None)
            self._pool_idx.discard(i)

    def _remaining_key(self, node_runs_or_nodes):
        out = []
        for x in node_runs_or_nodes:
            nr_status = getattr(x, "status", "pending")
            node = getattr(x, "node", x)
            if node.kind != NodeKind.TOOL:
                continue
            if nr_status in ("reused", "promoted"):
                continue
            out.append(node.tool)
        return tuple(out)

    def _refresh_beam(self, es: EpisodeState):
        active = [hr for hr in es.hyp_runs if hr.status == "active"]
        if len(active) >= self.rcfg.beam_k:
            return      # beam full — don't pay the builder for discards
        # dedup is scoped by build context: a carried-over branch resolves
        # its late bindings against ITS build-time history, so it is NOT a
        # duplicate of a fresh same-tool-sequence hypothesis built for the
        # current context (blocking the fresh one would leave only a branch
        # whose args contradict the agent's actual next action)
        have = {(self._remaining_key(hr.node_runs), hr.hyp.context_key)
                for hr in active}
        if self.rcfg.mode == "paste":
            builder = dataclasses.replace(self.builder, max_depth=1, with_prep=False)
        else:
            builder = self.builder
        hist = list(es.history)
        if es.phase == "executing" and es.inflight is not None:
            # speculate ACROSS the in-flight tool: its signature is known,
            # its result is not (bindings to it resolve lazily, post-landing)
            t, a = es.inflight
            hist = hist + [Event("tool", t, dict(a), None)]
        fresh = builder.build(hist, now=self.sim.now,
                              beam_width=self.rcfg.beam_k)
        for h in fresh:
            key = (self._remaining_key(h.nodes), h.context_key)
            if key in have or len(active) >= self.rcfg.beam_k:
                continue
            nrs = []
            ok = True
            for n in h.nodes:
                if n.kind != NodeKind.TOOL:
                    nrs.append(NodeRun(n, {}, run_tool=n.tool))
                    continue
                form = self.policy.speculative_form(n.tool)
                if form is None:
                    ok = False
                    break
                run_tool, transformed = form
                # resolve against the BUILD context (with the in-flight
                # placeholder): mined offsets are relative to `hist`, and a
                # binding that targets the unlanded event must yield None
                # now rather than a wrong value from the prior event
                args = {b.arg_name: b.resolve(hist) for b in n.bindings}
                args = {k: v for k, v in args.items() if v is not None}
                nrs.append(NodeRun(n, args, run_tool=run_tool, transformed=transformed))
            if not ok:
                continue
            hr = HypRun(h, es.ep.eid, Sandbox(es.state, h.hid), nrs, eu=0.0,
                        parents=h.parent_map(), base_len=len(hist))
            es.hyp_runs.append(hr)
            active.append(hr)
            have.add(key)

    def _packed_for(self, cand: List[HypRun]) -> PackedBeam:
        """Incremental beam packing: re-pack only when the pooled candidate
        beam actually changed, otherwise reuse the cached PackedBeam — beams
        are stable across most ticks.  The ordered hid tuple fully
        determines the packed tables even when candidates from several
        EpisodeStates share one pack: hids are globally unique across
        episodes (one builder numbers every hypothesis) and BranchHypothesis
        is immutable after build (node statuses live on NodeRun, which
        pack_beam never reads; fairness weights are passed alongside, not
        packed)."""
        sig = tuple(hr.hyp.hid for hr in cand)
        if self._packed_sig == sig and self._packed_beam is not None:
            self.metrics.sched_pack_hits += 1
            return self._packed_beam
        self.metrics.sched_pack_misses += 1
        k = bucket_k(len(cand), self.scorer.k_max)
        if len(self._pack_rows) > 8192:
            self._pack_rows.clear()           # bounded (hids grow per build)
        self._packed_beam = pack_beam([hr.hyp for hr in cand], k,
                                      self.scorer.n_max,
                                      row_cache=self._pack_rows)
        self._packed_sig = sig
        return self._packed_beam

    def _fairness_weights(
        self, pool: List[Tuple[EpisodeState, HypRun, List[int]]]
    ) -> Optional[np.ndarray]:
        """Per-candidate EU multipliers for the shared beam: tenants already
        holding in-flight speculative capacity get discounted so one
        episode's deep tree cannot starve another's candidates round after
        round.  Returns None (exactly the unweighted pass) when fairness is
        off or only one tenant has candidates — a uniform weight is a common
        positive factor and cannot change decisions, so skipping it keeps
        single-episode runs bit-identical to the pre-shared-beam path."""
        eids = [es.ep.eid for es, _, _ in pool]
        if self.rcfg.fairness_alpha <= 0 or len(set(eids)) < 2:
            return None
        cap = self._cap
        share: Dict[int, float] = {eid: 0.0 for eid in eids}
        for j in self.sim.running.values():
            if not j.speculative:
                continue
            eid = j.meta.get("eid")
            if eid in share:
                share[eid] += float(np.max(j.demand / cap))
        w = tenant_fairness_weights(share, self.rcfg.fairness_alpha)
        return np.array([w[eid] for eid in eids])

    def _memo_terms(
        self, pool: List[Tuple[EpisodeState, HypRun, List[int]]]
    ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        """Per-candidate reuse term for admission: a per-node ``memo_mask``
        marking launch-frontier TOOL nodes whose (tool, resolved args)
        already has a valid store entry, and the matching memo-excluded
        prefix ρ.  Memoized nodes contribute EU at zero demand — admission
        learns to prefer branches the store will partly serve for free.
        Rides ALONGSIDE the PackedBeam cache (store contents change every
        tick, the pack does not).  Returns (None, None) when the store has
        nothing to offer (keeps the no-memo path bit-identical)."""
        if not self._memo_on or not self.store.entries:
            return None, None
        # pass 1: which frontier nodes are servable?  Validation runs
        # against the BRANCH SANDBOX — exactly what the launch-time serve
        # will check — so a node whose entry conflicts with the branch's own
        # staged overlay is never scored as zero-demand and then executed
        # for real (over-admission past the Eq. 5 limit).
        excls: List[set] = []
        any_memo = False
        tool_pubs = self.store.tool_pubs
        inval = self.store.invalidations
        n_max = self.scorer.n_max
        for es, hr, fr in pool:
            excl = set()
            epoch = es.epoch
            for i in fr:
                nr = hr.node_runs[i]
                node = nr.node
                if node.kind != NodeKind.TOOL or node.idx >= n_max:
                    continue
                # verdict cache: every input to the servability decision
                # below is pinned by (episode epoch, this tool's publish
                # count, and — positives only — the invalidation counter);
                # see the NodeRun field comment for the argument.
                tp = tool_pubs.get(nr.run_tool, 0)
                if (nr.serv_epoch == epoch and nr.serv_pubs == tp
                        and (not nr.serv_ok or nr.serv_inval == inval)):
                    if nr.serv_ok:
                        excl.add(node.idx)
                        any_memo = True
                    continue
                ok = False
                if self.store.has_tool(nr.run_tool):
                    if node.bindings:
                        args = self._cached_node_args(es, hr, i)
                        complete = len(args) >= len(node.bindings)
                    else:
                        args = nr.resolved_args
                        complete = True
                    if complete:
                        # canonical key under the same epoch guard as the
                        # args (the canonicalization repr is pure in
                        # (tool, args))
                        if nr.mkey_epoch == epoch:
                            key = nr.mkey_cache
                        else:
                            key = memo_key(nr.run_tool, args)
                            nr.mkey_epoch, nr.mkey_cache = epoch, key
                        entry = self.store.entries.get(key)
                        if entry is not None and not entry.valid:
                            entry = None              # exactly store.peek
                        # track=False: a scoring-time peek must not hand
                        # the branch a base read-set it never earned (the
                        # launch-time serve re-validates with tracking ON
                        # before anything is consumed)
                        ok = entry is not None and self.store.validate(
                            entry, hr.sandbox, track=False)
                nr.serv_epoch, nr.serv_pubs = epoch, tp
                nr.serv_inval, nr.serv_ok = inval, ok
                if ok:
                    excl.add(node.idx)
                    any_memo = True
            excls.append(excl)
        if not any_memo:
            return None, None                 # no rho recompute on the hot path
        # pass 2: masks + memo-excluded prefix demand.  Unexcluded rows get
        # the STATIC prefix_rho(h), memoized per hid (hypotheses are
        # immutable after build) so steady-state ticks skip the Python DP.
        masks = np.zeros((len(pool), self.scorer.n_max))
        rhos = np.zeros((len(pool), RESOURCE_DIMS))
        for ci, (_es, hr, _fr) in enumerate(pool):
            excl = excls[ci]
            if excl:
                for idx in excl:
                    masks[ci, idx] = 1.0
                ek = (hr.hyp.hid, frozenset(excl))
                rho_e = self._rho_excl_cache.get(ek)
                if rho_e is None:
                    if len(self._rho_excl_cache) > 8192:
                        self._rho_excl_cache.clear()  # bounded
                    rho_e = self._rho_excl_cache[ek] = prefix_rho(
                        hr.hyp, ek[1])
                rhos[ci] = rho_e
            else:
                hid = hr.hyp.hid
                cached = self._rho_cache.get(hid)
                if cached is None:
                    if len(self._rho_cache) > 4096:
                        self._rho_cache.clear()   # bounded (hids grow per build)
                    cached = self._rho_cache[hid] = prefix_rho(hr.hyp)
                rhos[ci] = cached
        return masks, rhos

    def _admit_shared(self, pool: List[Tuple[EpisodeState, HypRun, List[int]]],
                      n_active: int):
        cand = [hr for _, hr, _ in pool]
        if not cand:
            return
        # beam fullness when an admission pass actually runs: every active
        # hypothesis across every active episode occupies a slot, whether
        # launchable this tick or mid-flight (Metrics.beam_occupancy_samples)
        self.metrics.beam_occupancy_samples.append(n_active)
        # ALL in-flight speculative demand is part of the conditioning
        # state: it stretches candidates (ΔI), consumes the budget B, and
        # shrinks the slack exactly like admitted-set demand (candidates
        # are idle, so nothing is charged twice)
        spec_rho = self.sim.running_demand(speculative=True)
        auth_rho = self.sim.running_demand(speculative=False) + spec_rho
        slack = self.sim.slack()
        budget = np.maximum(self.rcfg.budget.as_array() - spec_rho, 0.0)
        if self.rcfg.mode == "parallel":
            for hr in cand:
                hr.eu = hr.hyp.q
                hr.meta_admitted = True
            return
        weights = self._fairness_weights(pool)
        memo_masks, memo_rho = self._memo_terms(pool)
        # Never-fits pre-filter: the greedy (reference AND fused) admits a
        # candidate only when admitted_demand + ρ ≤ _fit_limit(limit), with
        # admitted_demand monotone from zero — so a candidate whose OWN
        # effective prefix ρ already exceeds the fit limit on any dimension
        # can never be picked on ANY iteration, and (EU is per-row, weights
        # are per-candidate) its presence cannot perturb any other row.
        # Dropping such rows before packing is decision- and value-identical
        # while collapsing the kernel's bucketed K in exactly the saturated
        # c≫1 regime where admission dominates the tick.  Weights/memo terms
        # are computed on the ORIGINAL pool above so per-candidate values
        # (incl. the <2-tenants uniform-weight gate) cannot shift.
        fit_lim = _fit_limit(np.minimum(slack, budget))
        if memo_rho is not None:
            eff_rho = memo_rho
        else:
            eff_rho = np.empty((len(cand), RESOURCE_DIMS))
            for ci, hr in enumerate(cand):
                hid = hr.hyp.hid
                rho_c = self._rho_cache.get(hid)
                if rho_c is None:
                    if len(self._rho_cache) > 4096:
                        self._rho_cache.clear()
                    rho_c = self._rho_cache[hid] = prefix_rho(hr.hyp)
                eff_rho[ci] = rho_c
        keep = np.flatnonzero(np.all(eff_rho <= fit_lim[None, :], axis=1))
        if len(keep) < len(cand):
            kept = set(keep.tolist())
            for ci, hr in enumerate(cand):
                if ci not in kept:
                    hr.meta_admitted = False  # exactly the rejected-path mark
            if not len(keep):
                return
            cand = [cand[ci] for ci in keep]
            if weights is not None:
                weights = weights[keep]
            if memo_masks is not None:
                memo_masks = memo_masks[keep]
            if memo_rho is not None:
                memo_rho = memo_rho[keep]
        # model-step-service feedback: a branch's ΔU payoff (unlocking the
        # next reasoning step early) is discounted by the expected wait that
        # step would see in the batch admission window — 0.0 under the
        # max_batch=1 baseline, keeping scoring bit-identical
        model_delay = self.model_service.expected_unlock_delay()
        # slot-marginal model-step cost (spec_model_steps): a hypothesis
        # whose speculative MODEL step would ride an idle slot of the
        # forming under-full batch pays ~0, one that would have to open a
        # new batch pays the full dispatch latency.  None when the path is
        # off OR every cost is zero — a zeros vector is an IEEE-exact no-op
        # in all three kernels, and None keeps the admission signature (and
        # the warm-start hit rate) identical to the flag's absence.
        spec_costs = None
        if self._spec_on and not self.model_service.spec_slot_free:
            base = self.tools["model_step"].base_latency
            sc = np.array([base if hr.hyp.model_idx >= 0 else 0.0
                           for hr in cand])
            if np.any(sc):
                spec_costs = sc
        # load-shedding tax (open-loop overload ladder): arrived-but-
        # unlaunched tenants are about to claim the idle window every
        # candidate's ΔO counts on, so the whole beam is taxed
        # shed_alpha × backlog — the lowest-EU speculation sheds first,
        # and past the knee the beam prices itself out entirely before any
        # authoritative work queues behind speculative demand.  0.0 when
        # the knob is off or nothing is queued: an IEEE-exact no-op in all
        # three kernels, so closed-loop schedules are bit-identical.
        shed_penalty = 0.0
        if self.rcfg.shed_alpha > 0:
            backlog = self._arrival_backlog()
            if backlog:
                shed_penalty = self.rcfg.shed_alpha * backlog
                self.metrics.shed_passes += 1
                self.metrics.shed_peak_backlog = max(
                    self.metrics.shed_peak_backlog, backlog)
        # Verified admission warm-start: the greedy/fused kernels are
        # deterministic functions of exactly the inputs signed below (see
        # admission_signature), so when nothing a decision depends on moved
        # since the last full pass, that pass's admitted set IS this pass's
        # answer — replay it instead of rescoring the pool.  Any deviation
        # (slack, demand, pool membership, weights, memo terms, model
        # delay) misses the signature and falls through to the full pass.
        sig = None
        if self.rcfg.warm_admit:
            sig = admission_signature(
                (hr.hyp.hid for hr in cand), slack, budget, auth_rho,
                weights, memo_masks, memo_rho, model_delay,
                spec_costs=spec_costs, shed_penalty=shed_penalty)
        if (sig is not None and self._warm_admitted is not None
                and sig == self._warm_sig):
            t0 = time.perf_counter()
            if self.rcfg.admission != "reference":
                # same pack-cache touch as the cold fused path (sig equality
                # implies the hid tuple matches, so this records a pack hit
                # and leaves the cache state exactly as the cold pass would)
                self._packed_for(cand)
            admitted_ids = self._warm_admitted
            for hr in cand:
                if hr.hyp.hid in admitted_ids:
                    hr.eu = admitted_ids[hr.hyp.hid]
                    hr.meta_admitted = True
                else:
                    hr.meta_admitted = False
            self.metrics.sched_admit_seconds += time.perf_counter() - t0
            self.metrics.sched_admit_calls += 1
            self.metrics.sched_warm_hits += 1
            return
        if self.rcfg.warm_admit:
            self.metrics.sched_warm_misses += 1
        hyps = [hr.hyp for hr in cand]
        t0 = time.perf_counter()
        if self.rcfg.admission == "reference":
            res = greedy_admit(
                hyps, self.scorer, slack, budget, auth_rho,
                idle_window=self.rcfg.idle_window, weights=weights,
                memo_masks=memo_masks, memo_rho=memo_rho,
                model_delay=model_delay, spec_costs=spec_costs,
                shed_penalty=shed_penalty,
            )
        else:
            if len(self._static_rows) > 8192:
                self._static_rows.clear()     # bounded (hids grow per build)
            res = fused_admit(
                hyps, self.scorer, slack, budget, auth_rho,
                idle_window=self.rcfg.idle_window,
                packed=self._packed_for(cand), weights=weights,
                memo_masks=memo_masks, memo_rho=memo_rho,
                model_delay=model_delay, spec_costs=spec_costs,
                shed_penalty=shed_penalty,
                small_beam_threshold=self.rcfg.host_admit_max,
                static_cache=self._static_rows if self.rcfg.warm_admit
                else None,
            )
        self.metrics.sched_admit_seconds += time.perf_counter() - t0
        self.metrics.sched_admit_calls += 1
        if shed_penalty > 0:
            # candidates priced out while the shed tax was active — the
            # graceful-degradation evidence trail (upper bound: capacity
            # rejections during overload are exactly the ladder working)
            self.metrics.shed_rejections += len(res.rejected)
        admitted_ids = {h.hid: res.eu[h.hid] for h in res.admitted}
        if sig is not None:
            self._warm_sig = sig
            self._warm_admitted = admitted_ids
        for hr in cand:
            if hr.hyp.hid in admitted_ids:
                hr.eu = admitted_ids[hr.hyp.hid]
                hr.meta_admitted = True
            else:
                hr.meta_admitted = False

    def _check_write_races(self, pool: List[Tuple[EpisodeState, HypRun, List[int]]]):
        """R3 (cross-branch write–write races) threaded into the shared
        admission pass: walk the just-admitted candidates in launch order
        (descending EU, then hid — the order ``_launch_nodes`` starts them)
        and track the EXACT (non-glob) write keys their frontier tools
        declare.  Two different tools claiming one key in the same pass
        would stage divergent writes to the same state.  With ``race_mask``
        on, the later (lower-EU) claimant is de-admitted this pass — it
        re-enters the pool next tick once the winner's write has landed;
        under ``sanitize`` alone the conflict is reported but not masked.
        Same-tool claims are benign (identical deterministic writes; true
        duplicates dedup through the result store) and glob overlaps
        usually hit distinct keys — neither is flagged, which is what keeps
        the default config race-silent."""
        admitted = [(es, hr, fr) for es, hr, fr in pool
                    if getattr(hr, "meta_admitted", False)]
        if len(admitted) < 2:
            return
        admitted.sort(key=lambda t: (-t[1].eu, t[1].hyp.hid))
        claimed: Dict[str, str] = {}      # exact write key -> claiming tool
        for es, hr, fr in admitted:
            keys: List[Tuple[str, str]] = []
            conflict = None
            for i in fr:
                nr = hr.node_runs[i]
                if nr.node.kind != NodeKind.TOOL:
                    continue
                spec = self.tools.get(nr.run_tool)
                if spec is None:
                    continue
                for pat in spec.writes:
                    if any(c in pat for c in "*?["):
                        continue          # glob: keys usually distinct
                    keys.append((pat, nr.run_tool))
                    prev = claimed.get(pat)
                    if conflict is None and prev is not None and prev != nr.run_tool:
                        conflict = (pat, prev, nr.run_tool)
            if conflict is not None:
                key, winner, loser = conflict
                if self.sanitizer is not None:
                    self.sanitizer._add(
                        "R3-write-race", "warn",
                        f"admit e{es.ep.eid} h{hr.hyp.hid}",
                        f"co-admitted {loser!r} writes {key!r} already "
                        f"claimed by {winner!r} this pass")
                if self.rcfg.race_mask:
                    hr.meta_admitted = False
                    self.metrics.race_masked += 1
                    continue              # masked branch claims nothing
            for key, tool in keys:
                claimed.setdefault(key, tool)

    def _launch_frontier(self, es: EpisodeState, hr: HypRun,
                         settle_warm: bool = True) -> List[int]:
        """Indices of every launchable (TOOL/PREP) node on the branch's
        ready frontier: pending nodes whose executable ancestors along the
        root path are all done/reused.  A running or blocked node gates only
        its OWN subtree — sibling branches keep their frontier (the serial
        node_runs-order walk this replaces assumed a linear chain).

        Per path: BARRIERs pass when staged execution is allowed; MODEL
        nodes always bound (reasoning is not tool-speculable here);
        NON_SPECULATIVE bounds; beyond a model-originated-args TOOL node
        only Level-0 PREP nodes may run (§7 Level 0: warm-up needs no
        arguments).

        ``settle_warm=False`` is the SIDE-EFFECT-FREE variant for the
        runtime sanitizer: already-warm pending preps are treated as settled
        without mutating their status, so a verification walk returns what
        the scheduler's walk would have cached without changing anything."""
        allow_staged = self.policy.max_level >= SafetyLevel.STAGED_WRITE
        out: List[int] = []
        open_: Dict[int, bool] = {}      # subtree not bounded above
        ready: Dict[int, bool] = {}      # executable ancestors all finished
        preponly: Dict[int, bool] = {}   # past a missing-args boundary
        for i, nr in enumerate(hr.node_runs):
            kind = nr.node.kind
            ps = hr.parents.get(i, ())
            if ps:
                op = all(open_.get(p, False) for p in ps)
                rd = all(ready.get(p, False) for p in ps)
                po = any(preponly.get(p, False) for p in ps)
            else:
                op, rd, po = True, True, False
            open_[i], ready[i], preponly[i] = False, False, po
            if not op:
                continue
            if kind == NodeKind.MODEL:
                if (self._spec_on and i == hr.hyp.model_idx
                        and hr.hyp.spine_leaf >= 0):
                    # speculative reasoning step: surfaced while "pending"
                    # — the submit path decides which boundary (deepest
                    # materialized spine prefix) is draftable, so neither
                    # full-spine readiness nor a missing-args bound blocks
                    # drafting the boundaries BEFORE the bound.  The
                    # post-MODEL segment opens only when the whole spine is
                    # materialized AND the join's own predicted outcome
                    # landed ("done") or the authoritative step validated
                    # it ("reused").
                    rd_spine = ready.get(hr.hyp.spine_leaf, False)
                    if nr.status == "pending":
                        out.append(i)
                    open_[i] = True
                    ready[i] = rd_spine and nr.status in ("done", "reused")
                continue
            if nr.node.level == SafetyLevel.NON_SPECULATIVE:
                continue
            if kind == NodeKind.BARRIER:
                open_[i], ready[i] = allow_staged, rd
                continue
            if kind == NodeKind.TOOL and nr.node.missing_args:
                open_[i], ready[i], preponly[i] = True, rd, True
                continue
            status = nr.status
            if kind == NodeKind.PREP and status == "pending"                     and nr.run_tool == "env_warmup" and self.sim.now <= es.warm_until:
                status = "reused"             # already warm — prep is a no-op
                if settle_warm:
                    nr.status = status
            if status == "pending" and rd and (kind == NodeKind.PREP or not po):
                out.append(i)
            open_[i] = True
            ready[i] = rd and status in ("done", "reused")
        return out

    def _launch_nodes(self):
        """Start admitted frontier nodes in descending admission-EU order
        (Algorithm 1: highest-value branches claim the slack first — with a
        wide beam, list order would let low-value branches starve the
        valuable ones at the capacity boundary).  The capacity fit check
        lives in ``_start_spec_node`` AFTER the store serve attempt: serving
        a memoized node costs zero slack, so a saturated machine must not
        block it — that is exactly the regime the store exists for."""
        ready: List[Tuple[float, int, int, EpisodeState, HypRun]] = []
        for es in self.episodes:
            for hr in es.hyp_runs:
                if hr.status != "active" or not getattr(hr, "meta_admitted", False):
                    continue
                for i in self._launch_frontier(es, hr):
                    ready.append((-hr.eu, hr.hyp.hid, i, es, hr))
        ready.sort(key=lambda t: t[:3])
        for _, _, i, es, hr in ready:
            self._start_spec_node(es, hr, i)

    def _launch_nodes_event(self):
        """Cached-frontier variant of ``_launch_nodes``: the frontier walk
        already ran in ``_rebuild_cache`` (this tick for dirty episodes, a
        previous tick for clean ones — every node-status change dirties its
        episode, so the cache is current), and launching is a retry loop
        over it — nodes that failed the fit/args check keep retrying every
        tick exactly as the dense re-walk would."""
        ready: List[Tuple[float, int, int, EpisodeState, HypRun]] = []
        for idx in sorted(self._spec_idx):
            es = self.episodes[idx]
            for hr, fr in self._frontiers[idx]:
                if hr.status != "active" or not getattr(hr, "meta_admitted", False):
                    continue
                for i in fr:
                    ready.append((-hr.eu, hr.hyp.hid, i, es, hr))
        ready.sort(key=lambda t: t[:3])
        for _, _, i, es, hr in ready:
            self._start_spec_node(es, hr, i)

    def _serve_spec(self, es: EpisodeState, hr: HypRun, i: int,
                    entry: MemoEntry) -> None:
        """Serve a store entry INTO a sandbox: the node completes instantly
        (zero slack burned), its staged writes land in the branch overlay,
        and validation reads have already been pulled through the CowView —
        so the entry's dependencies sit in the branch's base read-set and
        conflict pruning covers served results like executed ones."""
        self._mark_dirty(es)
        nr = hr.node_runs[i]
        self.store.apply_writes(entry, hr.sandbox)
        nr.result = entry.result
        nr.status = "done"
        nr.served = True
        entry.serves += 1
        hr.sandbox.record(Event("tool", nr.run_tool, dict(nr.resolved_args),
                                nr.result, self.sim.now, self.sim.now,
                                es.ep.eid))
        self._snapshot(hr, nr)
        self.metrics.memo_hits += 1
        # no spec_solo_seconds: nothing executed, so a later squash books
        # zero waste for this node (job stays None)

    def _start_spec_node(self, es: EpisodeState, hr: HypRun, i: int) -> bool:
        nr = hr.node_runs[i]
        if nr.node.kind == NodeKind.MODEL:
            # speculative reasoning step: rides an idle slot of the forming
            # batch instead of a simulator job of its own
            return self._submit_spec_step(es, hr, i)
        if nr.waiting:
            return False                  # subscribed to an in-flight twin
        if nr.node.kind == NodeKind.TOOL and nr.node.bindings:
            # copy: resolved_args outlives the epoch (sandbox events, memo
            # keys), the cached dict does not
            nr.resolved_args = dict(self._cached_node_args(es, hr, i))
            if len(nr.resolved_args) < len(nr.node.bindings):
                return False                  # inputs not materialized yet
        key = None
        if self._memo_on and nr.node.kind == NodeKind.TOOL:
            # epoch-cached canonical key (shared with _memo_terms): the
            # launch retry loop re-peeks every candidate every tick, and
            # re-canonicalizing unchanged args dominated those retries
            if nr.mkey_epoch == es.epoch:
                key = nr.mkey_cache
            else:
                key = memo_key(nr.run_tool, nr.resolved_args)
                nr.mkey_epoch, nr.mkey_cache = es.epoch, key
            entry = self.store.entries.get(key)
            if entry is not None and not entry.valid:
                entry = None                  # exactly store.peek
            if entry is not None and self.store.validate(entry, hr.sandbox):
                self._serve_spec(es, hr, i, entry)
                return True
            if self.store.is_pending(key):
                # an identical computation is in flight (another branch or
                # tenant): subscribe to its result instead of burning the
                # slack twice
                def on_pub(pub_entry, es=es, hr=hr, i=i):
                    self._mark_dirty(es)   # node unblocked (or re-armed)
                    nr2 = hr.node_runs[i]
                    nr2.waiting = False
                    if pub_entry is None:         # owner preempted: re-arm
                        return
                    if hr.status != "active" or nr2.status != "pending":
                        return
                    if not self.store.validate(pub_entry, hr.sandbox):
                        return
                    self._serve_spec(es, hr, i, pub_entry)

                self.store.subscribe(key, on_pub)
                nr.waiting = True
                self.metrics.memo_dedups += 1
                return False
        spec = self.tools[nr.run_tool]
        demand = nr.node.rho.as_array()
        total = self.sim.running_demand() + demand
        if np.any((total > self._cap + 1e-9) & (demand > 1e-12)):
            return False                      # no slack on a dim we need
        dur = spec.det_latency(nr.resolved_args)
        if nr.run_tool in self.COLD_TOOLS and self.sim.now <= es.warm_until:
            dur *= self.rcfg.warm_discount

        def done(sim: Simulator, job: SimJob, es=es, hr=hr, i=i):
            self._mark_dirty(es)      # node finished: frontier advances
            nr2 = hr.node_runs[i]
            mk = job.meta.get("memo_key")
            if nr2.run_tool == "env_warmup":
                # warmth is tenant-local: this episode's environment only
                es.warm_until = max(es.warm_until, sim.now + self.rcfg.warm_ttl)
            if hr.status != "active" and nr2.status != "promoted":
                self.store.abort(mk, job.jid)
                return
            fac = StateFacade(hr.sandbox)
            try:
                nr2.result = execute_tool(nr2.run_tool, nr2.resolved_args, fac)
            except KeyError:
                nr2.result = None
            else:
                if self.sanitizer is not None:
                    self.sanitizer.check_footprint(
                        nr2.run_tool, fac, f"spec e{es.ep.eid} h{hr.hyp.hid}.{i}")
            hr.sandbox.record(Event("tool", nr2.run_tool, nr2.resolved_args,
                                    nr2.result, job.started_at or 0.0, sim.now,
                                    es.ep.eid))
            if nr2.status != "promoted":
                nr2.status = "done"
            self._snapshot(hr, nr2)
            self.metrics.spec_solo_seconds += job.work
            if mk is not None:
                # publish the sandbox-computed result (per-call footprint;
                # sandbox writes are NOT authoritative, so no note_writes) —
                # resolves the pending entry and feeds every subscriber
                if not self._publish_result(fac, nr2.run_tool,
                                            nr2.resolved_args, nr2.result,
                                            es.ep.eid, note=False):
                    self.store.abort(mk, job.jid)

        job = self.sim.new_job(
            f"spec:{nr.run_tool}[h{hr.hyp.hid}.{i}]",
            spec.rho.as_array(), dur, speculative=True, on_complete=done,
            meta={"eu": hr.eu, "node_run": nr, "hyp": hr.hyp.hid,
                  "eid": es.ep.eid},
        )
        if key is not None:
            self.store.begin(key, job.jid)
            job.meta["memo_key"] = key
        nr.job = job
        nr.status = "running"
        self._mark_dirty(es)          # idle branch became in-flight
        self.sim.start(job)
        return True

    # ==================================================================
    def _tick(self, sim: Simulator):
        t0 = time.perf_counter()
        self._phase1()
        self._phase2()
        self._phase3()
        self._phase4()
        self._qos_tick(sim)
        if self.sanitizer is not None:
            # after the phases: the dirty set now holds exactly the episodes
            # whose caches are legitimately pending a rebuild, so every
            # OTHER episode's cached frontier must match a fresh walk
            self.sanitizer.on_tick()
        self.metrics.sched_ticks += 1
        self.metrics.sched_tick_seconds += time.perf_counter() - t0

    def _qos_tick(self, sim: Simulator):
        # QoS accounting: authoritative slowdown attributable to speculation,
        # attributed per tenant (arrival timers are zero-demand bookkeeping
        # jobs — they would dilute the samples with 1.0 ratios)
        dem = [j for j in sim.running.values() if not j.meta.get("timer")]
        if dem and any(j.speculative for j in dem):
            from repro_torch.core.interference import slowdowns as _sl
            auth = [j for j in dem if not j.speculative]
            if auth:
                mat_all = np.stack([j.demand for j in dem])
                slows_all = _sl(mat_all, self._cap)
                mat_auth = np.stack([j.demand for j in auth])
                slows_auth = _sl(mat_auth, self._cap)
                auth_all = [(j, s) for j, s in zip(dem, slows_all, strict=True)
                            if not j.speculative]
                for (j, s_with), s_without in zip(auth_all, slows_auth, strict=True):
                    ratio = float(s_with / max(s_without, 1e-9))
                    self.metrics.auth_slowdown_samples.append(ratio)
                    # a batched model job serves SEVERAL tenants at once
                    # (meta["eids"]): speculation stretching the batch taxes
                    # every member, so the per-tenant slowdown sample and
                    # any QoS violation land on each of them — per-batch
                    # attribution, not first-member-only
                    eids = j.meta.get("eids")
                    if eids is None:
                        eid = j.meta.get("eid")
                        eids = [eid] if eid is not None else []
                    for eid in eids:
                        self.metrics.tenant_slowdown_samples.setdefault(
                            eid, []).append(ratio)
                    if ratio > 1.05:
                        self.metrics.qos_violations += 1
                        for eid in eids:
                            self.metrics.tenant_qos_violations[eid] = (
                                self.metrics.tenant_qos_violations.get(eid, 0)
                                + 1)


def run_mode(
    episodes: List[Episode],
    engine: PatternEngine,
    mode: str,
    machine: Optional[Machine] = None,
    policy: EligibilityPolicy = FULL_POLICY,
    seed: int = 0,
    episode_source: Optional[Iterator[Episode]] = None,
    **kw,
) -> Metrics:
    """``episode_source`` switches the run to OPEN-LOOP serving: episodes
    come from the lazy iterator (nondecreasing arrivals, e.g.
    ``workload.open_loop_source``) as they arrive, and ``episodes`` is then
    usually the empty seed roster.  None keeps the frozen closed-loop
    roster semantics bit-identical."""
    rcfg = RuntimeConfig(mode=mode, seed=seed, **kw)
    if machine is None:
        machine = Machine()
    rt = BPasteRuntime(episodes, engine, machine, policy, rcfg,
                       episode_source=episode_source)
    return rt.run()
