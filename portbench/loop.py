"""The benchmark's multi-agent loop over the port's serving API.

A frozen generalisation of ``repro_torch.launch.serve.serve_agent_loop``
to N closed-loop agent sessions with a tool clock on the host. The port
has no multi-session front end, so the loop lives here and drives only the
serving API: ``ServingEngine.add_request`` / ``step`` (a finished turn's
slot is released as ``serve_agent_loop`` releases it),
``SlotSpeculator.admit`` / ``ensure_authoritative_room`` /
``match_and_promote``, ``ServingEngine.preempt`` on the speculative slots
an agent owns, and ``HypothesisBuilder.build``.

One iteration:
1. every tool that has returned (or episode that starts) begins a turn:
   ``match_and_promote`` with the observation; on a miss the agent's
   speculative slots are preempted, ``ensure_authoritative_room(1)``, and
   ``add_request(history + observation)``;
2. every agent that has just issued a tool call builds hypotheses and
   ``admit``\\ s them, where the mix has a speculative budget;
3. one ``engine.step()``, if any slot is active;
4. every turn that has decoded its drawn number of tokens (or met the
   engine's end of sequence) frees its slot and issues its next tool call,
   due after the tool's latency; an episode's last turn starts the next
   episode at once. With no slot active the loop sleeps until the next
   tool is due.

The counters (prompt tokens, admissions, the host clock around ``step``
and ``add_request``) run over the window before its traced part, the last
``trace_seconds``, where the profiler adds its own time to each launch;
the steps inside the traced part are timed apart, which gives that cost.

A turn runs from its tool's return (or its episode's start) to its last
reasoning token. The window opens once every agent has finished a turn;
its sample is every turn that starts inside it, and the loop serves on
after the window until those have finished, or until ``drain_cap_s`` has
passed, which leaves the rest failed.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from portbench.traffic import Traffic, observation


@dataclass
class Turn:
    agent: int
    ep: int
    start: float
    prompt: List[int]
    n_reason: int
    slot: int = -1
    promoted: bool = False
    end: Optional[float] = None
    served: List[int] = field(default_factory=list)


@dataclass
class _Agent:
    idx: int
    ep: int = 0
    call: int = 0                 # the next tool call of the episode
    units: List[List[int]] = field(default_factory=list)   # reasoning + obs of past turns
    reason: List[int] = field(default_factory=list)         # the last turn's reasoning
    obs: List[int] = field(default_factory=list)            # the pending observation
    events: list = field(default_factory=list)              # the episode's Event history
    turn: Optional[Turn] = None
    due: float = 0.0              # when the pending tool returns (or the episode starts)
    waiting: bool = True          # a tool or an episode start is pending
    just_issued: bool = False
    turns_done: int = 0


@dataclass
class Counters:
    prefill_tokens_auth: int = 0
    prefill_tokens_spec: int = 0
    spec_admitted: int = 0
    spec_promoted: int = 0
    spec_preempted: int = 0
    steps: int = 0
    step_s: float = 0.0
    traced_steps: int = 0
    traced_step_s: float = 0.0
    prefills: int = 0
    prefill_s: float = 0.0


@dataclass
class LoopResult:
    turns: List[Turn]
    t_open: float
    t_close: float
    seconds: float
    counters: Counters              # over the window, before its traced part
    shapes: Dict[str, list]         # per-call shapes while traced


class AgentLoop:
    """N agents served by one engine. ``span(name)`` is a context manager
    around each call into a layer (a profiler annotation in a traced run);
    ``trace_start()`` / ``trace_stop()`` bracket the traced part of the
    window."""

    def __init__(self, engine, speculator, builder, traffic: Traffic, cfg, *,
                 beam_width: int, span: Callable = None, event_cls=None):
        self.engine = engine
        self.spec = speculator
        self.builder = builder
        self.traffic = traffic
        self.cfg = cfg
        self.beam_width = beam_width
        self.span = span or (lambda name: contextlib.nullcontext())
        self.event_cls = event_cls
        self.agents = [_Agent(i) for i in range(len(traffic.scripts))]
        self.turns: List[Turn] = []
        self.rid = 0
        self.counting = False
        self.counters = Counters()
        self.tracing = False
        self.shapes: Dict[str, list] = {"prefill": [], "step": []}
        self.owner: Dict[int, int] = {}        # speculative slot -> the agent that admitted it
        self.spec_len: Dict[int, int] = {}     # speculative slot -> its prompt's length

    # -- histories ------------------------------------------------------
    def _episode(self, a: _Agent):
        return self.traffic.scripts[a.idx][a.ep % len(self.traffic.scripts[a.idx])]

    def _prompt(self, a: _Agent, extra: List[int], n_reason: int) -> List[int]:
        """System prompt + task + the past turns + ``extra``, dropping the
        oldest turns after the task until ``n_reason`` more tokens fit."""
        tasks = self.traffic.tasks[a.idx]
        head = self.traffic.system + tasks[a.ep % len(tasks)]
        limit = self.engine.max_len - 2 - n_reason
        while a.units and len(head) + sum(map(len, a.units)) + len(extra) > limit:
            a.units.pop(0)
        return head + [t for u in a.units for t in u] + extra

    def _spec_slots(self, a: _Agent) -> List[int]:
        return sorted(s for s, o in self.owner.items() if o == a.idx and s in self.spec.active)

    # -- the four parts of an iteration ----------------------------------
    def _begin_turns(self, now: float) -> None:
        ready = sorted((a for a in self.agents if a.waiting and a.due <= now),
                       key=lambda a: (a.due, a.idx))
        for a in ready:
            ep = self._episode(a)
            n_reason = ep.reasoning[a.call]
            prompt = self._prompt(a, a.reason + a.obs, n_reason)
            turn = Turn(a.idx, a.ep, a.due, prompt, n_reason)
            slot = None
            if self.spec is not None and a.obs:
                with self.span("spec.promote"):
                    slot = self.spec.match_and_promote(a.obs, request_id=self._next_rid())
                if slot is not None and self.owner.get(slot) == a.idx:
                    turn.prompt = self.engine.slots[slot].tokens[:self.spec_len[slot]]
                    turn.promoted = True
                    if self.counting and not self.tracing:
                        self.counters.spec_promoted += 1
                elif slot is not None:       # another agent's prediction: never this turn's
                    self._release(slot)
                    slot = None
                if slot is None:
                    self._drop_spec(a)
                    with self.span("spec.promote"):
                        self.spec.ensure_authoritative_room(1)
            if slot is None:
                t0 = time.perf_counter()
                with self.span("engine.add_request"):
                    slot = self.engine.add_request(prompt, request_id=self._next_rid())
                if slot is None:
                    raise RuntimeError("no free slot for an authoritative turn")
                if self.counting and not self.tracing:
                    self.counters.prefills += 1
                    self.counters.prefill_s += time.perf_counter() - t0
                    self.counters.prefill_tokens_auth += len(prompt)
                if self.tracing:
                    self.shapes["prefill"].append((len(prompt), False))
            if a.reason or a.obs:
                a.units.append(a.reason + a.obs)
            turn.slot = slot
            a.turn, a.waiting, a.reason, a.obs = turn, False, [], []
            self.turns.append(turn)

    def _admit(self) -> None:
        for a in self.agents:
            if not a.just_issued:
                continue
            a.just_issued = False
            if self.spec is None or not a.events:
                continue
            with self.span("hyp.build"):
                hyps = self.builder.build(a.events, beam_width=self.beam_width)
            before = set(self.spec.active)
            history = self._prompt(a, a.reason, 0)
            with self.span("spec.admit"):
                self.spec.admit([(h, h.q) for h in hyps], history_prompt=history)
            new = sorted(set(self.spec.active) - before)
            for s in new:
                self.owner[s] = a.idx
                self.spec_len[s] = len(self.engine.slots[s].tokens)
            if self.counting and not self.tracing:
                self.counters.spec_admitted += len(new)
                self.counters.prefill_tokens_spec += sum(self.spec_len[s] for s in new)
            if self.tracing:
                self.shapes["prefill"].extend((self.spec_len[s], True) for s in new)

    def _step(self) -> bool:
        eng = self.engine
        if not any(s.active and not s.done for s in eng.slots):
            return False
        if self.tracing:
            auth = [s.active and not s.done and not s.speculative for s in eng.slots]
            self.shapes["step"].append(([len(s.tokens) for s in eng.slots], auth))
        t0 = time.perf_counter()
        with self.span("engine.step"):
            eng.step()
        if self.counting and self.tracing:
            self.counters.traced_steps += 1
            self.counters.traced_step_s += time.perf_counter() - t0
        elif self.counting:
            self.counters.steps += 1
            self.counters.step_s += time.perf_counter() - t0
        # a speculative slot that met its end of sequence is no longer live
        if self.spec is not None:
            for slot in [s for s in self.spec.active if not eng.slots[s].active]:
                eng.preempt(slot)
                del self.spec.active[slot]
        return True

    def _finish_turns(self, now: float) -> None:
        eng = self.engine
        for a in self.agents:
            t = a.turn
            if t is None:
                continue
            s = eng.slots[t.slot]
            decoded = s.tokens[len(t.prompt):]
            if not s.done and len(decoded) + 1 < t.n_reason:
                continue
            t.served = (decoded + [int(eng.pending_tokens[t.slot])])[:t.n_reason]
            t.end = now
            self._release(t.slot)
            a.turn = None
            a.turns_done += 1
            ep = self._episode(a)
            if a.call < len(ep.calls):
                call = ep.calls[a.call]
                a.reason = t.served
                a.obs = observation(self.traffic, call, self.cfg.vocab_size)
                a.due = now + call.latency
                a.events.append(self.event_cls("tool", call.tool, dict(call.args),
                                               call.result))
                a.call += 1
                a.just_issued = True
            else:                       # the episode is over: the next one starts now
                a.ep += 1
                a.call = 0
                a.units, a.events, a.reason, a.obs = [], [], [], []
                a.due = now
            a.waiting = True

    # -- helpers ----------------------------------------------------------
    def _next_rid(self) -> int:
        self.rid += 1
        return self.rid

    def _release(self, slot: int) -> None:
        s = self.engine.slots[slot]
        s.active = False
        s.request_id = None

    def _drop_spec(self, a: _Agent) -> None:
        for slot in self._spec_slots(a):
            self.engine.preempt(slot)
            del self.spec.active[slot]
            if self.counting and not self.tracing:
                self.counters.spec_preempted += 1

    # -- the run ------------------------------------------------------------
    def run(self, seconds: float, drain_cap_s: float, *, trace_seconds: float = 0.0,
            trace_start=None, trace_stop=None) -> LoopResult:
        """Serve until the window of ``seconds`` has closed and its turns
        have finished. The last ``trace_seconds`` of the window are traced:
        the profiler's hooks stay on the host's launches once it has
        stopped, so the window's counters run before it starts."""
        t0 = time.perf_counter()
        for a in self.agents:
            a.due = t0
        t_open = t_close = trace_at = None
        trace_t0 = 0.0
        trace_on = False
        while True:
            self._begin_turns(time.perf_counter())
            self._admit()
            stepped = self._step()
            now = time.perf_counter()
            self._finish_turns(now)
            if t_open is None and all(a.turns_done for a in self.agents):
                t_open, t_close = now, now + seconds
                self.counting = True
                if trace_seconds > 0 and trace_start is not None:
                    trace_at = t_close - trace_seconds
            if trace_at is not None and now >= trace_at:
                trace_at = None
                trace_start()
                self.tracing, trace_on = True, True
                trace_t0 = time.perf_counter()
            if trace_on and now >= trace_t0 + trace_seconds:
                trace_stop()
                self.tracing, trace_on = False, False
            if t_open is not None and now >= t_close:
                self.counting = False
                sample = [t for t in self.turns if t_open <= t.start < t_close]
                if all(t.end is not None for t in sample) or now >= t_close + drain_cap_s:
                    break
            if not stepped:
                wake = min((a.due for a in self.agents if a.waiting), default=now)
                for mark in (trace_at, t_close):
                    if mark is not None and now < mark:
                        wake = min(wake, mark)
                if wake > now:
                    with self.span("loop.tool_wait"):
                        time.sleep(wake - now)
        if trace_on:
            trace_stop()
        return LoopResult(self.turns, t_open, t_close, seconds, self.counters, self.shapes)
