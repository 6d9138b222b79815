"""The harness on the CPU at a tiny size: whole runs of the four tiny
cells, the loop's invariants (turn counts, slot ownership, preemption of an
agent's speculative slots at its tool's return), the traced part at the
window's end, a run whose served tokens are altered where the engine
produces them, which must come out not correct, and the fp8 control,
which the same predicate must judge not correct."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.bench import find_cell, model_config
from portbench.loop import AgentLoop
from portbench.traffic import make_traffic
from portbench.weights import make_params

from conftest import TINY_CONFIGS

CELLS = [f"{c}.{m}" for c in TINY_CONFIGS for m in ("tiny-spec", "tiny-serial")]


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _quiet(*a, **k):
    pass


@pytest.mark.parametrize("cell", CELLS)
def test_run_cell_tiny(tiny_root, cell):
    c = find_cell(cell, tiny_root)
    out = harness.run_cell(c, 2**33 + 5, 1.0, False, "cpu", time.perf_counter(), tiny_root,
                           log=_quiet)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"ttna_p50_ms", "ttna_p90_ms", "turns_per_s", "setup_s"}
    assert out["metrics"]["ttna_p50_ms"]["value"] <= out["metrics"]["ttna_p90_ms"]["value"]
    assert list(out)[-1] == "checks"
    counts = out["counts"]
    if cell.endswith("tiny-spec"):
        assert counts["spec_admitted"] > 0 and counts["spec_promoted"] == 0
        assert counts["prefill_tokens_spec"] > 0
    else:
        assert counts["spec_admitted"] == 0 and counts["prefill_tokens_spec"] == 0


class _Checked(AgentLoop):
    """The loop, with its invariants asserted after every iteration."""
    iterations = 0

    def _finish_turns(self, now):
        super()._finish_turns(now)
        self.iterations += 1
        live = [s for s in self.engine.slots if s.active]
        turn_slots = [a.turn.slot for a in self.agents if a.turn is not None]
        assert len(set(turn_slots)) == len(turn_slots)
        if self.spec is None:
            assert not any(s.speculative for s in live)
            return
        assert len(self.spec.active) <= self.spec.budget_slots
        for slot in self.spec.active:
            owner = self.agents[self.owner[slot]]
            assert owner.waiting and owner.obs, "a live speculative slot's agent waits on a tool"
            assert self.engine.slots[slot].speculative and slot not in turn_slots
        for a in self.agents:
            if a.turn is not None:
                assert self._spec_slots(a) == [], "an agent in a turn owns no speculative slot"


@pytest.mark.parametrize("name", list(TINY_CONFIGS))
def test_loop_invariants_and_turn_counts(tiny_root, name):
    from repro_torch.core.events import Event
    from repro_torch.core.hypothesis import HypothesisBuilder
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.spec_serving import SlotSpeculator

    c = find_cell(f"{name}.tiny-spec", tiny_root)
    cfg = model_config(c.config)
    params = make_params(cfg, 3, "cpu", tie_embeddings=c.config["tie_embeddings"])
    eng = ServingEngine(cfg, params, max_batch=c.mix["max_batch"], max_len=c.mix["max_len"],
                        eos_id=c.config["eos_token_id"], device="cpu")
    spec = SlotSpeculator(eng, budget_slots=c.mix["spec_budget_slots"])
    traffic = make_traffic(c.mix, 3, cfg.vocab_size, c.config["eos_token_id"])
    preempted = []
    real_preempt = eng.preempt

    def preempt(slot):
        # a live slot goes at its owner's tool return; a finished one (its
        # end of sequence met) is dropped after the step
        if eng.slots[slot].active:
            owner = loop.agents[loop.owner[slot]]
            preempted.append((owner.idx, owner.waiting, owner.due <= time.perf_counter()))
        real_preempt(slot)

    eng.preempt = preempt
    loop = _Checked(eng, spec, HypothesisBuilder(harness._patterns(c.mix)), traffic, cfg,
                    beam_width=3, event_cls=Event)
    res = loop.run(1.0, 20.0)
    assert loop.iterations > 10
    assert preempted, "speculative slots are preempted at their tool's return"
    assert all(waiting and due for _, waiting, due in preempted)
    done = [t for t in res.turns if t.end is not None]
    assert all(len(t.served) == t.n_reason for t in done)
    for a in loop.agents:
        mine = [t for t in res.turns if t.agent == a.idx]
        assert len(mine) == a.turns_done + (a.turn is not None)
        for ep in range(a.ep + 1):
            script = traffic.scripts[a.idx][ep]
            turns = [t for t in mine if t.ep == ep]
            assert len(turns) <= len(script.calls) + 1
            if ep < a.ep:                        # a finished episode had every turn
                assert len(turns) == len(script.calls) + 1
            head = traffic.system + traffic.tasks[a.idx][ep]
            assert all(t.prompt[:len(head)] == head for t in turns)
            assert [t.n_reason for t in turns] == script.reasoning[:len(turns)]


def test_the_traced_part_is_the_window_end(tiny_root):
    """The profiler brackets the window's last ``trace_seconds``; steps
    before it feed the counters, steps inside it are timed apart."""
    from repro_torch.core.events import Event
    from repro_torch.core.hypothesis import HypothesisBuilder
    from repro_torch.serving.engine import ServingEngine

    c = find_cell(f"{list(TINY_CONFIGS)[0]}.tiny-serial", tiny_root)
    cfg = model_config(c.config)
    params = make_params(cfg, 4, "cpu", tie_embeddings=c.config["tie_embeddings"])
    eng = ServingEngine(cfg, params, max_batch=c.mix["max_batch"], max_len=c.mix["max_len"],
                        eos_id=c.config["eos_token_id"], device="cpu")
    traffic = make_traffic(c.mix, 4, cfg.vocab_size, c.config["eos_token_id"])
    marks = []
    loop = AgentLoop(eng, None, HypothesisBuilder(harness._patterns(c.mix)), traffic, cfg,
                     beam_width=3, event_cls=Event)
    res = loop.run(1.0, 20.0, trace_seconds=0.4,
                   trace_start=lambda: marks.append(("start", time.perf_counter())),
                   trace_stop=lambda: marks.append(("stop", time.perf_counter())))
    assert [m for m, _ in marks] == ["start", "stop"]
    start, stop = marks[0][1], marks[1][1]
    assert res.t_close - 0.4 <= start < res.t_close <= stop
    assert res.counters.steps > 0 and res.counters.traced_steps > 0


@pytest.mark.parametrize("name", list(TINY_CONFIGS))
def test_altered_token_is_not_correct(tiny_root, name, monkeypatch):
    """A token altered where the engine produces it (a decode step's
    output) fails the check."""
    from repro_torch.serving.engine import ServingEngine

    real_step = ServingEngine.step
    calls = {"n": 0}

    def step(self):
        out = real_step(self)
        calls["n"] += 1
        if calls["n"] % 7 == 0:
            for s in self.slots:
                if s.active and not s.speculative:
                    self.pending_tokens[s.idx] = (int(self.pending_tokens[s.idx]) + 101) \
                        % (self.cfg.vocab_size - 3) + 2
        return out

    monkeypatch.setattr(ServingEngine, "step", step)
    c = find_cell(f"{name}.tiny-serial", tiny_root)
    out = harness.run_cell(c, 11, 1.0, False, "cpu", time.perf_counter(), tiny_root, log=_quiet)
    assert not out["correct"]
    gap = out["checks"]["served_logit_gap"]
    assert gap["value"] > gap["limit"]


@pytest.mark.parametrize("name", list(TINY_CONFIGS))
def test_the_control_is_judged_not_correct(tiny_root, name):
    """The fp8 control, read at a run's checked positions, goes through the
    program's own predicate and fails it where the program passes."""
    c = find_cell(f"{name}.tiny-spec", tiny_root)
    out = harness.run_cell(c, 2**33 + 5, 1.0, False, "cpu", time.perf_counter(), tiny_root,
                           log=_quiet, control=True)
    assert out["correct"], out["checks"]
    assert out["control_correct"] is False
    gap = out["control_checks"]["served_logit_gap"]
    assert gap["value"] > gap["limit"]
    assert out["control_checks"]["served_tokens_checked"] == \
        out["checks"]["served_tokens_checked"]


@pytest.mark.parametrize("gap, failed, tokens, ok", [
    (0.1, 0, 300, True), (0.5, 0, 200, True), (0.51, 0, 300, False),
    (None, 0, 300, False), (0.1, 1, 300, False), (0.1, 0, 199, False)])
def test_within_holds_each_number_to_its_limit(gap, failed, tokens, ok):
    check = {"served_logit_gap": 0.5, "min_tokens_checked": 200}
    assert harness.within(harness.judged(gap, failed, tokens, check)) is ok


def test_end_to_end_reads_only_window_turns():
    from portbench.loop import LoopResult, Turn

    turns = [Turn(0, 0, 0.5, [1], 4, end=3.0), Turn(0, 0, 1.0, [1], 4, end=2.0),
             Turn(1, 0, 1.5, [1], 4, end=4.5), Turn(1, 0, 3.2, [1], 4, end=9.0)]
    res = LoopResult(turns, t_open=1.0, t_close=3.0, seconds=2.0, counters=None, shapes={})
    e2e = harness.end_to_end(res, t0=0.0)
    assert e2e["setup_s"] == 1.0
    assert e2e["turns_per_s"] == 0.5             # one end inside [1, 3): 3.0 is past the close
    assert e2e["ttna_p50_ms"] == pytest.approx(np.percentile([1000.0, 3000.0], 50))
