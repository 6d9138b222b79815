"""The port's span recorder (``repro_torch.obs``) and the serving engine's
spans, on the CPU: nothing recorded and no attribute computed while
recording is off; the nesting, parents and attributes of ``serving.step``
and ``serving.prefill``; names apart from the benchmark harness's own; and
the clock: spans annotated under the profiler map through their anchor onto
the profiler's copies; ``serving.step.model``'s ``graph`` and the engine's
``graph_replays``: false and 0 on the CPU, on a card (a test marked
``cuda``) true and every step."""
from __future__ import annotations

import gc
import warnings

import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.serving.engine import ServingEngine

NAMES = {"serving.step", "serving.step.model", "serving.step.readback", "serving.prefill"}


@pytest.fixture(scope="module")
def params():
    cfg = get_config("qwen2-7b").reduced()
    return cfg, M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


@pytest.fixture
def engine(params):
    cfg, p = params
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield ServingEngine(cfg, p, max_batch=4, max_len=64, device="cpu")
    obs.record(False)
    torch.set_num_threads(n)


def _serve(eng):
    """An authoritative prefill, a step, a speculative and an authoritative
    prefill, a step."""
    eng.add_request([2, 3, 4, 5, 6], request_id=1)
    eng.step()
    eng.add_request([7, 8, 9, 10, 11, 12, 13], request_id=-1, speculative=True)
    eng.add_request([14, 15, 16], request_id=2)
    eng.step()


def test_off_records_nothing_and_computes_no_attributes(engine, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("attributes computed with recording off")

    obs.record(True)
    obs.record(False)
    monkeypatch.setattr(ServingEngine, "_step_attrs", boom)
    monkeypatch.setattr(ServingEngine, "_prefill_attrs", boom)
    assert not obs.recording()
    assert obs.span("serving.step") is obs.span("serving.prefill", slot=1)
    _serve(engine)
    assert obs.spans() == []
    assert engine.steps_executed == 2


def test_nesting_and_parents(engine):
    obs.record(True)
    _serve(engine)
    spans = obs.spans()
    assert [s.name for s in spans] == [
        "serving.prefill", "serving.step", "serving.step.model", "serving.step.readback",
        "serving.prefill", "serving.prefill", "serving.step", "serving.step.model",
        "serving.step.readback"]
    for i, s in enumerate(spans):
        assert s.start_ns <= s.end_ns
        if s.name.startswith("serving.step."):
            parent = spans[s.parent]
            assert parent.name == "serving.step" and s.parent < i
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        else:
            assert s.parent == -1
    model, readback = spans[2], spans[3]
    assert model.end_ns <= readback.start_ns


def test_attributes(engine):
    obs.record(True)
    _serve(engine)
    prefills = [s.attrs for s in obs.spans() if s.name == "serving.prefill"]
    steps = [s.attrs for s in obs.spans() if s.name == "serving.step"]
    assert prefills == [
        {"slot": 0, "tokens": 5, "speculative": False, "decoding": 0, "auth_decoding": 0},
        {"slot": 1, "tokens": 7, "speculative": True, "decoding": 1, "auth_decoding": 1},
        {"slot": 2, "tokens": 3, "speculative": False, "decoding": 2, "auth_decoding": 1},
    ]
    assert steps == [{"rows": 1, "spec_rows": 0}, {"rows": 3, "spec_rows": 1}]


def test_the_model_span_says_whether_the_step_replayed(engine):
    """On the CPU every step runs eagerly: ``graph`` false, no replay."""
    obs.record(True)
    _serve(engine)
    assert [s.attrs for s in obs.spans() if s.name == "serving.step.model"] == \
        [{"graph": False}] * 2
    assert engine.graph_replays == 0 and engine.steps_executed == 2


@pytest.mark.cuda
def test_on_a_card_every_step_replays(params):
    """On a card the engine captures at its first step and replays every
    step: ``graph`` true on each ``serving.step.model``, and
    ``graph_replays`` equal to ``steps_executed``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode step is captured only there")
    cfg, _ = params
    p = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    eng = ServingEngine(cfg, p, max_batch=4, max_len=64, device="cuda")
    obs.record(True)
    try:
        _serve(eng)
    finally:
        obs.record(False)
    assert [s.attrs for s in obs.spans() if s.name == "serving.step.model"] == \
        [{"graph": True}] * 2
    assert eng.graph_replays == eng.steps_executed == 2


def test_names_are_apart_from_the_harness_spans(engine):
    from portbench.tracing import SPANS

    obs.record(True)
    _serve(engine)
    names = {s.name for s in obs.spans()}
    assert names == NAMES
    assert not names & set(SPANS)


def test_the_clock_maps_annotated_spans_onto_their_profiler_copies(engine, monkeypatch):
    """Under ``torch.profiler`` with the harness tracer's user-scope cut,
    every span annotated maps through its anchor onto its copy."""
    from portbench.tracing import Tracer

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    obs.record(True)
    engine.add_request([2, 3, 4], request_id=9)       # recorded before the profiler
    tracer = Tracer(True)
    gc.disable()
    try:
        with warnings.catch_warnings():     # without a card: CPU events only
            warnings.simplefilter("ignore")
            tracer.start()
        obs.annotate(True)
        with tracer.span("engine.step"):
            engine.step()
        with tracer.span("engine.add_request"):
            engine.add_request([5, 6, 7, 8], request_id=10)
        for _ in range(3):
            with tracer.span("engine.step"):
                engine.step()
        obs.annotate(False)
        tracer.stop()
    finally:
        gc.enable()
    copies = obs.RECORDER.copies(tracer.prof)
    annotated = obs.spans()[1:]
    assert [s for s, _, _ in copies] == annotated
    assert len(obs.RECORDER.anchors) == 1
    to = obs.RECORDER.to_profiler
    worst = max(max(abs(to(s.start_ns) - a), abs(to(s.end_ns, end=True) - b))
                for s, a, b in copies)
    assert worst < 200_000, f"{worst / 1e3:.1f} us"
    _, harness_spans, _ = tracer.raw_events()
    assert {n for n, _, _ in harness_spans} == {"engine.step", "engine.add_request"}
