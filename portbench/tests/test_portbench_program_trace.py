"""The metrics that read the program's own spans (``portbench/program.py``
and its seven readers), on the CPU: whole traced runs of the tiny cells,
each reader on a hand-built record, the program's counts over the untraced
part against the loop's counters, the reduction of idle gaps to the
innermost program span, and ``summarize`` blind to the program's
annotations among the profiler's events."""
from __future__ import annotations

import time

import pytest
import torch

from portbench import harness, program, roofline
from portbench.bench import find_cell, metric_reader, model_config
from portbench.loop import AgentLoop, Counters, LoopResult, Turn
from portbench.tracing import Tracer, summarize
from portbench.traffic import make_traffic
from portbench.weights import make_params

from conftest import HERE, TINY_CONFIGS

CELLS = [f"{c}.{m}" for c in TINY_CONFIGS for m in ("tiny-spec", "tiny-serial")]
HOST = ["engine.step_launch_ms", "engine.step_readback_ms", "engine.turn_queue_ms",
        "engine.prefill_stall_share"]
SPEC = ["spec.prefill_stall_share", "spec.decode_row_share"]
DEVICE = ["device.idle_decode_launch_share"]


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _all_metrics():
    return [{k: v for k, v in m.items() if k != "workloads"} for m in program.metrics()]


def test_the_metrics_are_the_seven_readers():
    names = [m["name"] for m in program.metrics()]
    assert names == HOST + SPEC + DEVICE
    for name in names:
        assert (HERE / "metrics" / f"{name}.py").exists()


@pytest.mark.parametrize("cell", CELLS)
def test_program_run_cell_tiny(tiny_root, cell):
    """A traced run on the CPU reads the host-side metrics; the device one
    finds no profiler there. The launch is a part of the program's own step
    (the harness's `engine.step_ms` can count one step more, which starts
    after the window's close, so it is no bound on a mean)."""
    from repro_torch import obs

    c = find_cell(cell, tiny_root)
    out = program.run_cell(c, 2**33 + 7, 1.0, True, "cpu", time.perf_counter(), tiny_root,
                           log=lambda *a, **k: None, program_metrics=_all_metrics())
    assert out["correct"], out["checks"]
    want = HOST + (SPEC if cell.endswith("tiny-spec") else [])
    assert [n for n in out["metrics"] if n in HOST + SPEC + DEVICE] == want
    steps = program.named(obs.spans(), "serving.step")
    model = program.named(obs.spans(), "serving.step.model")
    assert 0 < out["metrics"]["engine.step_launch_ms"]["value"]
    assert 0 < program.seconds(model) < program.seconds(steps)
    assert list(out)[-1] == "checks" and "program" not in out


def test_untraced_runs_record_nothing(tiny_root):
    from repro_torch import obs

    obs.record(True)
    obs.record(False)               # an empty record
    c = find_cell(CELLS[0], tiny_root)
    out = program.run_cell(c, 5, 0.5, False, "cpu", time.perf_counter(), tiny_root,
                           log=lambda *a, **k: None, program_metrics=_all_metrics())
    assert "program" not in out and obs.spans() == [] and not obs.recording()
    assert set(out["metrics"]) == {"ttna_p50_ms", "ttna_p90_ms", "turns_per_s", "setup_s"}


# -- each reader on a hand-built record ------------------------------------------
def _span(name, t0, t1, parent=-1, **attrs):
    from repro_torch.obs import Span

    s = Span(name, round(t0 * 1e9), parent, attrs)
    s.end_ns = round(t1 * 1e9)
    return s


def _prefill(t0, t1, slot, decoding, auth, spec=False):
    return _span("serving.prefill", t0, t1, slot=slot, decoding=decoding, auth_decoding=auth,
                 speculative=spec, tokens=10)


def _hand_record(spec_slots=2):
    """The window is [10, 20) s, the profiler started at 15 s."""
    spans = [
        _span("serving.step", 9.0, 9.1, rows=8, spec_rows=8),    # before the window
        _prefill(10.5, 11.0, 0, 2, 2),                                     # stalls 2 rows
        _span("serving.step", 11.0, 11.1, rows=4, spec_rows=1),
        _span("serving.step.model", 11.01, 11.06, 2),
        _span("serving.step.readback", 11.06, 11.09, 2),
        _span("serving.step", 12.0, 12.2, rows=2, spec_rows=0),
        _span("serving.step.model", 12.0, 12.1, 5),
        _span("serving.step.readback", 12.1, 12.15, 5),
        _prefill(12.0, 12.05, 5, 0, 0),          # slot 5's occupant before the turn below
        _prefill(13.0, 13.4, 3, 1, 0, spec=True),  # stalls a speculative row only
        _prefill(13.2, 13.3, 5, 2, 1),
        _prefill(14.0, 14.2, 4, 3, 1, spec=True),  # stalls an authoritative row
        _prefill(14.5, 14.6, 1, 0, 0),
        _prefill(15.5, 16.0, 6, 5, 5),                                     # traced part
        _span("serving.step", 16.0, 16.1, rows=10, spec_rows=10),
    ]
    turns = [Turn(0, 0, 10.2, [1], 4, slot=0, end=13.0),     # queue 300 ms
             Turn(1, 0, 14.3, [1], 4, slot=1, end=15.2),     # queue 200 ms
             Turn(2, 0, 12.0, [1], 4, slot=2, promoted=True, end=12.5),
             Turn(3, 0, 9.5, [1], 4, slot=7, end=11.0),      # before the window
             Turn(4, 0, 14.0, [1], 4, slot=2),               # never finished
             Turn(5, 0, 11.8, [1], 4, slot=5, end=14.9)]     # its own prefill is 13.2: 1400 ms
    loop = LoopResult(turns, 10.0, 20.0, 10.0, Counters(), {})
    rec = harness.Record({"spec_budget_slots": spec_slots}, loop, None, {}, 0.0)
    rec.program = program.Program(spans, [], round(15.0 * 1e9),
                                  program.ProgramIdle(5.0, {"outside": 1.0,
                                                            "serving.step.model": 0.5}))
    return rec


@pytest.mark.parametrize("name, want", [
    ("engine.step_launch_ms", (50 + 100) / 2), ("engine.step_readback_ms", (30 + 50) / 2),
    ("engine.turn_queue_ms", 300.0), ("engine.prefill_stall_share", 100 * 1.2 / 5),
    ("spec.prefill_stall_share", 100 * 0.2 / 5), ("spec.decode_row_share", 100 * 1 / 6),
    ("device.idle_decode_launch_share", 100 * 0.5 / 5)])
def test_reader_on_a_hand_built_record(name, want):
    read = metric_reader(name, HERE.parent)
    assert read(_hand_record()) == pytest.approx(want, rel=1e-9)
    serial = read(_hand_record(spec_slots=0))
    assert serial is None if name.startswith("spec.") else serial == pytest.approx(want)
    bare = _hand_record()
    del bare.program
    assert read(bare) is None


# -- the untraced part against the loop's counters ----------------------------------
def _counts(rec):
    """The program's view of the untraced part: its steps and their mean
    host ms, its authoritative prefills, and its prompt tokens by kind."""
    spans = program.part(rec)[0]
    steps = program.named(spans, "serving.step")
    prefills = program.named(spans, "serving.prefill")
    auth = [s for s in prefills if not s.attrs["speculative"]]
    return {"steps": len(steps), "step_ms": 1e3 * program.seconds(steps) / len(steps),
            "prefills": len(auth), "prefill_tokens_auth": sum(s.attrs["tokens"] for s in auth),
            "prefill_tokens_spec": sum(s.attrs["tokens"] for s in prefills
                                       if s.attrs["speculative"])}


@pytest.mark.parametrize("name", list(TINY_CONFIGS))
def test_program_counts_equal_the_loop_counters(tiny_root, name):
    from repro_torch import obs
    from repro_torch.core.events import Event
    from repro_torch.core.hypothesis import HypothesisBuilder
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.spec_serving import SlotSpeculator

    c = find_cell(f"{name}.tiny-spec", tiny_root)
    cfg = model_config(c.config)
    params = make_params(cfg, 6, "cpu", tie_embeddings=c.config["tie_embeddings"])
    eng = ServingEngine(cfg, params, max_batch=c.mix["max_batch"], max_len=c.mix["max_len"],
                        eos_id=c.config["eos_token_id"], device="cpu")
    spec = SlotSpeculator(eng, budget_slots=c.mix["spec_budget_slots"])
    traffic = make_traffic(c.mix, 6, cfg.vocab_size, c.config["eos_token_id"])
    loop = AgentLoop(eng, spec, HypothesisBuilder(harness._patterns(c.mix)), traffic, cfg,
                     beam_width=3, event_cls=Event)
    marks = []
    obs.record(True)
    try:
        res = loop.run(1.0, 20.0, trace_seconds=0.4,
                       trace_start=lambda: marks.append(time.perf_counter_ns()),
                       trace_stop=lambda: None)
    finally:
        obs.record(False)
    rec = harness.Record(c.mix, res, None, {}, 0.0)
    rec.program = program.Program(obs.spans(), [], marks[0])
    got, k = _counts(rec), res.counters
    assert k.steps > 0 and k.prefill_tokens_spec > 0
    assert (got["steps"], got["prefills"], got["prefill_tokens_auth"],
            got["prefill_tokens_spec"]) == (k.steps, k.prefills, k.prefill_tokens_auth,
                                            k.prefill_tokens_spec)
    # the program's step sits inside the harness's clock around it
    assert got["step_ms"] * got["steps"] <= 1e3 * k.step_s


# -- the reductions of the profiler's events --------------------------------------
class _Event:
    def __init__(self, name, start, end, device="CPU", annotation=True):
        self._n, self._s, self._e, self._d, self._a = name, start, end, device, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return type("D", (), {"name": self._d})

    def is_user_annotation(self):
        return self._a


class _Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda _self: list(events)})()
        self.profiler = type("P", (), {"kineto_results": results})()


HARNESS = [_Event("engine.step", 100, 200), _Event("engine.add_request", 300, 500)]
DEVICE_OPS = [_Event("flash_attention_bf16_kernel", 125, 160, "CUDA", False),
              _Event("elementwise_kernel", 320, 480, "CUDA", False)]
PROGRAM = [_Event("serving.step", 110, 190), _Event("serving.step.model", 120, 150),
           _Event("serving.prefill", 310, 490),
           _Event("serving.step", 130, 180, "CUDA", True)]   # the profiler's device-side copy


def _raw(events):
    t = Tracer(True)
    t.prof = _Prof(events)
    return t.raw_events()


def test_summarize_is_blind_to_the_program_annotations():
    without = summarize(*_raw(HARNESS + DEVICE_OPS), roofline.kernel_of)
    with_ = summarize(*_raw(HARNESS + PROGRAM + DEVICE_OPS), roofline.kernel_of)
    assert with_ == without
    assert without.spans == {"engine.step": 1, "engine.add_request": 1}


def test_program_idle_charges_the_innermost_span():
    dev, _, window = _raw(HARNESS + PROGRAM + DEVICE_OPS)
    copies = [(e.name(), e.start_ns(), e.end_ns()) for e in PROGRAM
              if e.device_type().name == "CPU"]
    got = program.program_idle(dev, copies, window)
    assert got.window_s == pytest.approx(400e-9)
    want = {"outside": 140e-9, "serving.step": 40e-9, "serving.step.model": 5e-9,
            "serving.prefill": 20e-9}
    assert got.idle_s_by_span == pytest.approx(want)
    assert sum(got.idle_s_by_span.values()) == pytest.approx(400e-9 - (35 + 160) * 1e-9)
