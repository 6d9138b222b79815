"""One run of a cell: set-up, the measured window, the check, the metrics.

Set-up (``setup_s``, from the process's start to the window's opening)
makes the weights on the device from the seed, builds the engine at the
mix's ``max_batch`` and ``max_len``, mines the pattern engine on the mix's
fixed episodes, warms up a prefill at the shortest and at the longest
prompt the mix sends and one decode step, then runs the loop until every
agent has finished a turn (the ramp). The window follows; then the drain,
the peak memory, the freed engine, and the check against the reference.
"""
from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from portbench import roofline
from portbench.bench import Cell, metric_reader, model_config
from portbench.check import chains, sample, served_gaps
from portbench.loop import AgentLoop, LoopResult
from portbench.tracing import Tracer, TraceSummary, summarize
from portbench.traffic import make_traffic, script_pool
from portbench.weights import make_params


@dataclass
class Record:
    """What a per-layer metric's reader reads."""
    mix: Dict[str, Any]
    loop: LoopResult
    trace: Optional[TraceSummary]
    least_s: Dict[str, float]       # per kernel: least seconds of its traced calls
    model_flops: float              # authoritative work in the traced window


def _patterns(mix):
    from repro_torch.core.events import Event
    from repro_torch.core.patterns import PatternEngine

    p = mix["patterns"]
    pool = dict(mix, pool_seed=p["seed"], agents=p["episodes"], episodes_per_agent=1)
    traces = [[Event("tool", c.tool, dict(c.args), c.result) for c in eps[0].calls]
              for eps in script_pool(pool)]
    return PatternEngine(context_len=p["context_len"], min_support=p["min_support"]).fit(traces)


def _release_all(engine) -> None:
    for s in engine.slots:
        s.active, s.done, s.request_id, s.speculative = False, False, None, False


def _warm_up(engine, traffic, mix) -> None:
    """The shapes the window sends: a prefill at the shortest and at the
    longest prompt, and one decode step with every slot in use."""
    short = traffic.system + traffic.tasks[0][0]
    longest = engine.max_len - 2 - mix["reasoning_tokens"]["min"]
    long_ = (short * (longest // len(short) + 1))[:longest]
    engine.add_request(long_, request_id=0)
    engine.add_request(short, request_id=0)
    for s in engine.slots:
        s.active = True
    engine.step()
    _release_all(engine)


def _percentile(xs, q) -> float:
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def judged(gap: Optional[float], failed: int, tokens: int,
           check: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """The numbers a run is judged by, each beside its limit: the widest
    served logit gap, the sampled turns left unfinished, the tokens checked."""
    return {
        "served_logit_gap": {"value": gap, "limit": float(check["served_logit_gap"])},
        "turns_failed": {"value": failed, "limit": 0},
        "served_tokens_checked": {"value": tokens, "limit": int(check["min_tokens_checked"])},
    }


def within(checks: Dict[str, Dict[str, Any]]) -> bool:
    """Whether every judged number keeps to its limit."""
    gap, failed, tokens = (checks[k] for k in
                           ("served_logit_gap", "turns_failed", "served_tokens_checked"))
    return (gap["value"] is not None and gap["value"] <= gap["limit"]
            and failed["value"] <= failed["limit"] and tokens["value"] >= tokens["limit"])


def end_to_end(loop: LoopResult, t0: float) -> Dict[str, float]:
    sample_turns = [t for t in loop.turns if loop.t_open <= t.start < loop.t_close]
    ttna = [(t.end - t.start) * 1e3 for t in sample_turns if t.end is not None]
    done_in = sum(1 for t in loop.turns
                  if t.end is not None and loop.t_open <= t.end < loop.t_close)
    out = {"setup_s": loop.t_open - t0, "turns_per_s": done_in / loop.seconds}
    if ttna:
        out["ttna_p50_ms"] = _percentile(ttna, 50)
        out["ttna_p90_ms"] = _percentile(ttna, 90)
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
             root: Path, log=print, control: bool = False) -> Dict[str, Any]:
    """Run ``cell`` once; returns the result line's fields (``checks`` last).
    ``control`` also reads the fp8 control at the checked positions and
    judges it as the program is judged, into ``control_correct`` (the
    calibration's, never a benchmark run's)."""
    import torch
    from repro_torch.core.events import Event
    from repro_torch.core.hypothesis import HypothesisBuilder
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.spec_serving import SlotSpeculator

    cuda = torch.device(device).type == "cuda"
    marks = [("start", t0)]

    def mark(name):
        if cuda:
            torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    mark("imports")
    cfg = model_config(cell.config)
    mix = cell.mix
    eos = int(cell.config["eos_token_id"])
    params = make_params(cfg, seed, device, tie_embeddings=bool(cell.config.get("tie_embeddings")))
    mark("weights")
    engine = ServingEngine(cfg, params, max_batch=mix["max_batch"], max_len=mix["max_len"],
                           eos_id=eos, device=device)
    spec = SlotSpeculator(engine, budget_slots=mix["spec_budget_slots"]) \
        if mix["spec_budget_slots"] > 0 else None
    mark("engine")
    builder = HypothesisBuilder(_patterns(mix))
    traffic = make_traffic(mix, seed, cfg.vocab_size, eos)
    mark("patterns+traffic")
    _warm_up(engine, traffic, mix)
    mark("warm-up")
    tracer = Tracer(trace and cuda)
    loop = AgentLoop(engine, spec, builder, traffic, cfg, beam_width=mix["beam_width"],
                     span=tracer.span, event_cls=Event)
    gc.collect()
    gc.disable()                # no collector pauses in the loop; reference counting frees
    try:
        res = loop.run(seconds, mix["drain_cap_s"],
                       trace_seconds=min(seconds, mix["trace_seconds"]) if tracer.enabled else 0.0,
                       trace_start=tracer.start, trace_stop=tracer.stop)
    finally:
        gc.enable()
    e2e = end_to_end(res, t0)
    marks += [("ramp", res.t_open), ("window", res.t_close), ("drain", time.perf_counter())]
    log("set-up and run: " + ", ".join(f"{n} {b - a:.2f} s" for (_, a), (n, b)
                                       in zip(marks, marks[1:])), file=sys.stderr)
    c = res.counters
    if c.traced_steps and c.steps:
        log(f"profiler: a step {c.traced_step_s / c.traced_steps * 1e3:.2f} ms of host wall "
            f"traced ({c.traced_steps}), {c.step_s / c.steps * 1e3:.2f} ms untraced "
            f"({c.steps})", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    smax = engine.max_len
    summary = None
    if tracer.enabled:
        t_read = time.perf_counter()
        dev, spans, window = tracer.raw_events()
        tracer.prof = None
        summary = summarize(dev, spans, window, roofline.kernel_of)
        del dev, spans
        log(f"trace: {summary.window_s:.3f} s read in {time.perf_counter() - t_read:.1f} s",
            file=sys.stderr)
    # the program's state goes before the reference runs
    del engine, spec, loop
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    picked = sample(chains(res.turns), mix["check"]["chains"], seed)
    gaps = served_gaps(params, cfg, cell.config["reference"], picked, device,
                       control=control) if picked else {}
    log(f"check: {gaps.get('chains', 0)} chains, {gaps.get('tokens_checked', 0)} served "
        f"tokens, trunk {gaps.get('trunk', 0)}, in {time.perf_counter() - t_check:.1f} s",
        file=sys.stderr)

    sample_turns = [t for t in res.turns if res.t_open <= t.start < res.t_close]
    attempted = len(sample_turns)
    failed = sum(1 for t in sample_turns if t.end is None)
    tokens = gaps.get("tokens_checked", 0)
    checks = judged(gaps.get("served_logit_gap"), failed, tokens, cell.config["check"])
    ran = attempted > 0 and "ttna_p90_ms" in e2e
    correct = ran and within(checks)

    metrics: Dict[str, Any] = {}
    if trace:
        rec = Record(mix, res, summary,
                     roofline.kernel_least_seconds(cfg, res.shapes, smax) if summary else {},
                     roofline.model_flops(cfg, res.shapes, smax) if summary else 0.0)
        for m in cell.per_layer:
            v = metric_reader(m["name"], root)(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    devinfo: Dict[str, Any] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    out: Dict[str, Any] = {"correct": bool(correct), "attempted": attempted, "failed": failed,
                           "metrics": metrics, "device": devinfo}
    if summary is not None:
        devinfo["busy_s"] = summary.busy_s
        devinfo["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": [[n, s] for n, s in summary.top_ops],
                            "idle_gaps": [[n, s] for n, s in
                                          list(summary.idle_s_by_span.items())[:10]]}
    out["counts"] = {"turns": len(res.turns), "window_turns_done": e2e["turns_per_s"] * seconds,
                     **vars(res.counters)}
    if control:
        out["control_checks"] = judged(gaps.get("control_logit_gap"), failed, tokens,
                                       cell.config["check"])
        out["control_correct"] = ran and within(out["control_checks"])
    out["checks"] = checks
    return out
