"""The port's discrete-event runtime against the JAX package's.

``run_mode(..., device="cpu")`` of the port and ``run_mode`` of the JAX
package get the same episodes and pattern tables (each package mines its
own from the same seeded workload) and must give the same summary on every
key outside WALL_CLOCK_KEYS, the scheduler's own wall-clock readings:
the four pinned serving cells of tests/data/pr9_pinned_serving.json (also
held against the file), event ≡ dense, serial/paste/parallel/bpaste on the
default workload, the fused pass forced onto the tensor path
(``host_admit_max=2``), the reference greedy at concurrency 3, the open loop
with shedding and adaptive linger, and speculative model steps. The
speculation-safety analyzer and its CLI report nothing.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import events as jev  # noqa: E402
from repro.core import interference as jint  # noqa: E402
from repro.core import patterns as jpat  # noqa: E402
from repro.core import runtime as jrt  # noqa: E402
from repro.core import workload as jwl  # noqa: E402
from repro_torch.core import admission as tadm  # noqa: E402
from repro_torch.core import analysis as tana  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.core import interference as tint  # noqa: E402
from repro_torch.core import patterns as tpat  # noqa: E402
from repro_torch.core import runtime as trt  # noqa: E402
from repro_torch.core import workload as twl  # noqa: E402
from repro_torch.core.hypothesis import HypothesisBuilder  # noqa: E402
from repro_torch.core.safety import FULL_POLICY  # noqa: E402

JAX = (jev, jint, jpat, jrt, jwl)
PORT = (tev, tint, tpat, trt, twl)
WALL_CLOCK_KEYS = {"sched_us_per_admit", "sched_us_per_tick"}
PINNED = os.path.join(os.path.dirname(__file__), "data", "pr9_pinned_serving.json")
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
STACK = dict(memo=True, model_max_batch=8, spec_model_steps=True,
             shed_alpha=1.0, adaptive_linger=True)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: many tiny tensor ops, several test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_ENGINES = {}


def _engine(pkg, n_train):
    """Each package mines its own pattern tables from the same workload."""
    key = (pkg is PORT, n_train)
    if key not in _ENGINES:
        wl, pat = pkg[4], pkg[2]
        train = wl.make_episodes(wl.WorkloadConfig(seed=1, n_episodes=n_train))
        _ENGINES[key] = pat.PatternEngine(context_len=2, min_support=3).fit(
            wl.episodes_to_traces(train))
    return _ENGINES[key]


def _machine(pkg, box):
    ev, intf = pkg[0], pkg[1]
    return {"thor": intf.Machine(),
            "serve": intf.Machine(ev.ResourceVector(cpu=12, mem_bw=100, io=500, accel=4)),
            "thor6": intf.Machine(ev.ResourceVector(cpu=6, mem_bw=50, io=200, accel=1)),
            }[box]


def _run(pkg, mode, box, workload, n_train=20, open_loop=False, **kw):
    """One run_mode call of ``pkg``; the port's on the CPU."""
    wl, rt = pkg[4], pkg[3]
    cfg = wl.WorkloadConfig(**workload)
    if open_loop:
        eps, src = [], wl.open_loop_source(cfg)
    else:
        eps, src = wl.make_episodes(cfg), None
    extra = {"device": "cpu"} if pkg is PORT else {}
    m = rt.run_mode(eps, _engine(pkg, n_train), mode, _machine(pkg, box), seed=7,
                    episode_source=src, **extra, **kw)
    s = m.summary()
    s["_served"] = len(m.tenant_sojourn)
    return s


def _strip(s):
    return {k: v for k, v in s.items() if k not in WALL_CLOCK_KEYS}


def _assert_equal(got, want, what):
    diffs = {k: (got.get(k), v) for k, v in _strip(want).items() if got.get(k) != v}
    assert not diffs and set(_strip(got)) == set(_strip(want)), f"{what}: {diffs}"


def _both(mode, box, workload, **kw):
    want = _run(JAX, mode, box, workload, **kw)
    got = _run(PORT, mode, box, workload, **kw)
    _assert_equal(got, want, f"{mode} on {box} {kw}")
    return got


SERVING = dict(seed=42, n_episodes=8, arrival_stagger=4.0, shared_frac=0.5, shared_pool=2)
DEFAULT = dict(seed=42, n_episodes=8)
PINNED_CELLS = {
    "bpaste_memo_thor_c8_b8": ("thor", "bpaste", True, 8),
    "serial_thor_c8_b8": ("thor", "serial", False, 8),
    "bpaste_memo_serve_c8_b1": ("serve", "bpaste", True, 1),
    "bpaste_memo_thor_c8_b1": ("thor", "bpaste", True, 1),
}


@pytest.mark.parametrize("cell", list(PINNED_CELLS))
def test_pinned_serving_cells(cell):
    box, mode, memo, max_batch = PINNED_CELLS[cell]
    got = _both(mode, box, SERVING, max_concurrent_episodes=8, memo=memo,
                model_max_batch=max_batch)
    with open(PINNED) as f:
        want = json.load(f)[cell]
    diffs = {k: (got.get(k), v) for k, v in want.items()
             if k not in WALL_CLOCK_KEYS and got.get(k) != v}
    assert not diffs, f"{cell}: {diffs}"


def test_event_scheduler_equals_dense():
    kw = dict(max_concurrent_episodes=8, memo=True, model_max_batch=8)
    event = _both("bpaste", "thor", SERVING, scheduler="event", **kw)
    dense = _both("bpaste", "thor", SERVING, scheduler="dense", **kw)
    assert _strip(event) == _strip(dense)


@pytest.mark.parametrize("mode", ["serial", "paste", "parallel", "bpaste"])
def test_modes_on_the_default_workload(mode):
    _both(mode, "thor6", DEFAULT, n_train=60)


def test_tensor_admission_path_matches_jax_and_host_path(monkeypatch):
    """``host_admit_max=2``: every pool above two candidates goes through
    ``admit_beam`` (here as torch ops on the CPU), and the summary equals
    JAX's on its device path and the port's own host path."""
    passes = []
    real = tadm.admit_beam

    def counted(*args, **kw):
        passes.append(args[0].device if args else kw["node_lat"].device)
        return real(*args, **kw)

    monkeypatch.setattr(tadm, "admit_beam", counted)
    kw = dict(max_concurrent_episodes=8, memo=True, model_max_batch=8)
    tensor = _both("bpaste", "serve", SERVING, host_admit_max=2, **kw)
    assert passes and all(d == torch.device("cpu") for d in passes)
    host = _run(PORT, "bpaste", "serve", SERVING, **kw)
    _assert_equal(tensor, host, "tensor path against the host path")


def test_reference_admission_matches_fused_at_concurrency_three():
    """tests/test_runtime.py's check, on the port, and each policy's
    summary against JAX's."""
    work = dict(seed=11, n_episodes=6)
    fused = _both("bpaste", "thor6", work, n_train=60, max_concurrent_episodes=3,
                  admission="fused")
    ref = _both("bpaste", "thor6", work, n_train=60, max_concurrent_episodes=3,
                admission="reference")
    assert fused["makespan"] == pytest.approx(ref["makespan"], rel=1e-9)
    assert fused["reuses"] == ref["reuses"]
    assert fused["promotions"] == ref["promotions"]


@pytest.mark.parametrize("mode,stack", [("serial", {}), ("bpaste", STACK)],
                         ids=["serial", "bpaste-stack"])
def test_open_loop_with_shedding_and_adaptive_linger(mode, stack):
    """As run_open_loop_demo runs it: every tenant served, no QoS tax."""
    work = dict(seed=42, n_episodes=16, open_loop_rate=0.1, shared_frac=0.5, shared_pool=2)
    s = _both(mode, "thor", work, open_loop=True, max_concurrent_episodes=4, **stack)
    assert s["_served"] == 16
    assert s["mean_auth_slowdown"] <= 1.0 + 1e-9 and s["qos_violations"] == 0
    if mode == "bpaste":
        assert s["shed_passes"] > 0


def test_speculative_model_steps():
    s = _both("bpaste", "thor", SERVING, max_concurrent_episodes=8, memo=True,
              model_max_batch=8, spec_model_steps=True)
    assert s["spec_steps_submitted"] > 0


def test_demos_hold_their_asserts(capsys):
    from repro_torch.launch.speculative_serving import run_edge_box_demo, run_open_loop_demo
    edge = run_edge_box_demo(device="cpu")
    opened = run_open_loop_demo(device="cpu")
    out = capsys.readouterr().out
    assert "edge box" in out and "open loop" in out
    assert edge["bpaste+memo+batch"]["makespan"] < edge["serial (no speculation)"]["makespan"]
    assert all(s["_served"] == 16 for s in opened.values())


def test_analyze_static_reports_nothing():
    eng = _engine(PORT, 20)
    builder = HypothesisBuilder(engine=eng)
    traces = twl.episodes_to_traces(twl.make_episodes(twl.WorkloadConfig(seed=1,
                                                                         n_episodes=20)))
    hyps = [h for t in traces[:5] for cut in range(1, len(t)) for h in builder.build(t[:cut])]
    report = tana.analyze_static(FULL_POLICY, eng, hyps)
    assert hyps and len(report.findings) == 0, report.render()


def test_analysis_cli_strict_exits_clean():
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--strict"],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "0 findings" in res.stdout


def test_runtime_config_device_reaches_the_scorer():
    rt = trt.BPasteRuntime([], _engine(PORT, 20), tint.Machine(), FULL_POLICY,
                           trt.RuntimeConfig(device="cpu"))
    assert rt.scorer.device == torch.device("cpu")
    assert trt.RuntimeConfig().device == "cuda"
    assert np.array_equal(rt.scorer.machine.cap_array(), tint.Machine().cap_array())
