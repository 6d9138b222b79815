"""Speculative serving, end to end: the port of ``examples/speculative_serving.py``.

Default, two demos on the discrete-event runtime (``core/runtime.py``):

  PYTHONPATH=src python -m repro_torch.launch.speculative_serving

* the batched edge box: an accel=1 box serving 8 concurrent tenants is
  model-step-bound, so plain speculation barely helps; batching the model
  step queue (``model_max_batch``) frees accelerator time that speculation
  and the result store turn into makespan, with authoritative work never
  slowed (mean auth slowdown ≤ 1.05, no QoS violation);
* the open loop: tenants arrive at a rate, the load-shedding ladder prices
  speculation out first; every tenant is served and authoritative work
  rides tax-free.

The runtime's scorer and fused admission pass run their tensor paths on
``--device`` (``cuda`` unless asked otherwise); pools up to
``RuntimeConfig.host_admit_max`` candidates take the host numpy path.

With ``--with-llm``, also serves a reduced LLM through
``launch/serve.py::serve_agent_loop``: reasoning tokens decode on the
ServingEngine and, during each tool call, B-PASTE prefills predicted
observations into free slots (promotion = zero-copy slot re-tag). ``--arch``
takes a dense (qwen2-7b), a Mamba2 (mamba2-2.7b) or a hybrid (zamba2-1.2b)
config.

  PYTHONPATH=src python -m repro_torch.launch.speculative_serving --with-llm --arch qwen2-7b
"""
from __future__ import annotations

import argparse
from typing import Dict

import torch

from repro_torch.configs import get_config
from repro_torch.core.interference import Machine
from repro_torch.core.patterns import PatternEngine
from repro_torch.core.runtime import run_mode
from repro_torch.core.workload import (
    WorkloadConfig, episodes_to_traces, make_episodes, open_loop_source,
)
from repro_torch.launch.serve import serve_agent_loop
from repro_torch.models import model as model_mod


def _engine() -> PatternEngine:
    train = make_episodes(WorkloadConfig(seed=1, n_episodes=20))
    return PatternEngine(context_len=2, min_support=3).fit(episodes_to_traces(train))


def run_edge_box_demo(n_episodes: int = 8, concurrency: int = 8, max_batch: int = 8,
                      device: str = "cuda") -> Dict[str, dict]:
    """The batched edge-box configuration: serial, bpaste with the result
    store, and bpaste with the store and a batched model-step queue.
    Returns each mode's summary by label."""
    thor = Machine()                         # accel=1 Thor-class edge box
    engine = _engine()
    tenants = make_episodes(WorkloadConfig(
        seed=42, n_episodes=n_episodes, arrival_stagger=4.0,
        shared_frac=0.5, shared_pool=2))

    print(f"edge box (accel=1), {n_episodes} tenants, concurrency={concurrency}:")
    results = {}
    for label, mode, memo, mb in [
        ("serial (no speculation)", "serial", False, 1),
        ("bpaste+memo (queue serial)", "bpaste", True, 1),
        ("bpaste+memo+batch", "bpaste", True, max_batch),
    ]:
        s = run_mode(tenants, engine, mode, thor, seed=7,
                     max_concurrent_episodes=concurrency, memo=memo,
                     model_max_batch=mb, device=device).summary()
        results[label] = s
        batch = ""
        if s["model_batched_steps"]:
            batch = (f"  batch_occ={s['model_batch_occupancy']:.2f} "
                     f"queue_delay={s['mean_model_queue_delay']:.2f}s")
        print(f"  {label:28s} makespan={s['makespan']:7.1f}  "
              f"auth_slowdown={s['mean_auth_slowdown']:.3f}  "
              f"qos_violations={s['qos_violations']:.0f}{batch}")
    serial = results["serial (no speculation)"]
    plain = results["bpaste+memo (queue serial)"]
    batched = results["bpaste+memo+batch"]
    print(f"  -> with the model-step queue serial, speculation barely moves "
          f"the edge box ({serial['makespan'] / plain['makespan']:.2f}x): "
          f"the queue IS the bottleneck")
    print(f"  -> batching the queue separates it: "
          f"{serial['makespan'] / batched['makespan']:.2f}x over serial, "
          f"authoritative protection intact")
    assert batched["makespan"] < serial["makespan"], "edge regime must separate"
    assert batched["mean_auth_slowdown"] <= 1.05 and batched["qos_violations"] == 0
    return results


def run_open_loop_demo(rate: float = 0.1, n_episodes: int = 16, concurrency: int = 4,
                       device: str = "cuda") -> Dict[str, dict]:
    """Open-loop arrivals with the full stack (result store, batched model
    steps, speculative steps, the shed ladder, adaptive linger) against
    serial. Returns each mode's summary by label, with ``_served`` tenants."""
    thor = Machine()
    engine = _engine()

    def source():
        return open_loop_source(WorkloadConfig(
            seed=42, n_episodes=n_episodes, open_loop_rate=rate,
            shared_frac=0.5, shared_pool=2))

    print(f"\nopen loop: tenants arrive at rate={rate}/s "
          f"(exponential inter-arrivals), concurrency={concurrency}:")
    results = {}
    for label, mode, stack in [
        ("serial (no speculation)", "serial", {}),
        ("bpaste+stack (shed+linger)", "bpaste",
         dict(memo=True, model_max_batch=8, spec_model_steps=True,
              shed_alpha=1.0, adaptive_linger=True)),
    ]:
        m = run_mode([], engine, mode, thor, seed=7,
                     max_concurrent_episodes=concurrency,
                     episode_source=source(), device=device, **stack)
        s = m.summary()
        s["_served"] = len(m.tenant_sojourn)
        results[label] = s
        shed = ""
        if s["shed_passes"]:
            shed = (f"  shed_passes={s['shed_passes']:.0f} "
                    f"peak_backlog={s['shed_peak_backlog']:.0f}")
        print(f"  {label:28s} p95_sojourn={s['p95_sojourn']:7.1f}s  "
              f"auth_slowdown={s['mean_auth_slowdown']:.3f}  "
              f"qos_violations={s['qos_violations']:.0f}{shed}")
    for s in results.values():
        assert s["_served"] == n_episodes, "every tenant must be served"
        assert s["mean_auth_slowdown"] <= 1.0 + 1e-9
        assert s["qos_violations"] == 0
    return results


def run_llm_demo(arch: str, n_episodes: int, device: str = "cuda") -> None:
    """A reduced ``arch`` with random weights on ``device``, served through
    ``serve_agent_loop`` with speculation off, then on."""
    cfg = get_config(arch).reduced()
    gen = torch.Generator(device=device).manual_seed(0)
    params = model_mod.init_params(cfg, gen, device=device)
    history = make_episodes(WorkloadConfig(seed=1, n_episodes=40))
    pe = PatternEngine(context_len=2, min_support=3).fit(episodes_to_traces(history))
    episodes = make_episodes(WorkloadConfig(seed=9, n_episodes=n_episodes))

    dt0, steps0, _, _ = serve_agent_loop(False, cfg, params, episodes, pe)
    dt1, steps1, hits, spec = serve_agent_loop(True, cfg, params, episodes, pe)
    print(f"baseline : {steps0} decode steps in {dt0:.1f}s")
    print(f"B-PASTE  : {steps1} decode steps in {dt1:.1f}s "
          f"(speculative slots admitted={spec.admitted}, promoted={spec.promotions}, "
          f"preempted={spec.preemptions}, hits={hits})")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.speculative_serving")
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--episodes", type=int, default=8,
                    help="tenants in the edge-box demo (LLM demo caps at 3)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="model-step micro-batch cap for the edge-box demo")
    ap.add_argument("--with-llm", action="store_true",
                    help="also serve a reduced LLM through serve_agent_loop")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run_edge_box_demo(n_episodes=args.episodes, max_batch=args.max_batch, device=args.device)
    run_open_loop_demo(device=args.device)
    if args.with_llm:
        run_llm_demo(args.arch, min(args.episodes, 3), device=args.device)


if __name__ == "__main__":
    main()
