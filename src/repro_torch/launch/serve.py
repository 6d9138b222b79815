"""Serving driver: B-PASTE speculative agent serving on the batched engine.

An agent loop whose reasoning steps decode on the ServingEngine while tool
calls run on the host; B-PASTE speculates future branches into free batch
slots. Serves every arch of ``configs.ARCHS``, reduced, as the JAX
package's ``repro.launch.serve`` does: the dense family (qwen2-7b, the
default, granite-8b, deepseek-7b, mistral-nemo-12b), the MoE family
(mixtral-8x7b, qwen3-moe-30b-a3b), the vlm and audio backbones
(internvl2-76b, musicgen-medium; the loop feeds them token ids), the Mamba2
family (mamba2-2.7b) and the hybrid family (zamba2-1.2b: Mamba2 layers and
a shared attention block), unchanged: the engine copies whichever cache
leaves the model's prefill returns. Every family with attention, the
hybrid too, takes an int8 KV cache (``kv_cache_dtype="int8"`` in the
config). Runs on the GPU unless ``--device cpu`` is given:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b --episodes 3
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --episodes 3
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b --device cpu

``main`` mirrors ``repro.launch.serve`` (a reduced model; the loop there
admits no speculative slot). :func:`serve_agent_loop` is the loop that
does speculate: the port of the ``--with-llm`` demo in
``examples/speculative_serving.py``.

The sequence-sharded split-KV decode has no flag here, as in the JAX
package: the engine's ``mesh_info`` is its entry point. Build the engine
and hand it to the loop::

    cfg = dataclasses.replace(get_config("qwen2-7b"), sharded_decode_attn=True)
    mi = MeshContext(make_local_mesh(4), ("data",), "model", 4, 1)  # 4 shards, one card
    engine = ServingEngine(cfg, params, max_batch=4, max_len=192, mesh_info=mi)
    serve_agent_loop(True, cfg, engine, episodes, pattern_engine)

(``kv_cache_dtype="int8"`` in the same ``replace`` gives the int8 cache.)
Over a mesh of processes every rank builds the same engine with
``mesh_info=mesh_context(make_dist_mesh(n))`` (``launch.mesh``,
``models.model``) and runs the same loop: the ranks step in lockstep, each
holding its slice of the cache, and sample the same tokens.
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core.events import Event
from repro_torch.core.hypothesis import HypothesisBuilder
from repro_torch.core.patterns import PatternEngine
from repro_torch.core.workload import WorkloadConfig, episodes_to_traces, make_episodes
from repro_torch.models import model as model_mod
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.spec_serving import SlotSpeculator, render_observation


def serve_agent_loop(spec_on: bool, cfg, engine_or_params, episodes, pattern_engine,
                     reason_tokens: int = 5):
    """Serve ``episodes`` on one engine, speculating with ``pattern_engine``
    when ``spec_on``. ``engine_or_params`` is a ServingEngine, or params from
    which one is built (max_batch=4, max_len=192, on the params' device).
    Returns (seconds, decode_steps, promotion hits, the SlotSpeculator)."""
    if isinstance(engine_or_params, ServingEngine):
        eng = engine_or_params
    else:
        eng = ServingEngine(cfg, engine_or_params, max_batch=4, max_len=192,
                            device=engine_or_params["embed"].device)
    spec = SlotSpeculator(eng, budget_slots=2)
    builder = HypothesisBuilder(pattern_engine)
    decode_steps = 0
    hits = 0
    t0 = time.time()
    for ep in episodes:
        history = []
        prompt = [2, 3, 4]
        eng.add_request(prompt, request_id=ep.eid)
        for step in ep.steps[:4]:
            # reasoning: decode a few tokens on the authoritative slot
            for _ in range(reason_tokens):
                eng.step()
                decode_steps += 1
            # while the tool "runs", speculate likely continuations
            if spec_on and history:
                hyps = builder.build(history, beam_width=3)
                spec.admit([(h, h.q) for h in hyps], history_prompt=prompt)
                for _ in range(3):          # tool latency window
                    eng.step()
                    decode_steps += 1
            obs_ids = render_observation(step.tool, {}, f"pred:{step.tool}", cfg.vocab_size)
            got = spec.match_and_promote(obs_ids, ep.eid) if spec_on else None
            if got is not None:
                hits += 1
            history.append(Event("tool", step.tool, dict(step.args), {"ok": True}))
        spec.squash_all()
        for s in eng.slots:
            s.active = False
            s.request_id = None
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    return time.time() - t0, decode_steps, hits, spec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--episodes", type=int, default=3)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=160)
    ap.add_argument("--spec-slots", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = model_mod.init_params(cfg, gen, device=args.device)
    engine = ServingEngine(cfg, params, max_batch=args.max_batch, max_len=args.max_len,
                           device=args.device)
    spec = SlotSpeculator(engine, budget_slots=args.spec_slots)

    # mine patterns offline
    train_eps = make_episodes(WorkloadConfig(seed=1, n_episodes=40))
    PatternEngine(context_len=2, min_support=3).fit(episodes_to_traces(train_eps))

    eps = make_episodes(WorkloadConfig(seed=9, n_episodes=args.episodes))
    obs.record(True)
    total_steps = 0
    for ep in eps:
        prompt = [2, 3, 4]
        engine.add_request(prompt, request_id=ep.eid)
        # decode a few reasoning tokens per agent step; tools interleave
        for step in ep.steps[: 4]:
            for _ in range(6):
                engine.step()
                total_steps += 1
            obs_ids = render_observation(step.tool, step.args, "auth", cfg.vocab_size)
            spec.match_and_promote(obs_ids, ep.eid)
        for s in engine.slots:
            if s.request_id == ep.eid:
                s.active = False
                s.request_id = None
    obs.record(False)
    print(f"served {args.episodes} episodes, {total_steps} decode steps; "
          f"a step {_median_ms('serving.step')} ms of host wall, "
          f"{_median_ms('serving.step.readback')} ms of it waiting on the tokens (medians), "
          f"promotions={spec.promotions} preemptions={spec.preemptions}")


def _median_ms(name: str) -> str:
    """The median host ms of the recorded spans called ``name``."""
    ms = [(s.end_ns - s.start_ns) * 1e-6 for s in obs.spans() if s.name == name]
    return f"{statistics.median(ms):.3f}" if ms else "-"


if __name__ == "__main__":
    main()
