"""``python -m repro.analysis`` — the speculation-safety static analyzer CLI.

Runs the full static pass from :mod:`repro.core.analysis` against a real
configuration: the eligibility policy, the DEFAULT_TOOLS registry, a seeded
synthetic workload, the pattern tables mined from it, and — unlike the
runtime-constructor pass — commit-barrier placement (R4) on beams actually
assembled from that workload's trace prefixes.  CI runs this on every push
with the default policy/workload and fails on ANY finding; operators run it
against their own policy overrides before enabling speculation.

Exit status: 0 when the report is clean, 1 when it has findings (2 under
``--strict`` if any finding is an *error*, so pipelines can distinguish).

``--sanitize-smoke`` additionally executes a small seeded serving run with
``RuntimeConfig.sanitize=True`` and folds any runtime-sanitizer findings
(S1–S5) into the same report — a seconds-scale end-to-end cross-check of the
event scheduler's caches, dirty sets, and counter groups.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.core.analysis import AnalysisReport, analyze_static, exit_code
from repro_torch.core.hypothesis import HypothesisBuilder
from repro_torch.core.patterns import PatternEngine
from repro_torch.core.runtime import BPasteRuntime, RuntimeConfig
from repro_torch.core.safety import (
    FULL_POLICY,
    PREP_ONLY_POLICY,
    READ_ONLY_POLICY,
    EligibilityPolicy,
)
from repro_torch.core.workload import WorkloadConfig, episodes_to_traces, make_episodes

POLICIES = {
    "full": FULL_POLICY,
    "read_only": READ_ONLY_POLICY,
    "prep_only": PREP_ONLY_POLICY,
}


def _build_beams(engine: PatternEngine, traces, max_hyps: int = 200):
    """Assemble beams from every trace prefix (the states the runtime would
    actually build at) until ``max_hyps`` hypotheses are collected — R4 wants
    REAL assembled trees, not synthetic fixtures."""
    builder = HypothesisBuilder(engine=engine)
    hyps = []
    for trace in traces:
        for cut in range(1, len(trace)):
            hyps.extend(builder.build(trace[:cut]))
            if len(hyps) >= max_hyps:
                return hyps
    return hyps


def _sanitize_smoke(policy: EligibilityPolicy, engine: PatternEngine,
                    report: AnalysisReport, seed: int) -> None:
    """Seconds-scale serving run with the runtime sanitizer on: S1–S5 checks
    fire on the sampled tick schedule, findings fold into ``report``."""
    eps = make_episodes(WorkloadConfig(
        seed=seed, n_episodes=8, arrival_stagger=2.0,
        shared_frac=0.5, shared_pool=2))
    rt = BPasteRuntime(
        eps, engine, policy=policy,
        rcfg=RuntimeConfig(seed=7, max_concurrent_episodes=4,
                           model_max_batch=4, sanitize=True,
                           sanitize_every=3, analysis="off"))
    rt.run()
    assert rt.sanitizer is not None
    report.extend(rt.sanitizer.report)
    report.meta["sanitize_smoke_ticks"] = rt.metrics.sched_ticks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro.analysis",
        description="Static speculation-safety analysis (rules R1-R4).")
    ap.add_argument("--policy", choices=sorted(POLICIES), default="full",
                    help="eligibility policy preset to analyze")
    ap.add_argument("--seed", type=int, default=1,
                    help="workload seed for mining + beam assembly")
    ap.add_argument("--episodes", type=int, default=20,
                    help="synthetic episodes to mine patterns from")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write the report as JSON ('-' for stdout)")
    ap.add_argument("--strict", action="store_true",
                    help="exit 2 when any finding is an error")
    ap.add_argument("--sanitize-smoke", action="store_true",
                    help="also run a small serving workload under "
                         "RuntimeConfig.sanitize=True (checks S1-S5)")
    args = ap.parse_args(argv)

    policy = POLICIES[args.policy]
    eps = make_episodes(WorkloadConfig(seed=args.seed,
                                       n_episodes=args.episodes))
    traces = episodes_to_traces(eps)
    engine = PatternEngine(context_len=2, min_support=3).fit(traces)
    hyps = _build_beams(engine, traces)

    report = analyze_static(policy, engine, hyps)
    if args.sanitize_smoke:
        _sanitize_smoke(policy, engine, report, args.seed)

    print(report.render())
    print(f"(policy={args.policy}, {len(engine.patterns)} patterns, "
          f"{report.meta.get('barrier_checked_hyps', 0)} beams checked, "
          f"{len(report.meta.get('write_conflicts', []))} may-overlap "
          f"write pairs)")
    if args.json:
        payload = json.dumps(report.to_json(), indent=2)
        if args.json == "-":
            print(payload)
        else:
            with open(args.json, "w") as fh:
                fh.write(payload + "\n")
    return exit_code(report, strict=args.strict)


if __name__ == "__main__":
    sys.exit(main())
