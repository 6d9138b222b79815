"""The readings that the correctness limits are set from, on the card:

    python3 -m portbench.calibrate --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, in one process, a run of the cell at its own load for
``--seconds`` (long enough to finish the mix's longest turns; the sample is
checked as a benchmark run checks it), then the same positions read by the
fp8 control, judged by the same limits (``harness.within``). Prints one
JSON line a seed: the program's widest served logit gap and ``correct``,
the control's and ``control_correct``. Exits 1 where a control reads
correct: the limits then fail to separate the two. The benchmark's own
runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from portbench.run import ROOT


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    torch.set_num_threads(1)
    from portbench.bench import find_cell
    from portbench.harness import run_cell

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = find_cell(args.workload, ROOT)
    passed = []
    for seed in args.seeds:
        out = run_cell(cell, seed % (2**63), args.seconds, False, "cuda", time.perf_counter(),
                       ROOT, control=True)
        ctrl = out["control_checks"]["served_logit_gap"]
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": out["correct"],
                          "served_logit_gap": out["checks"]["served_logit_gap"]["value"],
                          "control_correct": out["control_correct"],
                          "control_logit_gap": ctrl["value"], "limit": ctrl["limit"],
                          "tokens_checked": out["checks"]["served_tokens_checked"]["value"],
                          "turns_failed": out["checks"]["turns_failed"]["value"],
                          "memory_peak_bytes": out["device"]["memory_peak_bytes"]}), flush=True)
        if out["control_correct"]:
            passed.append(seed)
    if passed:
        print(f"calibrate: the control reads correct on seeds {passed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
