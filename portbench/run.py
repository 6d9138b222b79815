"""The benchmark's one command:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout (``src`` is put on the path here). It
loads, warms up and ramps the cell, measures for ``--seconds``, checks what
the window served against the plain reference, and prints one JSON line
last on standard output: the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``. The numbers the check compared,
each beside its limit, are the last lines on standard error and the last
key of that line. It exits non-zero, printing no result, without a CUDA
card, or if JAX or the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()  # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names) -> list:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's or the JAX package's."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    torch.set_num_threads(1)    # one process, one host thread of CPU work: steadier runs

    from portbench.bench import find_cell
    from portbench.harness import run_cell

    cell = find_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    seed = args.seed % (2**63)
    out = run_cell(cell, seed, args.seconds, bool(args.trace), "cuda", T0, ROOT)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
