"""The traced-cell matrix of ``test_torch_dryrun_cells_*.py``: the cells,
the subprocess that runs them on one fake mesh, and the checks of a
record."""
import json
import math
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMILIES = {"dense": "qwen2-7b", "moe": "qwen3-moe-30b-a3b", "ssm": "mamba2-2.7b",
            "hybrid": "zamba2-1.2b", "vlm": "internvl2-76b", "audio": "musicgen-medium"}
SIZES = {"train": (64, 8), "prefill": (64, 8), "decode": (64, 8)}


def _cells():
    cells = []
    for family, arch in FAMILIES.items():
        for kind, (seq, batch) in SIZES.items():
            cells.append({"id": f"{family}-{kind}", "arch": arch, "kind": kind, "seq": seq,
                          "batch": batch})
    cells.append({"id": "dense-train-fsdp", "arch": "qwen2-7b", "kind": "train", "seq": 64,
                  "batch": 8, "fsdp": True, "overrides": {"fsdp_act_constraint": True}})
    cells.append({"id": "moe-train-zero-opt", "arch": "qwen3-moe-30b-a3b", "kind": "train",
                  "seq": 64, "batch": 8, "zero_opt": True})
    cells.append({"id": "moe-train-window", "arch": "mixtral-8x7b", "kind": "train",
                  "seq": 64, "batch": 8, "overrides": {"sliding_window": 32}})
    return cells


CELLS = _cells()


def traced(mesh, cells=CELLS, timeout=900):
    """run_cell's records of ``cells`` on a fake mesh (sizes, names), in a
    subprocess of its own."""
    arg = [dict(c, mesh=mesh[0], names=mesh[1]) for c in cells]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(ROOT / "tests" / "torch_dryrun_cells.py"), "port",
                        json.dumps(arg)], capture_output=True, text=True, env=env,
                       timeout=timeout, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def check_cell(cell, rec, mesh):
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["devices"] == math.prod(mesh[0])
    assert rec["kind"] == cell["kind"]
    assert rec["flops_per_device"] > 0 and rec["compute_term_s"] > 0
    assert rec["memory_term_s"] > 0 and rec["analytic_bytes_per_device"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    # the model axis of every cell splits something: there are collectives
    assert rec["collectives"] and rec["collective_term_s"] > 0
    assert all(c["count"] > 0 and c["group"] > 1 for c in rec["collectives"].values())
    args = rec["memory_analysis"]["argument_bytes"]
    if cell["kind"] == "train":
        # rank 0's blocks of params, optimizer state and batch are the specs' bytes
        assert args == rec["state_bytes_per_device"] + rec["batch_bytes_per_device"]
    elif cell["kind"] == "prefill":
        assert args >= rec["param_bytes_per_device"]
    else:
        assert args > rec["param_bytes_per_device"] + rec["cache_bytes_per_device"]
    impl = rec.get("attn_impl", rec.get("ssd_impl"))
    assert impl == "plain"
