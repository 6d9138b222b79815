"""Nothing the benchmark runs loads JAX or the JAX package, and nothing
reads the JAX package's benchmarks; top-level names are compared whole
(``repro_torch`` begins with ``repro``)."""
from __future__ import annotations

import json
import os
import subprocess
import sys

from portbench.run import forbidden_modules

from conftest import HERE

ROOT = HERE.parent


def test_forbidden_modules_compares_whole_top_level_names():
    assert forbidden_modules(["repro_torch", "repro_torch.models.model", "jaxtyping",
                              "reprolib", "portbench.run"]) == []
    assert forbidden_modules(["repro.core.workload", "jax.numpy", "flax", "jaxlib.xla"]) == \
        ["flax", "jax", "jaxlib", "repro"]


def test_what_a_run_loads(tmp_path):
    """A whole run of a tiny cell on the CPU, in a fresh process, then the
    loaded modules, as ``portbench.run`` reads them after the window."""
    code = (
        "import sys, json, time\n"
        "sys.path[:0] = ['src', '.', 'portbench/tests']\n"
        "import torch; torch.set_num_threads(2)\n"
        "from pathlib import Path\n"
        "from conftest import write_tree\n"
        "from portbench.bench import find_cell\n"
        "from portbench.harness import run_cell\n"
        "import portbench.run, portbench.calibrate\n"
        f"root = write_tree(Path({str(tmp_path)!r}))\n"
        "out = run_cell(find_cell('tiny-dense.tiny-spec', root), 1, 0.5, False, 'cpu',\n"
        "               time.perf_counter(), root, log=lambda *a, **k: None)\n"
        "assert out['correct'], out\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    names = json.loads(out.stdout.strip().splitlines()[-1])
    assert forbidden_modules(names) == []
    assert "repro_torch" in names and "benchmarks" not in names


def test_the_reference_imports_nothing_of_the_program():
    code = (
        "import sys, json\n"
        "sys.path[:0] = ['.']\n"
        "import portbench.reference.dense, portbench.reference.mamba2, portbench.reference.quant\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=240, check=True)
    names = json.loads(out.stdout.strip().splitlines()[-1])
    assert not {"repro_torch", "repro", "jax", "benchmarks"} & set(names)


def test_no_source_names_the_jax_package_or_its_benchmarks():
    for path in HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        for line in path.read_text().splitlines():
            words = line.replace("(", " ").replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                top = words[1].split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "repro", "benchmarks"), (path, line)
