"""Hygiene of the PyTorch port (src/repro_torch/).

* It imports without JAX and loads nothing of the JAX package.
* Its copies of the framework-free modules stay equal to the originals in
  src/repro/ outside their import lines (a drift guard), indented imports
  included, apart from the edits listed in EDITS.
* It calls no library attention and no torch.compile.
"""
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"

COPIED = [
    "core/events.py",
    "core/sandbox.py",
    "core/executor.py",
    "core/workload.py",
    "core/mining/prefixspan.py",
    "core/patterns.py",
    "core/hypothesis.py",
    "serving/spec_serving.py",
    "core/interference.py",
    "core/simulator.py",
    "core/safety.py",
    "core/memo.py",
    "core/model_service.py",
    "core/trace.py",
    "core/analysis.py",
    "core/runtime.py",
    "analysis.py",
    "data/pipeline.py",
    "launch/roofline.py",
] + sorted(str(p.relative_to(SRC / "repro")) for p in (SRC / "repro" / "configs").glob("*.py"))

# The copies may differ from their originals by these edits, applied to
# the original before the comparison: (regular expression, replacement),
# each pattern matching exactly once. The runtime gains the device of its
# tensor paths; four notes on the reference's own change history (which
# name its pull requests by number) are reworded.
HISTORY_NOTE = r"PR[ -]\d+(?:/\d+)?"
EDITS = {
    "core/model_service.py": [
        (rf"\({HISTORY_NOTE}'s ``serving/thor_c8``", "(the serving bench's ``serving/thor_c8``"),
    ],
    "core/memo.py": [
        (rf"^{HISTORY_NOTE}'s serving bench", "The serving bench"),
    ],
    "core/analysis.py": [
        (rf"scheduler \({HISTORY_NOTE}\) added", "scheduler added"),
    ],
    "core/runtime.py": [
        (rf"\(the {HISTORY_NOTE} reference", "(the earlier reference"),
        # RuntimeConfig gains the device of the tensor paths
        (re.escape('    mode: str = "bpaste"\n'),
         '    mode: str = "bpaste"\n'
         '    device: str = "cuda"          # where the scorer and the fused admission\n'
         '                                  # pass run their tensor paths ("cpu" in\n'
         '                                  # tests); the host numpy paths ignore it\n'),
        # ... and hands it to the scorer
        (re.escape("                             k_max=rcfg.beam_k, n_max=rcfg.max_nodes)\n"),
         "                             k_max=rcfg.beam_k, n_max=rcfg.max_nodes,\n"
         "                             device=rcfg.device)\n"),
    ],
}


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        parts = p.relative_to(SRC).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def test_port_imports_without_jax_or_repro():
    code = (
        "import json, sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"mods = {_port_modules()!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "print(json.dumps(sorted(k for k in sys.modules\n"
        "                        if k == 'repro' or k.startswith('repro.'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def _rewrite_imports(text: str) -> str:
    out = []
    for line in text.splitlines(keepends=True):
        stripped = line.lstrip()
        if stripped.startswith("from repro.") or stripped.startswith("import repro."):
            line = line.replace("repro.", "repro_torch.", 1)
        out.append(line)
    return "".join(out)


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_matches_original(rel):
    original = (SRC / "repro" / rel).read_text()
    for pattern, new in EDITS.get(rel, []):
        original, n = re.subn(pattern, lambda _m, new=new: new, original, flags=re.M)
        assert n == 1, f"src/repro/{rel} matches {pattern!r} {n} times, not once"
    copy = (PORT / rel).read_text()
    assert copy == _rewrite_imports(original), (
        f"src/repro_torch/{rel} drifted from src/repro/{rel} outside its import lines"
        + (" and its named edits" if rel in EDITS else ""))


@pytest.mark.parametrize("banned", ["scaled_dot_product_attention", "torch.compile",
                                    "import jax", "from jax", "from repro.", "import repro."])
def test_port_uses_no_library_attention_or_jax(banned):
    hits = [str(p.relative_to(SRC)) for p in PORT.rglob("*")
            if p.suffix in (".py", ".cu", ".cuh") and banned in p.read_text()]
    assert hits == [], f"{banned!r} found in {hits}"


@pytest.mark.parametrize("rel", ["launch/dist.py", "launch/shardings.py",
                                 "training/compression.py", "launch/dryrun.py",
                                 "launch/input_specs.py", "launch/mesh.py",
                                 "staticcheck.py"])
def test_multi_device_modules_are_the_ports_own(rel):
    """The multi-device and dry-run modules and the static checker are the port's own
    code, not copies: they are among the modules imported without JAX above, import
    no jax and no repro, and are not in COPIED (the drift guard)."""
    module = "repro_torch." + rel.removesuffix(".py").replace("/", ".")
    assert module in _port_modules() and rel not in COPIED
    text = (PORT / rel).read_text()
    assert not re.search(r"^\s*(import jax|from jax|import repro\.|from repro\.)", text, re.M)
