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
# tensor paths; the configs' base, the fields of Zamba2's shared blocks;
# four notes on the reference's own change history (which
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
    "configs/base.py": [
        # ModelConfig gains the fields of Zamba2's shared blocks (unset, they
        # keep the Zamba-style block) ...
        (re.escape('    attn_every: int = 0               # hybrid: shared attn block after layers i%attn_every==attn_every-1\n'),
         '    attn_every: int = 0               # hybrid: shared attn block after layers i%attn_every==attn_every-1\n'
         + (
            "    # --- Zamba2's shared transformer blocks (hybrid; unset, the Zamba-style\n"
            '    # block above: one attention block added to the residual) ---\n'
            "    # the layers whose Mamba2 input takes a shared block's output, in order\n"
            "    # (Zamba2's hybrid_layer_ids); None: the Zamba-style block after every\n"
            '    # attn_every-th layer. Set, there are n_layers // attn_every of them, and\n'
            '    # each block reads concat(h, embeddings) and runs a gated-GELU MLP of d_ff.\n'
            '    hybrid_sites: Optional[Tuple[int, ...]] = None\n'
            '    n_shared_blocks: int = 1          # site k runs shared block k % n_shared_blocks\n'
            "    shared_lora_rank: int = 0         # rank of each site's own LoRA on the MLP's gate_up\n"
        )),
        # ... and the checks of the sites and the attention scale
        (re.escape('    # ------------------------------------------------------------------\n    @property\n    def resolved_head_dim(self) -> int:\n'),
         (
            '    def __post_init__(self):\n'
            '        if self.hybrid_sites is None:\n'
            '            if (self.n_shared_blocks, self.shared_lora_rank) != (1, 0):\n'
            '                raise ValueError("more than one shared block, or a LoRA, needs hybrid_sites "\n'
            '                                 "(the Zamba2 order)")\n'
            '            return\n'
            '        sites = tuple(int(i) for i in self.hybrid_sites)\n'
            '        object.__setattr__(self, "hybrid_sites", sites)   # a JSON list, hashable now\n'
            '        if self.family != "hybrid" or not self.attn_every:\n'
            '            raise ValueError("hybrid_sites belong to a hybrid config with attn_every")\n'
            '        if len(sites) != self.n_layers // self.attn_every:\n'
            '            raise ValueError(f"{len(sites)} hybrid_sites, but the cache holds "\n'
            '                             f"n_layers // attn_every = {self.n_layers // self.attn_every}")\n'
            '        if list(sites) != sorted(set(sites)) or not 0 <= sites[0] <= sites[-1] < self.n_layers:\n'
            '            raise ValueError(f"hybrid_sites {sites} must rise strictly within the layers")\n'
            '        if self.n_shared_blocks < 1 or self.shared_lora_rank < 1:\n'
            '            raise ValueError("the Zamba2 order needs a shared block and each site\'s LoRA")\n'
            '\n'
            '    @property\n'
            '    def attn_scale(self) -> float:\n'
            '        """The attention scores\' scale: (head_dim / 2)^-0.5 in the Zamba2\n'
            '        order, as published, else head_dim^-0.5."""\n'
            '        hd = self.resolved_head_dim\n'
            '        return (hd / 2 if self.hybrid_sites is not None else hd) ** -0.5\n'
            '\n'
        )
         + '    # ------------------------------------------------------------------\n    @property\n    def resolved_head_dim(self) -> int:\n'),
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
                                 "staticcheck.py", "obs.py"])
def test_multi_device_modules_are_the_ports_own(rel):
    """The multi-device and dry-run modules and the static checker are the port's own
    code, not copies: they are among the modules imported without JAX above, import
    no jax and no repro, and are not in COPIED (the drift guard)."""
    module = "repro_torch." + rel.removesuffix(".py").replace("/", ".")
    assert module in _port_modules() and rel not in COPIED
    text = (PORT / rel).read_text()
    assert not re.search(r"^\s*(import jax|from jax|import repro\.|from repro\.)", text, re.M)
