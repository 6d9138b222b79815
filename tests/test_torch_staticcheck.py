"""The port's static checker, ``repro_torch.staticcheck``, against the JAX
package's, ``repro.staticcheck``, and on its own rules.

* C1 (mutation coverage) and C4 (dispatch shape) are the JAX checker's
  rules: over either package's tree, and on every snippet of
  ``tests/test_staticcheck.py``'s kinds, the two checkers give the same
  findings and the same baselined sites.
* C2 (host syncs in the counterparts of the jitted scopes and their reach)
  and C3 (private torch imports) are the port's own: a firing and a clean
  snippet for each construct.
* The registry ``CAPTURE_SCOPES`` covers every ``jax.jit`` of the JAX
  package, with the static names the port kept.
* The default tree is clean, and the CLI runs with torch hidden.
"""
import ast
import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

import repro.staticcheck as ref  # noqa: E402
from repro_torch import staticcheck as sc  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
C1_C4 = ("C1-mutation", "C4-dispatch")


def _sites(report, rules=C1_C4):
    found = sorted((f.rule, f.site) for f in report.findings if f.rule in rules)
    base = sorted((b["rule"], b["site"]) for b in report.meta.get("baselined", [])
                  if b["rule"] in rules)
    return found, base


def _c2(report):
    return [f for f in report.findings if f.rule == "C2-sync"]


# ======================================================================
# C1 and C4: the JAX checker's rules, the JAX checker's results
# ======================================================================

@pytest.mark.parametrize("tree", ["repro", "repro_torch"])
def test_trees_give_the_jax_checkers_c1_c4_sites(tree):
    mine, theirs = sc.check_tree(SRC / tree), ref.check_tree(SRC / tree)
    assert _sites(mine) == _sites(theirs)
    found, base = _sites(mine)
    assert found == [] and base == [
        ("C1-mutation", "core/runtime.py:BPasteRuntime._launch_frontier"),
        ("C1-mutation", "core/runtime.py:BPasteRuntime._refresh_beam")]
    assert mine.meta["files_checked"] == theirs.meta["files_checked"]


def _cls(name, *methods):
    return f"class {name}:\n" + "".join(textwrap.indent(textwrap.dedent(m), "    ")
                                          for m in methods)


SNIPPETS = {
    # C1: one firing and one clean snippet of each case
    "unmarked-write": ("core/runtime.py", _cls("R", """
        def bad(self, es):
            es.pending_action = None
        """)),
    "marked-write": ("core/runtime.py", _cls("R", """
        def good(self, es):
            es.pending_action = None
            self._mark_dirty(es)
        """)),
    "mutator-method": ("core/runtime.py", _cls("R", """
        def bad(self, es):
            es.history.append(1)
        """)),
    "mutator-method-marked": ("core/runtime.py", _cls("R", """
        def good(self, es):
            es.history.append(1)
            self._finish_action(es)
        """)),
    "one-branch-unmarked": ("core/runtime.py", _cls("R", """
        def bad(self, es, flag):
            es.phase = 1
            if flag:
                self._mark_dirty(es)
        """)),
    "both-branches-marked": ("core/runtime.py", _cls("R", """
        def good(self, es, flag):
            es.phase = 1
            if flag:
                self._mark_dirty(es)
            else:
                self._mark_dirty_eid(es.eid)
        """)),
    "early-return": ("core/runtime.py", _cls("R", """
        def bad(self, es, flag):
            es.phase = 1
            if flag:
                return
            self._mark_dirty(es)
        """)),
    "early-return-marked": ("core/runtime.py", _cls("R", """
        def good(self, es, flag):
            es.phase = 1
            self._mark_dirty(es)
            if flag:
                return
        """)),
    "init-exempt": ("core/runtime.py", _cls("R", """
        def __init__(self):
            self.history = []
        """)),
    "init-write-elsewhere": ("core/runtime.py", _cls("R", """
        def reset(self):
            self.history = []
        """)),
    "pair-group-partial": ("core/runtime.py", _cls("NR", """
        def bad(self, nr):
            nr.args_cache = {}
        """)),
    "pair-group-full": ("core/runtime.py", _cls("NR", """
        def good(self, nr):
            nr.args_cache = {}
            nr.args_epoch = -1
        """)),
    "ban-rule-exempt-site": ("core/simulator.py", _cls("Simulator", """
        def set_speculative(self, job):
            job.speculative = True
        """)),
    "ban-rule-other-site": ("core/simulator.py", _cls("Simulator", """
        def set_speculative(self, job):
            job.speculative = True
        def other(self, job):
            job.priority = 2
        """)),
    "alias-write": ("core/simulator.py", _cls("Simulator", """
        def bad(self, key):
            g = self._groups.get(key)
            g.append(1)
        """)),
    "alias-write-cleared": ("core/simulator.py", _cls("Simulator", """
        def good(self, key):
            g = self._groups.get(key)
            g.append(1)
            self._demand_cache.clear()
        """)),
    "tombstone-write": ("core/simulator.py", _cls("Simulator", """
        def good(self, job):
            job._rate = 2.0
            self._live.pop(job.jid, None)
        """)),
    "live-write-unbumped": ("core/executor.py", """
        def bad(state):
            state.M.set("k", 1)
        """),
    "live-write-bumped": ("core/executor.py", """
        def good(state):
            state.M.set("k", 1)
            bump_if_live(state)
        """),
    "baselined-site": ("core/runtime.py", _cls("BPasteRuntime", """
        def _launch_frontier(self, nr):
            nr.status = 'reused'
        """)),
    # C4
    "unbucketed-pack": ("core/admission.py", """
        def repack(hyps, n_max):
            return pack_beam(hyps, len(hyps), n_max)
        """),
    "bucketed-pack": ("core/admission.py", """
        def repack(hyps, k_max, n_max):
            return pack_beam(hyps, bucket_k(len(hyps), k_max), n_max)
        """),
    "pack-at-k-max": ("core/scoring.py", _cls("Scorer", """
        def score(self, hyps):
            return pack_beam(hyps, self.k_max, self.n_max)
        """)),
    "pack-through-local-bucket": ("core/admission.py", """
        def repack(hyps, k_max, n_max):
            k = bucket_k(len(hyps), k_max)
            return pack_beam(hyps, k, n_max)
        """),
    "admit-outside-wrapper": ("core/runtime.py", """
        def sneaky(packed):
            return admit_beam(packed.node_lat, n_nodes=8)
        """),
    "admit-in-wrapper": ("core/admission.py", """
        def fused_admit(packed):
            return admit_beam(packed.node_lat, n_nodes=8)
        """),
    "score-outside-wrapper": ("core/admission.py", """
        def greedy_admit(tabs):
            return score_beam(**tabs, n_nodes=8)
        """),
    "score-in-wrapper": ("core/scoring.py", _cls("Scorer", """
        def score(self, tabs):
            return score_beam(**tabs, n_nodes=8)
        """)),
}
FIRES = {"unmarked-write", "mutator-method", "one-branch-unmarked", "early-return",
         "init-write-elsewhere", "pair-group-partial", "ban-rule-other-site", "alias-write",
         "live-write-unbumped", "unbucketed-pack", "admit-outside-wrapper",
         "score-outside-wrapper"}


@pytest.mark.parametrize("case", sorted(SNIPPETS))
def test_snippet_gives_the_jax_checkers_result(case):
    relpath, src = SNIPPETS[case]
    src = textwrap.dedent(src)
    mine, theirs = sc.check_source(src, relpath), ref.check_source(src, relpath)
    assert _sites(mine) == _sites(theirs)
    assert [f.rule for f in mine.findings] == [f.rule for f in theirs.findings]
    assert bool(mine.findings) == (case in FIRES), mine.render()
    assert bool(mine.meta.get("baselined")) == (case == "baselined-site")


def test_syntax_error_reported_not_raised():
    report = sc.check_source("def broken(:\n", "core/x.py")
    assert [f.rule for f in report.findings] == ["C0-syntax"]


# ======================================================================
# C2: host syncs in the capture scopes and their reach
# ======================================================================

HEADER = ("import numpy as np\nimport torch\nfrom torch.distributed.tensor import DTensor\n"
          "from typing import Any, Dict, Optional\nfrom repro_torch.configs.base import ModelConfig\n")
SIGNATURE = ("params, cfg: ModelConfig, cache: Dict[str, Any], tokens: torch.Tensor, n: int = 1, "
             "active: Optional[torch.Tensor] = None")


def _scope(body, signature=SIGNATURE, extra="", **modules):
    """A models/model.py whose decode_step (a capture scope) has ``body``,
    checked with the other modules given (``models__attention`` for
    models/attention.py)."""
    src = (HEADER + extra + f"\n\ndef decode_step({signature}):\n"
           + textwrap.indent(textwrap.dedent(body), "    "))
    sources = {"models/model.py": src}
    sources.update({k.replace("__", "/") + ".py": HEADER + textwrap.dedent(v)
                    for k, v in modules.items()})
    return sc.check_sources(sources)


SYNCS = {
    "item": "x = tokens.sum().item()\n",
    "tolist": "ids = tokens.tolist()\n",
    "cpu": "h = tokens.cpu()\n",
    "numpy": "a = tokens.numpy()\n",
    "to-cpu": 'h = tokens.to("cpu")\n',
    "to-device-cpu": 'h = tokens.to(device="cpu")\n',
    "synchronize": "torch.cuda.synchronize()\n",
    "stream-synchronize": "torch.cuda.current_stream().synchronize()\n",
    "nonzero-method": "i = tokens.nonzero()\n",
    "torch-nonzero": "i = torch.nonzero(tokens)\n",
    "torch-unique": "u = torch.unique(tokens)\n",
    "masked-select": "m = torch.masked_select(tokens, tokens > 0)\n",
    "one-arg-where": "w = torch.where(tokens > 0)\n",
    "tensor-of-host-data": "t = torch.tensor([1, 2], device=tokens.device)\n",
    "as-tensor-of-host-data": 'a = torch.as_tensor(np.arange(3), device="cuda")\n',
    "int-of-tensor": "k = int(tokens.max())\n",
    "float-of-tensor": "f = float(tokens.sum())\n",
    "bool-of-tensor": "b = bool(tokens.any())\n",
    "if-any": "if tokens.any():\n    pass\n",
    "if-all": "if (tokens > 0).all():\n    pass\n",
    "while": "while tokens.sum() > 0:\n    tokens = tokens - 1\n",
    "assert": "assert (tokens >= 0).all()\n",
    "conditional-expression": "y = 1 if tokens.max() > 3 else 2\n",
    "and": "if n > 1 and tokens.sum() > 0:\n    pass\n",
    "not": "if not tokens.any():\n    pass\n",
    "and-outside-a-test": "y = tokens.any() and n\n",
    "comparison-of-tensors": "if tokens[0] == tokens[1]:\n    pass\n",
    "comprehension-filter": "xs = [t for t in params['blocks'] if t.sum() > 0]\n",
    "unannotated-parameter": "if params['w'].sum() > 0:\n    pass\n",
    "optional-tensor-parameter": "if active is not None and active.any():\n    pass\n",
    "from-a-torch-call": "m = torch.zeros(3)\nif m.sum() > 0:\n    pass\n",
    "from-arithmetic": "m = tokens * 2\nif m[0] > 1:\n    pass\n",
    "from-a-cache-entry": "lengths = cache['lengths']\nif lengths.max() > 8:\n    pass\n",
    "loop-item-of-params": "for blk in params['blocks']:\n    if blk['ln'].sum() > 0:\n        pass\n",
    "unpacked-from-a-tuple": "a, b = torch.chunk(tokens, 2)\nif a.any():\n    pass\n",
    "functional-alias": "F = torch.nn.functional\ny = F.relu(tokens)\nif y.any():\n    pass\n",
}


@pytest.mark.parametrize("case", sorted(SYNCS))
def test_c2_sync_construct_fires(case):
    found = _c2(_scope(SYNCS[case]))
    assert len(found) == 1, [f.detail for f in found]
    assert found[0].site == "models/model.py:decode_step"
    assert "[reached from models/model.py:decode_step]" in found[0].detail


def test_c2_dtensor_parameter_is_a_tensor():
    found = _c2(_scope("if h.sum() > 0:\n    pass\n", signature="params, cfg, h: DTensor"))
    assert len(found) == 1


CLEAN = {
    "casts": "a = tokens.float()\nb = tokens.int()\nc = tokens.long()\nif a is None:\n    pass\n",
    "is-none": "if active is None or active is not None:\n    pass\n",
    "isinstance": "if isinstance(tokens, torch.Tensor) and not isinstance(cache, dict):\n    pass\n",
    "grad-enabled": "if torch.is_grad_enabled():\n    pass\n",
    "metadata": ("if (tokens.shape[0] > 1 or tokens.size(0) > 1 or tokens.dim() == 2\n"
                 "        or tokens.ndim == 2 or tokens.numel() > 3 or tokens.is_cuda\n"
                 "        or tokens.requires_grad or tokens.stride(0) == 1\n"
                 "        or tokens.data_ptr() == 0 or tokens.is_contiguous()\n"
                 "        or tokens.dtype == torch.int32 or tokens.device.type == 'cuda'):\n"
                 "    pass\n"),
    "int-of-a-shape": "k = int(tokens.shape[0])\nf = float(n)\n",
    "loop-over-blocks": "h = tokens\nfor i, blk in enumerate(params['blocks']):\n"
                        "    h = h + blk['w']\n    if i == n:\n        break\n",
    "int-parameter": "if n > 1:\n    pass\nwhile n > 0:\n    n -= 1\nassert n == 0\n",
    "cfg": "if cfg.sliding_window is not None and cfg.n_layers > 2:\n    pass\n",
    "three-argument-where": "w = torch.where(tokens > 0, tokens, 0)\n",
    "tensor-of-a-tensor": "t = torch.as_tensor(tokens, device='cuda')\n",
    "host-tensor": "t = torch.tensor([1, 2])\nu = torch.as_tensor([3], device='cpu')\n",
    "to-a-device": "t = tokens.to(tokens.device)\nu = tokens.to(torch.float32)\n",
    "item-of-host-values": "xs = [1, 2]\nv = xs.pop()\nif v:\n    pass\n",
    "container-truth": "st = cache or {}\nif cache and not cache:\n    pass\n",
    "unpacked-container-items": ("specs = {'a': (tokens, (3,), torch.int32)}\n"
                                "for name, (t, shape, dtype) in specs.items():\n"
                                "    if t.shape != shape or t.dtype != dtype:\n"
                                "        pass\n"),
    "private-foreach-call": "torch._foreach_mul_([tokens], 2.0)\n",
}


@pytest.mark.parametrize("case", sorted(CLEAN))
def test_c2_non_sync_form_is_clean(case):
    report = _scope(CLEAN[case])
    assert not report.findings, report.render()


def test_c2_static_scope_parameter_is_clean():
    # kernels/ops.py:flash_attention's impl is static in CAPTURE_SCOPES,
    # unannotated or not
    src = HEADER + textwrap.dedent("""
        def flash_attention(q, k, v, *, causal=True, window=None, scale=None, impl="auto"):
            if impl == "ref" or causal or (window is not None and window > 3):
                return q
            return q * scale
        """)
    assert not sc.check_source(src, "kernels/ops.py").findings


def test_c2_outside_any_scope_is_not_checked():
    src = HEADER + "def helper(t: torch.Tensor):\n    return t.item()\n"
    assert not sc.check_source(src, "models/model.py").findings


CROSS_MODULE = {
    "module-alias": ("from repro_torch.models import attention as attn_mod",
                     "y = attn_mod.helper(tokens)\n"),
    "imported-function": ("from repro_torch.models.attention import helper",
                          "y = helper(tokens)\n"),
    "import-as": ("import repro_torch.models.attention as am", "y = am.helper(tokens)\n"),
    "passed-by-name": ("from repro_torch.models.attention import helper",
                       "ys = list(map(helper, [tokens]))\n"),
}


@pytest.mark.parametrize("case", sorted(CROSS_MODULE))
def test_c2_follows_calls_across_modules(case):
    extra, body = CROSS_MODULE[case]
    report = _scope(body, extra=extra, models__attention="def helper(t):\n    return t.item()\n")
    found = _c2(report)
    assert [f.site for f in found] == ["models/attention.py:helper"], report.render()
    assert report.meta["functions_reached"] == 2


def test_c2_follows_calls_transitively_and_visits_each_once():
    report = _scope("a = first(tokens)\nb = first(tokens)\n", extra=textwrap.dedent("""
        def first(t):
            return second(t) + second(t)

        def second(t):
            return torch.tensor([t.sum().item()], device=t.device)
        """))
    found = _c2(report)       # .item() and torch.tensor() of its value, flagged once each
    assert len(found) == 2 and len({f.detail.split(":")[0] for f in found}) == 1
    assert {f.site for f in found} == {"models/model.py:second"}
    assert report.meta["functions_reached"] == 3


def test_c2_types_a_callee_from_its_call_sites():
    helper = textwrap.dedent("""
        def helper(t, k):
            if k > 1:
                return t
            return t * 2
        """)
    clean = _scope("y = helper(tokens, n)\n", extra=helper)
    assert not clean.findings, clean.render()
    fires = _scope("y = helper(tokens, tokens.sum())\n", extra=helper)
    assert [f.site for f in _c2(fires)] == ["models/model.py:helper"]


def test_c2_follows_an_autograd_functions_apply():
    extra = textwrap.dedent("""
        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, k):
                return x * k if k > 1 else x

            @staticmethod
            def backward(ctx, g):
                return g * float(g.sum()), None
        """)
    report = _scope("y = Fn.apply(tokens, n)\n", extra=extra)
    assert [f.site for f in _c2(report)] == ["models/model.py:Fn.backward"], report.render()


@pytest.mark.parametrize("form", ["def", "lambda"])
def test_c2_scans_nested_functions(form):
    body = ("def inner(t):\n    return t.item()\nys = list(map(inner, [tokens]))\n"
            if form == "def" else "ys = list(map(lambda t: t.item(), [tokens]))\n")
    found = _c2(_scope(body))
    inner = "inner" if form == "def" else "<lambda>"
    assert [f.site for f in found] == [f"models/model.py:decode_step.<locals>.{inner}"]


def test_c2_baseline_routes_the_admission_read_back_to_meta():
    src = HEADER + textwrap.dedent("""
        def admit_beam(q, rho, n_nodes: int):
            for _ in range(n_nodes):
                costly = rho.sum(dim=1) > 0
                if not costly.any():
                    break
            return q
        """)
    report = sc.check_source(src, "core/admission.py")
    assert not report.findings
    assert [(b["rule"], b["site"]) for b in report.meta["baselined"]] == [
        ("C2-sync", "core/admission.py:admit_beam")]


# ======================================================================
# C3: private or experimental torch modules
# ======================================================================

PRIVATE = {
    "torch-underscore-module": "import torch._dynamo\n",
    "from-torch-underscore": "from torch._subclasses.fake_tensor import FakeTensor\n",
    "internal": "from torch.testing._internal.common_utils import run_tests\n",
    "experimental": "from torch.distributed.tensor.experimental import local_map\n",
    "underscore-submodule": "from torch.utils._pytree import tree_map\n",
    "underscore-name": "from torch.distributed.distributed_c10d import _get_default_group\n",
    "underscore-from-torch": "from torch import _C\n",
}


@pytest.mark.parametrize("case", sorted(PRIVATE))
def test_c3_private_import_fires(case):
    report = sc.check_source(PRIVATE[case], "models/attention.py")
    assert [f.rule for f in report.findings] == ["C3-private-api"], report.render()


def test_c3_public_imports_and_private_calls_are_clean():
    src = textwrap.dedent("""
        import torch
        import torch.nn.functional as F
        from torch.distributed.tensor import DTensor, Shard
        from torch.utils.flop_counter import flop_registry

        def f(xs):
            torch._foreach_mul_(xs, 2.0)
            return torch._C._get_tracing_state()
        """)
    assert not sc.check_source(src, "models/attention.py").findings


@pytest.mark.parametrize("site", sorted(sc.SANCTIONED_PRIVATE_IMPORTS))
def test_c3_sanctioned_site_is_clean_there_only(site):
    relpath, module = site
    owner, _, name = module.rpartition(".")
    src = f"from {module} import X\n" if sc._private_path(owner) else \
        f"from {owner} import {name}\n"
    here = sc.check_source(src, relpath)
    assert not here.findings, here.render()
    assert [s["module"] for s in here.meta["sanctioned"]] == [module]
    assert sc.SANCTIONED_PRIVATE_IMPORTS[site]          # its reason
    elsewhere = sc.check_source(src, "models/model.py")
    assert [f.rule for f in elsewhere.findings] == ["C3-private-api"]


# ======================================================================
# the registry of capture scopes against the JAX package's jax.jit sites
# ======================================================================

# every jax.jit of src/repro, keyed (relpath, the jitted function's
# qualname; for a call of jax.jit on functools.partial(f, ...), f's name)
# -> its counterparts in the port
JIT_SITES = {
    ("kernels/ops.py", "flash_attention"): [("kernels/ops.py", "flash_attention")],
    ("kernels/ops.py", "decode_attention"): [("kernels/ops.py", "decode_attention"),
                                             ("kernels/ops.py", "decode_attention_partials")],
    ("kernels/ops.py", "ssd_scan"): [("kernels/ops.py", "ssd_scan")],
    ("serving/engine.py", "ServingEngine.__init__.<locals>._decode"):
        [("models/model.py", "decode_step")],
    ("serving/engine.py", "ServingEngine.__init__.<locals>._prefill_one"):
        [("models/model.py", "prefill")],
    ("core/admission.py", "admit_beam"): [("core/admission.py", "admit_beam")],
    ("core/scoring.py", "_critical_path"): [("core/scoring.py", "_critical_path")],
    ("core/scoring.py", "score_beam"): [("core/scoring.py", "score_beam")],
    ("launch/train.py", "train_step"): [("training/steps.py", "train_step")],
    ("launch/dryrun.py", "train_step"): [("training/steps.py", "train_step")],
    ("launch/dryrun.py", "prefill_step"): [("training/steps.py", "prefill_step")],
    ("launch/dryrun.py", "serve_step"): [("training/steps.py", "serve_step")],
}

# static_argnames of the JAX scope that the port function does not take
DROPPED = {
    ("kernels/ops.py", "flash_attention"): ({"block_q", "block_k"},
                                            "the kernels' tiles are module constants"),
    ("kernels/ops.py", "decode_attention"): ({"block_k"},
                                             "the kernels' tiles are module constants"),
    ("serving/engine.py", "ServingEngine.__init__.<locals>._prefill_one"):
        ({"prompt_len"}, "prefill reads the prompt's length from the batch's shape"),
}

# the JAX checker's other traced scopes (lax bodies, Pallas kernels): no
# counterpart in the port, each with where its work went
NO_COUNTERPART = {
    ("core/admission.py", "admit_beam.<locals>.cond"):
        ("the exit test of admit_beam's Python loop", ("core/admission.py", "admit_beam")),
    ("core/admission.py", "admit_beam.<locals>.body"):
        ("admit_beam's Python loop", ("core/admission.py", "admit_beam")),
    ("core/scoring.py", "_critical_path.<locals>.body"):
        ("_critical_path's Python loop", ("core/scoring.py", "_critical_path")),
    ("kernels/ops.py", "_jnp_flash_attention.<locals>.body"):
        ("the plain attention's key-block loop",
         ("kernels/flash_attention.py", "flash_attention_plain")),
    ("kernels/ops.py", "_jnp_ssd_chunked.<locals>.pass_state"):
        ("the plain SSD's chunk loop", ("kernels/ssd_scan.py", "ssd_scan_plain")),
    ("kernels/ref.py", "ssd_reference.<locals>.step"):
        ("the sequential SSD's loop", ("kernels/ref.py", "ssd_reference")),
    ("models/model.py", "forward.<locals>.outer"):
        ("forward's Python loop over the blocks", ("models/model.py", "forward")),
    ("models/model.py", "forward.<locals>.body"):
        ("forward's Python loop over the blocks", ("models/model.py", "forward")),
    ("models/model.py", "forward.<locals>.inner"):
        ("forward's Python loop over the blocks", ("models/model.py", "forward")),
    ("training/steps.py", "train_step.<locals>.body"):
        ("step_grads' Python loop over the microbatches", ("training/steps.py", "step_grads")),
    ("kernels/decode_attention.py", "_kernel"):
        ("a CUDA kernel", "kernels/csrc/decode_attention.cu"),
    ("kernels/decode_attention.py", "_kernel_partials"):
        ("a CUDA kernel (the decode kernel's partials entry)", "kernels/csrc/decode_attention.cu"),
    ("kernels/flash_attention.py", "_kernel"):
        ("a CUDA kernel", "kernels/csrc/flash_attention.cu"),
    ("kernels/ssd_scan.py", "_kernel"): ("a CUDA kernel", "kernels/csrc/ssd_scan.cu"),
}


@functools.cache
def _jit_sites():
    """{(relpath, jitted function): static_argnames} for every jax.jit
    decorator and call under src/repro."""
    out = {}
    root = SRC / "repro"
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        if rel == "staticcheck.py":
            continue
        tree = ast.parse(path.read_text())
        functions, qualnames = ref._index_functions(tree)
        for qn, fn in functions:
            for dec in fn.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                if ref._dotted(target) == "jax.jit":
                    out[(rel, qn)] = set()
                elif isinstance(dec, ast.Call) and ref._dotted(target).endswith("partial") \
                        and ref._dotted(dec.args[0]) == "jax.jit":
                    out[(rel, qn)] = ref._static_argnames(dec)
            assigns = sorted((n.lineno, t.id, n.value) for n in ast.walk(fn)
                             if isinstance(n, ast.Assign)
                             for t in n.targets if isinstance(t, ast.Name))
            for n in ref._walk_shallow(fn):
                if isinstance(n, ast.Call) and ref._dotted(n.func) == "jax.jit":
                    # the partial bound to the name last before the call
                    bound = [v for line, name, v in assigns
                             if name == n.args[0].id and line < n.lineno][-1]
                    assert ref._dotted(bound.func).endswith("partial"), ast.dump(bound)
                    out[(rel, ref._dotted(bound.args[0]).split(".")[-1])] = \
                        ref._static_argnames(n)
    return out


def _port_function(rel, qualname):
    tree = ast.parse((SRC / "repro_torch" / rel).read_text())
    return dict(sc._index_functions(tree)[0]).get(qualname)


def test_every_jit_site_maps_to_capture_scopes():
    sites = _jit_sites()
    assert set(sites) == set(JIT_SITES)
    mapped = {scope for scopes in JIT_SITES.values() for scope in scopes}
    assert mapped == set(sc.CAPTURE_SCOPES)


@pytest.mark.parametrize("site", sorted(JIT_SITES))
def test_capture_scope_keeps_the_static_names(site):
    static = _jit_sites()[site]
    want_dropped, reason = DROPPED.get(site, (set(), ""))
    for rel, qn in JIT_SITES[site]:
        fn = _port_function(rel, qn)
        assert fn is not None, f"{rel}:{qn} is not in the port"
        params = {p.arg for p in (*fn.args.posonlyargs, *fn.args.args, *fn.args.kwonlyargs)}
        assert static & params <= sc.CAPTURE_SCOPES[(rel, qn)]
        assert sc.CAPTURE_SCOPES[(rel, qn)] <= params
        assert static - params == want_dropped, reason


def test_other_traced_scopes_have_no_counterpart_for_a_reason():
    root = SRC / "repro"
    others = set()
    for path in sorted(root.rglob("*.py")):
        tree = ast.parse(path.read_text())
        _, qualnames = ref._index_functions(tree)
        for fn, _, kind in ref._traced_scopes(tree):
            if kind != "jit":
                others.add((path.relative_to(root).as_posix(), qualnames[id(fn)]))
    assert others == set(NO_COUNTERPART)
    trees = {p.relative_to(SRC / "repro_torch").as_posix(): ast.parse(p.read_text())
             for p in sorted((SRC / "repro_torch").rglob("*.py"))}
    c2 = sc._C2(sc._Index(trees, "repro_torch"), sc.AnalysisReport())
    c2.run(sc.CAPTURE_SCOPES)
    for reason, where in NO_COUNTERPART.values():
        assert reason
        if isinstance(where, tuple):
            assert where in c2.reached, where       # the loop is inside C2's reach
        else:
            assert (SRC / "repro_torch" / where).is_file(), where


# ======================================================================
# the default tree and the CLI
# ======================================================================

@pytest.fixture(scope="module")
def port_report():
    return sc.check_tree()


def test_default_tree_is_clean_with_exactly_the_baseline(port_report):
    report = port_report
    assert not report.findings, report.render()
    assert report.meta["files_checked"] > 60
    assert {(b["rule"], b["site"]) for b in report.meta["baselined"]} == set(sc.BASELINE)
    assert len(report.meta["baselined"]) == len(sc.BASELINE)
    assert {(s["site"].split(":")[0], s["module"]) for s in report.meta["sanctioned"]} == \
        set(sc.SANCTIONED_PRIVATE_IMPORTS)
    assert report.meta["functions_reached"] > 150


def test_the_admission_read_back_is_the_baselined_line(port_report):
    synced = [b for b in port_report.meta["baselined"] if b["rule"] == "C2-sync"]
    line = int(synced[0]["detail"].split(":")[0].split()[1])
    text = (SRC / "repro_torch" / "core" / "admission.py").read_text().splitlines()
    assert text[line - 1].strip().startswith("if not costly.any():")


def test_cli_strict_exits_zero_without_torch(tmp_path):
    out = tmp_path / "report.json"
    code = ("import runpy, sys\nsys.modules['torch'] = None\nsys.modules['jax'] = None\n"
            f"sys.argv = ['staticcheck', '--strict', '--json', {str(out)!r}]\n"
            "runpy.run_module('repro_torch.staticcheck', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "clean" in res.stdout
    payload = json.loads(out.read_text())
    assert payload["findings"] == [] and payload["meta"]["files_checked"] > 60


def test_cli_reports_a_broken_tree(tmp_path):
    (tmp_path / "models").mkdir()
    (tmp_path / "models" / "model.py").write_text(
        "def decode_step(params, cfg, cache, tokens):\n    return tokens.item()\n")
    assert sc.main(["--root", str(tmp_path)]) == 1
    assert sc.main(["--root", str(tmp_path), "--strict"]) == 2


def test_module_imports_only_the_standard_library_and_the_report():
    tree = ast.parse((SRC / "repro_torch" / "staticcheck.py").read_text())
    imported = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
    imported |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert imported - set(sys.stdlib_module_names) == {"repro_torch.core.analysis"}
