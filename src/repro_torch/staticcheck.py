"""``python -m repro_torch.staticcheck``: the port's cache-coherence,
host-sync and API static checker over its own source.

It reads source and imports no torch, so it runs on any host. Four rules:

  C1-mutation     mutation coverage of the runtime's epoch-guarded caches:
                  a declared registry of guarded state (``MUTATION_RULES``)
                  and its invalidation idioms (epoch bump / ``_mark_dirty``,
                  counter-cache clear, heap push / lazy invalidate,
                  ``bump_if_live``). Every function that writes a guarded
                  attribute, directly, through a mutator method or through
                  a local alias of the guarded container, must reach a
                  matching invalidation on every path; pair-grouped fields
                  (``NodeRun.*_cache`` / ``*_epoch``) are written together.
                  The runtime is a copy of the JAX package's, and so is the
                  rule: over either package it gives the JAX checker's
                  findings.
  C2-sync         no host sync inside the counterparts of the JAX package's
                  jitted scopes (``CAPTURE_SCOPES``) or in any port function
                  they reach: ``.item()``, ``.tolist()``, ``.cpu()``,
                  ``.numpy()``, ``.to("cpu")``, ``synchronize()``,
                  ``.nonzero()``, ``torch.nonzero`` / ``unique`` /
                  ``masked_select`` / one-argument ``where``,
                  ``torch.tensor`` / ``as_tensor`` of host data onto a
                  device, ``int()`` / ``float()`` / ``bool()`` of a tensor,
                  and an ``if`` / ``while`` / ``assert`` / conditional
                  expression / ``and`` / ``or`` / ``not`` whose truth is a
                  tensor's. PyTorch, unlike a tracer, runs a Python loop
                  over a list of tensors, a branch on a static argument or
                  an ``is None`` test without a sync, so none of those is
                  flagged; ``.shape``, ``.size()``, ``.dtype``, ``.device``
                  and the like read no data.
  C3-private-api  imports of private or experimental torch modules (a
                  ``torch._*`` component, an ``_internal`` component or an
                  ``experimental`` component) outside the sanctioned sites
                  of ``SANCTIONED_PRIVATE_IMPORTS``, each with its reason:
                  such modules change between PyTorch releases, and the
                  port runs on more than one.
  C4-dispatch     ``pack_beam``'s k flows through ``bucket_k`` (or the
                  ``k_max`` cap it buckets to), and the device entry points
                  ``admit_beam`` / ``score_beam`` are called only from their
                  wrappers ``fused_admit`` / ``Scorer.score``: bucketing
                  bounds the shapes of the device admission pass. The same
                  rule as the JAX checker's.

What counts as a tensor in C2. A parameter annotated with ``Tensor`` or
``DTensor`` (an ``Optional`` of one, a container of them) or with ``Any``,
``dict`` or ``Mapping`` (the caches' and batches' containers), and an
unannotated parameter, unless it is static: named in the scope's
``CAPTURE_SCOPES`` entry, named ``cfg`` / ``self`` / ``cls``, or annotated
otherwise (``int``, ``str``, ``ModelConfig``, ...). Then a name bound to a
``torch.*`` call that returns tensors, to a tensor's method, to a subscript
of a tensor, to arithmetic or a comparison on one, or to a call of a port
function whose return annotation names a tensor (or, without one, that is
given a tensor). ``.shape``, ``.dtype``, ``.device`` and any other
attribute but ``.T`` / ``.mT`` / ``.data`` / ``.grad`` / ``.real`` /
``.imag`` / ``saved_tensors`` are not tensors.

Reach. A sync in a callee syncs its caller, so the scan follows calls from
a scope into the port functions it can resolve statically: defined in the
same module, imported by ``from <package>.x import f`` or through a module
(``from <package> import m`` / ``import <package>.x as m``, then ``m.f``),
a function passed by name as an argument (``tree_map(f, ...)``), and an
autograd ``Function``'s ``apply`` (its ``forward`` and ``backward``).
Each function is scanned once, with its own parameters typed as above.

Approximations (deliberate, documented so that findings stay
interpretable): the C1 flow treats loop bodies as running once; C2 is flow
insensitive within a function (a name once a tensor stays one), does not
follow calls through objects (methods, ``mesh.psum``), function values held
in variables, ``getattr`` or relative imports, and does not see a sync in a
library function, boolean-mask indexing (``t[mask]``), a host copy by
``.to(device)`` of a host tensor, or ``any()`` / ``max()`` over tensors.

Zero findings are required on the default tree. A site that syncs (or
writes) for a reason the checker cannot see is listed in ``BASELINE`` with
its justification; baselined hits land in ``report.meta["baselined"]``,
never in the findings. Reuses :class:`repro_torch.core.analysis.AnalysisReport`.
Exit status mirrors ``python -m repro_torch.analysis``: 0 clean, 1 findings,
2 under ``--strict`` when any finding is an error.
"""
from __future__ import annotations

import argparse
import ast
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, FrozenSet, Iterable, List, Mapping, Optional, Set, Tuple

from repro_torch.core.analysis import AnalysisReport, exit_code

# ======================================================================
# registries
# ======================================================================

#: container-mutating method names that count as writes to the object the
#: method chain hangs off (``self._read_index.setdefault(nk, set()).add(k)``
#: is a write to ``_read_index``)
MUTATOR_METHODS: FrozenSet[str] = frozenset({
    "append", "extend", "insert", "pop", "popitem", "remove", "clear",
    "add", "discard", "update", "setdefault", "sort",
})


@dataclass(frozen=True)
class MutationRule:
    """One C1 entry: guarded attributes + the invalidation idiom that must
    accompany any write to them.

    ``invalidators`` entries are ``"call:<dotted tail>"`` (a call whose
    dotted name ends with the tail: ``_mark_dirty``,
    ``_demand_cache.clear``) or ``"write:<attr>"`` (a write to that attr is
    itself the invalidation: the heap's lazy ``_live`` tombstone). A rule
    with ``pair_groups`` instead requires group members to be written
    together. A rule with neither bans writes outright (single-writer
    fields); ``exempt`` qualnames are the sanctioned writers.
    """
    name: str
    modules: Tuple[str, ...]                  # relpath suffixes the rule scans
    attrs: FrozenSet[str]
    invalidators: Tuple[str, ...] = ()
    pair_groups: Tuple[FrozenSet[str], ...] = ()
    mutators: FrozenSet[str] = MUTATOR_METHODS
    exempt: FrozenSet[str] = frozenset()


MUTATION_RULES: Tuple[MutationRule, ...] = (
    # EpisodeState/NodeRun/HypRun fields the phase-4 rebuild caches hang off:
    # any write must bump the episode epoch + dirty-set (directly or through
    # a known dirtying-transition method, each of which marks internally).
    MutationRule(
        name="runtime-epoch",
        modules=("core/runtime.py",),
        attrs=frozenset({
            "history", "pending_action", "inflight", "hyp_runs", "phase",
            "warm_until", "matched_hr", "step_idx", "status", "result",
            "job", "served", "epoch",
        }),
        invalidators=(
            "call:_mark_dirty", "call:_mark_dirty_eid",
            # dirtying transitions: each calls _mark_dirty before mutating
            "call:_finish_action", "call:_commit_path", "call:_squash_one",
            "call:_squash_all", "call:_prune_beam", "call:_serve_spec",
        ),
        exempt=frozenset({"BPasteRuntime._mark_dirty"}),  # IS the bump
    ),
    # epoch-stamped cache pairs: writing the cache without the stamp (or
    # vice versa) silently serves a stale value next epoch check.
    MutationRule(
        name="noderun-pairs",
        modules=("core/runtime.py",),
        attrs=frozenset({
            "args_cache", "args_epoch", "mkey_cache", "mkey_epoch",
            "serv_epoch", "serv_pubs", "serv_inval", "serv_ok",
        }),
        pair_groups=(
            frozenset({"args_cache", "args_epoch"}),
            frozenset({"mkey_cache", "mkey_epoch"}),
            frozenset({"serv_epoch", "serv_pubs", "serv_inval", "serv_ok"}),
        ),
    ),
    # counter-group demand: any change to the running set or the group
    # counters must clear the O(#groups) demand cache.
    MutationRule(
        name="sim-demand",
        modules=("core/simulator.py",),
        attrs=frozenset({"running", "_groups"}),
        invalidators=("call:_demand_cache.clear",),
    ),
    # completion-time heap: a re-rated job needs a fresh heap entry
    # (_push) or a lazy tombstone (dropping its _live sequence number).
    MutationRule(
        name="sim-heap",
        modules=("core/simulator.py",),
        attrs=frozenset({"_rate"}),
        invalidators=("call:_push", "write:_live"),
    ),
    # job class flips corrupt the auth/spec counter split unless they go
    # through Simulator.set_speculative; ban every other write.
    MutationRule(
        name="class-flip",
        modules=("core/runtime.py", "core/simulator.py",
                 "core/model_service.py"),
        attrs=frozenset({"speculative", "priority"}),
        exempt=frozenset({"Simulator.set_speculative"}),
    ),
    # entry-table writes must keep the read index coherent.
    MutationRule(
        name="store-index",
        modules=("core/memo.py",),
        attrs=frozenset({"entries"}),
        invalidators=("call:_deindex", "write:_read_index"),
    ),
    # tool_pubs is the servability-cache monotone counter: single writer
    # (publish), never decremented; _deindex deliberately leaves it alone.
    MutationRule(
        name="store-pubs",
        modules=("core/memo.py",),
        attrs=frozenset({"tool_pubs"}),
        exempt=frozenset({"ResultStore.publish"}),
    ),
    # live-state tool writes must advance the sandbox staleness version.
    MutationRule(
        name="live-bump",
        modules=("core/executor.py",),
        attrs=frozenset({"M", "F", "E"}),
        invalidators=("call:bump_if_live",),
        mutators=frozenset({"set", "delete"}),
    ),
)

#: the port's counterpart of every jitted scope of the JAX package, as
#: (relpath, qualname) -> the parameters that are static there (the JAX
#: scope's ``static_argnames`` that the port function still has)
CAPTURE_SCOPES: Dict[Tuple[str, str], FrozenSet[str]] = {
    ("kernels/ops.py", "flash_attention"): frozenset({"causal", "window", "scale", "impl"}),
    ("kernels/ops.py", "decode_attention"): frozenset({"scale", "window", "impl"}),
    ("kernels/ops.py", "decode_attention_partials"): frozenset({"scale", "window", "impl"}),
    ("kernels/ops.py", "ssd_scan"): frozenset({"chunk", "impl"}),
    ("models/model.py", "decode_step"): frozenset({"cfg"}),
    ("models/model.py", "prefill"): frozenset({"cfg", "max_len"}),
    ("core/admission.py", "admit_beam"): frozenset({"n_nodes"}),
    ("core/scoring.py", "_critical_path"): frozenset({"n_iters"}),
    ("core/scoring.py", "score_beam"): frozenset({"n_nodes"}),
    ("training/steps.py", "train_step"): frozenset({"cfg", "opt_cfg", "mesh_info",
                                                    "microbatches"}),
    ("training/steps.py", "serve_step"): frozenset({"cfg", "mesh_info"}),
    ("training/steps.py", "prefill_step"): frozenset({"cfg", "max_len", "mesh_info"}),
}

#: sites that are safe, or that sync on purpose, for reasons outside the
#: checker's view: keyed (rule id, site), value is the justification
#: recorded in ``report.meta["baselined"]``
BASELINE: Dict[Tuple[str, str], str] = {
    ("C1-mutation", "core/runtime.py:BPasteRuntime._launch_frontier"):
        "settle-warm flips a pending env_warmup prep to reused mid-walk; "
        "the mutating walk only runs while phase 4 is rebuilding a dirty "
        "episode's frontier (the value being cached), and the sanitizer "
        "uses the settle_warm=False variant, which never mutates",
    ("C1-mutation", "core/runtime.py:BPasteRuntime._refresh_beam"):
        "appends fresh HypRuns while phase 4 rebuilds a dirty episode's "
        "beam; the epoch-guarded caches are recomputed in the same pass, "
        "and new NodeRuns start at epoch -1 so nothing stale can serve",
    ("C2-sync", "core/admission.py:admit_beam"):
        "`if not costly.any()` reads one flag back per pick with demand, "
        "the loop's exit test: a pass costs (picks with demand) + 1 "
        "iterations instead of K (ROADMAP Queue 2 item 9 would keep the "
        "loop on the device)",
}

#: C3: the private or experimental torch modules the port imports on
#: purpose, as (relpath, module) -> the reason
SANCTIONED_PRIVATE_IMPORTS: Dict[Tuple[str, str], str] = {
    ("launch/mesh.py", "torch.testing._internal.distributed.fake_pg"):
        "registers the 'fake' process-group backend and its FakeStore, on "
        "which the dry-run lays a 256- or 512-rank mesh out in one "
        "process; no public module has them",
    ("launch/dryrun.py", "torch.utils._python_dispatch"):
        "TorchDispatchMode, the base of the dry-run's RankCounter, which sees "
        "every aten op a rank runs; PyTorch exports it from no public module",
    ("launch/dryrun.py", "torch.distributed.distributed_c10d._resolve_process_group"):
        "the functional collectives name their group by a string; the "
        "counter resolves it to the group to read its size",
    ("launch/dryrun.py", "torch._subclasses.fake_tensor"):
        "FakeTensor: DTensor propagates global shapes on fake tensors, and "
        "the dry-run's counter skips the ops run on them; no public type "
        "names them",
    ("launch/dryrun.py", "torch.distributed.tensor.experimental"):
        "implicit_replication: the dry-run's step takes the plain tensors "
        "among its DTensors as replicated, as the JAX package's constants "
        "are; PyTorch has it only under experimental",
}

# C4: the wrappers the device entry points are called from (relpath suffix,
# qualname)
_ENTRYPOINT_WRAPPERS: Dict[str, Tuple[Tuple[str, str], ...]] = {
    "admit_beam": (("core/admission.py", "fused_admit"),),
    "score_beam": (("core/scoring.py", "Scorer.score"),),
}

# C2 vocabulary
_STATIC_PARAM_NAMES = frozenset({"self", "cls", "cfg"})
_TENSOR_ATTRS = frozenset({"T", "mT", "H", "mH", "data", "grad", "real", "imag",
                           "saved_tensors"})
# methods that read no data: their result is host metadata
_META_METHODS = frozenset({
    "size", "dim", "ndimension", "numel", "nelement", "stride", "storage_offset",
    "data_ptr", "is_contiguous", "element_size", "get_device", "is_floating_point",
    "is_complex", "is_pinned", "untyped_storage", "type",
})
_HOST_READ_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
_TENSOR_NAMESPACES = frozenset({
    "torch", "torch.nn.functional", "torch.linalg", "torch.fft", "torch.special",
    "torch.utils.checkpoint", "torch.distributed.tensor.DTensor",
})
_NON_TENSOR_TORCH = frozenset({
    "device", "dtype", "Size", "finfo", "iinfo", "Generator", "no_grad", "enable_grad",
    "inference_mode", "autocast", "manual_seed", "promote_types", "result_type",
    "can_cast", "Tensor",
})
_SYNC_TORCH_CALLS = frozenset({"torch.nonzero", "torch.unique", "torch.masked_select",
                               "torch.argwhere", "torch.cuda.synchronize"})


# ======================================================================
# small AST helpers
# ======================================================================

def _dotted(node: ast.AST) -> str:
    """Dotted-name suffix of an Attribute/Name chain (``self._groups.get``);
    chains hanging off calls/subscripts keep only the attribute tail."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _walk_shallow(node: ast.AST) -> Iterable[ast.AST]:
    """ast.walk that does NOT descend into nested function/lambda bodies
    (those execute on their own schedule and are analyzed separately)."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        for c in ast.iter_child_nodes(n):
            if isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
                continue
            stack.append(c)


def _chain_base_attr(node: ast.AST, attrs: FrozenSet[str],
                     aliases: Dict[str, str]) -> Optional[str]:
    """Descend an Attribute/Subscript/Call chain to the guarded attribute
    (or alias) it hangs off, if any."""
    while True:
        if isinstance(node, ast.Attribute):
            if node.attr in attrs:
                return node.attr
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, ast.Name):
            return aliases.get(node.id)
        else:
            return None


def _target_attr(t: ast.AST, attrs: FrozenSet[str],
                 aliases: Dict[str, str]) -> List[str]:
    """Guarded attrs written by one assignment/delete target."""
    if isinstance(t, (ast.Tuple, ast.List)):
        out: List[str] = []
        for e in t.elts:
            out.extend(_target_attr(e, attrs, aliases))
        return out
    if isinstance(t, ast.Starred):
        return _target_attr(t.value, attrs, aliases)
    if isinstance(t, ast.Attribute):
        return [t.attr] if t.attr in attrs else []
    if isinstance(t, ast.Subscript):
        a = _chain_base_attr(t.value, attrs, aliases)
        return [a] if a else []
    # plain Name rebinding is not a mutation of the guarded object
    return []


def _writes_in(stmt: ast.AST, attrs: FrozenSet[str],
               aliases: Dict[str, str],
               mutators: FrozenSet[str]) -> Set[str]:
    """Guarded attrs this statement writes: assignment targets, ``del``,
    and mutator-method calls anywhere in the statement."""
    written: Set[str] = set()
    for n in _walk_shallow(stmt):
        if isinstance(n, ast.Assign):
            for t in n.targets:
                written.update(_target_attr(t, attrs, aliases))
        elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
            written.update(_target_attr(n.target, attrs, aliases))
        elif isinstance(n, ast.Delete):
            for t in n.targets:
                written.update(_target_attr(t, attrs, aliases))
        elif (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
              and n.func.attr in mutators):
            a = _chain_base_attr(n.func.value, attrs, aliases)
            if a:
                written.add(a)
    return written


def _alias_source_attr(v: ast.AST, attrs: FrozenSet[str]) -> Optional[str]:
    """Does this RHS expression evaluate to (an element of) a guarded
    container, so the bound name aliases it?  Copies (``list(...)``,
    comprehensions, slices of copies) do NOT alias."""
    if isinstance(v, ast.Attribute) and v.attr in attrs:
        return v.attr
    if isinstance(v, ast.Subscript):
        inner = v.value
        if isinstance(inner, ast.Attribute) and inner.attr in attrs:
            return inner.attr
    if (isinstance(v, ast.Call) and isinstance(v.func, ast.Attribute)
            and v.func.attr in ("get", "setdefault")
            and isinstance(v.func.value, ast.Attribute)
            and v.func.value.attr in attrs):
        return v.func.value.attr
    return None


def _collect_aliases(fn: ast.AST, attrs: FrozenSet[str]) -> Dict[str, str]:
    """Local names bound to guarded containers (``g = self._groups.get(k)``,
    ``g = self._groups[k] = [...]``): writes through them count."""
    aliases: Dict[str, str] = {}
    for n in _walk_shallow(fn):
        if not isinstance(n, ast.Assign):
            continue
        names = [t.id for t in n.targets if isinstance(t, ast.Name)]
        if not names:
            continue
        src = _alias_source_attr(n.value, attrs)
        if src is None:
            # multi-target: ``g = self._groups[key] = [...]``
            for t in n.targets:
                if isinstance(t, ast.Subscript):
                    inner = t.value
                    if isinstance(inner, ast.Attribute) and inner.attr in attrs:
                        src = inner.attr
                        break
        if src is not None:
            for name in names:
                aliases[name] = src
    return aliases


# ======================================================================
# C1: mutation-coverage dataflow
# ======================================================================

# flow state: (wrote a guarded attr, hit an invalidator); sets of these
# (at most 4 members) flow through the function; a terminal (True, False)
# state is a path that mutated guarded state without invalidating.

class _C1Flow:
    def __init__(self, rule: MutationRule, aliases: Dict[str, str]):
        self.rule = rule
        self.aliases = aliases
        self.written: Set[str] = set()     # attrs written anywhere (detail)
        self._write_specs = frozenset(
            s.split(":", 1)[1] for s in rule.invalidators
            if s.startswith("write:"))
        self._call_specs = tuple(
            s.split(":", 1)[1] for s in rule.invalidators
            if s.startswith("call:"))

    def _invalidates(self, stmt: ast.AST) -> bool:
        if self._call_specs:
            for n in _walk_shallow(stmt):
                if isinstance(n, ast.Call):
                    d = _dotted(n.func)
                    if any(d == tail or d.endswith("." + tail)
                           for tail in self._call_specs):
                        return True
        if self._write_specs and _writes_in(
                stmt, self._write_specs, self.aliases, self.rule.mutators):
            return True
        return False

    def _apply(self, stmt: ast.AST,
               states: Set[Tuple[bool, bool]]) -> Set[Tuple[bool, bool]]:
        w = _writes_in(stmt, self.rule.attrs, self.aliases, self.rule.mutators)
        self.written.update(w)
        inv = self._invalidates(stmt)
        if not w and not inv:
            return states
        return {(ws or bool(w), vs or inv) for ws, vs in states}

    def run_block(self, stmts, states):
        """Returns (fallthrough states, return/raise states, break states).
        Loop bodies run exactly once (see module docstring)."""
        cur = set(states)
        exits: Set[Tuple[bool, bool]] = set()
        breaks: Set[Tuple[bool, bool]] = set()
        for stmt in stmts:
            if not cur:
                break                      # unreachable
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue                   # analyzed as its own function
            if isinstance(stmt, (ast.Return, ast.Raise)):
                exits |= self._apply(stmt, cur)
                cur = set()
            elif isinstance(stmt, (ast.Break, ast.Continue)):
                breaks |= cur
                cur = set()
            elif isinstance(stmt, ast.If):
                cur = self._apply(stmt.test, cur)
                b1, e1, br1 = self.run_block(stmt.body, cur)
                b2, e2, br2 = self.run_block(stmt.orelse, cur)
                cur = b1 | b2
                exits |= e1 | e2
                breaks |= br1 | br2
            elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                head = stmt.iter if isinstance(stmt, (ast.For, ast.AsyncFor)) \
                    else stmt.test
                cur = self._apply(head, cur)
                b, e, br = self.run_block(stmt.body, cur)
                cur = b | br               # this loop consumes its breaks
                exits |= e
                if stmt.orelse:
                    b2, e2, br2 = self.run_block(stmt.orelse, cur)
                    cur, exits, breaks = b2, exits | e2, breaks | br2
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    cur = self._apply(item.context_expr, cur)
                b, e, br = self.run_block(stmt.body, cur)
                cur, exits, breaks = b, exits | e, breaks | br
            elif isinstance(stmt, ast.Try):
                b, e, br = self.run_block(stmt.body, cur)
                exits |= e
                breaks |= br
                out = set(b)
                for h in stmt.handlers:
                    hb, he, hbr = self.run_block(h.body, cur | b)
                    out |= hb
                    exits |= he
                    breaks |= hbr
                if stmt.orelse:
                    ob, oe, obr = self.run_block(stmt.orelse, b)
                    out = (out - b) | ob
                    exits |= oe
                    breaks |= obr
                if stmt.finalbody:
                    out, fe, fbr = self.run_block(stmt.finalbody, out)
                    exits |= fe
                    breaks |= fbr
                cur = out
            else:
                cur = self._apply(stmt, cur)
        return cur, exits, breaks


def _check_mutation_rule(rule: MutationRule, relpath: str,
                         functions: List[Tuple[str, ast.AST]],
                         report: AnalysisReport) -> None:
    for qualname, fn in functions:
        if qualname.split(".")[-1] == "__init__":
            continue                       # construction populates, by design
        if any(qualname == ex or qualname.endswith("." + ex)
               for ex in rule.exempt):
            continue
        site = f"{relpath}:{qualname}"
        aliases = _collect_aliases(fn, rule.attrs)
        if rule.pair_groups:
            written = set()
            for stmt in fn.body:
                written |= _writes_in(stmt, rule.attrs, aliases, rule.mutators)
            for group in rule.pair_groups:
                hit = written & group
                if hit and hit != group:
                    _emit(report, "C1-mutation", "error", site,
                          f"[{rule.name}] writes {sorted(hit)} without the "
                          f"rest of the cache/epoch group "
                          f"{sorted(group - hit)}: a stale pair serves "
                          f"under the next epoch check")
            continue
        flow = _C1Flow(rule, aliases)
        out, exits, breaks = flow.run_block(fn.body, {(False, False)})
        final = out | exits | breaks
        if not rule.invalidators:
            if flow.written:
                _emit(report, "C1-mutation", "error", site,
                      f"[{rule.name}] writes single-writer field(s) "
                      f"{sorted(flow.written)} outside the sanctioned "
                      f"writer(s) {sorted(rule.exempt) or '(none)'}")
            continue
        if any(w and not inv for w, inv in final):
            _emit(report, "C1-mutation", "error", site,
                  f"[{rule.name}] writes guarded state "
                  f"{sorted(flow.written)} but some path reaches the end "
                  f"of the function without any of "
                  f"{list(rule.invalidators)}")


# ======================================================================
# the package index: modules, their functions and imports (C2's reach)
# ======================================================================

@dataclass
class _Module:
    relpath: str
    tree: ast.Module
    functions: Dict[str, ast.AST]     # qualname -> def
    qualnames: Dict[int, str]         # id(def) -> qualname
    classes: Set[str]                 # top-level class names
    imports: Dict[str, str]           # local name -> absolute dotted target


def _module_imports(tree: ast.Module) -> Dict[str, str]:
    """Every import of the module, at any depth (a function's lazy imports
    too): local name -> absolute dotted name. Relative imports are left
    out (see the module docstring)."""
    out: Dict[str, str] = {}
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            for a in n.names:
                if a.asname:
                    out[a.asname] = a.name
                else:
                    root = a.name.split(".")[0]
                    out.setdefault(root, root)
        elif isinstance(n, ast.ImportFrom) and n.module and not n.level:
            for a in n.names:
                out[a.asname or a.name] = f"{n.module}.{a.name}"
    return out


def _index_functions(tree: ast.Module):
    """[(qualname, node)] for every def, plus an id->qualname map."""
    out: List[Tuple[str, ast.AST]] = []
    qualnames: Dict[int, str] = {}

    def walk(node, prefix):
        for c in ast.iter_child_nodes(node):
            if isinstance(c, ast.ClassDef):
                walk(c, f"{prefix}{c.name}.")
            elif isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = f"{prefix}{c.name}"
                out.append((qn, c))
                qualnames[id(c)] = qn
                walk(c, f"{qn}.<locals>.")
            else:
                walk(c, prefix)

    walk(tree, "")
    return out, qualnames


class _Index:
    """The parsed modules of one package, by relpath, with the static
    resolution C2 follows calls by."""

    def __init__(self, trees: Mapping[str, ast.Module], package: str):
        self.package = package
        self.modules: Dict[str, _Module] = {}
        for relpath, tree in trees.items():
            functions, qualnames = _index_functions(tree)
            classes = {c.name for c in tree.body if isinstance(c, ast.ClassDef)}
            self.modules[relpath] = _Module(relpath, tree, dict(functions), qualnames,
                                            classes, _module_imports(tree))

    def module_of(self, dotted: str) -> Optional[str]:
        """The relpath of the package's module ``dotted``, if it is one."""
        if dotted == self.package:
            rel = "__init__.py"
            return rel if rel in self.modules else None
        if not dotted.startswith(self.package + "."):
            return None
        stem = dotted[len(self.package) + 1:].replace(".", "/")
        for rel in (f"{stem}.py", f"{stem}/__init__.py"):
            if rel in self.modules:
                return rel
        return None

    def resolve_name(self, relpath: str, name: str, depth: int = 0):
        """What ``name`` is in module ``relpath``: ("function", relpath,
        qualname), ("class", relpath, name), ("module", relpath) or None."""
        mod = self.modules.get(relpath)
        if mod is None or depth > 8:
            return None
        if name in mod.functions:
            return ("function", relpath, name)
        if name in mod.classes:
            return ("class", relpath, name)
        target = mod.imports.get(name)
        if target is None:
            return None
        rel = self.module_of(target)
        if rel is not None:
            return ("module", rel)
        owner, _, attr = target.rpartition(".")
        rel = self.module_of(owner)
        if rel is None:
            return None
        return self.resolve_name(rel, attr, depth + 1)

    def resolve_call(self, relpath: str, node: ast.AST) -> List[Tuple[str, str, str]]:
        """The port functions an expression in call position names, as
        (relpath, qualname, mode): ``f``, ``m.f``, ``m.Cls.meth`` ("call"),
        or ``Cls.apply`` of an autograd Function ("forward", which takes
        the call's arguments after its ctx, and "backward")."""
        if not isinstance(node, (ast.Name, ast.Attribute)) or not _rooted_in_name(node):
            return []
        parts = _dotted(node).split(".")
        what = self.resolve_name(relpath, parts[0])
        for i, part in enumerate(parts[1:], start=1):
            if what is None:
                return []
            if what[0] == "module":
                what = self.resolve_name(what[1], part)
            elif what[0] == "class":
                _, rel, cls = what
                fns = self.modules[rel].functions
                if part == "apply" and i == len(parts) - 1:
                    return [(rel, f"{cls}.{m}", m) for m in ("forward", "backward")
                            if f"{cls}.{m}" in fns]
                qn = f"{cls}.{part}"
                what = ("function", rel, qn) if qn in fns else None
            else:
                return []
        if what is not None and what[0] == "function":
            return [(what[1], what[2], "call")]
        return []

    def function(self, relpath: str, qualname: str) -> Optional[ast.AST]:
        mod = self.modules.get(relpath)
        return None if mod is None else mod.functions.get(qualname)


def _rooted_in_name(node: ast.AST) -> bool:
    while isinstance(node, ast.Attribute):
        node = node.value
    return isinstance(node, ast.Name)


# ======================================================================
# C2: host syncs in the capture scopes and their reach
# ======================================================================

# what a name holds, as far as C2 can tell: a tensor, or a container of
# tensors (a tuple, list or dict of them: indexing or iterating it gives
# tensors, and its truth reads nothing); anything else is None
_T, _C = "tensor", "container"


def _merge(*kinds: Optional[str]) -> Optional[str]:
    return _T if _T in kinds else _C if _C in kinds else None


def _annotation_kind(ann: Optional[ast.AST]) -> Optional[str]:
    """The kind an annotation declares: ``Tensor`` / ``DTensor`` (an
    ``Optional`` of one) a tensor; ``Any``, ``dict`` / ``Dict`` /
    ``Mapping``, or a ``Tuple`` / ``List`` / ``Sequence`` / ``Dict`` of
    tensors a container; anything else (``int``, ``str``, ``ModelConfig``,
    ``list``) static."""
    if ann is None:
        return None
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            return _annotation_kind(ast.parse(ann.value, mode="eval").body)
        except SyntaxError:
            return None
    if isinstance(ann, (ast.Name, ast.Attribute)):
        name = ann.id if isinstance(ann, ast.Name) else ann.attr
        if name in ("Tensor", "DTensor"):
            return _T
        return _C if name in ("Any", "dict", "Dict", "Mapping") else None
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):   # X | None
        return _merge(_annotation_kind(ann.left), _annotation_kind(ann.right))
    if isinstance(ann, ast.Subscript):
        base = _dotted(ann.value).split(".")[-1]
        args = ann.slice.elts if isinstance(ann.slice, ast.Tuple) else [ann.slice]
        kinds = [_annotation_kind(a) for a in args]
        if base in ("Optional", "Union"):
            return _merge(*kinds)
        return _C if any(kinds) else None
    return None


def _params(fn) -> List[ast.arg]:
    a = fn.args
    return [*a.posonlyargs, *a.args, *a.kwonlyargs]


def _default_kinds(fn, static: FrozenSet[str] = frozenset()) -> Dict[str, str]:
    """Parameter kinds where no call site says more (a capture scope, a
    function passed by name, a nested def): an annotation's kind, else a
    tensor; static names (the scope's, ``cfg``, ``self``, ``cls``) none."""
    out: Dict[str, str] = {}
    for p in _params(fn):
        if p.arg in static or p.arg in _STATIC_PARAM_NAMES:
            continue
        kind = _T if p.annotation is None else _annotation_kind(p.annotation)
        if kind:
            out[p.arg] = kind
    for p in (fn.args.vararg, fn.args.kwarg):
        if p is not None:
            out[p.arg] = _C
    return out


class _SyncScan:
    """One function's C2 scan: it types names (``kinds``, grown over two
    passes: the scan is flow insensitive), flags the syncs and visits the
    port functions called. ``quiet`` types only (a callee's return kind)."""

    def __init__(self, checker: "_C2", relpath: str, qualname: str, fn,
                 kinds: Dict[str, str], scope: str, quiet: bool = False):
        self.c = checker
        self.relpath, self.qualname, self.fn = relpath, qualname, fn
        self.kinds = dict(kinds)
        self.torch_alias: Dict[str, str] = {}     # local name -> torch namespace
        self.scope = scope
        self.quiet = quiet
        self.site = f"{relpath}:{qualname}"
        self.imports = checker.index.modules[relpath].imports

    # ---- typing ------------------------------------------------------
    def torch_name(self, node: ast.AST) -> Optional[str]:
        """The absolute torch dotted name of a Name/Attribute chain, if it
        is one (``torch.where``, ``F.pad`` with F an alias of
        torch.nn.functional, ``DTensor.from_local``)."""
        if not isinstance(node, (ast.Name, ast.Attribute)) or not _rooted_in_name(node):
            return None
        parts = _dotted(node).split(".")
        if parts[0] in self.kinds:
            return None
        root = self.torch_alias.get(parts[0]) or self.imports.get(parts[0])
        if root is None or not (root == "torch" or root.startswith("torch.")):
            return None
        return ".".join([root, *parts[1:]])

    def is_tensor(self, e: ast.AST) -> bool:
        return self.kind(e) == _T

    def kind(self, e: ast.AST) -> Optional[str]:
        if isinstance(e, ast.Name):
            return self.kinds.get(e.id)
        if isinstance(e, ast.Attribute):
            if self.kind(e.value) != _T:
                return None
            return _C if e.attr == "saved_tensors" else \
                _T if e.attr in _TENSOR_ATTRS else None
        if isinstance(e, ast.Subscript):
            return _T if self.kind(e.value) else None
        if isinstance(e, (ast.Starred, ast.NamedExpr)):
            return self.kind(e.value)
        if isinstance(e, ast.BinOp):
            return _merge(self.kind(e.left), self.kind(e.right))
        if isinstance(e, ast.UnaryOp):
            return None if isinstance(e.op, ast.Not) else \
                (_T if self.is_tensor(e.operand) else None)
        if isinstance(e, ast.Compare):
            if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in e.ops):
                return None
            return _T if any(self.is_tensor(x) for x in (e.left, *e.comparators)) else None
        if isinstance(e, ast.IfExp):
            return _merge(self.kind(e.body), self.kind(e.orelse))
        if isinstance(e, ast.BoolOp):
            return _merge(*(self.kind(v) for v in e.values))
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            return _C if any(self.kind(x) for x in e.elts) else None
        if isinstance(e, ast.Dict):
            return _C if any(self.kind(x) for x in e.values) else None
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            self.bind_generators(e)
            return _C if self.kind(e.elt) else None
        if isinstance(e, ast.DictComp):
            self.bind_generators(e)
            return _C if self.kind(e.value) else None
        if isinstance(e, ast.Call):
            return self.call_kind(e)
        return None

    def call_kind(self, e: ast.Call) -> Optional[str]:
        f = e.func
        tn = self.torch_name(f)
        if tn is not None:
            ns, _, last = tn.rpartition(".")
            ok = (ns in _TENSOR_NAMESPACES and last not in _NON_TENSOR_TORCH
                  and not last.startswith(("is_", "get_", "set_", "use_", "_")))
            return _T if ok else None
        args = [*e.args, *(k.value for k in e.keywords)]
        if isinstance(f, ast.Attribute):
            if f.attr in _META_METHODS or f.attr in _HOST_READ_METHODS:
                return None
            recv = self.kind(f.value)
            if recv == _T:
                return _T                           # a tensor's method
            if recv == _C:
                return _C if f.attr in ("values", "items", "copy") else \
                    _T if f.attr in ("get", "pop", "setdefault") else None
        if isinstance(f, ast.Name):
            if f.id in ("tuple", "list", "dict", "sorted", "reversed", "zip", "map",
                        "filter", "enumerate", "iter"):
                return _C if any(self.kind(a) for a in args) else None
            if f.id in ("next", "sum", "abs"):
                return _T if any(self.kind(a) for a in args) else None
        for rel, qn, mode in self.c.index.resolve_call(self.relpath, f):
            if mode != "backward":
                return self.c.return_kind(rel, qn)
        return None

    def bind(self, target: ast.AST, kind: Optional[str]) -> None:
        """Bind ``target`` to a value of ``kind``. Unpacking a tensor gives
        tensors; unpacking a container gives its items (:meth:`bind_item`)."""
        if not kind:
            return
        if isinstance(target, (ast.Tuple, ast.List)):
            for t in target.elts:
                self.bind_item(t, kind)
        elif isinstance(target, ast.Starred):
            self.bind(target.value, _C)
        elif isinstance(target, ast.Name):
            self.kinds[target.id] = _merge(self.kinds.get(target.id), kind)

    def bind_item(self, target: ast.AST, kind: Optional[str]) -> None:
        """Bind ``target`` to one item of a value of ``kind``: a tensor's
        item is a tensor; a container's item is taken for a tensor, unless
        the target unpacks it further, where what each part holds is
        unknown (``for name, (t, shape) in specs.items()``)."""
        if kind == _T:
            self.bind(target, _T)
        elif kind == _C and not isinstance(target, (ast.Tuple, ast.List)):
            self.bind(target, _T)

    def bind_value(self, target: ast.AST, value: ast.AST) -> None:
        if isinstance(target, (ast.Tuple, ast.List)) and \
                isinstance(value, (ast.Tuple, ast.List)) and \
                len(target.elts) == len(value.elts):
            for t, v in zip(target.elts, value.elts):
                self.bind_value(t, v)
            return
        if isinstance(target, ast.Name) and not isinstance(value, ast.Call) \
                and self.torch_name(value) is not None:
            self.torch_alias[target.id] = self.torch_name(value)   # F = torch.nn.functional
            return
        self.bind(target, self.kind(value))

    def bind_iter(self, target: ast.AST, it: ast.AST) -> None:
        """Loop / comprehension targets: ``range`` gives ints,
        ``enumerate`` an int and the items, ``zip`` each argument's items,
        ``.items()`` a key and the values."""
        pair = isinstance(target, ast.Tuple)
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Name):
            if it.func.id == "range":
                return
            if it.func.id == "enumerate" and it.args and pair and len(target.elts) == 2:
                self.bind_item(target.elts[1], self.kind(it.args[0]))
                return
            if it.func.id == "zip" and pair and len(target.elts) == len(it.args):
                for t, a in zip(target.elts, it.args):
                    self.bind_item(t, self.kind(a))
                return
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Attribute) and \
                it.func.attr == "items" and pair and len(target.elts) == 2:
            self.bind_item(target.elts[1], self.kind(it.func.value))
            return
        self.bind_item(target, self.kind(it))

    def bind_generators(self, e) -> None:
        for g in e.generators:
            self.bind_iter(g.target, g.iter)

    # ---- flags -------------------------------------------------------
    def flag(self, lineno: int, what: str) -> None:
        if not self.quiet:
            self.c.flag(self.site, lineno, what, self.scope)

    def truth(self, test: ast.AST, lineno: int, what: str) -> None:
        """A Python truth test: bool() of a tensor reads it back."""
        if isinstance(test, ast.BoolOp):
            for v in test.values:
                self.truth(v, lineno, what)
        elif isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            self.truth(test.operand, lineno, what)
        elif self.is_tensor(test):
            self.flag(lineno, f"{what} on a tensor's value (bool() reads it back)")

    def scan_expr(self, e: ast.AST, tested: bool = False) -> None:
        """Flag the syncs of an expression and visit its callees. With
        ``tested`` the expression is a statement's truth test, whose
        top-level and / or / not the statement's own flag covers."""
        chain: Set[int] = set()
        if tested:
            stack = [e]
            while stack:
                n = stack.pop()
                if isinstance(n, ast.BoolOp) or (isinstance(n, ast.UnaryOp)
                                                 and isinstance(n.op, ast.Not)):
                    chain.add(id(n))
                    stack.extend(n.values if isinstance(n, ast.BoolOp) else [n.operand])
        for n in _walk_shallow(e):
            if isinstance(n, ast.IfExp):
                self.truth(n.test, n.lineno, "conditional expression")
            elif isinstance(n, ast.BoolOp) and id(n) not in chain:
                for v in n.values[:-1]:
                    self.truth(v, n.lineno, "and / or")
            elif isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.Not) \
                    and id(n) not in chain:
                self.truth(n.operand, n.lineno, "not")
            elif isinstance(n, (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)):
                self.bind_generators(n)
                for g in n.generators:
                    for cond in g.ifs:
                        self.truth(cond, n.lineno, "comprehension filter")
            elif isinstance(n, ast.Call):
                self.scan_call(n)
        if not self.quiet:
            for n in ast.walk(e):
                if isinstance(n, ast.Lambda):
                    self.c.scan_nested(self, n)

    def scan_call(self, n: ast.Call) -> None:
        f = n.func
        tn = self.torch_name(f)
        if isinstance(f, ast.Attribute) and tn is None:
            if f.attr in ("cpu", "numpy") or (f.attr in ("item", "tolist", "nonzero")
                                              and self.is_tensor(f.value)):
                self.flag(n.lineno, f".{f.attr}() reads a tensor back to the host")
            elif f.attr == "synchronize":
                self.flag(n.lineno, ".synchronize() waits for the device")
            elif f.attr == "to" and _to_cpu(n):
                self.flag(n.lineno, '.to("cpu") copies a tensor back to the host')
        if tn is not None:
            if tn in _SYNC_TORCH_CALLS:
                self.flag(n.lineno, f"{tn}() synchronizes with the device")
            elif tn == "torch.where" and len(n.args) == 1 and not n.keywords:
                self.flag(n.lineno, "one-argument torch.where() (a nonzero) "
                                    "reads the count back")
            elif tn in ("torch.tensor", "torch.as_tensor") and n.args \
                    and not self.kind(n.args[0]) and _to_device(n):
                self.flag(n.lineno, f"{tn}() of host data onto a device copies "
                                    f"from pageable memory and synchronizes")
        if isinstance(f, ast.Name) and f.id in ("int", "float", "bool") and \
                any(self.is_tensor(a) for a in n.args):
            self.flag(n.lineno, f"{f.id}() of a tensor reads it back to the host")
        if self.quiet:
            return
        # reach: the callee, typed from this call, and functions passed by name
        for rel, qn, mode in self.c.index.resolve_call(self.relpath, f):
            fn = self.c.index.function(rel, qn)
            kinds = _default_kinds(fn) if mode == "backward" else \
                self.call_kinds(fn, n, skip=1 if mode == "forward" else 0)
            self.c.visit(rel, qn, kinds, self.scope)
        for a in (*n.args, *(k.value for k in n.keywords)):
            for rel, qn, _ in self.c.index.resolve_call(self.relpath, a):
                self.c.visit(rel, qn, _default_kinds(self.c.index.function(rel, qn)),
                             self.scope)

    def call_kinds(self, fn, call: ast.Call, skip: int = 0) -> Dict[str, str]:
        """A callee's parameter kinds at this call: each unannotated
        parameter takes its argument's kind (``skip`` leading parameters,
        an autograd Function's ctx, are tensors); an annotated one keeps
        its annotation's."""
        params = _params(fn)
        positional = [*fn.args.posonlyargs, *fn.args.args]
        given: Dict[str, Optional[str]] = {p.arg: _T for p in positional[:skip]}
        rest = positional[skip:]
        for i, a in enumerate(call.args):
            if isinstance(a, ast.Starred):
                if self.kind(a.value):
                    for p in rest[i:]:
                        given[p.arg] = _T
                    if fn.args.vararg is not None:
                        given[fn.args.vararg.arg] = _C
                break
            if i < len(rest):
                given[rest[i].arg] = self.kind(a)
            elif fn.args.vararg is not None and self.kind(a):
                given[fn.args.vararg.arg] = _C
        names = {p.arg for p in params}
        for k in call.keywords:
            if k.arg in names:
                given[k.arg] = self.kind(k.value)
            elif k.arg is None and self.kind(k.value):
                for p in params:
                    given.setdefault(p.arg, _T)
        out: Dict[str, str] = {}
        for p in params:
            if p.arg in _STATIC_PARAM_NAMES:
                continue
            kind = given.get(p.arg) if p.annotation is None else \
                _annotation_kind(p.annotation)
            if kind:
                out[p.arg] = kind
        if fn.args.vararg is not None and given.get(fn.args.vararg.arg):
            out[fn.args.vararg.arg] = _C
        return out

    # ---- statements --------------------------------------------------
    def returns(self) -> Optional[str]:
        return _merge(*(self.kind(n.value) for n in _walk_shallow(self.fn)
                        if isinstance(n, ast.Return) and n.value is not None))

    def run(self) -> None:
        if isinstance(self.fn, ast.Lambda):
            body = [ast.Return(value=self.fn.body, lineno=self.fn.lineno,
                               col_offset=self.fn.col_offset)]
        else:
            body = self.fn.body
        for _ in range(2):
            self.block(body)

    def block(self, stmts) -> None:
        for s in stmts:
            self.stmt(s)

    def stmt(self, s: ast.stmt) -> None:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not self.quiet:
                self.c.scan_nested(self, s)
            return
        if isinstance(s, ast.ClassDef):
            return
        if isinstance(s, ast.Assign):
            self.scan_expr(s.value)
            for t in s.targets:
                self.bind_value(t, s.value)
            return
        if isinstance(s, (ast.AnnAssign, ast.AugAssign)):
            if s.value is not None:
                self.scan_expr(s.value)
                kind = self.kind(s.value)
                if isinstance(s, ast.AugAssign):
                    kind = _merge(kind, self.kind(s.target))
                self.bind(s.target, kind)
            return
        if isinstance(s, (ast.If, ast.While)):
            self.scan_expr(s.test, tested=True)
            self.truth(s.test, s.lineno, "Python if" if isinstance(s, ast.If)
                       else "Python while")
            self.block(s.body)
            self.block(s.orelse)
            return
        if isinstance(s, ast.Assert):
            self.scan_expr(s.test, tested=True)
            self.truth(s.test, s.lineno, "assert")
            return
        if isinstance(s, (ast.For, ast.AsyncFor)):
            self.scan_expr(s.iter)
            self.bind_iter(s.target, s.iter)
            self.block(s.body)
            self.block(s.orelse)
            return
        if isinstance(s, (ast.With, ast.AsyncWith)):
            for item in s.items:
                self.scan_expr(item.context_expr)
            self.block(s.body)
            return
        if isinstance(s, ast.Try):
            self.block(s.body)
            for h in s.handlers:
                self.block(h.body)
            self.block(s.orelse)
            self.block(s.finalbody)
            return
        self.scan_expr(s)


def _to_cpu(n: ast.Call) -> bool:
    """``.to("cpu")``, ``.to(device="cpu")``, ``.to(torch.device("cpu"))``."""
    vals = list(n.args[:1]) + [k.value for k in n.keywords if k.arg == "device"]
    for v in vals:
        if isinstance(v, ast.Call) and v.args:
            v = v.args[0]
        if isinstance(v, ast.Constant) and v.value == "cpu":
            return True
    return False


def _to_device(n: ast.Call) -> bool:
    """A ``device=`` keyword other than the constant ``"cpu"``."""
    for k in n.keywords:
        if k.arg == "device":
            return not (isinstance(k.value, ast.Constant) and k.value.value == "cpu")
    return False


class _C2:
    """The walk from each capture scope through its reach. A function is
    scanned when first reached and again only when a call gives one of its
    parameters a kind it did not have (the kinds only grow, so the walk
    ends); flags are deduplicated."""

    def __init__(self, index: _Index, report: AnalysisReport):
        self.index = index
        self.report = report
        self.kinds: Dict[object, Dict[str, str]] = {}   # function -> its parameters' kinds
        self.reached: Set[Tuple[str, str]] = set()
        self.flagged: Set[Tuple[str, int, str]] = set()
        self._returns: Dict[Tuple[str, str], Optional[str]] = {}

    def flag(self, site: str, lineno: int, what: str, scope: str) -> None:
        key = (site, lineno, what)
        if key in self.flagged:
            return                                  # two passes revisit lines
        self.flagged.add(key)
        _emit(self.report, "C2-sync", "error", site,
              f"line {lineno}: {what} [reached from {scope}]")

    def run(self, scopes: Mapping[Tuple[str, str], FrozenSet[str]]) -> None:
        for (rel, qn), static in scopes.items():
            fn = self.index.function(rel, qn)
            if fn is not None:
                self.visit(rel, qn, _default_kinds(fn, static), f"{rel}:{qn}")

    def _grown(self, key, kinds: Dict[str, str]) -> Optional[Dict[str, str]]:
        old = self.kinds.get(key)
        if old is None:
            new = dict(kinds)
        else:
            new = {k: _merge(old.get(k), kinds.get(k)) for k in {*old, *kinds}}
            if new == old:
                return None
        self.kinds[key] = new
        return new

    def visit(self, rel: str, qn: str, kinds: Dict[str, str], scope: str) -> None:
        fn = self.index.function(rel, qn)
        if fn is None:
            return
        self.reached.add((rel, qn))
        new = self._grown((rel, qn), kinds)
        if new is not None:
            _SyncScan(self, rel, qn, fn, new, scope).run()

    def scan_nested(self, outer: _SyncScan, fn) -> None:
        """A def or lambda inside a scanned function runs on its caller's
        schedule: scanned with the closure's kinds and its own parameters'
        defaults."""
        kinds = dict(outer.kinds)
        for name in (p.arg for p in (*_params(fn), fn.args.vararg, fn.args.kwarg) if p):
            kinds.pop(name, None)
        kinds.update(_default_kinds(fn))
        new = self._grown(id(fn), kinds)
        if new is None:
            return
        name = getattr(fn, "name", "<lambda>")
        inner = _SyncScan(self, outer.relpath, f"{outer.qualname}.<locals>.{name}", fn,
                          new, outer.scope)
        inner.torch_alias = dict(outer.torch_alias)
        inner.run()

    def return_kind(self, rel: str, qn: str) -> Optional[str]:
        """A port function's return kind: its annotation's, else what its
        return statements give with its parameters' default kinds."""
        key = (rel, qn)
        if key not in self._returns:
            self._returns[key] = None               # a recursive call: none
            fn = self.index.function(rel, qn)
            if fn.returns is not None:
                self._returns[key] = _annotation_kind(fn.returns)
            else:
                scan = _SyncScan(self, rel, qn, fn, _default_kinds(fn), "", quiet=True)
                scan.run()
                self._returns[key] = scan.returns()
        return self._returns[key]


# ======================================================================
# C3: private or experimental torch modules
# ======================================================================

def _private_path(dotted: str) -> bool:
    parts = dotted.split(".")
    if parts[0] != "torch":
        return False
    return any(p.startswith("_") or p == "_internal" or "experimental" in p
               for p in parts[1:])


def _check_private_api(relpath: str, tree: ast.Module,
                       report: AnalysisReport) -> None:
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            mods = [a.name for a in n.names]
        elif isinstance(n, ast.ImportFrom) and n.module and not n.level:
            mods = [n.module] if _private_path(n.module) else \
                [f"{n.module}.{a.name}" for a in n.names]
        else:
            continue
        for mod in mods:
            if not _private_path(mod):
                continue
            reason = SANCTIONED_PRIVATE_IMPORTS.get((relpath, mod))
            if reason is not None:
                report.meta.setdefault("sanctioned", []).append(
                    {"site": f"{relpath}:{n.lineno}", "module": mod, "reason": reason})
                continue
            report.add("C3-private-api", "error", relpath,
                       f"line {n.lineno}: import of the private or experimental "
                       f"module {mod}: its API changes between PyTorch releases; "
                       f"sanction the site with its reason in "
                       f"SANCTIONED_PRIVATE_IMPORTS or use a public API")


# ======================================================================
# C4: dispatch-shape discipline
# ======================================================================

def _check_dispatch(relpath: str, tree: ast.Module,
                    qualnames: Dict[int, str],
                    report: AnalysisReport) -> None:
    # enclosing-function map for every call node
    encl: Dict[int, str] = {}

    def assign_encl(fn, qn):
        for n in _walk_shallow(fn):
            encl[id(n)] = qn

    for n in ast.walk(tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            assign_encl(n, qualnames.get(id(n), n.name))

    for n in ast.walk(tree):
        if not isinstance(n, ast.Call):
            continue
        tail = _dotted(n.func).split(".")[-1]
        qn = encl.get(id(n), "<module>")
        site = f"{relpath}:{qn}"
        if tail == "pack_beam":
            k_arg = None
            if len(n.args) >= 2:
                k_arg = n.args[1]
            else:
                for kw in n.keywords:
                    if kw.arg == "k_max":
                        k_arg = kw.value
            if k_arg is None:
                continue
            ok = False
            for sub in ast.walk(k_arg):
                if isinstance(sub, ast.Call) \
                        and _dotted(sub.func).split(".")[-1] == "bucket_k":
                    ok = True
                elif (isinstance(sub, ast.Name) and sub.id == "k_max") or \
                        (isinstance(sub, ast.Attribute)
                         and sub.attr == "k_max"):
                    ok = True
            if not ok and isinstance(k_arg, ast.Name):
                # local assigned from bucket_k(...) earlier in the function
                for fn_node in ast.walk(tree):
                    if isinstance(fn_node, (ast.FunctionDef,
                                            ast.AsyncFunctionDef)) \
                            and qualnames.get(id(fn_node)) == qn:
                        for a in _walk_shallow(fn_node):
                            if (isinstance(a, ast.Assign)
                                    and isinstance(a.value, ast.Call)
                                    and _dotted(a.value.func).split(".")[-1]
                                    == "bucket_k"
                                    and any(isinstance(t, ast.Name)
                                            and t.id == k_arg.id
                                            for t in a.targets)):
                                ok = True
            if not ok:
                _emit(report, "C4-dispatch", "error", site,
                      f"line {n.lineno}: pack_beam k argument does not flow "
                      f"through bucket_k/k_max: unbounded shapes for the "
                      f"device admission pass downstream")
        elif tail in _ENTRYPOINT_WRAPPERS:
            allowed = _ENTRYPOINT_WRAPPERS[tail]
            if not any(relpath.endswith(mod)
                       and (qn == f or qn.endswith("." + f))
                       for mod, f in allowed):
                _emit(report, "C4-dispatch", "error", site,
                      f"line {n.lineno}: direct call into the device entry "
                      f"point {tail}() outside its wrapper "
                      f"{[f'{m}:{f}' for m, f in allowed]}: bypasses "
                      f"bucketing and shape discipline")


# ======================================================================
# entry points
# ======================================================================

def _emit(report: AnalysisReport, rule: str, severity: str, site: str,
          detail: str) -> None:
    just = BASELINE.get((rule, site))
    if just is not None:
        report.meta.setdefault("baselined", []).append(
            {"rule": rule, "site": site, "detail": detail,
             "justification": just})
        return
    report.add(rule, severity, site, detail)


def check_sources(sources: Mapping[str, str], package: str = "repro_torch",
                  report: Optional[AnalysisReport] = None) -> AnalysisReport:
    """Run C1-C4 over a package given as {relpath: source}; ``package``
    is its import name (C2 resolves ``<package>.x`` imports to ``x.py``)."""
    if report is None:
        report = AnalysisReport()
    trees: Dict[str, ast.Module] = {}
    for relpath, src in sources.items():
        try:
            trees[relpath] = ast.parse(src)
        except SyntaxError as e:
            report.add("C0-syntax", "error", relpath, str(e))
    index = _Index(trees, package)
    for relpath, mod in index.modules.items():
        for rule in MUTATION_RULES:
            if any(relpath.endswith(m) for m in rule.modules):
                _check_mutation_rule(rule, relpath, list(mod.functions.items()), report)
        _check_private_api(relpath, mod.tree, report)
        _check_dispatch(relpath, mod.tree, mod.qualnames, report)
    c2 = _C2(index, report)
    c2.run(CAPTURE_SCOPES)
    report.meta["functions_reached"] = len(c2.reached)
    return report


def check_source(src: str, relpath: str,
                 report: Optional[AnalysisReport] = None) -> AnalysisReport:
    """Run C1-C4 over one module's source text (tests feed snippets here
    with a crafted ``relpath`` to select the rule scope)."""
    return check_sources({relpath: src}, report=report)


def check_tree(root: Optional[Path] = None) -> AnalysisReport:
    """Run the checker over every module of the package at ``root``
    (default: this package's directory)."""
    if root is None:
        root = Path(__file__).resolve().parent
    root = Path(root)
    files = sorted(p for p in root.rglob("*.py")
                   if "__pycache__" not in p.parts)
    sources = {p.relative_to(root).as_posix(): p.read_text() for p in files}
    report = check_sources(sources, package=root.name)
    report.meta["files_checked"] = len(files)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.staticcheck",
        description="Cache-coherence, host-sync and private-API static "
                    "checker (rules C1-C4) over the port's source.")
    ap.add_argument("--root", default=None,
                    help="package root to scan (default: the installed "
                         "repro_torch package directory)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write the report as JSON ('-' for stdout)")
    ap.add_argument("--strict", action="store_true",
                    help="exit 2 when any finding is an error")
    args = ap.parse_args(argv)

    report = check_tree(Path(args.root) if args.root else None)
    print(report.render())
    base = report.meta.get("baselined", [])
    sanctioned = report.meta.get("sanctioned", [])
    print(f"({report.meta.get('files_checked', 0)} files checked, "
          f"{report.meta.get('functions_reached', 0)} functions reached from "
          f"{len(CAPTURE_SCOPES)} capture scopes, {len(base)} baselined site(s), "
          f"{len(sanctioned)} sanctioned private import(s))")
    for b in base:
        print(f"  baselined {b['rule']} @ {b['site']}: {b['justification']}")
    for s in sanctioned:
        print(f"  sanctioned {s['module']} @ {s['site']}: {s['reason']}")
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
