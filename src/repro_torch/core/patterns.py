"""PASTE pattern tuples (C, T, f, p) + late-bound argument resolvers Φ.

The context C is an event-signature suffix; T the predicted tool; f a
*late-binding* argument mapping (args derived from prior tool outputs via
simple transformations, per PASTE's data-flow regularity observation); p the
empirical confidence.  B-PASTE uses these as building blocks for assembling
bounded future subgraphs (hypothesis.py).

Paper anchor: §3 (pattern tuples, data-flow regularities), Eq. 1's Φ (the
late-bound argument resolvers hypotheses carry).
Upstream: mining/prefixspan.py (motifs), events.py (signatures).
Downstream: hypothesis.py (root prediction + tree expansion via
``PatternEngine.predict_sigs``), runtime.py (miss-pruning predictions).
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence, Tuple

from repro_torch.core.events import Event, Trace, signature, trace_signatures
from repro_torch.core.mining.prefixspan import conditional_next, prefixspan

# ----------------------------------------------------------------------
# Late-binding transformations: arg <- transform(prior event output field)
# ----------------------------------------------------------------------

def _t_identity(v):
    return v


def _t_first(v):
    if isinstance(v, (list, tuple)) and v:
        return v[0]
    return None


def _t_basename(v):
    return os.path.basename(v) if isinstance(v, str) else None


def _t_dirname(v):
    return os.path.dirname(v) if isinstance(v, str) else None


TRANSFORMS: Dict[str, Callable[[Any], Any]] = {
    "identity": _t_identity,
    "first": _t_first,
    "basename": _t_basename,
    "dirname": _t_dirname,
}


@dataclass(frozen=True)
class ArgBinding:
    """arg_name <- transform(source event's result field).  source_offset is
    the (negative) event index relative to the prediction point."""
    arg_name: str
    source_offset: int           # -1 = immediately preceding event, etc.
    source_field: Optional[str]  # None = whole result; else result[field]
    transform: str               # key into TRANSFORMS

    def resolve(self, history: Sequence[Event]) -> Any:
        if len(history) < -self.source_offset:
            return None
        ev = history[self.source_offset]
        v = ev.result
        if self.source_field is not None:
            if isinstance(v, dict):
                v = v.get(self.source_field)
            else:
                v = getattr(v, self.source_field, None)
        return TRANSFORMS[self.transform](v)


@dataclass(frozen=True)
class PatternTuple:
    """PASTE (C, T, f, p)."""
    context: Tuple[Hashable, ...]       # event-signature suffix
    tool: str                           # predicted tool T
    bindings: Tuple[ArgBinding, ...]    # f (late-binding arg mapping)
    confidence: float                   # p
    next_sig: Optional[Hashable] = None # full predicted event signature
    missing_args: Tuple[str, ...] = () # observed args with NO reliable binding
                                        # (model-originated — a speculation
                                        # boundary, cf. PASTE's "freshly
                                        # hallucinated" arguments)

    def resolve_args(self, history: Sequence[Event]) -> Dict[str, Any]:
        return {b.arg_name: b.resolve(history) for b in self.bindings}


def _candidate_values(ev: Event) -> List[Tuple[Optional[str], str, Any]]:
    """(field, transform, value) candidates derivable from an event result."""
    out = []
    results = [(None, ev.result)]
    if isinstance(ev.result, dict):
        results += [(k, v) for k, v in ev.result.items()]
    for fieldname, v in results:
        for tname, fn in TRANSFORMS.items():
            try:
                tv = fn(v)
            except Exception:
                tv = None
            if tv is not None and isinstance(tv, (str, int, float)):
                out.append((fieldname, tname, tv))
    return out


def mine_bindings(
    traces: Sequence[Trace], context: Tuple, tool: str, lookback: int = 3,
    min_frac: float = 0.6,
) -> Tuple[Tuple[ArgBinding, ...], Tuple[str, ...]]:
    """For each arg of `tool` occurring after `context`, find a (offset,
    field, transform) that reproduces the observed value in >= min_frac of
    occurrences — PASTE's data-flow regularity mining."""
    # collect (history, args) occurrences
    occs: List[Tuple[List[Event], Dict[str, Any]]] = []
    cl = len(context)
    for tr in traces:
        sigs = trace_signatures(tr)
        for i in range(cl, len(tr)):
            if tr[i].tool == tool and tuple(sigs[i - cl : i]) == context:
                occs.append((tr[:i], tr[i].args))
    if not occs:
        return (), ()
    arg_names = sorted({k for _, a in occs for k in a})
    bindings: List[ArgBinding] = []
    for arg in arg_names:
        best: Optional[ArgBinding] = None
        best_frac = 0.0
        # hit fractions denominate over ALL occurrences carrying the arg:
        # an offset only reachable in a few occurrences (len(hist) < off
        # elsewhere) must not score its hits against that tiny sample — a
        # frac-1.0-of-2 binding would beat a frac-0.9-of-20 one and resolve
        # garbage on the 18 histories where its source event doesn't exist
        n_arg = sum(1 for _, args in occs if arg in args)
        for off in range(1, lookback + 1):
            # tally candidate (field, transform) hits across occurrences
            tallies: Dict[Tuple[Optional[str], str], int] = {}
            for hist, args in occs:
                if arg not in args or len(hist) < off:
                    continue
                for fieldname, tname, tv in _candidate_values(hist[-off]):
                    if tv == args[arg]:
                        tallies[(fieldname, tname)] = tallies.get((fieldname, tname), 0) + 1
            for (fieldname, tname), hits in tallies.items():
                frac = hits / max(n_arg, 1)
                # prefer equally-reliable bindings with EARLIER sources: their
                # inputs materialize sooner, so branch nodes can launch while
                # later tools are still in flight
                if frac > best_frac or (frac == best_frac and best is not None
                                        and -off < best.source_offset):
                    best_frac = frac
                    best = ArgBinding(arg, -off, fieldname, tname)
        if best is not None and best_frac >= min_frac:
            bindings.append(best)
    bound = {b.arg_name for b in bindings}
    missing = tuple(a for a in arg_names if a not in bound)
    return tuple(bindings), missing


@dataclass
class PatternEngine:
    """Offline-mined pattern store + online next-tool prediction."""
    context_len: int = 2
    min_support: int = 2
    patterns: List[PatternTuple] = field(default_factory=list)
    next_tables: Dict[Tuple, Dict[Hashable, float]] = field(default_factory=dict)
    motifs: List = field(default_factory=list)
    # context -> [(pattern, confidence) desc] — prediction is on the per-tick
    # hot path (every tree-node expansion queries it), so no linear scans
    _by_context: Dict[Tuple, List[Tuple[PatternTuple, float]]] = field(
        default_factory=dict, repr=False)

    def fit(self, traces: Sequence[Trace]) -> "PatternEngine":
        seqs = [trace_signatures(t) for t in traces]
        self.next_tables = conditional_next(seqs, self.context_len, self.min_support)
        self.motifs = prefixspan(seqs, min_support=self.min_support, max_len=5, max_gap=1)
        # build pattern tuples for the most confident (context -> tool) pairs
        self.patterns = []
        for ctx, table in self.next_tables.items():
            for nxt_sig, p in table.items():
                tool = nxt_sig[1]
                bindings, missing = mine_bindings(traces, ctx, tool)
                self.patterns.append(
                    PatternTuple(ctx, tool, bindings, p, nxt_sig, missing))
        self.patterns.sort(key=lambda pt: -pt.confidence)
        self._index()
        return self

    def _index(self) -> Dict[Tuple, List[Tuple[PatternTuple, float]]]:
        self._by_context = {}
        for pt in self.patterns:          # already confidence-descending
            self._by_context.setdefault(pt.context, []).append(
                (pt, pt.confidence))
        return self._by_context

    def predict(
        self, history: Sequence[Event], top: int = 4, backoff: str = "longest"
    ) -> List[Tuple[PatternTuple, float]]:
        """Top candidate next tools for the current history (longest matching
        context wins; confidence from the empirical table)."""
        return self.predict_sigs([signature(e) for e in history], top, backoff)

    def predict_sigs(
        self, sigs: Sequence[Hashable], top: int = 4, backoff: str = "longest"
    ) -> List[Tuple[PatternTuple, float]]:
        """Signature-space prediction (used for subgraph expansion, where
        future events exist only as predicted signatures).

        backoff="longest": candidates from the longest matching context only
        (the classic backoff — stop at the most specific table).
        backoff="merge": candidates from every matching context length,
        most-specific first, deduplicated by predicted signature — shorter
        contexts contribute *additional* distinct roots, which is what lets
        a beam fill past the fan-out of one table (multi-root fill)."""
        by_ctx = self._by_context or (self._index() if self.patterns else {})
        merged: List[Tuple[PatternTuple, float]] = []
        seen_sigs = set()
        for cl in range(self.context_len, 0, -1):
            if len(sigs) < cl:
                continue
            ctx = tuple(sigs[-cl:])
            cands = [(pt, c) for pt, c in by_ctx.get(ctx, ())
                     if pt.next_sig not in seen_sigs]
            if backoff == "longest":
                if cands:
                    return cands[:top]
                continue
            for pt, _ in cands:
                seen_sigs.add(pt.next_sig)
            merged.extend(cands)
            if len(merged) >= top:
                break
        return merged[:top]
