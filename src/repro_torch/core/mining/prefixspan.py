"""PrefixSpan: prefix-projected sequential pattern mining (Pei et al., ICDE'01).

Mines frequent short-horizon motifs from event-signature streams (paper §3:
"Sequential pattern mining methods such as PrefixSpan naturally fit the
offline mining phase").  Items are hashable event signatures; sequences are
per-request traces.  We mine *contiguous-gap-bounded* patterns: agent motifs
like edit→test→read are near-adjacent, so a max_gap keeps patterns causal
and the search bounded.

Paper anchor: §3 (offline mining phase).  Upstream: events.py signature
streams (via workload traces).  Downstream: patterns.py
(``conditional_next`` feeds the conditional next-tool tables).
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Hashable, List, Sequence, Tuple


@dataclass(frozen=True)
class Pattern:
    items: Tuple[Hashable, ...]
    support: int                 # number of sequences containing the pattern

    def __len__(self) -> int:
        return len(self.items)


def prefixspan(
    sequences: Sequence[Sequence[Hashable]],
    min_support: int = 2,
    max_len: int = 5,
    max_gap: int = 2,
) -> List[Pattern]:
    """Mine frequent sequential patterns.

    Returns patterns sorted by (length desc, support desc).  ``max_gap``
    bounds the number of skipped events between CONSECUTIVE pattern items
    (gap=1 means strictly contiguous); the first item may occur anywhere.

    Projections track EVERY in-window occurrence position per sequence
    (standard gap-constrained pseudo-projection).  Keeping only the
    earliest occurrence undercounts: in ``[a b a c]`` with ``max_gap=2``
    the pattern ``(a, c)`` is supported by the second ``a`` (adjacent to
    ``c``) even though the window after the first ``a`` contains no ``c``.
    """
    # projected database: (seq_idx, next_start_pos) — possibly several
    # positions per sequence, one per valid occurrence of the prefix
    def project(db: List[Tuple[int, int]], item: Hashable,
                anchored: bool) -> List[Tuple[int, int]]:
        out = []
        seen = set()
        for si, pos in db:
            seq = sequences[si]
            end = min(len(seq), pos + max_gap) if anchored else len(seq)
            for j in range(pos, end):
                if seq[j] == item and (si, j + 1) not in seen:
                    seen.add((si, j + 1))
                    out.append((si, j + 1))
        return out

    results: List[Pattern] = []

    def grow(prefix: Tuple[Hashable, ...], db: List[Tuple[int, int]]):
        if len(prefix) >= max_len:
            return
        # count candidate next items: gap-windowed after a non-empty prefix,
        # anywhere in the sequence for the pattern's first item
        anchored = bool(prefix)
        counts: Dict[Hashable, set] = defaultdict(set)
        for si, pos in db:
            seq = sequences[si]
            end = min(len(seq), pos + max_gap) if anchored else len(seq)
            for j in range(pos, end):
                counts[seq[j]].add(si)
        for item, seqs in sorted(counts.items(), key=lambda kv: repr(kv[0])):
            sup = len(seqs)
            if sup < min_support:
                continue
            new_prefix = prefix + (item,)
            results.append(Pattern(new_prefix, sup))
            grow(new_prefix, project(db, item, anchored))

    root_db = [(i, 0) for i in range(len(sequences))]
    grow((), root_db)
    results.sort(key=lambda p: (-len(p.items), -p.support, repr(p.items)))
    return results


def conditional_next(
    sequences: Sequence[Sequence[Hashable]],
    context_len: int = 2,
    min_count: int = 2,
) -> Dict[Tuple[Hashable, ...], Dict[Hashable, float]]:
    """Empirical P(next item | last `context_len` items) tables — the (C, p)
    part of PASTE pattern tuples, for every context length 1..context_len."""
    counts: Dict[Tuple, Dict[Hashable, int]] = defaultdict(lambda: defaultdict(int))
    for seq in sequences:
        for i in range(1, len(seq)):
            for cl in range(1, context_len + 1):
                if i - cl < 0:
                    continue
                ctx = tuple(seq[i - cl : i])
                counts[ctx][seq[i]] += 1
    tables: Dict[Tuple, Dict[Hashable, float]] = {}
    for ctx, nxt in counts.items():
        total = sum(nxt.values())
        if total < min_count:
            continue
        tables[ctx] = {k: v / total for k, v in nxt.items()}
    return tables
