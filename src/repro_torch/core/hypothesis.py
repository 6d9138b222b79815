"""Branch hypotheses H = (G, q, Φ, ρ, σ)  (paper Eq. 1, §4).

A hypothesis packages a *bounded local future subgraph* G (Tool /
Preparation / Model / Barrier-Commit nodes with edges), the follow
probability q, late-bound argument resolvers Φ, an aggregate multi-resource
profile ρ, and safety annotations σ.  Hypotheses are assembled online from
PASTE pattern tuples: each root candidate (context → tool) is grown
best-first into a bounded **tree** — every node is extended with the top
``branch_factor`` continuations from the pattern engine, with the parent's
follow mass split across children via the empirical conditional
probabilities — up to (max_depth, max_nodes) bounds, inserting PREP nodes
before cold tools and BARRIER nodes before Level-2 (staged-write) nodes.
The beam is filled with one tree per predicted root (multi-root fill, roots
drawn with merged context backoff), so no single root can monopolize
``beam_width``.

``assembly="chain"`` keeps the pre-tree behavior (each root expanded with
its single most likely continuation into a linear chain) as a measured
baseline for benchmarks/bench_beam.py.

Paper anchor: Eq. 1 (hypothesis tuple), §4 (bounded local future
subgraphs), §6.3 (safe prefix — here the frontier region
``safe_prefix()``), §7 (PREP/BARRIER insertion per safety level).
Upstream: patterns.py (root predictions, continuations, arg bindings),
events.py (ToolSpec ρ/latency/levels).  Downstream: scoring.py packs
beams of these into padded tables, admission.py admits them, runtime.py
executes them as HypRun branches inside sandboxes.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.events import (
    DEFAULT_TOOLS, Event, ResourceVector, SafetyLevel, ToolSpec, signature,
)
from repro_torch.core.patterns import ArgBinding, PatternEngine, PatternTuple


class NodeKind(str, Enum):
    TOOL = "tool"
    PREP = "prep"
    MODEL = "model"
    BARRIER = "barrier"


@dataclass
class Node:
    """One node of a future subgraph."""
    idx: int
    kind: NodeKind
    tool: str
    level: SafetyLevel
    rho: ResourceVector
    est_latency: float
    bindings: Tuple[ArgBinding, ...] = ()
    missing_args: Tuple[str, ...] = ()
    cond_prob: float = 1.0        # P(this node | parent executed)

    @property
    def speculative_allowed(self) -> bool:
        return self.level != SafetyLevel.NON_SPECULATIVE


@dataclass
class BranchHypothesis:
    """H_i = (G_i, q_i, Φ_i, ρ_i, σ_i)."""
    hid: int
    nodes: List[Node]
    edges: List[Tuple[int, int]]          # DAG over node idx
    q: float                              # follow probability
    context_key: Tuple                    # signature context it was built from
    created_t: float = 0.0
    model_idx: int = -1                   # idx of the terminal MODEL join
    spine_leaf: int = -1                  # idx of the max-path_q leaf: the
                                          # continuation the speculative
                                          # model step assumes (two-segment
                                          # assembly emits this leaf's edge
                                          # into the MODEL join FIRST, so
                                          # path_to(model_idx) walks the
                                          # spine)

    # ---- derived ----
    @property
    def rho(self) -> ResourceVector:
        """Aggregate resource profile (peak over the serial chain = max)."""
        agg = ResourceVector()
        for n in self.nodes:
            agg = ResourceVector(
                max(agg.cpu, n.rho.cpu), max(agg.mem_bw, n.rho.mem_bw),
                max(agg.io, n.rho.io), max(agg.accel, n.rho.accel),
            )
        return agg

    @property
    def sigma(self) -> SafetyLevel:
        """Strictest safety class present."""
        return max((n.level for n in self.nodes), default=SafetyLevel.READ_ONLY)

    def solo_latency(self) -> float:
        return sum(n.est_latency for n in self.nodes)

    def parent_map(self) -> Dict[int, Tuple[int, ...]]:
        """idx -> parent idx tuple.  Nodes are emitted in topological order
        (parents precede children in ``nodes``); only the terminal MODEL
        join has more than one parent."""
        parents: Dict[int, List[int]] = {}
        for i, j in self.edges:
            parents.setdefault(j, []).append(i)
        return {j: tuple(ps) for j, ps in parents.items()}

    def path_to(self, idx: int,
                parents: Optional[Dict[int, Tuple[int, ...]]] = None) -> List[int]:
        """Root-to-node index path.  Every non-MODEL node has at most one
        parent, so the path is unique (MODEL joins are never path targets).
        Callers holding a cached ``parent_map()`` can pass it in."""
        if parents is None:
            parents = self.parent_map()
        path = [idx]
        while True:
            ps = parents.get(path[0], ())
            if not ps:
                return path
            path.insert(0, ps[0])

    def safe_prefix(self, allow_staged: bool = True) -> List[Node]:
        """Speculatively-executable frontier region of G (§6.3).

        A node is in the prefix iff it is executable AND every ancestor on
        its root path is prefix-transparent — a per-branch generalization of
        the linear "longest prefix": one blocked branch no longer cuts off
        its siblings.  MODEL nodes are future reasoning boundaries — never
        executed by the tool-speculation runtime (they bound their branch).
        BARRIER nodes bound a branch unless the policy allows staged Level-2
        execution (writes stay sandbox-local until authoritative
        confirmation either way); when passed they are transparent but not
        emitted.  NON_SPECULATIVE and model-originated-args TOOL nodes bound
        their branch."""
        parents = self.parent_map()
        open_: Dict[int, bool] = {}
        out = []
        for n in self.nodes:                       # topological order
            ps = parents.get(n.idx, ())
            if ps and not all(open_.get(p, False) for p in ps):
                open_[n.idx] = False
                continue
            if n.kind == NodeKind.MODEL:
                open_[n.idx] = False
                continue
            if n.kind == NodeKind.BARRIER:
                open_[n.idx] = allow_staged
                continue
            if n.level == SafetyLevel.NON_SPECULATIVE:
                open_[n.idx] = False
                continue
            if n.kind == NodeKind.TOOL and n.missing_args:
                open_[n.idx] = False   # model-originated args: not executable
                continue
            open_[n.idx] = True
            out.append(n)
        return out

    def first_tool(self) -> Optional[Node]:
        for n in self.nodes:
            if n.kind == NodeKind.TOOL:
                return n
        return None


COLD_TOOLS = frozenset({"test", "build", "pip_install"})


def barrier_violations(h: BranchHypothesis) -> List[int]:
    """Node indices of Level-2+ TOOL nodes missing their commit BARRIER.

    The assembly invariant (§4.1, §6.3): every TOOL node whose safety level
    is STAGED_WRITE or stricter has a BARRIER node as its immediate parent,
    so staged writes can never leak past an unconfirmed prefix.  The static
    analyzer (core/analysis.py rule R4) checks this on real assembled beams
    rather than trusting the builder."""
    by_idx = {n.idx: n for n in h.nodes}
    parents = h.parent_map()
    bad: List[int] = []
    for n in h.nodes:
        if n.kind != NodeKind.TOOL or n.level < SafetyLevel.STAGED_WRITE:
            continue
        ps = parents.get(n.idx, ())
        if not any(by_idx[p].kind == NodeKind.BARRIER for p in ps):
            bad.append(n.idx)
    return bad


@dataclass
class _TreeNode:
    """Expansion-time tree of pattern tuples (pre-assembly)."""
    pt: PatternTuple
    cond: float                   # P(this node | parent executed)
    path_q: float                 # root_p · Π cond along the root path
    depth: int
    children: List["_TreeNode"] = field(default_factory=list)


@dataclass
class HypothesisBuilder:
    engine: PatternEngine
    tools: Dict[str, ToolSpec] = field(default_factory=lambda: dict(DEFAULT_TOOLS))
    max_depth: int = 4
    max_nodes: int = 8
    branch_factor: int = 3
    min_q: float = 0.05
    with_prep: bool = True        # PREP nodes are a B-PASTE §4.1 feature
    assembly: str = "tree"        # "tree" | "chain" (pre-tree linear baseline)
    spec_steps: bool = False      # two-segment trees: continue past the MODEL
                                  # join with the mined table's top predicted
                                  # continuation (speculative reasoning steps)
    _next_hid: itertools.count = field(default_factory=itertools.count)

    def _context_key(self, history: Sequence[Event]) -> Tuple:
        """Signature suffix identifying the build context — as long as the
        engine's mining context (NOT a hard-coded 2: an engine configured
        with a different ``context_len`` must produce keys the runtime's
        carry-over classification can compare against its own tails)."""
        cl = self.engine.context_len
        return tuple(signature(e) for e in history[-cl:]) if cl > 0 else ()

    def _tool_node(self, idx: int, pt: PatternTuple, cond: float) -> Node:
        spec = self.tools[pt.tool]
        return Node(
            idx=idx, kind=NodeKind.TOOL, tool=pt.tool, level=spec.level,
            rho=spec.rho, est_latency=spec.base_latency,
            bindings=pt.bindings, missing_args=pt.missing_args, cond_prob=cond,
        )

    def build(self, history: Sequence[Event], now: float = 0.0,
              beam_width: int = 8) -> List[BranchHypothesis]:
        """Enumerate up to beam_width branch hypotheses for the current state.

        Tree assembly: one bounded tree-shaped subgraph per predicted root,
        roots drawn with merged context-backoff (multi-root fill — beam
        width is bounded by root supply, never by the first root saturating
        it).  Chain assembly (baseline): linear chains, first root may
        monopolize the beam."""
        if self.assembly == "chain":
            return self._build_chains(history, now, beam_width)
        sigs = [signature(e) for e in history]
        # multi-root fill: one bounded tree per predicted root (merged
        # backoff supplies roots past the most specific table's fan-out),
        # so the beam width is bounded by root supply, never by the first
        # root saturating it
        roots = self.engine.predict_sigs(sigs, top=beam_width, backoff="merge")
        hyps: List[BranchHypothesis] = []
        for root_pt, root_p in roots:
            if root_p < self.min_q:
                continue
            tree = self._expand_tree(sigs, root_pt, root_p)
            hyps.append(self._assemble_tree(tree, root_p, history, now))
        return hyps

    def _build_chains(self, history: Sequence[Event], now: float,
                      beam_width: int) -> List[BranchHypothesis]:
        roots = self.engine.predict(history, top=self.branch_factor)
        sigs = [signature(e) for e in history]
        hyps: List[BranchHypothesis] = []
        for root_pt, root_p in roots:
            chains = self._expand_chain(sigs, root_pt, root_p)
            for chain_pts, q in chains:
                if q < self.min_q:
                    continue
                hyps.append(self._assemble(chain_pts, q, history, now))
                if len(hyps) >= beam_width:
                    break
            if len(hyps) >= beam_width:
                break
        return hyps

    def _node_cost(self, pt: PatternTuple) -> int:
        """Assembled-node footprint of one pattern tuple (tool node plus any
        PREP / BARRIER helpers _assemble_tree will insert before it)."""
        cost = 1
        if self.with_prep and pt.tool in COLD_TOOLS:
            cost += 1
        if self.tools[pt.tool].level >= SafetyLevel.STAGED_WRITE:
            cost += 1
        return cost

    def _expand_tree(
        self, sigs: List, root: PatternTuple, root_p: float
    ) -> _TreeNode:
        """Best-first tree growth: repeatedly take the highest-path-probability
        node and attach its top ``branch_factor`` continuations, splitting the
        parent's follow mass across children via the empirical conditional
        probabilities (predicted signatures appended in sig space).  Bounded
        by ``max_depth`` (tools per path), ``max_nodes`` (assembled node
        budget) and ``min_q`` (path-probability floor)."""
        root_tn = _TreeNode(root, 1.0, root_p, 1)
        budget = self.max_nodes - self._node_cost(root)
        heap: List[Tuple[float, int, _TreeNode, List]] = []
        ctr = itertools.count()

        def push(tn: _TreeNode, pseudo_sigs: List):
            if tn.depth < self.max_depth:
                heapq.heappush(heap, (-tn.path_q, next(ctr), tn, pseudo_sigs))

        push(root_tn, list(sigs) + [root.next_sig])
        while heap and budget > 0:
            _, _, tn, pseudo = heapq.heappop(heap)
            for pt, p in self.engine.predict_sigs(pseudo, top=self.branch_factor):
                q_child = tn.path_q * p
                if q_child < self.min_q or pt.next_sig is None:
                    continue
                cost = self._node_cost(pt)
                if cost > budget:
                    continue
                budget -= cost
                child = _TreeNode(pt, p, q_child, tn.depth + 1)
                tn.children.append(child)
                push(child, pseudo + [pt.next_sig])
        return root_tn

    def _assemble_tree(
        self, tree: _TreeNode, q: float, history: Sequence[Event], now: float
    ) -> BranchHypothesis:
        """Emit the bounded subgraph G: PREP before cold tools, BARRIER
        before Level-2 nodes (both on the branch's own path), branching edges
        at interior nodes, and a single MODEL join behind every leaf (the
        reasoning boundary whichever branch the agent follows).

        With ``spec_steps`` the tree is **two-segment**: the spine (max
        path-probability root-to-leaf path) continues PAST the MODEL join
        with the mined table's top predicted continuation — the reasoning
        outcome a speculative model step would assume.  The spine leaf's
        edge into the MODEL join is emitted first so ``path_to(model_idx)``
        walks the spine (``path_to`` follows first parents)."""
        nodes: List[Node] = []
        edges: List[Tuple[int, int]] = []
        leaves: List[int] = []
        leaf_info: List[Tuple[int, float, List]] = []
        idx = 0

        def emit(tn: _TreeNode, parent: Optional[int], path_sigs: List):
            nonlocal idx
            spec = self.tools[tn.pt.tool]
            prev = parent
            # preparation node before cold tools (speculative warm-up, §4.1)
            if self.with_prep and tn.pt.tool in COLD_TOOLS:
                prep_spec = self.tools["env_warmup"]
                nodes.append(Node(idx, NodeKind.PREP, "env_warmup",
                                  prep_spec.level, prep_spec.rho,
                                  prep_spec.base_latency))
                if prev is not None:
                    edges.append((prev, idx))
                prev = idx
                idx += 1
            # commit barrier before Level-2 nodes (§4.1, §6.3)
            if spec.level >= SafetyLevel.STAGED_WRITE:
                nodes.append(Node(idx, NodeKind.BARRIER, "barrier",
                                  SafetyLevel.READ_ONLY, ResourceVector(), 0.0))
                if prev is not None:
                    edges.append((prev, idx))
                prev = idx
                idx += 1
            nodes.append(self._tool_node(idx, tn.pt, tn.cond))
            if prev is not None:
                edges.append((prev, idx))
            tool_idx = idx
            idx += 1
            if not tn.children:
                leaves.append(tool_idx)
                leaf_info.append((tool_idx, tn.path_q, path_sigs))
            for child in tn.children:
                emit(child, tool_idx, path_sigs + [child.pt.next_sig])

        sigs = [signature(e) for e in history]
        emit(tree, None, sigs + [tree.pt.next_sig])
        # spine: max-path_q root-to-leaf path (ties break to emission order)
        spine_idx, _, spine_sigs = max(leaf_info, key=lambda t: t[1])
        # model node: the reasoning boundary that this subgraph would unlock
        model_spec = self.tools["model_step"]
        midx = idx
        nodes.append(Node(midx, NodeKind.MODEL, "model_step", model_spec.level,
                          model_spec.rho, model_spec.base_latency))
        if self.spec_steps:
            # spine leaf first: path_to(model_idx) must walk the spine
            for leaf in [spine_idx] + [lf for lf in leaves if lf != spine_idx]:
                edges.append((leaf, midx))
            self._emit_segment2(nodes, edges, midx, spine_sigs)
        else:
            for leaf in leaves:
                edges.append((leaf, midx))
        hist_key = self._context_key(history)
        return BranchHypothesis(
            hid=next(self._next_hid), nodes=nodes, edges=edges, q=q,
            context_key=hist_key, created_t=now,
            model_idx=midx, spine_leaf=spine_idx,
        )

    def _emit_segment2(self, nodes: List[Node], edges: List[Tuple[int, int]],
                       model_idx: int, spine_sigs: List) -> None:
        """Segment 2 of a two-segment tree: the mined table's top
        continuation PAST the reasoning boundary.  Model steps never appear
        in the mined signature stream, so the same ``predict_sigs`` call
        that would have extended the spine leaf predicts what the agent's
        next reasoning step will decide.  The subtree stays closed (MODEL
        is not in ``safe_prefix``) until the runtime validates a speculative
        model step against the authoritative history; it then launches like
        any frontier node.  PREP/BARRIER helpers are inserted exactly as in
        segment 1 (R4: staged writes keep their commit barrier)."""
        preds = self.engine.predict_sigs(spine_sigs, top=1)
        if not preds:
            return
        pt, p = preds[0]
        if p < self.min_q or pt.next_sig is None:
            return
        spec = self.tools[pt.tool]
        idx = len(nodes)
        prev = model_idx
        if self.with_prep and pt.tool in COLD_TOOLS:
            prep_spec = self.tools["env_warmup"]
            nodes.append(Node(idx, NodeKind.PREP, "env_warmup",
                              prep_spec.level, prep_spec.rho,
                              prep_spec.base_latency))
            edges.append((prev, idx))
            prev = idx
            idx += 1
        if spec.level >= SafetyLevel.STAGED_WRITE:
            nodes.append(Node(idx, NodeKind.BARRIER, "barrier",
                              SafetyLevel.READ_ONLY, ResourceVector(), 0.0))
            edges.append((prev, idx))
            prev = idx
            idx += 1
        nodes.append(self._tool_node(idx, pt, p))
        edges.append((prev, idx))

    def _expand_chain(
        self, sigs: List, root: PatternTuple, root_p: float
    ) -> List[Tuple[List[PatternTuple], float]]:
        """Depth-first chains of pattern tuples: the root plus its most
        likely continuations (predicted signatures appended in sig space)."""
        chains: List[Tuple[List[PatternTuple], float]] = []

        def grow(chain: List[PatternTuple], q: float, pseudo_sigs: List):
            chains.append((list(chain), q))
            if len(chain) >= self.max_depth:
                return
            nxt = self.engine.predict_sigs(pseudo_sigs, top=1)
            for pt, p in nxt:
                if q * p < self.min_q or pt.next_sig is None:
                    continue
                grow(chain + [pt], q * p, pseudo_sigs + [pt.next_sig])

        grow([root], root_p, list(sigs) + [root.next_sig])
        # prefer deeper chains first (they subsume shallower ones), then q
        chains.sort(key=lambda c: (-len(c[0]), -c[1]))
        # dedup: keep the maximal chain per root tool sequence
        seen = set()
        out = []
        for chain, q in chains:
            key = tuple(pt.tool for pt in chain)
            if any(key == k[: len(key)] for k in seen):
                continue
            seen.add(key)
            out.append((chain, q))
        return out

    def _assemble(
        self, chain: List[PatternTuple], q: float, history: Sequence[Event], now: float
    ) -> BranchHypothesis:
        nodes: List[Node] = []
        edges: List[Tuple[int, int]] = []
        idx = 0
        prev: Optional[int] = None
        for depth, pt in enumerate(chain):
            spec = self.tools[pt.tool]
            # preparation node before cold tools (speculative warm-up, §4.1)
            if self.with_prep and pt.tool in COLD_TOOLS:
                prep_spec = self.tools["env_warmup"]
                nodes.append(Node(idx, NodeKind.PREP, "env_warmup",
                                  prep_spec.level, prep_spec.rho,
                                  prep_spec.base_latency))
                if prev is not None:
                    edges.append((prev, idx))
                prev = idx
                idx += 1
            # commit barrier before Level-2 nodes (§4.1, §6.3)
            if spec.level >= SafetyLevel.STAGED_WRITE:
                nodes.append(Node(idx, NodeKind.BARRIER, "barrier",
                                  SafetyLevel.READ_ONLY, ResourceVector(), 0.0))
                if prev is not None:
                    edges.append((prev, idx))
                prev = idx
                idx += 1
            cond = pt.confidence if depth > 0 else 1.0
            nodes.append(self._tool_node(idx, pt, cond))
            if prev is not None:
                edges.append((prev, idx))
            prev = idx
            idx += 1
            if idx >= self.max_nodes:
                break
        # model node: the reasoning boundary that this branch would unlock
        model_spec = self.tools["model_step"]
        nodes.append(Node(idx, NodeKind.MODEL, "model_step", model_spec.level,
                          model_spec.rho, model_spec.base_latency))
        if prev is not None:
            edges.append((prev, idx))
        hist_key = self._context_key(history)
        return BranchHypothesis(
            hid=next(self._next_hid), nodes=nodes, edges=edges, q=q,
            context_key=hist_key, created_t=now,
            model_idx=idx, spine_leaf=prev if prev is not None else -1,
        )
