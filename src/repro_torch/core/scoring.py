"""Expected critical-path reduction scoring (paper Eq. 3–4), on PyTorch.

    EU(H_i | S) = q_i · ( ΔO_i(S) + λ·ΔU_i(S) − μ·ΔI_i(S) )

The port of ``repro/core/scoring.py``; DESIGN.md documents the estimators:

  ΔO_i — overlap gain: the solo latency of the admitted *prefix*, i.e. the
        serial time hidden if the agent follows this branch (capped by the
        expected idle window when provided).
  ΔU_i — downstream unlock gain: the critical-path length of the subgraph
        *behind* the prefix (longest path over G_i restricted to post-prefix
        nodes, each weighted by its conditional probability).
  ΔI_i — interference penalty: bottleneck-model stretch of the candidate
        prefix under the currently-admitted demand, plus the stretch it
        inflicts on the admitted set (Eq. 4: L^co − L^solo).

Two backends share one set of estimators:

* host numpy (``static_raw_terms``, ``finish_static_terms`` and the
  ``xp=np`` branches), line for line as in the JAX package, because the
  admission warm cache's bit-identity rests on their order of arithmetic;
* torch ops on an explicit device, in float32 as the JAX package's jitted
  paths run (x64 off): ``_critical_path``, the ``xp=torch`` branches and
  ``score_beam``.  ``device_tables`` moves a numpy ``PackedBeam`` and what
  rides alongside it to the device in one copy.

Three per-tick terms ride ALONGSIDE the packed tables (never inside them,
so pack caches survive): tenant fairness weights, the result-store reuse
term (memo masks + memo-excluded ρ), and the model-step service's
queue-delay discount on ΔU (``model_delay``).

Paper anchor: Eq. 3 (EU objective), Eq. 4 (ΔI interference term).
Upstream: hypothesis.py (beams), interference.py (Machine/stretch model),
model_service.py (expected unlock delay).  Downstream: admission.py
(shares ``static_gain_terms``/``eu_given_admitted``), runtime Phase 4.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.events import RESOURCE_DIMS
from repro_torch.core.hypothesis import BranchHypothesis
from repro_torch.core.interference import Machine


@dataclass
class PackedBeam:
    """Padded arrays for a beam of K hypotheses, Nmax nodes each.

    ``prefix_mask`` marks the speculatively-executable FRONTIER region of
    each subgraph (``BranchHypothesis.safe_prefix``): for tree-shaped
    hypotheses a blocked branch bounds only its own subtree, so the mask is
    a set of root-connected nodes, not a contiguous list prefix.  The DAG
    adjacency drives ΔU's critical path either way."""
    node_lat: np.ndarray      # (K, N)
    node_prob: np.ndarray     # (K, N) conditional probs
    node_mask: np.ndarray     # (K, N)
    prefix_mask: np.ndarray   # (K, N)
    adj: np.ndarray           # (K, N, N)  adj[k, i, j] = edge i->j
    q: np.ndarray             # (K,)
    rho: np.ndarray           # (K, R) prefix aggregate demand
    k_valid: np.ndarray       # (K,) hypothesis mask


def prefix_rho(h: BranchHypothesis, exclude: frozenset = frozenset()) -> np.ndarray:
    """Worst-case concurrent demand of the safe-prefix frontier region.

    Nodes on one root path run serially (ancestor gating), but sibling
    branches of a tree-shaped prefix may run CONCURRENTLY, so the
    element-wise max over prefix nodes (exact for linear chains) would
    understate a branchy prefix.  Per-dimension DP over the prefix
    sub-forest: conc(v) = max(rho_v, Σ_children conc(child)); disconnected
    prefix roots co-run, so their conc sums.  Reduces to the element-wise
    max for chains.

    ``exclude`` holds node idxs that demand NOTHING (memoized nodes — the
    result store serves them without execution); they stay in the tree
    structure so serial parent->child paths remain connected."""
    prefix = {n.idx: n for n in h.safe_prefix()}
    if not prefix:
        return np.zeros(RESOURCE_DIMS)
    # effective parent = nearest ANCESTOR in the prefix: BARRIER nodes are
    # prefix-transparent (passed but not emitted), so serial parent->barrier
    # ->child paths must stay connected here or the child would be summed
    # as a bogus concurrent root
    parents = h.parent_map()
    children: dict = {}
    roots = []
    for idx in prefix:
        ps = parents.get(idx, ())
        anc = ps[0] if ps else None
        while anc is not None and anc not in prefix:
            ps = parents.get(anc, ())
            anc = ps[0] if ps else None
        if anc is None:
            roots.append(idx)
        else:
            children.setdefault(anc, []).append(idx)

    def conc(i: int) -> np.ndarray:
        own = (np.zeros(RESOURCE_DIMS) if i in exclude
               else prefix[i].rho.as_array())
        kids = children.get(i)
        if not kids:
            return own
        return np.maximum(own, np.sum([conc(j) for j in kids], axis=0))

    return np.sum([conc(i) for i in roots], axis=0)


def pack_rows(h: BranchHypothesis, n_max: int) -> tuple:
    """One hypothesis's packed row set — the per-row slice of every
    PackedBeam table.  Hypotheses are immutable after build (node statuses
    live on NodeRun, never read here), so rows keyed by hid are cacheable
    forever: re-packing a pooled beam then costs an array copy per row
    instead of the safe-prefix/parent-map/rho DP per node."""
    N = n_max
    node_lat = np.zeros(N)
    node_prob = np.ones(N)
    node_mask = np.zeros(N)
    prefix_mask = np.zeros(N)
    adj = np.zeros((N, N))
    prefix_ids = {n.idx for n in h.safe_prefix()}
    for n in h.nodes[:N]:
        node_lat[n.idx] = n.est_latency
        node_prob[n.idx] = n.cond_prob
        node_mask[n.idx] = 1.0
        if n.idx in prefix_ids:
            prefix_mask[n.idx] = 1.0
    for i, j in h.edges:
        if i < N and j < N:
            adj[i, j] = 1.0
    return (node_lat, node_prob, node_mask, prefix_mask, adj, h.q,
            prefix_rho(h))


def pack_beam(hyps: Sequence[BranchHypothesis], k_max: int, n_max: int,
              row_cache: Optional[dict] = None) -> PackedBeam:
    """Pack a candidate beam into the fused-admission tables.  With a
    ``row_cache`` ({hid: pack_rows(...)}, caller-owned and caller-bounded)
    the per-hypothesis Python DP runs once per hid ever — incremental
    re-packing for pooled cross-episode beams whose membership churns by
    one episode at a time."""
    K, N = k_max, n_max
    node_lat = np.zeros((K, N))
    node_prob = np.ones((K, N))
    node_mask = np.zeros((K, N))
    prefix_mask = np.zeros((K, N))
    adj = np.zeros((K, N, N))
    q = np.zeros((K,))
    rho = np.zeros((K, RESOURCE_DIMS))
    k_valid = np.zeros((K,))
    for k, h in enumerate(hyps[:K]):
        if row_cache is None:
            rows = pack_rows(h, N)
        else:
            rows = row_cache.get(h.hid)
            if rows is None:
                rows = row_cache[h.hid] = pack_rows(h, N)
        k_valid[k] = 1.0
        (node_lat[k], node_prob[k], node_mask[k], prefix_mask[k], adj[k],
         q[k], rho[k]) = rows
    return PackedBeam(node_lat, node_prob, node_mask, prefix_mask, adj, q, rho, k_valid)


def device_tables(packed: PackedBeam, device, **alongside) -> dict:
    """The packed beam's tables and what rides alongside them (memo masks,
    weights, spec costs, demand vectors, scalars) as float32 tensors on
    ``device``, keyed by name; an entry of ``alongside`` named like a
    table (``rho``) replaces it.  Everything goes in one host-to-device
    copy: numpy rounds each value to float32, as JAX does when a float64
    array enters a jitted function with x64 off."""
    arrays = {"node_lat": packed.node_lat, "node_prob": packed.node_prob,
              "node_mask": packed.node_mask, "prefix_mask": packed.prefix_mask,
              "adj": packed.adj, "q": packed.q, "rho": packed.rho,
              "k_valid": packed.k_valid, **alongside}
    flat = [np.asarray(a, np.float32).ravel() for a in arrays.values()]
    buf = torch.from_numpy(np.concatenate(flat)).to(device)
    out, off = {}, 0
    for (name, a), f in zip(arrays.items(), flat, strict=True):
        out[name] = buf[off:off + f.size].view(np.shape(a))
        off += f.size
    return out


def _critical_path(adj, lat, mask, n_iters: int):
    """Longest path (per hypothesis) over masked DAG.  adj (K,N,N), lat (K,N)."""
    lat = lat * mask
    live = mask > 0
    dist = lat
    for _ in range(n_iters):
        # dist[k, j] = max_i adj[i,j] * (dist[i] + lat[j])
        via = (adj * (dist[:, :, None] + lat[:, None, :])).amax(dim=1)
        dist = torch.maximum(dist, via * live)
    return dist.amax(dim=1)


def static_raw_terms(node_lat, node_prob, node_mask, prefix_mask, adj,
                     n_nodes: int):
    """The hypothesis-INTRINSIC half of ``static_gain_terms`` (host/numpy):
    everything computable from the packed rows alone, before the two
    per-tick inputs (``memo_mask``, ``model_delay``) are applied.  Rows are
    independent — no term mixes hypotheses — so values computed for a row in
    any batch are bit-identical to the same row in any other batch, which is
    what makes the per-hid admission warm cache sound (hids are globally
    unique and BranchHypothesis is immutable after build).

    Returns ``(l_solo, lat_pref, raw_delta_u)`` where ``lat_pref`` is the
    per-node prefix latency row (``node_lat * prefix_mask``, kept unreduced
    so ``finish_static_terms`` can apply a fresh memo mask) and
    ``raw_delta_u`` is the post-prefix critical path BEFORE the model-delay
    clamp."""
    lat_pref = node_lat * prefix_mask
    l_solo = lat_pref.sum(axis=1)
    post_mask = node_mask * (1.0 - prefix_mask)
    elp = node_lat * node_prob * post_mask
    dist = elp.copy()
    for _ in range(n_nodes):               # masked longest-path relaxation
        via = np.max(adj * (dist[:, :, None] + elp[:, None, :]), axis=1)
        dist = np.maximum(dist, via * (post_mask > 0))
    return l_solo, lat_pref, dist.max(axis=1)


def finish_static_terms(l_solo, lat_pref, raw_delta_u, idle_window,
                        memo_mask=None, model_delay=0.0):
    """Fold the per-tick inputs into cached raw terms (host/numpy): the memo
    mask drops store-served prefix nodes from the interference-exposed
    latency, and the model delay clamps ΔU — the only two places per-tick
    state enters the static terms.  Same arithmetic, same order as the
    un-cached path, so results are bit-identical by construction."""
    if memo_mask is None:
        l_exec = l_solo
    else:
        l_exec = (lat_pref * (1.0 - memo_mask)).sum(axis=1)
    delta_o = np.minimum(l_solo, idle_window)
    delta_u = np.maximum(raw_delta_u - model_delay, 0.0)
    return l_solo, l_exec, delta_o, delta_u


def static_gain_terms(node_lat, node_prob, node_mask, prefix_mask, adj,
                      idle_window, n_nodes: int, memo_mask=None,
                      model_delay=0.0, xp=torch):
    """Per-hypothesis terms independent of the admitted set: prefix solo
    latency, the prefix's EXECUTED latency, ΔO (idle-window-capped), and ΔU
    (post-prefix critical path).

    ``memo_mask`` (K, N) marks prefix nodes whose results the cross-episode
    store already holds (the reuse term): they still contribute their
    latency to ΔO but need no execution, so they drop out of ``l_exec``
    (the latency exposed to interference in ΔI) exactly as they drop out of
    the prefix ρ the caller passes alongside (``prefix_rho(h, exclude=...)``).

    ``model_delay`` is the model-step service's expected queue+batch-window
    delay (``ModelStepService.expected_unlock_delay``):
    ``ΔU ← max(ΔU − model_delay, 0)``; 0 leaves ΔU bit-identical.

    ``xp=np`` takes numpy arrays (the host path); ``xp=torch`` takes
    float32 tensors on one device, with ``idle_window`` and
    ``model_delay`` as 0-d tensors or numbers.  Shared by ``score_beam``
    and the fused admission pass, which hoists these out of its loop since
    only ΔI depends on the admitted demand.  Returns (l_solo, l_exec,
    delta_o, delta_u)."""
    if xp is not torch:
        # host-side fast path: the raw/finish split is THE implementation
        # (the admission warm cache replays static_raw_terms results per
        # hid, so both cached and uncached passes must go through it)
        l_solo, lat_pref, raw_du = static_raw_terms(
            node_lat, node_prob, node_mask, prefix_mask, adj, n_nodes)
        return finish_static_terms(l_solo, lat_pref, raw_du, idle_window,
                                   memo_mask=memo_mask,
                                   model_delay=model_delay)
    l_solo = (node_lat * prefix_mask).sum(dim=1)
    if memo_mask is None:
        l_exec = l_solo
    else:
        l_exec = (node_lat * prefix_mask * (1.0 - memo_mask)).sum(dim=1)
    delta_o = l_solo.clamp_max(idle_window)
    post_mask = node_mask * (1.0 - prefix_mask)
    exp_lat = node_lat * node_prob
    delta_u = _critical_path(adj, exp_lat, post_mask, n_iters=n_nodes)
    delta_u = (delta_u - model_delay).clamp_min(0.0)
    return l_solo, l_exec, delta_o, delta_u


def eu_given_admitted(l_exec, delta_o, delta_u, q, rho, k_valid,
                      admitted_rho, cap, lam, mu, idle_window, xp=torch):
    """EU (Eq. 3) for every hypothesis conditioned on the admitted demand.

    Only ΔI varies with the admitted set; the static terms come from
    ``static_gain_terms``.  ``l_exec`` is the prefix latency that actually
    EXECUTES (memoized nodes excluded — they are served, not run, so no
    interference touches them).  ``xp`` selects the backend: torch inside
    the device paths, np for the host-side arithmetic (``_admit_numpy``
    inlines the same operations).  The two branches are the same
    operations in the same order.  Returns (eu (K,), delta_i (K,))."""
    if xp is not torch:
        # ΔI: bottleneck stretch of prefix under admitted demand + inflicted
        util = (admitted_rho[None, :] + rho) / cap[None, :]          # (K,R)
        stretch = xp.where(rho > 0, xp.maximum(util, 1.0), 1.0).max(axis=1)
        self_pen = l_exec * (stretch - 1.0)
        # inflicted on admitted set: admitted work stretched by new util
        adm_util = admitted_rho / cap
        adm_stretch_before = xp.maximum(adm_util, 1.0).max()
        adm_stretch_after = xp.where(
            admitted_rho[None, :] > 0, xp.maximum(util, 1.0), 1.0
        ).max(axis=1)
        inflicted = xp.maximum(adm_stretch_after - adm_stretch_before, 0.0) * idle_window
        delta_i = self_pen + inflicted
        eu = q * (delta_o + lam * delta_u - mu * delta_i) * k_valid
        return eu, delta_i
    util = (admitted_rho[None, :] + rho) / cap[None, :]              # (K,R)
    u1 = util.clamp_min(1.0)
    stretch = torch.where(rho > 0, u1, 1.0).amax(dim=1)
    self_pen = l_exec * (stretch - 1.0)
    adm_util = admitted_rho / cap
    adm_stretch_before = adm_util.clamp_min(1.0).amax()
    adm_stretch_after = torch.where(admitted_rho[None, :] > 0, u1, 1.0).amax(dim=1)
    inflicted = (adm_stretch_after - adm_stretch_before).clamp_min(0.0) * idle_window
    delta_i = self_pen + inflicted
    eu = q * (delta_o + lam * delta_u - mu * delta_i) * k_valid
    return eu, delta_i


def score_beam(
    node_lat, node_prob, node_mask, prefix_mask, adj, q, rho, k_valid,
    memo_mask, admitted_rho, cap, lam, mu, idle_window, model_delay,
    spec_cost, shed_penalty, n_nodes: int,
):
    """Vectorized EU for every hypothesis given the admitted demand, as
    torch ops on the device of its float32 tensor arguments (the scalars
    may be 0-d tensors or numbers).

    ``memo_mask`` (K, N) marks store-memoized prefix nodes (zero execution,
    zero interference exposure); ``rho`` must already exclude them.
    ``model_delay`` discounts ΔU by the model-step service's expected
    queue+batch-window delay (see ``static_gain_terms``).
    ``spec_cost`` (K,) is the slot-marginal model-step cost of the
    hypothesis's speculative MODEL step, subtracted μ-scaled from ΔO BEFORE
    ΔI — zeros are an IEEE-exact no-op.  ``shed_penalty`` (≥ 0) is the
    load-shedding tax under open-loop overload, folded at the SAME point as
    ``spec_cost`` in every admission path; 0 is an IEEE-exact no-op.

    Returns (eu (K,), delta_o, delta_u, delta_i)."""
    l_solo, l_exec, delta_o, delta_u = static_gain_terms(
        node_lat, node_prob, node_mask, prefix_mask, adj, idle_window,
        n_nodes, memo_mask=memo_mask, model_delay=model_delay,
    )
    delta_o = delta_o - mu * spec_cost - shed_penalty
    eu, delta_i = eu_given_admitted(
        l_exec, delta_o, delta_u, q, rho, k_valid, admitted_rho, cap,
        lam, mu, idle_window,
    )
    return eu, delta_o, delta_u, delta_i


def tenant_fairness_weights(
    spec_share: dict, alpha: float = 1.0
) -> dict:
    """Per-tenant multiplier for the shared cross-episode beam's EU objective.

    ``spec_share[eid]`` is tenant eid's current in-flight speculative demand,
    bottleneck-normalized (max over dimensions of demand/cap, summed over the
    tenant's running speculative jobs).  The weight

        w_e = 1 / (1 + α · share_e)

    discounts candidates from tenants already holding speculative capacity,
    so one episode's deep tree cannot monopolize the shared beam round after
    round while other tenants' candidates starve.  EU is linear in q, so
    applying w_e to EU equals scoring with q·w_e (admission.py threads the
    weights through every admission path identically).  Weights are positive
    and ≤ 1; with a single tenant — or α=0 — every weight is a common
    positive factor, which leaves the greedy order and the eu>0 threshold
    unchanged (single-episode admissions are bit-identical to unweighted)."""
    return {eid: 1.0 / (1.0 + alpha * max(float(s), 0.0))
            for eid, s in spec_share.items()}



@dataclass
class Scorer:
    """Scores beams with ``score_beam`` on ``device`` ("cuda" unless the
    caller asks for another; resolved when built, nothing allocated until a
    call).  Each call uploads its packed tables and returns numpy."""
    machine: Machine
    lam: float = 0.5
    mu: float = 1.0
    k_max: int = 8
    n_max: int = 12
    device: Union[str, torch.device] = "cuda"

    def __post_init__(self):
        self.device = torch.device(self.device)

    def score(
        self,
        hyps: Sequence[BranchHypothesis],
        admitted_rho: np.ndarray,
        idle_window: float = 10.0,
        memo_masks: Optional[np.ndarray] = None,
        memo_rho: Optional[np.ndarray] = None,
        model_delay: float = 0.0,
        spec_costs: Optional[np.ndarray] = None,
        shed_penalty: float = 0.0,
    ) -> Tuple[np.ndarray, PackedBeam, dict]:
        """``memo_masks`` (len(hyps), N) / ``memo_rho`` (len(hyps), R) carry
        the store-reuse term: per-node memoized flags and the matching
        memo-excluded prefix demand.  They ride ALONGSIDE the packed tables
        (like fairness weights) — the PackedBeam stays store-agnostic, so
        runtime pack caches remain valid as the store fills.  ``model_delay``
        is the model-step service's expected unlock delay (a scalar uploaded
        with the tables).  ``spec_costs``
        (len(hyps),) is the per-hypothesis slot-marginal model-step cost
        (see ``score_beam``); None means zeros (bit-identical no-op).
        ``shed_penalty`` is the scalar load-shedding ΔO tax (see
        ``score_beam``); 0 (the default) is a bit-identical no-op."""
        pb = pack_beam(hyps, self.k_max, self.n_max)
        K = pb.q.shape[0]
        mm = np.zeros((K, self.n_max))
        sc = np.zeros(K)
        rho = pb.rho
        if memo_masks is not None:
            mm[: len(hyps), :] = np.asarray(memo_masks, float)
        if spec_costs is not None:
            sc[: len(hyps)] = np.asarray(spec_costs, float)
        if memo_rho is not None:
            rho = rho.copy()
            rho[: len(hyps), :] = np.asarray(memo_rho, float)
        t = device_tables(
            pb, self.device, rho=rho, memo_mask=mm, admitted_rho=admitted_rho,
            cap=self.machine.cap_array(), lam=self.lam, mu=self.mu,
            idle_window=idle_window, model_delay=model_delay, spec_cost=sc,
            shed_penalty=shed_penalty)
        eu, do, du, di = score_beam(**t, n_nodes=self.n_max)
        detail = {
            "delta_o": do.cpu().numpy(), "delta_u": du.cpu().numpy(),
            "delta_i": di.cpu().numpy(),
        }
        return eu.cpu().numpy(), pb, detail

    def score_all(
        self,
        hyps: Sequence[BranchHypothesis],
        admitted_rho: np.ndarray,
        idle_window: float = 10.0,
        memo_masks: Optional[np.ndarray] = None,
        memo_rho: Optional[np.ndarray] = None,
        model_delay: float = 0.0,
        spec_costs: Optional[np.ndarray] = None,
        shed_penalty: float = 0.0,
    ) -> np.ndarray:
        """EU for EVERY hypothesis, chunked over ``k_max``-sized beams.

        ``score`` silently truncates beams wider than ``k_max`` (the padded
        tables only hold the first K rows); this scores len(hyps) entries by
        chunking.  Exact: EU has no cross-hypothesis coupling — ΔI depends
        only on the candidate's own ρ and the (shared) admitted demand."""
        if not len(hyps):
            return np.zeros(0)
        out = []
        for i in range(0, len(hyps), self.k_max):
            chunk = hyps[i:i + self.k_max]
            eu, _, _ = self.score(
                chunk, admitted_rho, idle_window,
                memo_masks=None if memo_masks is None
                else memo_masks[i:i + self.k_max],
                memo_rho=None if memo_rho is None
                else memo_rho[i:i + self.k_max],
                model_delay=model_delay,
                spec_costs=None if spec_costs is None
                else spec_costs[i:i + self.k_max],
                shed_penalty=shed_penalty,
            )
            out.append(eu[: len(chunk)])
        return np.concatenate(out)
