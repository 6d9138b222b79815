"""Admission control (paper Eq. 5–6), on PyTorch: pick A* ⊆ beam
maximizing Σ EU(H|A) subject to Σρ ≤ min(R_slack, B).

The port of ``repro/core/admission.py``.  Primary policy is the paper's
greedy (Algorithm 1 line 20): repeatedly admit the highest-marginal-EU
prefix that still fits, re-scoring interference after each admission (EU is
conditioned on the admitted set, so marginals change).

``fused_admit`` is the production path.  Pools of at most
``small_beam_threshold`` candidates run ``_admit_numpy`` on the host; larger
pools run ``admit_beam`` on ``scorer.device``: score → pick the argmax-EU
candidate that fits → add its ρ to the admitted demand → re-score, as torch
ops over the padded PackedBeam tables uploaded in one copy.  The
admitted-set-invariant terms ΔO/ΔU are hoisted out of the loop; only ΔI is
re-evaluated per admission.  The loop reads one flag back per iteration and
takes demand-free picks together, so a pass costs (picks with demand) + 1
iterations, not K.
Beams wider than ``k_max`` are padded up to a ``bucket_k`` size instead of
being truncated.

``greedy_admit`` is kept as the reference oracle — a numpy greedy loop
around the scorer, one ``score_beam`` call per k_max chunk per iteration.
``exact_admit`` enumerates all subsets (K ≤ ~14) for tests and quality
reports.  The host paths are the JAX package's, line for line.

Paper anchor: Eq. 5–6 (admission under min(R_slack, B)), Algorithm 1
line 20 (greedy re-scoring).  Upstream: scoring.py (shared estimators,
PackedBeam), hypothesis.py (candidates).  Downstream: runtime Phase 4
(``_admit_shared`` is the only production caller).
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.events import RESOURCE_DIMS
from repro_torch.core.hypothesis import BranchHypothesis
from repro_torch.core.scoring import (
    PackedBeam, Scorer, device_tables, eu_given_admitted, finish_static_terms,
    pack_beam, prefix_rho, static_gain_terms, static_raw_terms,
)


# capacity-fit tolerance, shared by every admission path (reference, exact,
# fused kernel, numpy fast path) so they agree at the constraint boundary
_FIT_EPS = 1e-6


def _fit_limit(limit):
    """Per-dimension fit threshold: relative + absolute slop so the device
    pass's f32 accumulation (error ∝ magnitude) can't flip a boundary
    decision against the f64 paths."""
    return limit + _FIT_EPS * (1.0 + limit)


# concurrency-aware prefix demand shared with pack_beam, so the reference
# greedy, the exact oracle, and the fused kernel agree on ρ exactly
_prefix_rho = prefix_rho


@dataclass
class AdmissionResult:
    admitted: List[BranchHypothesis]
    eu: dict                     # hid -> EU at admission time
    rejected: List[BranchHypothesis]


def greedy_admit(
    hyps: Sequence[BranchHypothesis],
    scorer: Scorer,
    slack: np.ndarray,           # R_slack (R,)
    budget: np.ndarray,          # B (R,)
    authoritative_rho: np.ndarray,
    idle_window: float = 10.0,
    weights: Optional[np.ndarray] = None,
    memo_masks: Optional[np.ndarray] = None,
    memo_rho: Optional[np.ndarray] = None,
    model_delay: float = 0.0,
    spec_costs: Optional[np.ndarray] = None,
    shed_penalty: float = 0.0,
) -> AdmissionResult:
    """Reference greedy: score_beam calls (one per k_max chunk) + numpy
    re-pack PER admission iteration.  Semantics oracle for ``fused_admit``;
    prefer the fused path in hot loops.

    ``weights`` (len(hyps),) are per-hypothesis fairness multipliers (shared
    cross-episode beams weight each tenant's candidates by its current
    speculative share).  EU is linear in q, so weighting EU post-score is
    exactly weighting q — the greedy order, the eu>0 admission threshold
    (weights are positive), and the recorded EU-at-admit all see q·w.

    ``memo_masks`` (len(hyps), n_max) / ``memo_rho`` (len(hyps), R) carry
    the result-store reuse term (see scoring.static_gain_terms): memoized
    prefix nodes contribute EU at zero demand, so both the scoring AND the
    capacity-fit check use the memo-excluded prefix ρ.

    ``model_delay`` is the model-step service's expected queue+batch-window
    delay, discounting every candidate's ΔU (scoring.static_gain_terms).

    ``spec_costs`` (len(hyps),) is the slot-marginal model-step cost of each
    candidate's speculative MODEL step (see scoring.score_beam); None means
    zeros (bit-identical no-op).

    ``shed_penalty`` is the scalar load-shedding ΔO tax under open-loop
    backlog (see scoring.score_beam); 0 is a bit-identical no-op."""
    limit = np.minimum(slack, budget)
    admitted: List[BranchHypothesis] = []
    admitted_demand = np.zeros(RESOURCE_DIMS)
    eu_at_admit: dict = {}
    remaining = list(hyps)
    idx_of = {id(h): i for i, h in enumerate(hyps)}
    w_by_hid = (
        {h.hid: float(weights[i]) for i, h in enumerate(hyps)}
        if weights is not None else None
    )
    while remaining:
        # score_all chunks beams wider than scorer.k_max — every remaining
        # hypothesis gets a real EU, not the padded-table truncation
        rows = [idx_of[id(h)] for h in remaining]
        eu = scorer.score_all(
            remaining, authoritative_rho + admitted_demand, idle_window,
            memo_masks=None if memo_masks is None else memo_masks[rows],
            memo_rho=None if memo_rho is None else memo_rho[rows],
            model_delay=model_delay,
            spec_costs=None if spec_costs is None else spec_costs[rows],
            shed_penalty=shed_penalty,
        )
        if w_by_hid is not None:
            eu = eu * np.array([w_by_hid[h.hid] for h in remaining])
        order = np.argsort(-eu)
        picked = None
        for oi in order:
            if eu[oi] <= 0:
                break
            cand = remaining[oi]
            if memo_rho is not None:
                rho = memo_rho[idx_of[id(cand)]]
            else:
                rho = _prefix_rho(cand)
            if np.all(admitted_demand + rho <= _fit_limit(limit)):
                picked = (oi, cand, float(eu[oi]), rho)
                break
        if picked is None:
            break
        oi, cand, val, rho = picked
        admitted.append(cand)
        eu_at_admit[cand.hid] = val
        admitted_demand = admitted_demand + rho
        remaining.pop(oi)
    return AdmissionResult(admitted, eu_at_admit, remaining)


def bucket_k(n: int, k_max: int) -> int:
    """Smallest bucket ≥ n hypotheses: multiples of k_max up to 2·k_max,
    then GEOMETRIC (k_max · 2^j) above.

    Bucketing keeps the device pass's shape set bounded while never
    dropping candidates (padded rows carry k_valid=0 and are inert): a
    12-wide beam with k_max=8 packs at K=16.  Geometric growth matters
    under c≫1 tenants, where the pooled beam width moves every tick; the
    buckets are the JAX package's, where each new shape cost a compile."""
    km = max(k_max, 1)
    if n <= 2 * km:
        return max(km, km * math.ceil(n / km))
    b = 2 * km
    while b < n:
        b *= 2
    return b


def admission_signature(hids, slack, budget, auth_rho, weights, memo_masks,
                        memo_rho, model_delay, spec_costs=None,
                        shed_penalty=0.0) -> tuple:
    """Byte-exact signature of every input one shared-admission pass is a
    function of.  ``greedy_admit``/``fused_admit`` are deterministic in
    (candidate hypotheses, slack, budget, conditioning demand, fairness
    weights, memo terms, model delay) — hypotheses are immutable after
    build and globally numbered, so the ordered hid tuple pins them.  Two
    passes with equal signatures therefore produce identical admitted
    sets and EU values, which is what lets the runtime's warm-start
    (``RuntimeConfig.warm_admit``) replay last tick's decision instead of
    re-running the kernel, with ANY deviation falling back to the full
    pass."""
    return (
        tuple(hids),
        slack.tobytes(), budget.tobytes(), auth_rho.tobytes(),
        None if weights is None else weights.tobytes(),
        None if memo_masks is None else memo_masks.tobytes(),
        None if memo_rho is None else memo_rho.tobytes(),
        float(model_delay),
        None if spec_costs is None else spec_costs.tobytes(),
        float(shed_penalty),
    )



def admit_beam(
    node_lat, node_prob, node_mask, prefix_mask, adj, q, rho, k_valid,
    w, memo_mask, auth_rho, cap, limit, lam, mu, idle_window, model_delay,
    spec_cost, shed_penalty, n_nodes: int,
):
    """One greedy admission pass as torch ops on the device of its float32
    tensor arguments (``device_tables`` builds them; the scalars may be 0-d
    tensors or numbers).

    Each iteration scores every still-remaining hypothesis against the
    current admitted demand, picks the argmax-EU candidate with positive EU
    whose prefix ρ fits under ``limit``, and folds its demand in.  Picks
    without demand (fully memo-served prefixes) change no term and have an
    EU that no demand changes, so every eligible one is taken in the
    iteration it is first eligible, beside the pick with demand; the
    admitted set and the EUs are those of picking one by one (``_admit_numpy``
    likewise takes them without a rescore).  The loop stops when no
    eligible candidate has demand: one flag read back per iteration, picks
    with demand + 1 iterations, at most K+1.  ``torch.argmax`` returns the
    first maximal index, as ``jnp.argmax`` does, over the same
    ``-inf``-filled EU.

    ΔO/ΔU are loop-invariant (they depend only on the hypothesis graph), so
    they are computed once up front; the loop re-evaluates only ΔI.

    ``w`` (K,) are positive per-hypothesis fairness weights; EU is linear in
    q so multiplying EU by w is identical to scoring with q·w.
    ``memo_mask`` (K, N) marks result-store-memoized prefix nodes; the
    caller passes ``rho`` already excluding them.  ``model_delay``,
    ``spec_cost`` (K,) and ``shed_penalty`` fold into the hoisted static
    terms with the SAME operation order as every other admission path, so
    zeros stay an IEEE-exact no-op.

    Returns (admitted_mask (K,), eu_at_admit (K,), admitted_demand (R,)).
    """
    l_solo, l_exec, delta_o, delta_u = static_gain_terms(
        node_lat, node_prob, node_mask, prefix_mask, adj, idle_window,
        n_nodes, memo_mask=memo_mask, model_delay=model_delay,
    )
    delta_o = delta_o - mu * spec_cost - shed_penalty
    fit_lim = _fit_limit(limit)
    K = q.shape[0]
    rows = torch.arange(K, device=q.device)
    free = (rho == 0).all(dim=1)          # picks that leave the demand as it is
    remaining = k_valid
    admitted = torch.zeros_like(q)
    eu_adm = torch.zeros_like(q)
    demand = torch.zeros_like(auth_rho)
    for _ in range(K + 1):
        eu, _ = eu_given_admitted(
            l_exec, delta_o, delta_u, q, rho, k_valid,
            auth_rho + demand, cap, lam, mu, idle_window,
        )
        eu = eu * w
        fits = (demand[None, :] + rho <= fit_lim[None, :]).all(dim=1)
        elig = (remaining > 0) & fits & (eu > 0.0)
        # A pick without demand leaves the demand, and so every EU and fit,
        # as they are; a demand-free row's own EU never depends on the
        # demand (no stretch, nothing inflicted).  So the one-by-one greedy
        # admits every eligible demand-free row sooner or later at the EU
        # it has now, and its picks with demand come in the order of the
        # first argmax over the rows with demand.  Take the former all at
        # once, with the next of the latter.
        costly = elig & ~free
        take = (elig & free) | (costly & (rows == torch.argmax(
            torch.where(costly, eu, -torch.inf))))
        remaining = torch.where(take, 0.0, remaining)
        admitted = torch.where(take, 1.0, admitted)
        eu_adm = torch.where(take, eu, eu_adm)
        demand = demand + (take[:, None] * rho).sum(dim=0)
        if not costly.any():              # the one read-back of a step
            break
    return admitted, eu_adm, demand


def _admit_numpy(packed: PackedBeam, auth_rho, cap, limit, lam, mu,
                 idle_window, w=None, memo_mask=None,
                 rho=None, model_delay=0.0, spec_cost=None,
                 shed_penalty=0.0,
                 static_terms=None) -> Tuple[np.ndarray, np.ndarray]:
    """The ``admit_beam`` algorithm on the same PackedBeam tables in pure
    numpy — the host-side fast path for small beams, where the fixed cost
    of a device pass dwarfs the actual arithmetic.  The Eq. 3
    estimator is the shared ``eu_given_admitted``/``static_gain_terms``
    (with ``xp=np``), so there is exactly one implementation of every term.
    ``memo_mask``/``rho`` carry the result-store reuse term (``rho``
    overrides the packed prefix demand with the memo-excluded one).
    Returns (admitted_mask (K,), eu_at_admit (K,))."""
    lat, prob = packed.node_lat, packed.node_prob
    mask, pmask, adj = packed.node_mask, packed.prefix_mask, packed.adj
    q, k_valid = packed.q, packed.k_valid
    if rho is None:
        rho = packed.rho
    K, N = lat.shape
    rho = np.asarray(rho, float)
    auth_rho = np.asarray(auth_rho, float)
    cap = np.asarray(cap, float)
    fit_lim = _fit_limit(limit)
    if w is None:
        w = np.ones(K)
    admitted = np.zeros(K)
    eu_adm = np.zeros(K)
    # Rows that can never be admitted are dropped before any scoring:
    # padding / invalid rows (k_valid 0 → eu 0, never > 0) and rows whose
    # prefix demand alone exceeds the limit (the admitted demand only
    # GROWS, so an initial non-fit stays a non-fit).  Every per-row term
    # below is independent of the other rows, so compaction changes no
    # value and — because np.argmax keeps first-index tie-breaks and
    # compaction preserves order — no decision.
    act = np.flatnonzero((k_valid > 0)
                         & np.all(rho <= fit_lim[None, :], axis=1))
    if not len(act):
        return admitted, eu_adm
    lat, prob, mask, pmask, adj = (
        lat[act], prob[act], mask[act], pmask[act], adj[act])
    q, k_valid, rho, w = q[act], k_valid[act], rho[act], w[act]
    if memo_mask is not None:
        memo_mask = memo_mask[act]
    if spec_cost is not None:
        spec_cost = spec_cost[act]
    if static_terms is None:
        l_solo, l_exec, delta_o, delta_u = static_gain_terms(
            lat, prob, mask, pmask, adj, idle_window, N,
            memo_mask=memo_mask, model_delay=model_delay, xp=np,
        )
    else:
        # warm-cached raw terms (full-K arrays, see _cached_static_terms):
        # only the per-tick memo mask / model delay still need folding in
        s_solo, s_pref, s_raw = static_terms
        l_solo, l_exec, delta_o, delta_u = finish_static_terms(
            s_solo[act], s_pref[act], s_raw[act], idle_window,
            memo_mask=memo_mask, model_delay=model_delay,
        )
    if spec_cost is not None:
        # slot-marginal model-step cost — same point and operation order as
        # score_beam/admit_beam so zeros are an IEEE-exact no-op
        delta_o = delta_o - mu * spec_cost
    # load-shedding ΔO tax — folded at the same point as the device paths
    # ((ΔO − μ·spec) − shed); subtracting the 0.0 default is IEEE-exact
    delta_o = delta_o - shed_penalty
    # Second prune: ΔI ≥ 0 only ever subtracts, so q·(ΔO+λΔU)·k_valid·w
    # is a static per-row EU ceiling — rows at/below 0 can never clear the
    # eu > 0 eligibility bar.  (spec_cost and shed_penalty are already
    # folded into ΔO above, so the ceiling remains valid.)
    static_gain = delta_o + lam * delta_u
    pos = np.flatnonzero(q * static_gain * k_valid * w > 0.0)
    if not len(pos):
        return admitted, eu_adm
    if len(pos) < len(act):
        act = act[pos]
        l_exec, static_gain = l_exec[pos], static_gain[pos]
        q, k_valid, rho, w = q[pos], k_valid[pos], rho[pos], w[pos]
    remaining = k_valid.copy()
    demand = np.zeros_like(auth_rho)
    adm_c = np.zeros(len(act))
    eu_c = np.zeros(len(act))
    # The greedy loop below is ``eu_given_admitted`` inlined with its
    # loop-invariant subexpressions hoisted (same operations, same order —
    # bit-identical row values, verified by the kernel-equivalence suite).
    # Beams of dozens-to-hundreds run this every admission pass with ~1
    # pick per iteration, so per-iteration ufunc dispatch — not the (K,R)
    # arithmetic — is the cost; hoisting ``rho > 0``, the static-gain
    # combination, and the duplicated ``maximum(util, 1)`` roughly halves
    # it.
    rho_pos = rho > 0
    while True:
        admitted_rho = auth_rho + demand
        util = (admitted_rho[None, :] + rho) / cap[None, :]
        u1 = np.maximum(util, 1.0)
        stretch = np.where(rho_pos, u1, 1.0).max(axis=1)
        self_pen = l_exec * (stretch - 1.0)
        adm_util = admitted_rho / cap
        adm_stretch_before = np.maximum(adm_util, 1.0).max()
        adm_stretch_after = np.where(
            admitted_rho[None, :] > 0, u1, 1.0).max(axis=1)
        inflicted = np.maximum(
            adm_stretch_after - adm_stretch_before, 0.0) * idle_window
        delta_i = self_pen + inflicted
        eu = q * (static_gain - mu * delta_i) * k_valid
        eu = eu * w
        fits = np.all(demand[None, :] + rho <= fit_lim[None, :], axis=1)
        elig = (remaining > 0) & fits & (eu > 0.0)
        # Zero-demand picks (fully memo-served prefixes) leave ``demand``
        # — and therefore every term above — untouched, so consecutive
        # ones resolve against the SAME eu/fits without a rescore: just
        # retire the picked row from eligibility, exactly what the full
        # recompute would have done.
        while True:
            if not elig.any():
                admitted[act] = adm_c
                eu_adm[act] = eu_c
                return admitted, eu_adm
            pick = int(np.argmax(np.where(elig, eu, -np.inf)))
            remaining[pick] = 0.0
            adm_c[pick] = 1.0
            eu_c[pick] = eu[pick]
            if rho[pick].any():
                demand = demand + rho[pick]
                break
            elig[pick] = False


def _cached_static_terms(hyps, packed: PackedBeam, n_nodes: int,
                         cache: dict):
    """Assemble full-K ``(l_solo, lat_pref, raw_delta_u)`` arrays for the
    host admission path from a caller-owned per-hid cache (caller-bounded,
    like pack_beam's row_cache): rows already seen replay their cached
    ``static_raw_terms`` values, unseen rows are computed in one sub-batch
    and recorded.  Sound because the raw terms are hypothesis-intrinsic and
    row-independent (see static_raw_terms) — this is what lets the admission
    warm-start pay even while the pool's MEMBERSHIP churns every tick and
    the full-signature replay misses.  Padding rows (k ≥ len(hyps)) stay
    zero; _admit_numpy's k_valid compaction drops them before use."""
    K, N = packed.node_lat.shape
    l_solo = np.zeros(K)
    lat_pref = np.zeros((K, N))
    raw_du = np.zeros(K)
    miss = [k for k, h in enumerate(hyps) if h.hid not in cache]
    if miss:
        idx = np.asarray(miss)
        ms, mp, mr = static_raw_terms(
            packed.node_lat[idx], packed.node_prob[idx],
            packed.node_mask[idx], packed.prefix_mask[idx],
            packed.adj[idx], n_nodes)
        for j, k in enumerate(miss):
            cache[hyps[k].hid] = (ms[j], mp[j], mr[j])
    for k, h in enumerate(hyps):
        s, p, r = cache[h.hid]
        l_solo[k] = s
        lat_pref[k] = p
        raw_du[k] = r
    return l_solo, lat_pref, raw_du


def fused_admit(
    hyps: Sequence[BranchHypothesis],
    scorer: Scorer,
    slack: np.ndarray,
    budget: np.ndarray,
    authoritative_rho: np.ndarray,
    idle_window: float = 10.0,
    packed: Optional[PackedBeam] = None,
    small_beam_threshold: int = 2,
    weights: Optional[np.ndarray] = None,
    memo_masks: Optional[np.ndarray] = None,
    memo_rho: Optional[np.ndarray] = None,
    model_delay: float = 0.0,
    spec_costs: Optional[np.ndarray] = None,
    shed_penalty: float = 0.0,
    static_cache: Optional[dict] = None,
) -> AdmissionResult:
    """Greedy admission via ``admit_beam`` on ``scorer.device``: one upload,
    one loop of torch ops and one download per admission pass (vs. one
    scoring call per *iteration* in ``greedy_admit``).  Beams of ≤
    ``small_beam_threshold`` hypotheses take an equivalent pure-numpy path
    instead — below that size the fixed cost of the device pass exceeds the
    whole computation.  ``packed`` lets
    callers reuse a cached PackedBeam (see BPasteRuntime incremental
    packing); it must have been packed from exactly these ``hyps`` at a
    bucketed K ≥ len(hyps).  ``weights`` (len(hyps),) are the per-hypothesis
    fairness multipliers (see ``greedy_admit``) — NOT part of the packed
    tables, so the PackedBeam cache stays valid as tenant shares move.
    ``memo_masks`` (len(hyps), n_max) / ``memo_rho`` (len(hyps), R) carry
    the result-store reuse term and ride alongside the pack for the same
    reason (store contents change every tick; the pack does not).
    ``model_delay`` (the model-step service's expected unlock delay) also
    rides alongside, as it moves every tick with the batch window.  ``spec_costs`` (len(hyps),) is the slot-marginal
    model-step cost term (scoring.score_beam), riding alongside for the
    same reason; None means zeros, a bit-identical no-op.
    ``shed_penalty`` is the scalar load-shedding ΔO tax (scoring.score_beam)
    — another alongside-rider; 0 is a bit-identical no-op.
    ``static_cache`` (caller-owned {hid: raw terms},
    host path only) replays hypothesis-intrinsic static gain terms across
    passes — see ``_cached_static_terms``."""
    if not len(hyps):
        return AdmissionResult([], {}, [])
    limit = np.minimum(slack, budget)
    if packed is None or packed.q.shape[0] < len(hyps):
        packed = pack_beam(hyps, bucket_k(len(hyps), scorer.k_max), scorer.n_max)
    cap = scorer.machine.cap_array()
    K = packed.q.shape[0]
    w_pad = np.ones(K)
    if weights is not None:
        w_pad[: len(hyps)] = np.asarray(weights, float)
    mm_pad = np.zeros((K, packed.node_lat.shape[1]))
    sc_pad = np.zeros(K)
    rho = packed.rho
    if memo_masks is not None:
        mm_pad[: len(hyps), :] = np.asarray(memo_masks, float)
    if spec_costs is not None:
        sc_pad[: len(hyps)] = np.asarray(spec_costs, float)
    if memo_rho is not None:
        rho = rho.copy()
        rho[: len(hyps), :] = np.asarray(memo_rho, float)
    if len(hyps) <= small_beam_threshold:
        static_terms = None
        if static_cache is not None:
            static_terms = _cached_static_terms(
                hyps, packed, scorer.n_max, static_cache)
        admitted_mask, eu_adm = _admit_numpy(
            packed, np.asarray(authoritative_rho, float), cap,
            np.asarray(limit, float), scorer.lam, scorer.mu, idle_window,
            w=w_pad, memo_mask=mm_pad, rho=rho, model_delay=model_delay,
            spec_cost=sc_pad, shed_penalty=shed_penalty,
            static_terms=static_terms,
        )
    else:
        t = device_tables(
            packed, scorer.device, rho=rho, w=w_pad, memo_mask=mm_pad,
            auth_rho=authoritative_rho, cap=cap, limit=limit, lam=scorer.lam,
            mu=scorer.mu, idle_window=idle_window, model_delay=model_delay,
            spec_cost=sc_pad, shed_penalty=shed_penalty)
        admitted_mask, eu_adm, _ = admit_beam(**t, n_nodes=scorer.n_max)
        admitted_mask = admitted_mask.cpu().numpy()
        eu_adm = eu_adm.cpu().numpy()
    admitted, rejected, eu = [], [], {}
    for i, h in enumerate(hyps):
        if admitted_mask[i] > 0:
            admitted.append(h)
            eu[h.hid] = float(eu_adm[i])
        else:
            rejected.append(h)
    return AdmissionResult(admitted, eu, rejected)


def exact_admit(
    hyps: Sequence[BranchHypothesis],
    scorer: Scorer,
    slack: np.ndarray,
    budget: np.ndarray,
    authoritative_rho: np.ndarray,
    idle_window: float = 10.0,
) -> Tuple[List[BranchHypothesis], float]:
    """Brute-force Eq. 5 (for tests / quality reporting).  O(2^K)."""
    limit = np.minimum(slack, budget)
    best: Tuple[float, Tuple[int, ...]] = (0.0, ())
    n = len(hyps)
    rhos = [_prefix_rho(h) for h in hyps]
    for r in range(1, n + 1):
        for subset in itertools.combinations(range(n), r):
            demand = np.sum([rhos[i] for i in subset], axis=0)
            if not np.all(demand <= _fit_limit(limit)):
                continue
            # EU of each member conditioned on the OTHERS in the subset
            total = 0.0
            for i in subset:
                others = np.sum(
                    [rhos[j] for j in subset if j != i], axis=0,
                ) if r > 1 else np.zeros(RESOURCE_DIMS)
                eu, _, _ = scorer.score(
                    [hyps[i]], authoritative_rho + others, idle_window
                )
                total += float(eu[0])
            if total > best[0]:
                best = (total, subset)
    return [hyps[i] for i in best[1]], best[0]
