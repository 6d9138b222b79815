"""The port's scoring and admission against the JAX package's.

Every beam of tests/test_admission_fused.py is rebuilt here from the same
random draws, once with each package's hypothesis classes, and goes
through every admission path of both packages: the reference greedy
(``greedy_admit``, one ``score_beam`` call per chunk and iteration), the
fused pass at its default routing, the fused pass forced onto the device
path (``admit_beam``; here on the CPU, as torch ops in float32 against
JAX's jitted float32) and forced onto the host path (``_admit_numpy``).
Admitted sets must be identical path for path, EU-at-admit within
rtol = atol = 1e-4 (the JAX test's own tolerance), and ``score_beam``'s
EU, ΔO, ΔU and ΔI within rtol = atol = 1e-5. The port's device path must
also agree with its own host path.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import admission as jadm  # noqa: E402
from repro.core import events as jev  # noqa: E402
from repro.core import hypothesis as jhyp  # noqa: E402
from repro.core import interference as jint  # noqa: E402
from repro.core import scoring as jsc  # noqa: E402
from repro_torch.core import admission as tadm  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.core import hypothesis as thyp  # noqa: E402
from repro_torch.core import interference as tint  # noqa: E402
from repro_torch.core import scoring as tsc  # noqa: E402

JAX = (jev, jhyp, jint, jsc, jadm)
PORT = (tev, thyp, tint, tsc, tadm)
EU_TOL = 1e-4
SCORE_TOL = 1e-5
READ_TOOLS = ["grep", "read", "parse", "search", "fetch", "visit"]
SLACK = np.array([5.7, 41.0, 180.0, 1.0])
BUDGET = np.array([4.3, 33.0, 150.0, 1.0])


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: many tiny tensor ops, several test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# beams as plain descriptions, built by either package
# ----------------------------------------------------------------------
def _chain(tools, q):
    nodes = [("TOOL", t, 1.0) for t in tools]
    return nodes, [(i - 1, i) for i in range(1, len(tools))], q


def _random_chains(rng, k):
    """tests/test_admission_fused.py::_random_beam's draws."""
    out = []
    for _ in range(k):
        depth = int(rng.integers(1, 5))
        tools = [READ_TOOLS[int(rng.integers(0, len(READ_TOOLS)))] for _ in range(depth)]
        out.append(_chain(tools, float(rng.uniform(0.1, 0.95))))
    return out


def _random_tree(rng, q=None):
    """tests/test_admission_fused.py::_mk_tree_hyp's draws: a bounded tree
    of read tools, probability split across siblings, a MODEL join behind
    the leaves."""
    q = float(rng.uniform(0.2, 0.95)) if q is None else q
    nodes, edges = [], []

    def emit(parent, cond, depth):
        me = len(nodes)
        nodes.append(("TOOL", READ_TOOLS[int(rng.integers(0, len(READ_TOOLS)))], cond))
        if parent is not None:
            edges.append((parent, me))
        leaves = []
        if depth < 3 and len(nodes) < 7:
            n_kids = int(rng.integers(0, 3))
            if n_kids:
                probs = rng.dirichlet(np.ones(n_kids)) * float(rng.uniform(0.6, 1.0))
                for p in probs:
                    leaves += emit(me, float(p), depth + 1)
        return leaves or [me]

    leaves = emit(None, 1.0, 1)
    join = len(nodes)
    nodes.append(("MODEL", "model_step", 1.0))
    edges += [(leaf, join) for leaf in leaves]
    return nodes, edges, q


def _build(pkg, descs):
    ev, hyp = pkg[0], pkg[1]
    hyps = []
    for hid, (nodes, edges, q) in enumerate(descs):
        built = []
        for i, (kind, tool, cond) in enumerate(nodes):
            spec = ev.DEFAULT_TOOLS[tool]
            built.append(hyp.Node(i, getattr(hyp.NodeKind, kind), tool, spec.level,
                                  spec.rho, spec.base_latency, cond_prob=cond))
        hyps.append(hyp.BranchHypothesis(hid, built, list(edges), q, context_key=("x",)))
    return hyps


def _random_memo(rng, hyps, n_max=12):
    """tests/test_admission_fused.py::_random_memo's draws (over the JAX
    package's hypotheses; the port gets the same arrays)."""
    masks = np.zeros((len(hyps), n_max))
    rhos = np.zeros((len(hyps), jev.RESOURCE_DIMS))
    for i, h in enumerate(hyps):
        excl = set()
        for n in h.safe_prefix():
            if n.idx < n_max and rng.random() < 0.5:
                masks[i, n.idx] = 1.0
                excl.add(n.idx)
        rhos[i] = jsc.prefix_rho(h, frozenset(excl))
    return masks, rhos


def _spec_costs_for(descs, rng):
    has_model = np.array([any(kind == "MODEL" for kind, _, _ in d[0]) for d in descs])
    return np.where(has_model, rng.uniform(0.5, 3.0, len(descs)), 0.0)


# ----------------------------------------------------------------------
# the cases of tests/test_admission_fused.py, draw for draw
# ----------------------------------------------------------------------
def _case(kind, seed, k):
    """(descs, slack, budget, auth, keyword arguments of the admission call)."""
    kw = {}
    if kind == "random":
        rng = np.random.default_rng(seed)
        descs = _random_chains(rng, k)
    elif kind == "small":
        rng = np.random.default_rng(100 + seed)
        descs = _random_chains(rng, k)
    elif kind == "shared":
        rng = np.random.default_rng(500 + seed)
        descs = _random_chains(rng, k)
        w_by_tenant = {0: 1.0, 1: float(rng.uniform(0.4, 0.9))}
        kw["weights"] = np.array([w_by_tenant[hid % 2] for hid in range(k)])
    elif kind == "memo":
        rng = np.random.default_rng(700 + seed)
        descs = _random_chains(rng, k)
        kw["memo_masks"], kw["memo_rho"] = _random_memo(rng, _build(JAX, descs))
    elif kind == "memo_tree_weights":
        rng = np.random.default_rng(900 + seed)
        descs = [_random_tree(rng) for _ in range(k)]
        kw["memo_masks"], kw["memo_rho"] = _random_memo(rng, _build(JAX, descs))
        kw["weights"] = np.array([1.0 if h % 2 else 0.7 for h in range(k)])
    elif kind == "tree":
        rng = np.random.default_rng(300 + seed)
        descs = [_random_tree(rng) for _ in range(k)]
    elif kind == "model_delay":
        rng = np.random.default_rng(500 + seed)
        descs = [_random_tree(rng) for _ in range(k)]
        auth = rng.uniform(0.0, 2.0, jev.RESOURCE_DIMS)
        kw["model_delay"] = float(rng.uniform(0.5, 4.0))
        return descs, SLACK, BUDGET, auth, kw
    elif kind == "spec_cost":
        rng = np.random.default_rng(700 + seed)
        descs = [_random_tree(rng) for _ in range(k)]
        auth = rng.uniform(0.0, 2.0, jev.RESOURCE_DIMS)
        kw["spec_costs"] = _spec_costs_for(descs, rng)
        return descs, SLACK, BUDGET, auth, kw
    elif kind == "shed":
        rng = np.random.default_rng(1000 + seed)
        descs = [_random_tree(rng) for _ in range(k)]
        auth = rng.uniform(0.0, 2.0, jev.RESOURCE_DIMS)
        kw["shed_penalty"] = float(rng.uniform(0.2, 3.0))
        return descs, SLACK, BUDGET, auth, kw
    elif kind == "all_terms":
        rng = np.random.default_rng(1200 + seed)
        descs = [_random_tree(rng) for _ in range(k)]
        auth = rng.uniform(0.0, 2.0, jev.RESOURCE_DIMS)
        kw.update(spec_costs=_spec_costs_for(descs, rng), model_delay=1.7, shed_penalty=0.9)
        return descs, SLACK, BUDGET, auth, kw
    elif kind == "wide":
        rng = np.random.default_rng(42)
        return _random_chains(rng, 12), SLACK, BUDGET, np.zeros(4), kw
    else:
        raise ValueError(kind)
    auth = rng.uniform(0.0, 2.0, jev.RESOURCE_DIMS)
    return descs, SLACK, BUDGET, auth, kw


CASES = (
    [("random", s, k) for s in range(8) for k in (3, 5, 8)]
    + [("small", s, k) for s in range(4) for k in (1, 2)]
    + [("shared", s, k) for s in range(4) for k in (4, 7, 10)]
    + [("memo", s, k) for s in range(6) for k in (3, 6, 10)]
    + [("memo_tree_weights", s, 6) for s in range(3)]
    + [("tree", s, k) for s in range(6) for k in (3, 6, 10)]
    + [("model_delay", s, k) for s in range(4) for k in (3, 6)]
    + [("spec_cost", s, k) for s in range(4) for k in (3, 6)]
    + [("shed", s, k) for s in range(4) for k in (3, 6)]
    + [("all_terms", s, 6) for s in range(2)]
    + [("wide", 0, 12)]
)


def _paths(pkg, descs, slack, budget, auth, kw):
    """Every admission path of one package on one beam."""
    _, _, intf, scoring, admission = pkg
    extra = {} if pkg is JAX else {"device": "cpu"}
    sc = scoring.Scorer(intf.Machine(), **extra)
    hyps = _build(pkg, descs)
    return {
        "reference": admission.greedy_admit(hyps, sc, slack, budget, auth, **kw),
        "fused": admission.fused_admit(hyps, sc, slack, budget, auth, **kw),
        "device": admission.fused_admit(hyps, sc, slack, budget, auth,
                                        small_beam_threshold=0, **kw),
        "host": admission.fused_admit(hyps, sc, slack, budget, auth,
                                      small_beam_threshold=len(hyps), **kw),
    }


def _assert_same(want, got, what):
    assert sorted(h.hid for h in got.admitted) == sorted(h.hid for h in want.admitted), (
        f"{what}: admitted {[h.hid for h in got.admitted]}, "
        f"want {[h.hid for h in want.admitted]}")
    for hid, val in want.eu.items():
        np.testing.assert_allclose(got.eu[hid], val, rtol=EU_TOL, atol=EU_TOL, err_msg=what)
    assert len(got.rejected) == len(want.rejected), what


@pytest.mark.parametrize("kind,seed,k", CASES, ids=[f"{c}-{s}-{k}" for c, s, k in CASES])
def test_admission_matches_jax(kind, seed, k):
    descs, slack, budget, auth, kw = _case(kind, seed, k)
    want = _paths(JAX, descs, slack, budget, auth, kw)
    got = _paths(PORT, descs, slack, budget, auth, kw)
    for path in want:
        _assert_same(want[path], got[path], f"{kind} seed {seed} k {k}, {path}")
    _assert_same(got["host"], got["device"], "port device path against its host path")
    assert got["device"].admitted or not want["reference"].admitted


def _score(pkg, hyps, auth, kw):
    _, _, intf, scoring, _ = pkg
    extra = {} if pkg is JAX else {"device": "cpu"}
    sc = scoring.Scorer(intf.Machine(), **extra)
    n = min(len(hyps), sc.k_max)
    args = {key: kw[key][:n] for key in ("memo_masks", "memo_rho", "spec_costs") if key in kw}
    args.update({key: kw[key] for key in ("model_delay", "shed_penalty") if key in kw})
    eu, _, detail = sc.score(hyps[:n], auth, idle_window=8.0, **args)
    return np.asarray(eu), {key: np.asarray(v) for key, v in detail.items()}


@pytest.mark.parametrize("kind,seed,k", [c for c in CASES if c[0] != "small"][::3])
def test_score_beam_matches_jax(kind, seed, k):
    descs, _, _, auth, kw = _case(kind, seed, k)
    eu_j, det_j = _score(JAX, _build(JAX, descs), auth, kw)
    eu_t, det_t = _score(PORT, _build(PORT, descs), auth, kw)
    assert eu_t.dtype == np.float32
    np.testing.assert_allclose(eu_t, eu_j, rtol=SCORE_TOL, atol=SCORE_TOL)
    for key in ("delta_o", "delta_u", "delta_i"):
        np.testing.assert_allclose(det_t[key], det_j[key], rtol=SCORE_TOL, atol=SCORE_TOL,
                                   err_msg=key)


@pytest.mark.parametrize("seed", range(6))
def test_critical_path_matches_jax_on_random_dags(seed):
    """Longest paths over random masked DAGs (edges i -> j only for i < j),
    as many relaxations as nodes."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    K, N = 16, 12
    adj = np.triu(rng.random((K, N, N)) < 0.3, k=1).astype(np.float32)
    lat = rng.uniform(0.0, 5.0, (K, N)).astype(np.float32)
    mask = (rng.random((K, N)) < 0.8).astype(np.float32)
    want = np.asarray(jsc._critical_path(jnp.asarray(adj), jnp.asarray(lat),
                                         jnp.asarray(mask), n_iters=N))
    got = tsc._critical_path(torch.from_numpy(adj), torch.from_numpy(lat),
                             torch.from_numpy(mask), n_iters=N).numpy()
    np.testing.assert_allclose(got, want, rtol=SCORE_TOL, atol=SCORE_TOL)


# ----------------------------------------------------------------------
# the single-beam tests of tests/test_admission_fused.py, on both packages
# ----------------------------------------------------------------------
def test_boundary_fit_large_magnitude():
    """Demands of 49.9 io against a limit of exactly 3 x 49.9: the f32
    device path, the host path and the f64 reference admit the same three,
    in both packages."""
    def build(pkg):
        ev, hyp = pkg[0], pkg[1]
        spec = ev.ToolSpec("io_heavy", ev.SafetyLevel.READ_ONLY,
                           ev.ResourceVector(0.5, 1.0, 49.9, 0), 2.0)
        return [hyp.BranchHypothesis(
            hid, [hyp.Node(0, hyp.NodeKind.TOOL, "io_heavy", spec.level, spec.rho,
                           spec.base_latency)], [], 0.9 - 0.1 * hid, context_key=("x",))
            for hid in range(4)]

    slack = np.array([12.0, 100.0, 500.0, 1.0])
    budget = np.array([12.0, 100.0, 149.7, 1.0])
    for pkg in (JAX, PORT):
        _, _, intf, scoring, admission = pkg
        sc = scoring.Scorer(intf.Machine(), **({} if pkg is JAX else {"device": "cpu"}))
        hyps = build(pkg)
        ref = admission.greedy_admit(hyps, sc, slack, budget, np.zeros(4))
        krn = admission.fused_admit(hyps, sc, slack, budget, np.zeros(4),
                                    small_beam_threshold=0)
        npy = admission.fused_admit(hyps, sc, slack, budget, np.zeros(4),
                                    small_beam_threshold=len(hyps))
        assert len(ref.admitted) == 3
        _assert_same(ref, krn, "device path at the boundary")
        _assert_same(ref, npy, "host path at the boundary")


def test_fairness_weight_flips_starved_tenant_in():
    slack = np.array([1.2, 10.0, 60.0, 1.0])
    descs = [_chain(["grep", "read"], 0.8), _chain(["grep", "read"], 0.7)]
    sc = tsc.Scorer(tint.Machine(), device="cpu")
    hyps = _build(PORT, descs)
    plain = tadm.fused_admit(hyps, sc, slack, slack, np.zeros(4), small_beam_threshold=0)
    assert [h.hid for h in plain.admitted] == [0]
    weighted = tadm.fused_admit(hyps, sc, slack, slack, np.zeros(4),
                                weights=np.array([0.5, 1.0]), small_beam_threshold=0)
    assert [h.hid for h in weighted.admitted] == [1]


def test_memo_admits_zero_demand_branch_at_capacity():
    h = _build(PORT, [_chain(["grep", "read"], 0.8)])[0]
    sc = tsc.Scorer(tint.Machine(), device="cpu")
    masks = np.zeros((1, 12))
    for n in h.safe_prefix():
        masks[0, n.idx] = 1.0
    tight = np.full(4, 1e-6)
    for thr in (0, 1):
        assert tadm.fused_admit([h], sc, tight, tight, np.zeros(4),
                                small_beam_threshold=thr).admitted == []
        served = tadm.fused_admit([h], sc, tight, tight, np.zeros(4), memo_masks=masks,
                                  memo_rho=np.zeros((1, 4)), small_beam_threshold=thr)
        assert [x.hid for x in served.admitted] == [0]


def test_wide_beam_best_hypothesis_beyond_kmax_is_admitted():
    descs = [_chain(["grep", "read"], 0.1) for _ in range(11)]
    descs.append(_chain(["grep", "read", "parse"], 0.95))
    slack = np.array([2.3, 11.0, 120.0, 1.0])
    sc = tsc.Scorer(tint.Machine(), device="cpu")
    hyps = _build(PORT, descs)
    eu = sc.score_all(hyps, np.zeros(4), idle_window=8.0)
    assert eu.shape == (12,) and np.all(eu > 0)
    for res in (tadm.greedy_admit(hyps, sc, slack, slack, np.zeros(4)),
                tadm.fused_admit(hyps, sc, slack, slack, np.zeros(4))):
        assert 11 in {h.hid for h in res.admitted}


def test_empty_beam():
    sc = tsc.Scorer(tint.Machine(), device="cpu")
    res = tadm.fused_admit([], sc, np.ones(4), np.ones(4), np.zeros(4))
    assert res.admitted == [] and res.rejected == []
    assert sc.score_all([], np.zeros(4)).shape == (0,)


def test_host_helpers_equal_jax():
    """The host numpy helpers are the JAX package's, value for value."""
    rng = np.random.default_rng(7)
    descs = [_random_tree(rng) for _ in range(5)]
    pj, pt = jsc.pack_beam(_build(JAX, descs), 8, 12), tsc.pack_beam(_build(PORT, descs), 8, 12)
    for field in ("node_lat", "node_prob", "node_mask", "prefix_mask", "adj", "q", "rho",
                  "k_valid"):
        np.testing.assert_array_equal(getattr(pt, field), getattr(pj, field), err_msg=field)
    for n in range(1, 200):
        assert tadm.bucket_k(n, 8) == jadm.bucket_k(n, 8)
    assert tsc.tenant_fairness_weights({0: 0.0, 1: 2.0}) == \
        jsc.tenant_fairness_weights({0: 0.0, 1: 2.0})
    args = ((1, 2), SLACK, BUDGET, np.zeros(4), np.ones(2), None, None, 0.0)
    assert tadm.admission_signature(*args, spec_costs=np.ones(2), shed_penalty=0.7) == \
        jadm.admission_signature(*args, spec_costs=np.ones(2), shed_penalty=0.7)


def test_device_tables_round_to_float32_in_one_buffer():
    rng = np.random.default_rng(3)
    pb = tsc.pack_beam(_build(PORT, [_random_tree(rng) for _ in range(3)]), 8, 12)
    t = tsc.device_tables(pb, "cpu", rho=np.full((8, 4), 0.1), lam=0.5)
    assert all(v.dtype == torch.float32 for v in t.values())
    assert t["adj"].shape == (8, 12, 12) and t["lam"].shape == ()
    assert float(t["rho"][0, 0]) == float(np.float32(0.1))
    assert len({v.untyped_storage().data_ptr() for v in t.values()}) == 1


def test_cuda_scorer_without_a_card_raises():
    """No fallback: a device pass asked of "cuda" raises where there is no
    card (building the scorer allocates nothing, so it does not)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    sc = tsc.Scorer(tint.Machine())
    assert sc.device == torch.device("cuda")
    hyps = _build(PORT, _random_chains(np.random.default_rng(0), 4))
    with pytest.raises((RuntimeError, AssertionError)):
        tadm.fused_admit(hyps, sc, SLACK, BUDGET, np.zeros(4))
    with pytest.raises((RuntimeError, AssertionError)):
        sc.score(hyps, np.zeros(4))


@pytest.mark.parametrize("seed", range(4))
def test_demand_free_picks_with_ties(seed):
    """Identical chains, some fully memo-served (no demand), in shuffled
    order and with equal EU: the device pass takes demand-free picks
    together and must pick exactly what the one-by-one greedy picks (JAX's
    while_loop, both host paths), ties going to the first index."""
    rng = np.random.default_rng(40 + seed)
    k = 10
    descs = [_chain(["grep", "read"], 0.8) for _ in range(k)]
    hyps = _build(JAX, descs)
    served = rng.permutation(k)[: k // 2]
    masks, rhos = np.zeros((k, 12)), np.stack([jsc.prefix_rho(h) for h in hyps])
    for i in served:
        for n in hyps[i].safe_prefix():
            masks[i, n.idx] = 1.0
        rhos[i] = 0.0
    kw = dict(memo_masks=masks, memo_rho=rhos)
    if seed % 2:
        kw["weights"] = rng.choice([0.5, 1.0], size=k)
    slack = np.array([2.3, 11.0, 120.0, 1.0]) * (1 + seed)
    want = _paths(JAX, descs, slack, slack, np.zeros(4), kw)
    got = _paths(PORT, descs, slack, slack, np.zeros(4), kw)
    for path in want:
        _assert_same(want[path], got[path], f"ties seed {seed}, {path}")
    assert {h.hid for h in got["device"].admitted} >= set(served.tolist())
