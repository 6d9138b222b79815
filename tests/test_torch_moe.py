"""The PyTorch port's MoE block and MoE models against the JAX package's.

The block's parts on numpy data (router f32 at 1e-6; positions in expert,
keep mask and dispatch rows exactly, with the same expert ids fed to both
packages, also where slots drop), the block (y, lb_loss and drop_frac at
f32 1e-5), and reduced mixtral-8x7b and qwen3-moe-30b-a3b (forward, prefill
and decode at f32 1e-4) with one set of weights: the JAX params as numpy,
bridged by ``params_from_numpy``. Then the port's twins of
tests/test_models.py's decode consistency (prefill + one decode step
against the full forward, at its tolerances) for a dense, an MoE, an SSM
and a hybrid arch, and of its load-balance aux check.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402

TOL = 1e-4
BLOCK_TOL = 1e-5
MOE_ARCHS = ["mixtral-8x7b", "qwen3-moe-30b-a3b"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on the
    cores (xdist), and many small tensor ops slow down tenfold when each
    process also spreads them over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch="mixtral-8x7b", dtype="float32", **moe_kw):
    jcfg, cfg = (dataclasses.replace(get(arch).reduced(), dtype=dtype)
                 for get in (jax_get_config, get_config))
    if moe_kw:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe_kw))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
    return jcfg, cfg


def _normal(rng, shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _block_params(cfg, seed):
    """One MoE block's weights as numpy, the router f32."""
    rng = np.random.default_rng(seed)
    D, E, Fd = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff_expert
    return {"router": _normal(rng, (D, E), D ** -0.5),
            "w_gate": _normal(rng, (E, D, Fd), D ** -0.5),
            "w_up": _normal(rng, (E, D, Fd), D ** -0.5),
            "w_down": _normal(rng, (E, Fd, D), Fd ** -0.5)}


def _to_torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_route_matches_jax():
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(0)
    x = _normal(rng, (40, cfg.d_model))
    router = _normal(rng, (cfg.d_model, cfg.moe.n_experts), cfg.d_model ** -0.5)
    want = jmoe._route(jnp.asarray(x), jnp.asarray(router), jcfg)
    got = moe._route(torch.from_numpy(x), torch.from_numpy(router), cfg)
    assert got[0].dtype == got[2].dtype == torch.float32
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        _close(g, w, 1e-6)


def _jax_keep_dest(e_flat, cap, n_experts):
    """keep and dest as the JAX package's _moe_local computes them
    (src/repro/models/moe.py, the local path: every expert local)."""
    pos = jmoe._positions_in_expert(e_flat, n_experts + 1)
    keep = pos < cap
    return pos, keep, jnp.where(keep, e_flat * cap + pos, n_experts * cap)


# (tokens, capacity factor, expert draw): uniform, and skewed towards expert 0
DISPATCH_CASES = [(24, 8.0, "uniform"), (24, 1.0, "uniform"), (24, 1.0, "skewed"),
                  (7, 1.25, "skewed"), (1, 1.25, "uniform")]


@pytest.mark.parametrize("t,cf,draw", DISPATCH_CASES)
def test_positions_keep_and_dest_match_jax_exactly(t, cf, draw):
    _, cfg = _cfgs(capacity_factor=cf)
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    rng = np.random.default_rng(t)
    p = None if draw == "uniform" else [0.55, 0.25, 0.15, 0.05]
    experts = np.stack([rng.choice(E, size=k, replace=False, p=p) for _ in range(t)])
    cap = moe.capacity(t, cfg)
    assert cap == max(1, int(np.ceil(t * k * cf / E)))
    pos, keep, dest = _jax_keep_dest(jnp.asarray(experts.reshape(-1)), cap, E)
    e_t = torch.from_numpy(experts).long()
    np.testing.assert_array_equal(moe._positions_in_expert(e_t.reshape(-1)).numpy(),
                                  np.asarray(pos))
    got_keep, got_dest = moe._dispatch(e_t, cap, E)
    np.testing.assert_array_equal(got_keep.numpy(), np.asarray(keep))
    np.testing.assert_array_equal(got_dest.numpy(), np.asarray(dest))
    if (t, cf, draw) == (24, 1.0, "skewed"):
        assert not got_keep.all()          # a case that drops


@pytest.mark.parametrize("t,cf,draw", DISPATCH_CASES)
def test_moe_local_with_fed_expert_ids_matches_jax(monkeypatch, t, cf, draw):
    """The same expert ids and gates fed to both packages' ``_moe_local``:
    the same slots kept, y within f32 1e-5."""
    jcfg, cfg = _cfgs(capacity_factor=cf)
    E, k, D = cfg.moe.n_experts, cfg.moe.top_k, cfg.d_model
    rng = np.random.default_rng(100 + t)
    p = None if draw == "uniform" else [0.55, 0.25, 0.15, 0.05]
    experts = np.stack([rng.choice(E, size=k, replace=False, p=p) for _ in range(t)])
    gates = rng.uniform(0.1, 1.0, size=(t, k)).astype(np.float32)
    probs = rng.dirichlet(np.ones(E), size=t).astype(np.float32)
    x = _normal(rng, (1, t, D))
    params = _block_params(cfg, seed=t)
    monkeypatch.setattr(jmoe, "_route", lambda *_: (jnp.asarray(gates), jnp.asarray(experts),
                                                    jnp.asarray(probs)))
    monkeypatch.setattr(moe, "_route", lambda *_: (torch.from_numpy(gates),
                                                   torch.from_numpy(experts).long(),
                                                   torch.from_numpy(probs)))
    want_y, want_aux = jmoe._moe_local(jax.tree.map(jnp.asarray, params), jnp.asarray(x), jcfg,
                                       E, 0)
    got_y, got_aux = moe._moe_local(_to_torch(params), torch.from_numpy(x), cfg, E, 0)
    assert float(got_aux["kept"]) == float(want_aux["kept"])
    assert got_aux["slots"] == float(want_aux["slots"]) == t * k
    _close(got_y, want_y, BLOCK_TOL)
    _close(got_aux["lb_loss"], want_aux["lb_loss"], BLOCK_TOL)


@pytest.mark.parametrize("offset", [0, 2])
@pytest.mark.parametrize("t,cf,draw", DISPATCH_CASES)
def test_moe_local_shard_with_fed_expert_ids_matches_jax(monkeypatch, t, cf, draw, offset):
    """One expert-parallel shard: 2 of the 4 experts from ``offset``, their
    weights alone, the slots routed elsewhere in the overflow bin; the same
    expert ids and gates fed to both packages' ``_moe_local``: the same
    slots kept and the partial y within f32 1e-5."""
    jcfg, cfg = _cfgs(capacity_factor=cf)
    E, k, D = cfg.moe.n_experts, cfg.moe.top_k, cfg.d_model
    rng = np.random.default_rng(300 + t)
    p = None if draw == "uniform" else [0.55, 0.25, 0.15, 0.05]
    experts = np.stack([rng.choice(E, size=k, replace=False, p=p) for _ in range(t)])
    gates = rng.uniform(0.1, 1.0, size=(t, k)).astype(np.float32)
    probs = rng.dirichlet(np.ones(E), size=t).astype(np.float32)
    x = _normal(rng, (1, t, D))
    params = _block_params(cfg, seed=t)
    shard = {name: (a if name == "router" else a[offset:offset + 2]) for name, a in params.items()}
    monkeypatch.setattr(jmoe, "_route", lambda *_: (jnp.asarray(gates), jnp.asarray(experts),
                                                    jnp.asarray(probs)))
    monkeypatch.setattr(moe, "_route", lambda *_: (torch.from_numpy(gates),
                                                   torch.from_numpy(experts).long(),
                                                   torch.from_numpy(probs)))
    want_y, want_aux = jmoe._moe_local(jax.tree.map(jnp.asarray, shard), jnp.asarray(x), jcfg,
                                       2, offset)
    got_y, got_aux = moe._moe_local(_to_torch(shard), torch.from_numpy(x), cfg, 2, offset)
    assert float(got_aux["kept"]) == float(want_aux["kept"])
    _close(got_y, want_y, BLOCK_TOL)
    _close(got_aux["lb_loss"], want_aux["lb_loss"], BLOCK_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("cf", [8.0, 1.0])
def test_moe_forward_matches_jax(arch, cf):
    """The whole block from its own router, without drops (the reduced
    configs' factor 8) and with them (factor 1)."""
    jcfg, cfg = _cfgs(arch, capacity_factor=cf)
    rng = np.random.default_rng(7)
    x = _normal(rng, (2, 13, cfg.d_model))
    params = _block_params(cfg, seed=8)
    want_y, want_aux = jmoe.moe_forward(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                                        jcfg, None)
    got_y, got_aux = moe.moe_forward(_to_torch(params), torch.from_numpy(x), cfg)
    assert got_y.shape == x.shape and got_y.dtype == torch.float32
    _close(got_y, want_y, BLOCK_TOL)
    _close(got_aux["lb_loss"], want_aux["lb_loss"], BLOCK_TOL)
    _close(got_aux["drop_frac"], want_aux["drop_frac"], BLOCK_TOL)
    assert (float(got_aux["drop_frac"]) > 0) == (cf == 1.0)


def test_moe_combine_is_bitwise_repeatable():
    _, cfg = _cfgs(capacity_factor=1.0)
    x = torch.from_numpy(_normal(np.random.default_rng(9), (4, 1, cfg.d_model)))
    params = _to_torch(_block_params(cfg, seed=9))
    first, again = (moe.moe_forward(params, x, cfg) for _ in range(2))
    assert torch.equal(first[0], again[0])
    assert torch.equal(first[1]["drop_frac"], again[1]["drop_frac"])


def _bridge(arch, seed=0):
    jcfg, cfg = _cfgs(arch)
    np_params = jax.tree.map(np.asarray, JM.init_params(jax.random.key(seed), jcfg))
    return jcfg, cfg, jax.tree.map(jnp.asarray, np_params), M.params_from_numpy(
        np_params, cfg, device="cpu")


@pytest.fixture(scope="module", params=MOE_ARCHS)
def bridged(request):
    return _bridge(request.param)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=shape).astype(np.int32)


def test_forward_matches_jax(bridged):
    """70 tokens: past reduced mixtral's window of 64."""
    jcfg, cfg, jparams, params = bridged
    toks = _tokens(cfg, (2, 70), seed=3)
    want, want_aux = JM.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    got, aux = M.forward(params, cfg, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 70, cfg.padded_vocab)
    _close(got, want, TOL)
    _close(aux, want_aux, TOL)
    assert float(aux) > 0.0


def test_prefill_and_decode_match_jax(bridged):
    jcfg, cfg, jparams, params = bridged
    prompt = _tokens(cfg, (2, 11), seed=4)
    feed = _tokens(cfg, (5, 2), seed=5)
    want, jcache = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(prompt)}, max_len=32)
    got, cache = M.prefill(params, cfg, {"tokens": torch.from_numpy(prompt).long()}, max_len=32)
    _close(got, want, TOL)
    _close(cache["k"], jcache["k"], TOL)
    for tok in feed:
        want, jcache = JM.decode_step(jparams, jcfg, jcache, jnp.asarray(tok))
        got, cache = M.decode_step(params, cfg, cache, torch.from_numpy(tok).long())
        _close(got, want, TOL)
    _close(cache["v"], jcache["v"], TOL)
    np.testing.assert_array_equal(cache["lengths"].numpy(), np.asarray(jcache["lengths"]))


def test_router_stays_float32_through_params_from_numpy():
    jcfg, cfg = _cfgs(dtype="bfloat16")
    np_params = jax.tree.map(np.asarray, JM.init_params(jax.random.key(1), jcfg))
    assert np_params["blocks"]["moe"]["router"].dtype == np.float32
    params = M.params_from_numpy(np_params, cfg, device="cpu")
    blk = params["blocks"][2]["moe"]
    assert blk["router"].dtype == torch.float32 and blk["w_up"].dtype == torch.bfloat16
    np.testing.assert_array_equal(blk["router"].numpy(), np_params["blocks"]["moe"]["router"][2])
    own = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert own["blocks"][0]["moe"]["router"].dtype == torch.float32
    assert own["blocks"][0]["moe"]["w_gate"].shape == (cfg.moe.n_experts, cfg.d_model,
                                                       cfg.moe.d_ff_expert)


@pytest.mark.parametrize("arch", ["granite-8b", "mixtral-8x7b", "mamba2-2.7b", "zamba2-1.2b"])
def test_decode_consistency(arch):
    """prefill(x[:-1]) + decode(x[-1]) must equal forward(x) at the last
    position (tests/test_models.py::test_decode_consistency, its reduced
    bf16 configs and tolerances)."""
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(_tokens(cfg, (1, 24), seed=6)).long()
    lg_full, _ = M.forward(params, cfg, {"tokens": toks})
    lg_pre, cache = M.prefill(params, cfg, {"tokens": toks[:, :-1]}, max_len=40)
    np.testing.assert_allclose(torch.log_softmax(lg_full[:, -2], -1).numpy(),
                               torch.log_softmax(lg_pre, -1).numpy(), atol=1e-2, rtol=1e-2)
    lg_dec, _ = M.decode_step(params, cfg, cache, toks[:, -1])
    np.testing.assert_allclose(torch.log_softmax(lg_full[:, -1], -1).numpy(),
                               torch.log_softmax(lg_dec, -1).numpy(), atol=2e-2, rtol=2e-2)


def test_moe_load_balance_aux():
    """tests/test_models.py::test_moe_load_balance_aux: about 1 at uniform
    routing over E experts; finite and positive."""
    cfg = get_config("mixtral-8x7b").reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(_tokens(cfg, (2, 32), seed=10)).long()
    _, aux = M.forward(params, cfg, {"tokens": toks})
    assert 0.0 < float(aux) < 10.0


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-30b-a3b"])
def test_moe_under_a_local_mesh_runs_every_expert(arch):
    """Over a LocalMesh one process holds every shard, so an MoE block runs
    all its experts at once, what the shards' psum adds up to: prefill and
    decode equal those without a mesh. The mesh of processes is held
    against JAX's shard_map in tests/test_torch_dist_moe.py."""
    _, cfg = _cfgs(arch)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    mi = M.mesh_context(make_local_mesh(2, device="cpu"))
    toks = torch.from_numpy(_tokens(cfg, (1, 5), seed=11)).long()
    lg_mesh, cache_mesh = M.prefill(params, cfg, {"tokens": toks}, max_len=16, mesh_info=mi)
    lg, cache = M.prefill(params, cfg, {"tokens": toks}, max_len=16)
    assert torch.equal(lg_mesh, lg)
    lg_mesh, _ = M.decode_step(params, cfg, cache_mesh, toks[:, -1], mesh_info=mi)
    lg, _ = M.decode_step(params, cfg, cache, toks[:, -1])
    assert torch.equal(lg_mesh, lg)
