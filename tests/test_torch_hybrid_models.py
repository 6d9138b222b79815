"""The PyTorch port's hybrid (zamba2: Mamba2 + shared attention) model
against the JAX package's, at float32.

zamba2-1.2b reduced (6 Mamba2 layers of d_model 128, 8 SSM heads of
head_dim 32, d_state 16, chunk 32; one group of 6 and the shared attention
block, 4 heads of head_dim 32 over 4 kv heads), and the same with
``n_layers=14``: two groups and a tail of 2 layers that no attention
follows. One set of weights serves both packages: the JAX params as numpy
arrays, bridged by ``params_from_numpy``. The JAX side runs its jnp paths,
the port its plain versions (CPU tensors). Logits, states and K/V agree
within 1e-4 (atol and rtol): the arithmetic is the same, only summation
order differs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

TOL = 1e-4
ARCH = "zamba2-1.2b"
DEPTHS = [None, 14]   # .reduced() (G = 1, no tail) and G = 2 with a tail of 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on the
    cores (xdist), and this file's many small tensor ops slow down tenfold
    when each process also spreads them over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(dtype="float32", n_layers=None, **kw):
    if n_layers is not None:
        kw["n_layers"] = n_layers
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), dtype=dtype, **kw)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype, **kw)
    return jcfg, cfg


def _bridge(n_layers, dtype="float32", seed=0):
    jcfg, cfg = _cfgs(dtype, n_layers, attn_impl="jnp")
    np_params = jax.tree.map(np.asarray, JM.init_params(jax.random.key(seed), jcfg))
    return (jcfg, dataclasses.replace(cfg, attn_impl="auto"),
            jax.tree.map(jnp.asarray, np_params), M.params_from_numpy(np_params, cfg,
                                                                      device="cpu"))


@pytest.fixture(scope="module", params=DEPTHS, ids=["reduced", "14-layers"])
def bridged(request):
    return _bridge(request.param)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=shape).astype(np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_hybrid_split():
    for n_layers, want in ((None, (1, 6, 0)), (14, (2, 6, 2)), (38, (6, 6, 2))):
        jcfg, cfg = _cfgs(n_layers=n_layers)
        assert M.hybrid_split(cfg) == JM.hybrid_split(jcfg) == want
    assert M.hybrid_split(get_config(ARCH)) == (6, 6, 2)     # full width: 38 layers


def test_params_from_numpy_layout(bridged):
    jcfg, cfg, jparams, params = bridged
    assert len(params["blocks"]) == cfg.n_layers
    assert set(params) == {"embed", "final_norm", "lm_head", "blocks", "shared_attn"}
    shared = params["shared_attn"]
    hd = cfg.resolved_head_dim
    assert shared["ln"].shape == (cfg.d_model,)
    assert shared["attn"]["wq"].shape == (cfg.d_model, cfg.n_heads * hd)
    assert shared["attn"]["wo"].shape == (cfg.n_heads * hd, cfg.d_model)
    np.testing.assert_array_equal(shared["attn"]["wk"].numpy(),
                                  np.asarray(jparams["shared_attn"]["attn"]["wk"]))
    np.testing.assert_array_equal(params["blocks"][-1]["ssm"]["A_log"].numpy(),
                                  np.asarray(jparams["blocks"]["ssm"]["A_log"][-1]))


def test_params_from_numpy_bfloat16_keeps_f32_leaves():
    """The SSM's A_log, D and dt_bias stay float32 in a bf16 config; the
    shared block's leaves are bf16; the port's own init has the same tree."""
    jcfg, cfg = _cfgs(dtype="bfloat16")
    np_params = jax.tree.map(np.asarray, JM.init_params(jax.random.key(1), jcfg))
    params = M.params_from_numpy(np_params, cfg, device="cpu")
    for name in ("A_log", "D", "dt_bias"):
        assert params["blocks"][0]["ssm"][name].dtype == torch.float32, name
    assert params["shared_attn"]["ln"].dtype == torch.bfloat16
    assert {v.dtype for v in params["shared_attn"]["attn"].values()} == {torch.bfloat16}
    own = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    def layout(tree):
        if isinstance(tree, dict):
            return {k: layout(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [layout(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)

    assert layout(own) == layout(params)


@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_forward_matches_jax(bridged, impl):
    jcfg, cfg, jparams, params = bridged
    toks = _tokens(cfg, (2, 45), seed=3)          # two SSD chunks of 32, the second ragged
    want, _ = JM.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    got, aux = M.forward(params, dataclasses.replace(cfg, attn_impl=impl),
                         {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 45, cfg.padded_vocab) and got.dtype == torch.float32
    assert float(aux) == 0.0
    _close(got, want)


def test_prefill_and_decode_match_jax(bridged):
    jcfg, cfg, jparams, params = bridged
    g = M.hybrid_split(cfg)[0]
    prompt = _tokens(cfg, (2, 11), seed=4)
    feed = _tokens(cfg, (6, 2), seed=5)
    want, jcache = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(prompt)}, max_len=32)
    got, cache = M.prefill(params, cfg, {"tokens": torch.from_numpy(prompt).long()}, max_len=32)
    _close(got, want)
    assert cache["k"].shape == jcache["k"].shape == (g, 2, 32, cfg.n_kv_heads,
                                                     cfg.resolved_head_dim)
    for name in ("k", "v"):
        _close(cache[name], jcache[name])
    for leaf, jleaf in zip(cache["ssm_state"], jcache["ssm_state"], strict=True):
        assert leaf.shape == jleaf.shape and leaf.shape[:2] == (cfg.n_layers, 2)
        _close(leaf, jleaf)
    for tok in feed:
        want, jcache = JM.decode_step(jparams, jcfg, jcache, jnp.asarray(tok))
        got, cache = M.decode_step(params, cfg, cache, torch.from_numpy(tok).long())
        _close(got, want)
        np.testing.assert_array_equal(cache["lengths"].numpy(), np.asarray(jcache["lengths"]))
    for name in ("k", "v"):
        _close(cache[name], jcache[name])
    for leaf, jleaf in zip(cache["ssm_state"], jcache["ssm_state"], strict=True):
        _close(leaf, jleaf)


@pytest.mark.parametrize("n_layers", DEPTHS)
@pytest.mark.parametrize("dtype,tol", [("bfloat16", (1e-2, 2e-2)), ("float32", (1e-4, 1e-4))])
def test_decode_consistency(n_layers, dtype, tol):
    """prefill(x[:-1]) + decode(x[-1]) must equal forward(x) at the last pos
    (tests/test_models.py::test_decode_consistency on zamba2-1.2b; bf16 at
    its tolerances)."""
    _, cfg = _cfgs(dtype=dtype, n_layers=n_layers)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(_tokens(cfg, (1, 24), seed=6)).long()
    lg_full, _ = M.forward(params, cfg, {"tokens": toks})
    lg_pre, cache = M.prefill(params, cfg, {"tokens": toks[:, :-1]}, max_len=40)
    pre_tol, dec_tol = tol
    np.testing.assert_allclose(torch.log_softmax(lg_full[:, -2], -1).numpy(),
                               torch.log_softmax(lg_pre, -1).numpy(), atol=pre_tol, rtol=pre_tol)
    lg_dec, _ = M.decode_step(params, cfg, cache, toks[:, -1])
    np.testing.assert_allclose(torch.log_softmax(lg_full[:, -1], -1).numpy(),
                               torch.log_softmax(lg_dec, -1).numpy(), atol=dec_tol, rtol=dec_tol)


def test_long_context_hybrid_decode_smoke():
    """tests/test_swa_and_sim.py::test_long_context_hybrid_decode_smoke: a
    64-token prompt into a cache of 256, 4 steps; the SSM state's shape does
    not depend on the cache's length, the shared block's K/V do."""
    _, cfg = _cfgs(dtype="bfloat16")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(_tokens(cfg, (1, 64), seed=7)).long()
    lg, cache = M.prefill(params, cfg, {"tokens": toks}, max_len=256)
    tok = torch.argmax(lg, -1)
    for _ in range(4):
        lg, cache = M.decode_step(params, cfg, cache, tok)
        tok = torch.argmax(lg, -1)
        assert not torch.isnan(lg).any()
    assert int(cache["lengths"][0]) == 64 + 4
    assert cache["ssm_state"][3].shape[1] == 1
    short = M.init_cache(cfg, batch=1, max_len=16, device="cpu")
    assert [a.shape for a in short["ssm_state"]] == [a.shape for a in cache["ssm_state"]]
    assert cache["k"].shape[2] == 256 and short["k"].shape[2] == 16


def test_decode_inactive_rows_keep_state_kv_and_length(bridged):
    _, cfg, _, params = bridged
    prompt = torch.from_numpy(_tokens(cfg, (2, 5), seed=8)).long()
    _, cache = M.prefill(params, cfg, {"tokens": prompt}, max_len=16)
    before = [leaf.clone() for leaf in cache["ssm_state"]]
    before_kv = {name: cache[name].clone() for name in ("k", "v")}
    _, cache = M.decode_step(params, cfg, cache, prompt[:, -1],
                             active=torch.tensor([True, False]))
    assert cache["lengths"].tolist() == [6, 5]
    for leaf, old in zip(cache["ssm_state"], before, strict=True):
        assert torch.equal(leaf[:, 1], old[:, 1])
        assert not torch.equal(leaf[:, 0], old[:, 0])
    for name, old in before_kv.items():
        assert torch.equal(cache[name][:, 1], old[:, 1])
        assert not torch.equal(cache[name][:, 0, 5], old[:, 0, 5])   # row 5 written in place


def test_init_cache_layout():
    for n_layers in DEPTHS:
        _, cfg = _cfgs(dtype="bfloat16", n_layers=n_layers)
        cache = M.init_cache(cfg, batch=3, max_len=64, device="cpu")
        s = cfg.ssm
        di, gn, nh = s.d_inner(cfg.d_model), s.n_groups * s.d_state, s.n_heads(cfg.d_model)
        L, g = cfg.n_layers, M.hybrid_split(cfg)[0]
        assert [tuple(a.shape) for a in cache["ssm_state"]] == [
            (L, 3, s.d_conv - 1, di), (L, 3, s.d_conv - 1, gn), (L, 3, s.d_conv - 1, gn),
            (L, 3, nh, s.head_dim, s.d_state)]
        assert [a.dtype for a in cache["ssm_state"]] == [torch.bfloat16] * 3 + [torch.float32]
        for name in ("k", "v"):   # one per application of the shared block, max_len rows
            assert cache[name].shape == (g, 3, 64, cfg.n_kv_heads, cfg.resolved_head_dim)
            assert cache[name].dtype == torch.bfloat16
        assert cache["lengths"].dtype == torch.int32
