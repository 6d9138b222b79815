"""The PyTorch port's dense model against the JAX package's, on qwen2-7b
reduced to 4 layers at float32.

One set of weights serves both: the JAX package's params, with random
non-zero QKV biases, as numpy arrays, bridged into the port by
``params_from_numpy``. Logits agree within 1e-4 (atol and rtol): the
arithmetic is the same, only summation order differs.
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


def _cfgs(dtype="float32", **kw):
    jcfg = dataclasses.replace(jax_get_config("qwen2-7b").reduced(), dtype=dtype, **kw)
    cfg = dataclasses.replace(get_config("qwen2-7b").reduced(), dtype=dtype, **kw)
    return jcfg, cfg


def numpy_params(jcfg, seed=0):
    """The JAX package's params as numpy, QKV biases made random and non-zero."""
    params = jax.tree.map(np.asarray, JM.init_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed)
    attn = params["blocks"]["attn"]
    for name in ("bq", "bk", "bv"):
        attn[name] = (0.1 * rng.normal(size=attn[name].shape)).astype(attn[name].dtype)
    return params


@pytest.fixture(scope="module")
def bridged():
    jcfg, cfg = _cfgs()
    np_params = numpy_params(jcfg)
    jparams = jax.tree.map(jnp.asarray, np_params)
    return jcfg, cfg, jparams, M.params_from_numpy(np_params, cfg, device="cpu")


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=shape).astype(np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)


def test_params_from_numpy_layout(bridged):
    jcfg, cfg, jparams, params = bridged
    assert len(params["blocks"]) == cfg.n_layers
    blk = params["blocks"][1]["attn"]
    assert blk["wq"].shape == (cfg.d_model, cfg.n_heads * cfg.resolved_head_dim)
    np.testing.assert_array_equal(blk["bk"].numpy(), np.asarray(jparams["blocks"]["attn"]["bk"][1]))
    assert float(blk["bq"].abs().min()) > 0.0


def test_params_from_numpy_bfloat16():
    jcfg, cfg = _cfgs(dtype="bfloat16")
    np_params = jax.tree.map(np.asarray, JM.init_params(jax.random.key(1), jcfg))
    params = M.params_from_numpy(np_params, cfg, device="cpu")
    assert params["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(params["embed"].float().numpy(),
                                  np.asarray(np_params["embed"], np.float32))


@pytest.mark.parametrize("attn_impl", ["auto", "ref"])
def test_forward_matches_jax(bridged, attn_impl):
    jcfg, cfg, jparams, params = bridged
    cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    toks = _tokens(cfg, (2, 24), seed=3)
    want, _ = JM.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    got, aux = M.forward(params, cfg, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 24, cfg.padded_vocab) and got.dtype == torch.float32
    assert float(aux) == 0.0
    _close(got, want)


def test_prefill_and_decode_match_jax(bridged):
    jcfg, cfg, jparams, params = bridged
    prompt = _tokens(cfg, (2, 11), seed=4)
    feed = _tokens(cfg, (6, 2), seed=5)
    want, jcache = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(prompt)}, max_len=32)
    got, cache = M.prefill(params, cfg, {"tokens": torch.from_numpy(prompt).long()}, max_len=32)
    _close(got, want)
    assert cache["k"].shape == (cfg.n_layers, 2, 32, cfg.n_kv_heads, cfg.resolved_head_dim)
    _close(cache["k"], jcache["k"])
    for tok in feed:
        want, jcache = JM.decode_step(jparams, jcfg, jcache, jnp.asarray(tok))
        got, cache = M.decode_step(params, cfg, cache, torch.from_numpy(tok).long())
        _close(got, want)
        np.testing.assert_array_equal(cache["lengths"].numpy(), np.asarray(jcache["lengths"]))
    _close(cache["v"], jcache["v"])


@pytest.mark.parametrize("dtype,tol", [("bfloat16", (1e-2, 2e-2)), ("float32", (1e-4, 1e-4))])
def test_decode_consistency(dtype, tol):
    """prefill(x[:-1]) + decode(x[-1]) must equal forward(x) at the last pos
    (tests/test_models.py::test_decode_consistency; bf16 at its tolerances)."""
    _, cfg = _cfgs(dtype=dtype)
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


def test_decode_inactive_rows_keep_cache_and_length(bridged):
    _, cfg, _, params = bridged
    prompt = torch.from_numpy(_tokens(cfg, (2, 5), seed=7)).long()
    _, cache = M.prefill(params, cfg, {"tokens": prompt}, max_len=16)
    before_k, before_v = cache["k"].clone(), cache["v"].clone()
    active = torch.tensor([True, False])
    _, cache = M.decode_step(params, cfg, cache, prompt[:, -1], active=active)
    assert cache["lengths"].tolist() == [6, 5]
    assert torch.equal(cache["k"][:, 1], before_k[:, 1])
    assert torch.equal(cache["v"][:, 1], before_v[:, 1])
    assert not torch.equal(cache["k"][:, 0, 5], before_k[:, 0, 5])


def test_init_params_shapes_and_vocab_mask():
    _, cfg = _cfgs()
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert params["embed"].shape == (cfg.padded_vocab, cfg.d_model)
    assert params["blocks"][0]["mlp"]["w_down"].shape == (cfg.d_ff, cfg.d_model)
    w = params["blocks"][0]["attn"]["wq"]
    assert float(w.abs().max()) <= 2.0 * cfg.d_model ** -0.5 + 1e-6     # truncated at 2 sigma
    toks = torch.from_numpy(_tokens(cfg, (1, 8), seed=8)).long()
    logits, _ = M.forward(params, cfg, {"tokens": toks})
    assert torch.isfinite(logits[..., :cfg.vocab_size]).all()
    if cfg.padded_vocab != cfg.vocab_size:
        assert (logits[..., cfg.vocab_size:] <= -1e29).all()
