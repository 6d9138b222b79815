"""Attention head padding in the PyTorch port.

With ``head_pad_multiple`` the query and KV head counts round up, the
padded heads' columns of wq/wk/wv and rows of wo are zero, and the kernels
see the padded counts. The port's twin of
tests/test_perf_features.py::test_head_padding_exact_equivalence (3 heads
of head_dim 16 padded to 4; the plain versions on the CPU, bit-identical),
the same through prefill and decode and the sequence-sharded decode, and
the JAX package's padded params bridged into the port against the JAX
package (float32, 1e-4).
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
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

TOL = 1e-4
SMALL = dict(n_heads=3, n_kv_heads=3, head_dim=16, d_model=48)


def _cfg(get=get_config, **kw):
    return dataclasses.replace(get("qwen2-7b").reduced(), **SMALL, **kw)


def _tokens(cfg, shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape)).long()


def test_padded_params_are_zero_past_the_real_heads():
    cfg = _cfg(head_pad_multiple=4)
    assert (cfg.eff_n_heads, cfg.eff_n_kv_heads) == (4, 4)
    attn = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")["blocks"][0]["attn"]
    hd = cfg.resolved_head_dim
    assert attn["wq"].shape == (48, 4 * hd) and attn["wo"].shape == (4 * hd, 48)
    assert attn["bq"].shape == attn["bk"].shape == attn["bv"].shape == (4 * hd,)
    for name in ("wq", "wk", "wv"):
        assert not attn[name][:, 3 * hd:].any() and attn[name][:, :3 * hd].any()
    assert not attn["wo"][3 * hd:].any()


def test_head_padding_exact_equivalence():
    """Zero-init padded heads: a bit-identical forward, from the same draws."""
    cfg = _cfg()
    cfgp = dataclasses.replace(cfg, head_pad_multiple=4)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    paramsp = M.init_params(cfgp, torch.Generator().manual_seed(0), device="cpu")
    toks = _tokens(cfg, (2, 16), seed=1)
    l1, _ = M.forward(params, cfg, {"tokens": toks})
    l2, _ = M.forward(paramsp, cfgp, {"tokens": toks})
    assert float((l1 - l2).abs().max()) == 0.0


@pytest.mark.parametrize("sharded", [False, True])
def test_padded_prefill_and_decode_equal_the_unpadded(sharded):
    """Through the cache: prefill, then decode steps, unsharded or
    sequence-sharded over 2 shards of the padded cache (f32, 1e-5; the
    shards sum their partials in another order)."""
    cfg = dataclasses.replace(_cfg(), dtype="float32")
    cfgp = dataclasses.replace(cfg, head_pad_multiple=4, sharded_decode_attn=sharded)
    mi = M.MeshContext(make_local_mesh(2, device="cpu"), ("data",), "model", 2, 1) \
        if sharded else None
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    paramsp = M.init_params(cfgp, torch.Generator().manual_seed(0), device="cpu")
    prompt = _tokens(cfg, (2, 9), seed=2)
    lg, cache = M.prefill(params, cfg, {"tokens": prompt}, max_len=16)
    lgp, cachep = M.prefill(paramsp, cfgp, {"tokens": prompt}, max_len=16)
    assert cachep["k"].shape[-2] == 4 and cache["k"].shape[-2] == 3
    torch.testing.assert_close(lgp, lg, atol=1e-5, rtol=1e-5)
    for tok in _tokens(cfg, (4, 2), seed=3):
        lg, cache = M.decode_step(params, cfg, cache, tok)
        lgp, cachep = M.decode_step(paramsp, cfgp, cachep, tok, mesh_info=mi)
        torch.testing.assert_close(lgp, lg, atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def bridged():
    jcfg = dataclasses.replace(_cfg(jax_get_config), dtype="float32", head_pad_multiple=4)
    cfg = dataclasses.replace(_cfg(), dtype="float32", head_pad_multiple=4)
    np_params = jax.tree.map(np.asarray, JM.init_params(jax.random.key(0), jcfg))
    return jcfg, cfg, jax.tree.map(jnp.asarray, np_params), M.params_from_numpy(
        np_params, cfg, device="cpu")


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


def test_jax_padded_params_match_jax(bridged):
    jcfg, cfg, jparams, params = bridged
    assert params["blocks"][0]["attn"]["wq"].shape == (48, 4 * 16)
    toks = _tokens(cfg, (2, 12), seed=4)
    want, _ = JM.forward(jparams, jcfg, {"tokens": jnp.asarray(toks.numpy())})
    got, _ = M.forward(params, cfg, {"tokens": toks})
    _close(got, want)
    want, jcache = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks.numpy())}, max_len=24)
    got, cache = M.prefill(params, cfg, {"tokens": toks}, max_len=24)
    _close(got, want)
    _close(cache["k"], jcache["k"])
    for tok in _tokens(cfg, (3, 2), seed=5):
        want, jcache = JM.decode_step(jparams, jcfg, jcache, jnp.asarray(tok.numpy()))
        got, cache = M.decode_step(params, cfg, cache, tok)
        _close(got, want)
