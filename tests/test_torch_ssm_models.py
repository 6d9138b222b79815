"""The PyTorch port's Mamba2 model against the JAX package's, on
mamba2-2.7b reduced to 4 layers (d_model 128, 8 SSM heads of head_dim 32,
d_state 16, chunk 32) at float32.

One set of weights serves both: the JAX package's params as numpy arrays,
bridged into the port by ``params_from_numpy``. The JAX side runs its jnp
chunked scan, the port its plain chunked scan (CPU tensors). Logits and
states agree within 1e-4 (atol and rtol): the arithmetic is the same, only
summation order differs.
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
ARCH = "mamba2-2.7b"


def _cfgs(dtype="float32", **kw):
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), dtype=dtype, **kw)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype, **kw)
    return jcfg, cfg


@pytest.fixture(scope="module")
def bridged():
    jcfg, cfg = _cfgs(attn_impl="jnp")
    np_params = jax.tree.map(np.asarray, JM.init_params(jax.random.key(0), jcfg))
    jparams = jax.tree.map(jnp.asarray, np_params)
    return jcfg, dataclasses.replace(cfg, attn_impl="auto"), jparams, \
        M.params_from_numpy(np_params, cfg, device="cpu")


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=shape).astype(np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_params_from_numpy_layout(bridged):
    jcfg, cfg, jparams, params = bridged
    assert len(params["blocks"]) == cfg.n_layers
    blk = params["blocks"][2]["ssm"]
    s = cfg.ssm
    assert blk["w_x"].shape == (cfg.d_model, s.d_inner(cfg.d_model))
    assert blk["conv_B_w"].shape == (s.d_conv, s.n_groups * s.d_state)
    np.testing.assert_array_equal(blk["A_log"].numpy(),
                                  np.asarray(jparams["blocks"]["ssm"]["A_log"][2]))


def test_params_from_numpy_bfloat16_keeps_f32_leaves():
    """A_log, D and dt_bias stay float32 in a bf16 config, as in JAX."""
    jcfg, cfg = _cfgs(dtype="bfloat16")
    np_params = jax.tree.map(np.asarray, JM.init_params(jax.random.key(1), jcfg))
    params = M.params_from_numpy(np_params, cfg, device="cpu")
    blk = params["blocks"][0]["ssm"]
    for name in ("A_log", "D", "dt_bias"):
        assert blk[name].dtype == torch.float32, name
        np.testing.assert_array_equal(blk[name].numpy(),
                                      np.asarray(np_params["blocks"]["ssm"][name][0]))
    for name in ("w_z", "conv_x_w", "norm_w", "out_proj"):
        assert blk[name].dtype == torch.bfloat16, name
    assert params["blocks"][0]["ln"].dtype == params["embed"].dtype == torch.bfloat16
    # the port's own init agrees
    own = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")["blocks"][0]["ssm"]
    assert {k: v.dtype for k, v in own.items()} == {k: v.dtype for k, v in blk.items()}


@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_forward_matches_jax(bridged, impl):
    jcfg, cfg, jparams, params = bridged
    toks = _tokens(cfg, (2, 45), seed=3)          # two chunks of 32, the second ragged
    want, _ = JM.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    got, aux = M.forward(params, dataclasses.replace(cfg, attn_impl=impl),
                         {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 45, cfg.padded_vocab) and got.dtype == torch.float32
    assert float(aux) == 0.0
    _close(got, want)


def test_prefill_and_decode_match_jax(bridged):
    jcfg, cfg, jparams, params = bridged
    prompt = _tokens(cfg, (2, 11), seed=4)
    feed = _tokens(cfg, (6, 2), seed=5)
    want, jcache = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(prompt)}, max_len=32)
    got, cache = M.prefill(params, cfg, {"tokens": torch.from_numpy(prompt).long()}, max_len=32)
    _close(got, want)
    assert len(cache["ssm_state"]) == 4
    for leaf, jleaf in zip(cache["ssm_state"], jcache["ssm_state"], strict=True):
        assert leaf.shape == jleaf.shape and leaf.shape[:2] == (cfg.n_layers, 2)
        _close(leaf, jleaf)
    assert cache["ssm_state"][3].dtype == torch.float32
    for tok in feed:
        want, jcache = JM.decode_step(jparams, jcfg, jcache, jnp.asarray(tok))
        got, cache = M.decode_step(params, cfg, cache, torch.from_numpy(tok).long())
        _close(got, want)
        np.testing.assert_array_equal(cache["lengths"].numpy(), np.asarray(jcache["lengths"]))
    for leaf, jleaf in zip(cache["ssm_state"], jcache["ssm_state"], strict=True):
        _close(leaf, jleaf)


@pytest.mark.parametrize("dtype,tol", [("bfloat16", (1e-2, 2e-2)), ("float32", (1e-4, 1e-4))])
def test_decode_consistency(dtype, tol):
    """prefill(x[:-1]) + decode(x[-1]) must equal forward(x) at the last pos
    (tests/test_models.py::test_decode_consistency; bf16 at its tolerances)."""
    _, cfg = _cfgs(dtype=dtype)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(_tokens(cfg, (1, 40), seed=6)).long()
    lg_full, _ = M.forward(params, cfg, {"tokens": toks})
    lg_pre, cache = M.prefill(params, cfg, {"tokens": toks[:, :-1]}, max_len=48)
    pre_tol, dec_tol = tol
    np.testing.assert_allclose(torch.log_softmax(lg_full[:, -2], -1).numpy(),
                               torch.log_softmax(lg_pre, -1).numpy(), atol=pre_tol, rtol=pre_tol)
    lg_dec, _ = M.decode_step(params, cfg, cache, toks[:, -1])
    np.testing.assert_allclose(torch.log_softmax(lg_full[:, -1], -1).numpy(),
                               torch.log_softmax(lg_dec, -1).numpy(), atol=dec_tol, rtol=dec_tol)


def test_decode_inactive_rows_keep_state_and_length(bridged):
    _, cfg, _, params = bridged
    prompt = torch.from_numpy(_tokens(cfg, (2, 5), seed=7)).long()
    _, cache = M.prefill(params, cfg, {"tokens": prompt}, max_len=16)
    before = [leaf.clone() for leaf in cache["ssm_state"]]
    _, cache = M.decode_step(params, cfg, cache, prompt[:, -1],
                             active=torch.tensor([True, False]))
    assert cache["lengths"].tolist() == [6, 5]
    for leaf, old in zip(cache["ssm_state"], before, strict=True):
        assert torch.equal(leaf[:, 1], old[:, 1])
        assert not torch.equal(leaf[:, 0], old[:, 0])


def test_init_cache_layout():
    _, cfg = _cfgs(dtype="bfloat16")
    cache = M.init_cache(cfg, batch=3, max_len=64, device="cpu")
    s = cfg.ssm
    di, gn, nh = s.d_inner(cfg.d_model), s.n_groups * s.d_state, s.n_heads(cfg.d_model)
    L = cfg.n_layers
    assert [tuple(a.shape) for a in cache["ssm_state"]] == [
        (L, 3, s.d_conv - 1, di), (L, 3, s.d_conv - 1, gn), (L, 3, s.d_conv - 1, gn),
        (L, 3, nh, s.head_dim, s.d_state)]
    assert [a.dtype for a in cache["ssm_state"]] == [torch.bfloat16] * 3 + [torch.float32]
    assert cache["lengths"].dtype == torch.int32 and "k" not in cache
