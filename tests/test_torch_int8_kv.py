"""The port's int8 KV cache against the JAX package's.

``kv_quantize`` is held bit for bit against JAX's on the same float32 input
(both round half to even). The int8 model (qwen2-7b reduced to 4 layers at
float32, JAX params with random non-zero QKV biases bridged through numpy)
is held on log-softmax at 2e-2, the bound of
tests/test_perf_features.py::test_sharded_decode_multidevice: a last-bit
difference in K between the packages can move one quantized value by one
step. Its prefill, six decode steps, and the sequence-sharded decode over
2 and 4 shards are compared with JAX's unsharded int8 decode; the cache
stays int8 across steps (test_int8_kv_cache_decode_close), and the engine
copies the values and scales of a prefilled request into its slot.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

TOL = 2e-2
MAX_LEN = 32


def _cfgs(dtype="float32", **kw):
    kw = {"kv_cache_dtype": "int8", **kw}
    jcfg = dataclasses.replace(jax_get_config("qwen2-7b").reduced(), dtype=dtype, **kw)
    cfg = dataclasses.replace(get_config("qwen2-7b").reduced(), dtype=dtype, **kw)
    return jcfg, cfg


@pytest.fixture(scope="module")
def bridged():
    jcfg, cfg = _cfgs()
    params = jax.tree.map(np.asarray, JM.init_params(jax.random.key(0), jcfg))
    rng = np.random.default_rng(0)
    attn = params["blocks"]["attn"]
    for name in ("bq", "bk", "bv"):
        attn[name] = (0.1 * rng.normal(size=attn[name].shape)).astype(attn[name].dtype)
    return (jcfg, cfg, jax.tree.map(jnp.asarray, params),
            M.params_from_numpy(params, cfg, device="cpu"))


def _lsm(x):
    x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    return torch.log_softmax(x.float(), dim=-1).numpy()


def _mesh(n_model):
    return M.MeshContext(make_local_mesh(n_model, device="cpu"), ("data",), "model", n_model, 1)


def test_kv_quantize_bit_identical_to_jax():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(3, 16, 4, 32)) * rng.uniform(0.01, 10, size=(3, 16, 4, 1)))
    x = x.astype(np.float32)
    x[0, :3] = 0.0                                   # zero vectors: scale clamps to 1e-8
    x[1, 0, 0, :4] = [127.0, 63.5, -0.5, 1.5]          # halves round to even
    jq, js = jattn.kv_quantize(jnp.asarray(x))
    q, s = attn_mod.kv_quantize(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (3, 16, 4)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    for dtype in ("float32", "bfloat16"):
        want = jattn.kv_dequantize(jq, js, getattr(jnp, dtype)).astype(jnp.float32)
        got = attn_mod.kv_dequantize(q, s, getattr(torch, dtype)).float()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_prefill_and_decode_match_jax(bridged):
    jcfg, cfg, jparams, params = bridged
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab_size, size=(2, 11)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, size=(6, 2)).astype(np.int32)
    want, jcache = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(prompt)}, max_len=MAX_LEN)
    got, cache = M.prefill(params, cfg, {"tokens": torch.from_numpy(prompt).long()},
                           max_len=MAX_LEN)
    np.testing.assert_allclose(_lsm(got), _lsm(want), atol=TOL, rtol=0)
    (kq, ks), (jkq, jks) = cache["k"], jcache["k"]
    assert kq.dtype == torch.int8 and kq.shape == jkq.shape and ks.shape == jks.shape
    assert np.abs(kq.numpy().astype(np.int32) - np.asarray(jkq, np.int32)).max() <= 1
    for tok in feed:
        want, jcache = JM.decode_step(jparams, jcfg, jcache, jnp.asarray(tok))
        got, cache = M.decode_step(params, cfg, cache, torch.from_numpy(tok).long())
        np.testing.assert_allclose(_lsm(got), _lsm(want), atol=TOL, rtol=0)
    assert cache["k"][0].dtype == torch.int8 and cache["v"][1].dtype == torch.float32
    assert cache["lengths"].tolist() == [17, 17]


@pytest.mark.parametrize("n_model", [2, 4])
def test_int8_sharded_decode_matches_jax(bridged, n_model):
    jcfg, cfg, jparams, params = bridged
    cfg = dataclasses.replace(cfg, sharded_decode_attn=True)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, size=(2, 7)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, size=(4, 2)).astype(np.int32)
    _, jcache = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(prompt)}, max_len=MAX_LEN)
    _, cache = M.prefill(params, cfg, {"tokens": torch.from_numpy(prompt).long()},
                         max_len=MAX_LEN)
    for tok in feed:
        want, jcache = JM.decode_step(jparams, jcfg, jcache, jnp.asarray(tok))
        got, cache = M.decode_step(params, cfg, cache, torch.from_numpy(tok).long(),
                                   mesh_info=_mesh(n_model))
        np.testing.assert_allclose(_lsm(got), _lsm(want), atol=TOL, rtol=0)


def test_int8_cache_stays_int8_and_close_to_bf16():
    """tests/test_perf_features.py::test_int8_kv_cache_decode_close on the port."""
    _, cfg8 = _cfgs(dtype="bfloat16")
    cfg = dataclasses.replace(cfg8, kv_cache_dtype="bfloat16")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 20)))
    lg, cache = M.prefill(params, cfg, {"tokens": toks}, max_len=40)
    lg8, cache8 = M.prefill(params, cfg8, {"tokens": toks}, max_len=40)
    t = torch.argmax(lg, -1)
    d1, _ = M.decode_step(params, cfg, cache, t)
    d2, c2 = M.decode_step(params, cfg8, cache8, t)
    assert np.abs(_lsm(d1) - _lsm(d2)).max() < 0.15
    assert c2["k"][0].dtype == torch.int8
    d3, _ = M.decode_step(params, cfg8, c2, torch.argmax(d2, -1))
    assert not torch.isnan(d3).any()


def test_engine_copies_int8_values_and_scales(bridged):
    _, cfg, _, params = bridged
    eng = ServingEngine(cfg, params, max_batch=3, max_len=MAX_LEN, device="cpu")
    assert eng.cache["k"][0].dtype == torch.int8
    eng.add_request([11, 12, 13], request_id=1)
    slot = eng.add_request([5, 6, 7, 8], request_id=2)
    _, cache = M.prefill(params, cfg, {"tokens": torch.tensor([[5, 6, 7, 8]])}, max_len=MAX_LEN)
    for name in ("k", "v"):
        for big, small in zip(eng.cache[name], cache[name], strict=True):
            assert torch.equal(big[:, slot], small[:, 0])
    assert eng.cache["lengths"].tolist() == [3, 4, 0]
    out = eng.step()
    assert set(out) == {0, 1} and eng.cache["lengths"].tolist() == [4, 5, 0]
