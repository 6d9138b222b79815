"""The port's rolling-buffer sliding-window cache against the JAX package's.

granite-8b reduced to 2 layers at float32 with ``sliding_window=8``
(tests/test_swa_and_sim.py::test_rolling_window_decode_matches_full_forward),
one set of weights for both packages, bridged through numpy. With a cache
of ``max_len = 8`` rows (no longer than the window) the cache is a rolling
buffer: a prefill keeps the last 8 positions and decode writes each new
row at ``length % 8``, attending over ``min(length + 1, 8)`` rows with no
window mask. Held:

* decode from a 6-token prompt past the buffer's end against the port's
  and JAX's full forward under the window mask (log-softmax, that test's
  3e-2) and against JAX's own rolling decode (logits and caches, 1e-4);
* a prefill longer than the buffer (13 tokens into 8 rows), then decode,
  against both full forwards under the window mask (3e-2) and against
  JAX's rolling decode started from JAX's prefill cache moved to the rows
  that decode expects (1e-4): JAX's own prefill keeps a long prompt's
  positions unrotated, which its decode then overwrites out of order;
* the sequence-sharded rolling decode over a local mesh of 4 shards of 2
  rows against the unsharded one (1e-4);
* the int8 rolling cache after an 11-token prompt against JAX's, moved as
  above (log-softmax, 2e-2 as in tests/test_torch_int8_kv.py: a quantized
  value may round the other way), and against both full forwards under the
  window mask (3e-2).
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
WINDOW_TOL = 3e-2
INT8_TOL = 2e-2
WINDOW = 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on the
    cores (xdist), and this file's many small tensor ops slow down tenfold
    when each process also spreads them over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    kw = dict(sliding_window=WINDOW, n_layers=2, max_seq_len=64, dtype="float32", **kw)
    return (dataclasses.replace(jax_get_config("granite-8b").reduced(), **kw),
            dataclasses.replace(get_config("granite-8b").reduced(), **kw))


def _bridge(jcfg, cfg):
    np_params = jax.tree.map(np.asarray, JM.init_params(jax.random.key(0), jcfg))
    return jax.tree.map(jnp.asarray, np_params), M.params_from_numpy(np_params, cfg,
                                                                      device="cpu")


@pytest.fixture(scope="module")
def bridged():
    jcfg, cfg = _cfgs()
    return (jcfg, cfg, *_bridge(jcfg, cfg))


def _tokens(cfg, shape=(2, 20), seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=shape).astype(np.int32)


def _lsm(x):
    x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    return torch.log_softmax(x.float(), dim=-1).numpy()


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _mesh(n_model):
    return M.MeshContext(make_local_mesh(n_model, device="cpu"), ("data",), "model", n_model, 1)


def test_rolling_window_decode_matches_full_forward(bridged):
    jcfg, cfg, jparams, params = bridged
    toks = _tokens(cfg)
    _, jcache = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks[:, :6])}, max_len=WINDOW)
    _, cache = M.prefill(params, cfg, {"tokens": torch.from_numpy(toks[:, :6]).long()},
                         max_len=WINDOW)
    assert cache["k"].shape[2] == WINDOW                 # the buffer is capped at the window
    for t in range(6, 16):                               # wraps after 8 tokens
        want, jcache = JM.decode_step(jparams, jcfg, jcache, jnp.asarray(toks[:, t]))
        got, cache = M.decode_step(params, cfg, cache, torch.from_numpy(toks[:, t]).long())
        _close(got, want)
        _close(cache["k"], jcache["k"])
        full, _ = M.forward(params, cfg, {"tokens": torch.from_numpy(toks[:, :t + 1]).long()})
        jfull, _ = JM.forward(jparams, jcfg, {"tokens": jnp.asarray(toks[:, :t + 1])})
        np.testing.assert_allclose(_lsm(got), _lsm(full[:, -1]), atol=WINDOW_TOL,
                                   rtol=WINDOW_TOL)
        np.testing.assert_allclose(_lsm(got), _lsm(jfull[:, -1]), atol=WINDOW_TOL,
                                   rtol=WINDOW_TOL)
    assert cache["lengths"].tolist() == [16, 16]


def _rolled(jcache, s):
    """JAX's prefill cache of an ``s``-token prompt with position p moved to
    row p % WINDOW, the layout its rolling decode writes to: its own prefill
    keeps positions s-8..s-1 at rows 0..7 (see the module docstring of
    repro_torch.models.attention)."""
    return {**jcache, **{n: jax.tree.map(lambda t: jnp.roll(t, s % WINDOW, axis=2), jcache[n])
                         for n in ("k", "v")}}


def _full_lsm(params, jparams, cfg, jcfg, toks):
    """Log-softmax of the last position of the port's and JAX's full forward
    (under the window mask) over ``toks``."""
    full, _ = M.forward(params, cfg, {"tokens": torch.from_numpy(toks).long()})
    jfull, _ = JM.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    return _lsm(full[:, -1]), _lsm(jfull[:, -1])


def test_rolling_prefill_longer_than_the_buffer(bridged):
    """13 prompt tokens into 8 rows: the cache keeps positions 5..12, each
    at row p % 8, and decode writes over the row that has just left the
    window, so it matches the full forward under the window mask."""
    jcfg, cfg, jparams, params = bridged
    toks = _tokens(cfg, seed=2)
    want, jcache = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks[:, :13])},
                              max_len=WINDOW)
    got, cache = M.prefill(params, cfg, {"tokens": torch.from_numpy(toks[:, :13]).long()},
                           max_len=WINDOW)
    _close(got, want)
    jcache = _rolled(jcache, 13)
    for name in ("k", "v"):
        assert cache[name].shape == jcache[name].shape
        _close(cache[name], jcache[name])
    for t in range(13, 17):
        want, jcache = JM.decode_step(jparams, jcfg, jcache, jnp.asarray(toks[:, t]))
        got, cache = M.decode_step(params, cfg, cache, torch.from_numpy(toks[:, t]).long())
        _close(got, want)
        for full in _full_lsm(params, jparams, cfg, jcfg, toks[:, :t + 1]):
            np.testing.assert_allclose(_lsm(got), full, atol=WINDOW_TOL, rtol=WINDOW_TOL)


def test_rolling_sharded_decode_matches_unsharded(bridged):
    """4 shards of 2 rows: the new row lands on the shard that holds its
    rolled slot, and every shard attends over its rows with no window."""
    _, cfg, _, params = bridged
    sharded = dataclasses.replace(cfg, sharded_decode_attn=True)
    toks = torch.from_numpy(_tokens(cfg, seed=3)).long()
    _, cache = M.prefill(params, cfg, {"tokens": toks[:, :5]}, max_len=WINDOW)
    _, cache_sh = M.prefill(params, sharded, {"tokens": toks[:, :5]}, max_len=WINDOW)
    active = torch.tensor([True, False])
    for t in range(5, 17):
        want, cache = M.decode_step(params, cfg, cache, toks[:, t])
        got, cache_sh = M.decode_step(params, sharded, cache_sh, toks[:, t], mesh_info=_mesh(4))
        _close(got, want)
        _close(cache_sh["k"], cache["k"])
    # an inactive row keeps its rolled rows and its length on every shard
    before = cache_sh["k"].clone()
    _, cache_sh = M.decode_step(params, sharded, cache_sh, toks[:, 17], active=active,
                                mesh_info=_mesh(4))
    assert cache_sh["lengths"].tolist() == [18, 17]
    assert torch.equal(cache_sh["k"][:, 1], before[:, 1])
    assert not torch.equal(cache_sh["k"][:, 0], before[:, 0])


def test_int8_rolling_cache_matches_jax():
    jcfg, cfg = _cfgs(kv_cache_dtype="int8")
    jparams, params = _bridge(jcfg, cfg)
    toks = _tokens(cfg, seed=4)
    want, jcache = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks[:, :11])},
                              max_len=WINDOW)
    got, cache = M.prefill(params, cfg, {"tokens": torch.from_numpy(toks[:, :11]).long()},
                           max_len=WINDOW)
    np.testing.assert_allclose(_lsm(got), _lsm(want), atol=INT8_TOL, rtol=0)
    jcache = _rolled(jcache, 11)
    (kq, ks), (jkq, jks) = cache["k"], jcache["k"]
    assert kq.dtype == torch.int8 and kq.shape == jkq.shape == (2, 2, WINDOW, *kq.shape[3:])
    assert np.abs(kq.numpy().astype(np.int32) - np.asarray(jkq, np.int32)).max() <= 1
    for t in range(11, 17):
        want, jcache = JM.decode_step(jparams, jcfg, jcache, jnp.asarray(toks[:, t]))
        got, cache = M.decode_step(params, cfg, cache, torch.from_numpy(toks[:, t]).long())
        np.testing.assert_allclose(_lsm(got), _lsm(want), atol=INT8_TOL, rtol=0)
        for full in _full_lsm(params, jparams, cfg, jcfg, toks[:, :t + 1]):
            np.testing.assert_allclose(_lsm(got), full, atol=WINDOW_TOL, rtol=WINDOW_TOL)
    assert cache["k"][0].dtype == torch.int8 and cache["lengths"].tolist() == [17, 17]
