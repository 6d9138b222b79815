"""The port's sequence-sharded split-KV decode against the JAX package's.

qwen2-7b reduced to 4 layers at float32, one set of weights for both
packages (the JAX params with random non-zero QKV biases, bridged through
numpy). With ``sharded_decode_attn`` and a local mesh of n_model = 2 or 4
shards on the CPU, the port's ``decode_step`` is held at 1e-4 against:

* JAX's plain ``decode_step`` in this process;
* JAX's own ``attn_decode_sharded`` (shard_map on a (4,2) and a (2,4) mesh
  of 8 host devices), run in a subprocess with its own XLA device count,
  as tests/test_perf_features.py::test_sharded_decode_multidevice runs it.
  The subprocess builds the params, saves them, the tokens and its logits
  to an .npz; with the int8 cache its logits are compared on log-softmax
  at 2e-2, that test's bound.

Also: inactive rows keep their cache on every shard, ``Smax % n_model != 0``
takes the plain decode, and a sharded engine serves the speculative agent
loop.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.patterns import PatternEngine  # noqa: E402
from repro_torch.core.workload import (  # noqa: E402
    WorkloadConfig, episodes_to_traces, make_episodes,
)
from repro_torch.launch.mesh import make_local_mesh, mesh_axes, mesh_counts  # noqa: E402
from repro_torch.launch.serve import serve_agent_loop  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

TOL = 1e-4
INT8_TOL = 2e-2
MAX_LEN = 32
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, jax, jax.numpy as jnp, numpy as np
    from repro import compat
    from repro.configs import get_config
    from repro.models import model as M
    from repro.models.model import MeshContext
    cfg = dataclasses.replace(get_config("qwen2-7b").reduced(), dtype="float32")
    params = jax.tree.map(np.asarray, M.init_params(jax.random.key(0), cfg))
    rng = np.random.default_rng(0)
    for name in ("bq", "bk", "bv"):
        a = params["blocks"]["attn"][name]
        params["blocks"]["attn"][name] = (0.1 * rng.normal(size=a.shape)).astype(a.dtype)
    prompt = rng.integers(0, cfg.vocab_size, size=(2, 11)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, size=(3, 2)).astype(np.int32)
    out = {"prompt": prompt, "feed": feed}
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    for path, a in flat:
        out["param/" + "/".join(p.key for p in path)] = a
    jp = jax.tree.map(jnp.asarray, params)
    for kv in ("float32", "int8"):
        for n_model in (2, 4):
            mesh = compat.make_mesh((8 // n_model, n_model), ("data", "model"))
            mi = MeshContext(mesh, ("data",), "model", n_model, 8 // n_model)
            c = dataclasses.replace(cfg, sharded_decode_attn=True,
                                    **({"kv_cache_dtype": "int8"} if kv == "int8" else {}))
            _, cache = M.prefill(jp, c, {"tokens": jnp.asarray(prompt)}, max_len=%(max_len)d)
            for i, tok in enumerate(feed):
                lg, cache = M.decode_step(jp, c, cache, jnp.asarray(tok), mesh_info=mi)
                out[f"logits/{kv}/{n_model}/{i}"] = np.asarray(lg)
    np.savez(sys.argv[1], **out)
    print("JAX_SHARDED_OK")
""") % {"max_len": MAX_LEN}


def _unflatten(npz):
    params = {}
    for key in npz.files:
        if not key.startswith("param/"):
            continue
        node = params
        *path, leaf = key.split("/")[1:]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = npz[key]
    return params


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    """Run JAX's shard_map decode in a subprocess; returns its .npz."""
    path = tmp_path_factory.mktemp("jax_sharded") / "out.npz"
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(path)], capture_output=True,
                       text=True, env=env, timeout=300, cwd=ROOT)
    assert "JAX_SHARDED_OK" in r.stdout, r.stderr[-3000:]
    return np.load(path)


def _cfgs(**kw):
    jcfg = dataclasses.replace(jax_get_config("qwen2-7b").reduced(), dtype="float32", **kw)
    cfg = dataclasses.replace(get_config("qwen2-7b").reduced(), dtype="float32", **kw)
    return jcfg, cfg


def _mesh(n_model):
    mesh = make_local_mesh(n_model, device="cpu")
    n_batch, n = mesh_counts(mesh)
    return M.MeshContext(mesh, *mesh_axes(mesh), n, n_batch)


def _log_softmax(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.asarray(jax.nn.log_softmax(jnp.asarray(x), axis=-1))


@pytest.fixture(scope="module")
def bridged(jax_sharded):
    np_params = _unflatten(jax_sharded)
    jcfg, cfg = _cfgs()
    return (jcfg, cfg, jax.tree.map(jnp.asarray, np_params),
            M.params_from_numpy(np_params, cfg, device="cpu"))


def test_local_mesh():
    mesh = make_local_mesh(4, device="cpu")
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 1, "model": 4} and mesh.device == torch.device("cpu")
    assert mesh_axes(mesh) == (("data",), "model") and mesh_counts(mesh) == (1, 4)
    assert _mesh(4) == M.MeshContext(mesh, ("data",), "model", 4, 1)
    with pytest.raises(ValueError):
        make_local_mesh(0, device="cpu")


@pytest.mark.parametrize("n_model", [2, 4])
def test_sharded_decode_matches_jax_plain_decode(bridged, jax_sharded, n_model):
    jcfg, cfg, jparams, params = bridged
    cfg = dataclasses.replace(cfg, sharded_decode_attn=True)
    prompt, feed = jax_sharded["prompt"], jax_sharded["feed"]
    _, jcache = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(prompt)}, max_len=MAX_LEN)
    _, cache = M.prefill(params, cfg, {"tokens": torch.from_numpy(prompt).long()},
                         max_len=MAX_LEN, mesh_info=_mesh(n_model))
    for tok in feed:
        want, jcache = JM.decode_step(jparams, jcfg, jcache, jnp.asarray(tok))
        got, cache = M.decode_step(params, cfg, cache, torch.from_numpy(tok).long(),
                                   mesh_info=_mesh(n_model))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("n_model", [2, 4])
def test_sharded_decode_matches_jax_shard_map(bridged, jax_sharded, kv, n_model):
    _, cfg, _, params = bridged
    cfg = dataclasses.replace(cfg, sharded_decode_attn=True,
                              **({"kv_cache_dtype": "int8"} if kv == "int8" else {}))
    prompt, feed = jax_sharded["prompt"], jax_sharded["feed"]
    _, cache = M.prefill(params, cfg, {"tokens": torch.from_numpy(prompt).long()},
                         max_len=MAX_LEN)
    for i, tok in enumerate(feed):
        got, cache = M.decode_step(params, cfg, cache, torch.from_numpy(tok).long(),
                                   mesh_info=_mesh(n_model))
        want = jax_sharded[f"logits/{kv}/{n_model}/{i}"]
        if kv == "int8":
            np.testing.assert_allclose(_log_softmax(got), _log_softmax(want), atol=INT8_TOL,
                                       rtol=0)
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_sharded_decode_keeps_inactive_rows(bridged, kv):
    """An inactive row keeps its K/V (and int8 scales) on every shard and its
    length; the active row's new row lands on the shard that holds it."""
    _, cfg, _, params = bridged
    cfg = dataclasses.replace(cfg, sharded_decode_attn=True,
                              **({"kv_cache_dtype": "int8"} if kv == "int8" else {}))
    prompt = torch.tensor([[5, 6, 7, 8, 9], [9, 8, 7, 6, 5]])
    _, cache = M.prefill(params, cfg, {"tokens": prompt}, max_len=16)
    leaves = [t for name in ("k", "v") for t in (cache[name] if kv == "int8" else (cache[name],))]
    before = [t.clone() for t in leaves]
    active = torch.tensor([True, False])
    _, cache = M.decode_step(params, cfg, cache, prompt[:, -1], active=active,
                             mesh_info=_mesh(4))   # 4 shards of 4 positions: slot 5 in shard 1
    assert cache["lengths"].tolist() == [6, 5]
    for t, t0 in zip(leaves, before, strict=True):
        assert torch.equal(t[:, 1], t0[:, 1])
        assert not torch.equal(t[:, 0, 5], t0[:, 0, 5])
        assert torch.equal(t[:, 0, :5], t0[:, 0, :5]) and torch.equal(t[:, 0, 6:], t0[:, 0, 6:])


def test_indivisible_cache_takes_plain_decode(bridged, monkeypatch):
    """Smax % n_model != 0 takes attn_decode, as the JAX dispatch does; a
    divisible cache takes attn_decode_sharded."""
    _, cfg, _, params = bridged
    cfg = dataclasses.replace(cfg, sharded_decode_attn=True)
    calls = []
    real = attn_mod.attn_decode_sharded

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(attn_mod, "attn_decode_sharded", spy)
    prompt = torch.tensor([[5, 6, 7]])
    for max_len, want_calls in ((30, 0), (32, cfg.n_layers)):
        calls.clear()
        _, cache = M.prefill(params, cfg, {"tokens": prompt}, max_len=max_len)
        _, plain_cache = M.prefill(params, cfg, {"tokens": prompt}, max_len=max_len)
        got, _ = M.decode_step(params, cfg, cache, prompt[:, -1], mesh_info=_mesh(4))
        want, _ = M.decode_step(params, dataclasses.replace(cfg, sharded_decode_attn=False),
                                plain_cache, prompt[:, -1])
        assert len(calls) == want_calls
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)


def test_sharded_engine_serves_the_agent_loop(bridged, monkeypatch):
    """A sharded engine serves the speculative agent loop, speculation
    admitting slots, every decode step through the sharded attention, and
    its decisions match an unsharded engine's."""
    _, cfg, _, params = bridged
    calls = []
    real = attn_mod.attn_decode_sharded

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(attn_mod, "attn_decode_sharded", spy)
    pe = PatternEngine(context_len=2, min_support=3).fit(
        episodes_to_traces(make_episodes(WorkloadConfig(seed=1, n_episodes=40))))
    episodes = make_episodes(WorkloadConfig(seed=9, n_episodes=2))
    results = []
    for sharded in (False, True):
        c = dataclasses.replace(cfg, sharded_decode_attn=sharded)
        eng = ServingEngine(c, params, max_batch=4, max_len=64, device="cpu",
                            mesh_info=_mesh(4) if sharded else None)
        calls.clear()
        _, steps, hits, spec = serve_agent_loop(True, c, eng, episodes, pe)
        assert len(calls) == (cfg.n_layers * eng.steps_executed if sharded else 0)
        results.append((steps, eng.steps_executed, spec.admitted, spec.promotions, hits))
    assert results[1][2] > 0
    assert results[0] == results[1]
