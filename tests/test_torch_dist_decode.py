"""The sequence-sharded decode over a mesh of processes (gloo ranks on the
CPU) against the JAX package's ``shard_map`` decode and the port's own
single-process paths.

Reduced qwen2-7b at float32, one set of weights for both packages (the JAX
params with random non-zero QKV biases, bridged through numpy). Each rank
holds its (B_local, Smax / n_model, KV, hd) slice of every cache and
launches the partials kernel's plain version once a layer; pmax and psum
of the partials run over the model axis's process group. On meshes of
(1, 2), (1, 4) and (2, 2) ranks (the last with the batch of 2 sharded
over the data axis), each rank's logits are held:

* at 1e-4 against JAX's ``attn_decode_sharded`` (``shard_map`` on a mesh
  of the same model width over 4 host devices, in a subprocess with its own
  XLA device count, as tests/test_perf_features.py runs it), and with the
  int8 cache on log-softmax at 2e-2;
* at 1e-4 against the port's LocalMesh path (one process, the shards as
  views of one cache) and its unsharded decode.

Also: an inactive row keeps its cache on every rank; each rank's new row
lands only on the rank whose slice holds its slot; a sharded engine
serves the speculative agent loop on every rank in lockstep, each rank's
summary and tokens the same as a single-process engine's.
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

import torch_dist_bodies as bodies  # noqa: E402
from repro_torch.core.patterns import PatternEngine  # noqa: E402
from repro_torch.core.workload import (  # noqa: E402
    WorkloadConfig, episodes_to_traces, make_episodes,
)
from repro_torch.launch.dist import spawn  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.launch.serve import serve_agent_loop  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

TOL = 1e-4
INT8_TOL = 2e-2
MAX_LEN = 32
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"1x2": (2, 2), "1x4": (4, 4), "2x2": (4, 2)}   # name: (world, model_parallel)
ACTIVE = np.array([True, False])

JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, jax, jax.numpy as jnp, numpy as np
    from repro import compat
    from repro.configs import get_config
    from repro.models import model as M
    from repro.models.model import MeshContext
    cfg = dataclasses.replace(get_config("qwen2-7b").reduced(), dtype="float32")
    params = jax.tree.map(np.asarray, M.init_params(jax.random.key(3), cfg))
    rng = np.random.default_rng(3)
    for name in ("bq", "bk", "bv"):
        a = params["blocks"]["attn"][name]
        params["blocks"]["attn"][name] = (0.1 * rng.normal(size=a.shape)).astype(a.dtype)
    prompt = rng.integers(0, cfg.vocab_size, size=(2, 11)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, size=(3, 2)).astype(np.int32)
    out = {"prompt": prompt, "feed": feed}
    for path, a in jax.tree_util.tree_flatten_with_path(params)[0]:
        out["param/" + "/".join(p.key for p in path)] = a
    jp = jax.tree.map(jnp.asarray, params)
    for kv in ("float32", "int8"):
        for n_model in (2, 4):
            mesh = compat.make_mesh((4 // n_model, n_model), ("data", "model"))
            mi = MeshContext(mesh, ("data",), "model", n_model, 4 // n_model)
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
    """JAX's shard_map decode in a subprocess; its .npz."""
    path = tmp_path_factory.mktemp("jax_dist_decode") / "out.npz"
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(path)], capture_output=True,
                       text=True, env=env, timeout=300, cwd=ROOT)
    assert "JAX_SHARDED_OK" in r.stdout, r.stderr[-3000:]
    return np.load(path)


@pytest.fixture(scope="module")
def inputs(jax_sharded):
    return _unflatten(jax_sharded), jax_sharded["prompt"].astype(np.int64), \
        jax_sharded["feed"].astype(np.int64)


@pytest.fixture(scope="module")
def ranks(inputs):
    np_params, prompt, feed = inputs
    return {name: spawn(bodies.decode_suite, world, device="cpu", model_parallel=mp,
                        args=(np_params, prompt, feed, ACTIVE))
            for name, (world, mp) in MESHES.items()}


def _cfg(**kw):
    return bodies.config("qwen2-7b", sharded_decode_attn=True, **kw)


def _single(np_params, prompt, feed, kw, n_model):
    """The port's single-process logits: (LocalMesh of n_model shards, unsharded)."""
    out = []
    for mesh_info in (M.mesh_context(make_local_mesh(n_model, device="cpu")), None):
        cfg = _cfg(**kw)
        params = M.params_from_numpy(np_params, cfg, device="cpu")
        _, cache = M.prefill(params, cfg, {"tokens": torch.from_numpy(prompt)}, max_len=MAX_LEN)
        steps = []
        for tok in feed:
            lg, cache = M.decode_step(params, cfg, cache, torch.from_numpy(tok),
                                      mesh_info=mesh_info)
            steps.append(lg.numpy())
        out.append(np.stack(steps))
    return out


def _log_softmax(x):
    return np.asarray(jax.nn.log_softmax(jnp.asarray(x), axis=-1))


@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("name", list(MESHES))
def test_dist_decode_matches_jax_shard_map(ranks, jax_sharded, name, kv):
    world, mp = MESHES[name]
    want = np.stack([jax_sharded[f"logits/{kv}/{mp}/{i}"] for i in range(3)])
    for res in ranks[name]:
        out = res[kv]
        a, b = out["rows"]
        assert (b - a) == (1 if world // mp == 2 else 2)       # the batch sharded over data
        if kv == "int8":
            np.testing.assert_allclose(_log_softmax(out["logits"]), _log_softmax(want[:, a:b]),
                                       atol=INT8_TOL, rtol=0)
        else:
            np.testing.assert_allclose(out["logits"], want[:, a:b], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("name", list(MESHES))
def test_dist_decode_matches_the_single_process_paths(ranks, inputs, name, kv):
    world, mp = MESHES[name]
    np_params, prompt, feed = inputs
    local, plain = _single(np_params, prompt, feed, {"kv_cache_dtype": kv}, mp)
    for res in ranks[name]:
        out = res[kv]
        a, b = out["rows"]
        np.testing.assert_allclose(out["logits"], local[:, a:b], atol=TOL, rtol=TOL)
        np.testing.assert_allclose(out["logits"], plain[:, a:b], atol=TOL, rtol=TOL)
        # this rank holds its slice of the cache: (L, B_local, Smax / n_model, KV, hd)
        assert out["after"][0].shape[1:3] == (b - a, MAX_LEN // mp)
        # 3 collectives a layer (pmax of m, psum of l and of acc) a step
        cfg = _cfg()
        assert out["counts"]["collectives"] == 3 * cfg.n_layers * len(feed)
        assert out["counts"]["staged_copies"] == 0


@pytest.mark.parametrize("name", list(MESHES))
def test_dist_decode_keeps_inactive_rows(ranks, name):
    """A 5-token prompt, 16 rows: slot 5 lies in the second slice of 8 (2
    ranks a model axis) or of 4 (4 ranks). The inactive row keeps its cache
    on every rank; the active row's new row lands on the rank that holds
    slot 5 and nowhere else."""
    world, mp = MESHES[name]
    chunk = 16 // mp
    for res in ranks[name]:
        out = res["inactive"]
        a, b = out["rows"]
        model = res["inactive"]["coords"]["model"]
        act = ACTIVE[a:b]
        assert out["lengths"].tolist() == [6 if x else 5 for x in act]
        for before, after in zip(out["before"], out["after"], strict=True):
            for row, is_active in enumerate(act):
                holds = model * chunk <= 5 < (model + 1) * chunk
                if is_active and holds:
                    loc = 5 - model * chunk
                    assert not np.array_equal(after[:, row, loc], before[:, row, loc])
                    keep = np.ones(chunk, bool)
                    keep[loc] = False
                    np.testing.assert_array_equal(after[:, row, keep], before[:, row, keep])
                else:
                    np.testing.assert_array_equal(after[:, row], before[:, row])


@pytest.fixture(scope="module")
def single_engine(inputs):
    np_params = inputs[0]
    cfg = bodies.config("qwen2-7b")
    params = M.params_from_numpy(np_params, cfg, device="cpu")
    pe = PatternEngine(context_len=2, min_support=3).fit(
        episodes_to_traces(make_episodes(WorkloadConfig(seed=1, n_episodes=40))))
    eng = ServingEngine(cfg, params, max_batch=4, max_len=64, device="cpu")
    _, steps, hits, spec = serve_agent_loop(True, cfg, eng,
                                            make_episodes(WorkloadConfig(seed=9, n_episodes=2)),
                                            pe)
    return (steps, eng.steps_executed, spec.admitted, spec.promotions, hits), \
        [list(s.tokens) for s in eng.slots]


@pytest.mark.parametrize("name", list(MESHES))
def test_dist_engine_serves_the_agent_loop_in_lockstep(ranks, single_engine, name):
    world, mp = MESHES[name]
    summary, tokens = single_engine
    cfg = _cfg()
    assert summary[2] > 0                       # speculation admitted slots
    for res in ranks[name]:
        out = res["serve"]
        assert tuple(out["summary"]) == summary
        assert out["tokens"] == tokens
        rows = 4 // (world // mp)
        assert out["cache_k"] == (cfg.n_layers, rows, 64 // mp, cfg.n_kv_heads,
                                  cfg.resolved_head_dim)
        # every engine step combines partials once a layer on every rank (the
        # plain partials on the CPU launch no kernel), and gathers the logits
        # over the data axis where the batch is sharded
        assert out["partials_launches"] == 0
        assert out["counts"] == {"collectives": (3 * cfg.n_layers + (world > mp))
                                 * summary[1], "staged_copies": 0}


def test_indivisible_cache_is_refused_on_ranks():
    """Under a DistMesh a rank's slice cannot say which layout it is in, so
    a cache whose rows do not divide over the model axis is refused (a
    LocalMesh takes the plain decode there, tests/test_torch_sharded_decode.py)."""
    from repro_torch.launch.mesh import DistMesh
    from repro_torch.models import attention as attn_mod
    mesh = DistMesh(shape={"data": 1, "model": 4}, axis_names=("data", "model"),
                    device=torch.device("cpu"), rank=0, coords={"data": 0, "model": 0},
                    groups={}, backend="gloo")           # no group: nothing here communicates
    mi = M.mesh_context(mesh)
    with pytest.raises(ValueError, match="multiple of 4"):
        attn_mod.seq_sharded(_cfg(), mi, 30)
    assert attn_mod.seq_sharded(_cfg(), mi, 32)
    assert not attn_mod.seq_sharded(dataclasses.replace(_cfg(), sharded_decode_attn=False), mi,
                                    32)
