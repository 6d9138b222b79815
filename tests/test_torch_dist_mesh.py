"""The port's mesh of processes (``launch.mesh.DistMesh``, ``launch.dist``)
and its partition specs (``launch.shardings``), on gloo ranks on the CPU.

* psum / pmax / pmean / all_gather / axis_index over each axis of (1, 2),
  (2, 2) and (4, 1) meshes against numpy, in f32 and bf16 (all_gather in
  int8 too), with the collectives counted and none staged through the host;
* ``param_specs``, ``opt_specs`` (``zero`` or not), ``batch_specs`` and
  ``cache_specs`` equal to the JAX package's for every arch of
  ``configs.ARCHS`` on (data, model) and (pod, data, model) meshes (the JAX
  functions read only ``mesh.axis_names`` and ``mesh.shape``, so a plain
  stand-in with those two serves), a hybrid's int8 K/V as pairs of that
  spec (``_hybrid_int8_pairs``);
* ``shard_tree`` then ``gather_tree`` is the identity on every arch's
  params and ZeRO-sharded AdamW state, and the blocks have the shapes the
  specs give;
* a rank that raises fails the spawn.

Each mesh is one spawn of its ranks (``torch_dist_bodies``), shared by
the tests that read it.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from jax.sharding import PartitionSpec  # noqa: E402

import torch_dist_bodies as bodies  # noqa: E402
from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.launch import shardings as jsh  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.launch.dist import spawn  # noqa: E402
from repro_torch.launch.mesh import HOST_STAGED  # noqa: E402

MESHES = {"1x2": (2, 2), "2x2": (4, 2), "4x1": (4, 1)}   # name: (world, model_parallel)


@pytest.fixture(scope="module")
def ranks():
    return {name: spawn(bodies.mesh_suite, world, device="cpu", model_parallel=mp)
            for name, (world, mp) in MESHES.items()}


def _values(world):
    return [np.arange(6, dtype=np.float32).reshape(2, 3) + 10.0 * r for r in range(world)]


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("axis", ["data", "model", "data+model"])
@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
def test_collectives_match_numpy(ranks, name, axis, dtype):
    world, mp = MESHES[name]
    vals = _values(world)
    for rank, res in enumerate(ranks[name]):
        out = res["collectives"]
        d, m = divmod(rank, mp)
        assert out["coords"] == {"data": d, "model": m}
        group = {"data": [g * mp + m for g in range(world // mp)],
                 "model": [d * mp + j for j in range(mp)],
                 "data+model": list(range(world))}[axis]
        assert out["index"][axis] == group.index(rank)
        parts = np.stack([vals[r] for r in group])
        if dtype == "torch.bfloat16":   # the inputs are exact in bf16; sums of up to 4 round
            parts = torch.from_numpy(parts).bfloat16().float().numpy()
        tol = 0 if dtype == "torch.float32" else 2e-2
        np.testing.assert_allclose(out[f"psum/{axis}/{dtype}"], parts.sum(0), rtol=tol)
        np.testing.assert_array_equal(out[f"pmax/{axis}/{dtype}"], parts.max(0))
        np.testing.assert_allclose(out[f"pmean/{axis}/{dtype}"], parts.mean(0), rtol=tol)
        np.testing.assert_array_equal(out[f"all_gather/{axis}/{dtype}"], parts)
        np.testing.assert_array_equal(out[f"all_gather/{axis}/int8"],
                                      np.stack([vals[r].astype(np.int8) for r in group]))


@pytest.mark.parametrize("name", list(MESHES))
def test_collectives_are_counted_and_none_staged(ranks, name):
    world, mp = MESHES[name]
    runs = {"data": world // mp > 1, "model": mp > 1, "data+model": True}
    per_axis = 2 * 4 + 1                  # psum, pmax, pmean, all_gather x 2 dtypes, int8
    for res in ranks[name]:
        counts = res["collectives"]["counts"]
        assert counts == {"collectives": per_axis * sum(runs.values()), "staged_copies": 0}
    assert HOST_STAGED == frozenset()


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_shard_then_gather_is_the_identity(ranks, name, arch):
    world, mp = MESHES[name]
    cfg = ARCHS[arch].reduced()
    mesh = _StandIn({"data": world // mp, "model": mp})
    specs = {"params": sh.param_specs(cfg, mesh), "opt": sh.opt_specs(cfg, mesh, zero=True)}
    for rank, res in enumerate(ranks[name]):
        out = res["roundtrip"][arch]
        assert out["same"]
        # the embedding's rows and the first layer's K projection, per their specs
        rows = cfg.padded_vocab // (mp if specs["params"]["embed"][0] else 1)
        assert out["shapes"]["params/embed"][0] == rows
        wk = specs["params"]["blocks"].get("attn", {}).get("wk")
        if wk is not None:
            cols = cfg.eff_n_kv_heads * cfg.resolved_head_dim // (mp if wk[2] else 1)
            assert out["shapes"]["params/blocks/0/attn/wk"] == (cfg.d_model, cols)


def test_a_failing_rank_fails_the_spawn():
    with pytest.raises(Exception, match="rank 1 fails"):
        spawn(bodies.fail_on_rank_one, 2, device="cpu")


@dataclasses.dataclass
class _StandIn:
    """What the JAX package's spec functions read of a mesh."""
    shape: dict

    @property
    def axis_names(self):
        return tuple(self.shape)


SPEC_MESHES = [{"data": 2, "model": 2}, {"data": 16, "model": 16}, {"data": 4, "model": 3},
               {"pod": 2, "data": 16, "model": 16}]


def _as_tuples(tree):
    """A tree of PartitionSpecs or Specs with each spec as a plain tuple."""
    if isinstance(tree, (PartitionSpec, sh.Spec)):
        return ("spec",) + tuple(tree)
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    return tuple(_as_tuples(v) for v in tree)


@pytest.mark.parametrize("shape", SPEC_MESHES, ids=lambda s: "x".join(map(str, s.values())))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_specs_equal_jax(arch, shape):
    mesh = _StandIn(shape)
    cfg, jcfg = ARCHS[arch], JAX_ARCHS[arch]
    for full in (False, True):        # the real widths and the reduced config
        c, jc = (cfg, jcfg) if full else (cfg.reduced(), jcfg.reduced())
        assert _as_tuples(sh.param_specs(c, mesh)) == _as_tuples(jsh.param_specs(jc, mesh))
        for zero in (False, True):
            assert (_as_tuples(sh.opt_specs(c, mesh, zero=zero))
                    == _as_tuples(jsh.opt_specs(jc, mesh, zero=zero)))
        for kind in ("train", "prefill"):
            assert (_as_tuples(sh.batch_specs(c, mesh, kind))
                    == _as_tuples(jsh.batch_specs(jc, mesh, kind)))
        for batch, max_len in ((4, 192), (1, 4096), (32, 100)):
            for kv in ("bfloat16", "int8"):
                ck = dataclasses.replace(c, kv_cache_dtype=kv)
                jk = dataclasses.replace(jc, kv_cache_dtype=kv)
                want = _as_tuples(jsh.cache_specs(jk, mesh, batch, max_len))
                if c.family == "hybrid" and kv == "int8":
                    want = _hybrid_int8_pairs(want)
                assert _as_tuples(sh.cache_specs(ck, mesh, batch, max_len)) == want


def _hybrid_int8_pairs(specs):
    """The JAX package's hybrid cache specs hold one spec for each of K and
    V, that of its ``init_cache``'s plain cfg.dtype arrays, also with an int8
    cache; the port's cache takes the layout of the JAX hybrid prefill's
    int8 (values, scales) pairs, laid out alike: the values as the plain
    array, the scales without its head_dim entry."""
    return dict(specs, **{name: (specs[name], specs[name][:-1]) for name in ("k", "v")})


def _sharded_paths(specs, prefix=""):
    if isinstance(specs, sh.Spec):
        return [prefix] if any(a is not None for a in specs) else []
    return [p for k, v in specs.items() for p in _sharded_paths(v, f"{prefix}/{k}")]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_rank_param_specs_shard_only_the_experts(arch):
    """A rank of a DistMesh holds every leaf whole but an MoE block's
    experts, as param_specs shards those."""
    cfg = ARCHS[arch]
    for shape in ({"data": 2, "model": 2}, {"data": 1, "model": 3}):
        mesh = _StandIn(shape)
        specs = sh.rank_param_specs(cfg, mesh)
        moe = specs["blocks"].pop("moe", None)
        assert _sharded_paths(specs) == []
        if cfg.family == "moe":
            assert moe == sh.param_specs(cfg, mesh)["blocks"]["moe"]


def test_dist_mesh_needs_an_initialised_group():
    from repro_torch.launch.mesh import make_dist_mesh
    with pytest.raises(RuntimeError, match="initialised"):
        make_dist_mesh()
