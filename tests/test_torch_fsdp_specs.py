"""The port's FSDP layouts (``launch.shardings.fsdp_param_specs``,
``fsdp_batch_axes``, ``fsdp_batch_specs``) against the JAX package's, for
every arch on the production meshes and a (4, 2) mesh, and their own
property: at most one sharded dim a leaf, and only a dim that the product
of all mesh axes divides. Then ``to_placements``: a spec as DTensor
placements, several axes on one dim numbered as a PartitionSpec numbers
them."""
import math

import pytest

torch = pytest.importorskip("torch")
from jax.sharding import PartitionSpec  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402
from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.launch import shardings as jsh  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch import input_specs  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402


class _StandIn:
    """What both packages' spec functions read of a mesh."""

    def __init__(self, shape):
        self.shape = dict(shape)

    @property
    def axis_names(self):
        return tuple(self.shape)


MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 4, "model": 2}]


def _as_tuples(tree):
    if isinstance(tree, (PartitionSpec, sh.Spec)):
        return ("spec",) + tuple(tree)
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    return tuple(_as_tuples(v) for v in tree)


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s.values())))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_fsdp_specs_equal_jax(arch, shape):
    mesh = _StandIn(shape)
    cfg, jcfg = ARCHS[arch], JAX_ARCHS[arch]
    assert _as_tuples(sh.fsdp_param_specs(cfg, mesh)) == _as_tuples(
        jsh.fsdp_param_specs(jcfg, mesh))
    for batch in (1, 3, 8, 16, 32, 128, 256, 512, 1024):
        assert sh.fsdp_batch_axes(mesh, batch) == jsh.fsdp_batch_axes(mesh, batch)
        assert _as_tuples(sh.fsdp_batch_specs(cfg, mesh, "train", batch)) == _as_tuples(
            jsh.fsdp_batch_specs(jcfg, mesh, "train", batch))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s.values())))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_fsdp_specs_shard_one_divisible_dim(arch, shape):
    """Every leaf: at most one sharded dim, over all the mesh's axes, on a
    dim their product divides; a block leaf's spec has its layer entry and
    leaves it whole."""
    mesh = _StandIn(shape)
    cfg = ARCHS[arch]
    n_all = math.prod(shape.values())
    specs = sh.fsdp_param_specs(cfg, mesh)
    structs = input_specs.param_structs(cfg)
    resolved = sh.specs_by_path(structs, specs)
    for path, leaf in _leaves(structs):
        spec = resolved[path]
        assert len(spec) == leaf.dim()
        sharded = [i for i, a in enumerate(spec) if a is not None]
        assert len(sharded) <= 1
        for i in sharded:
            assert spec[i] == tuple(shape)
            assert leaf.shape[i] % n_all == 0 and leaf.shape[i] >= n_all
    for spec in _spec_leaves(specs["blocks"]):
        assert spec[0] is None            # the layer entry, never sharded


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, prefix + (i,))]
    return [(prefix, tree)]


def _spec_leaves(tree):
    if isinstance(tree, sh.Spec):
        return [tree]
    return [x for v in tree.values() for x in _spec_leaves(v)]


def test_to_placements():
    mesh = _StandIn({"pod": 2, "data": 4, "model": 3})
    assert sh.to_placements(sh.P(), mesh) == (Replicate(),) * 3
    assert sh.to_placements(sh.P(("pod", "data"), None), mesh) == (Shard(0), Shard(0),
                                                                    Replicate())
    assert sh.to_placements(sh.P(None, "model", "pod"), mesh) == (Shard(2), Replicate(),
                                                                  Shard(1))
    assert sh.to_placements(sh.P(("pod", "data", "model")), mesh) == (Shard(0),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        sh.to_placements(sh.P(("model", "data")), mesh)


@pytest.mark.parametrize("axes", [("pod", "data"), ("data", "model"), ("pod", "data", "model"),
                                  ("pod", "model")])
def test_several_shards_of_one_dim_number_pieces_row_major(axes):
    """DTensor splits a dim sharded on several mesh dims in mesh-dim order:
    the rank at coordinates c holds piece number row-major(c) over those
    mesh dims, the first the slowest, as a PartitionSpec tuple numbers the
    devices of its axes. Checked for every rank of a (2, 4, 3) mesh with
    DTensor's own offset arithmetic."""
    sizes = {"pod": 2, "data": 4, "model": 3}
    mesh = _StandIn(sizes)
    n = math.prod(sizes[a] for a in axes)
    rows = 5 * n
    placements = sh.to_placements(sh.P(axes, None), mesh)
    for coord in [(p, d, m) for p in range(2) for d in range(4) for m in range(3)]:
        at = dict(zip(sizes, coord, strict=True))
        piece = 0
        for a in axes:
            piece = piece * sizes[a] + at[a]
        local, offset = _compute_local_shape_and_global_offset(
            (rows, 7), tuple(sizes.values()), list(coord), placements)
        assert local == (rows // n, 7)
        assert offset == (piece * (rows // n), 0)
        assert sh.local_shape((rows, 7), placements, mesh) == local


def test_shard_bytes_and_local_shape_round_up():
    mesh = _StandIn({"data": 4, "model": 3})
    spec = sh.P("data", "model")
    assert sh.shard_bytes((10, 7), torch.bfloat16, spec, mesh) == 3 * 3 * 2
    assert sh.local_shape((10, 7), sh.to_placements(spec, mesh), mesh) == (3, 3)
    tree = {"a": torch.empty((8, 6), device="meta"), "b": [torch.empty((5,), device="meta")]}
    specs = {"a": sh.P(None, "model"), "b": [sh.P("data")]}
    assert sh.tree_device_bytes(tree, specs, mesh) == 8 * 2 * 4 + 2 * 4
