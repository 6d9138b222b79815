"""Meshes for the port: the counterpart of ``repro.launch.mesh``.

The JAX package lays a mesh over devices, and one process drives them all
(``shard_map``). The port has two kinds of mesh:

* :class:`LocalMesh` (:func:`make_local_mesh`): the single controller kept
  on one card. Its ``model`` axis is a set of shards held by this process
  on one device. The sequence-sharded decode
  (``models.attention.attn_decode_sharded``) gives each shard a view of its
  sequence range of the cache, launches the partials kernel once per shard
  and combines their softmax partials on that device.
* :class:`DistMesh` (:func:`make_dist_mesh`): a mesh of processes over
  ``torch.distributed``. Each rank is one point of the mesh and holds its
  own block of every sharded tensor; every collective of a ``shard_map``
  body over a mesh axis becomes a collective over that axis's process group
  (:meth:`DistMesh.psum`, :meth:`~DistMesh.pmax`, :meth:`~DistMesh.pmean`,
  :meth:`~DistMesh.all_gather`). Ranks are laid out over the axes
  row-major, as the JAX package lays devices out: on a (data, model) mesh
  of shape (nb, nm), rank ``d * nm + m`` sits at (d, m). ``launch.dist.spawn``
  starts such ranks on one host.

The backend is the process group's: gloo on the CPU and for ranks that
share one card, NCCL where each rank has a card of its own. How a CUDA
tensor travels through a collective is fixed per (backend, op) in
:data:`HOST_STAGED`: a pair listed there copies the tensor to the host
before the collective and back after it, in :meth:`DistMesh._collective`
alone, and the mesh counts those copies (``counts["staged_copies"]``).
No pair is listed: gloo takes CUDA tensors of every dtype the port reduces
(bfloat16, float32, int8, int64) in ``all_reduce`` (sum and max) and
``all_gather``, and so does NCCL. gloo moves them through host memory
itself. The card tests hold every op not listed to that (so a PyTorch
whose gloo refuses one fails there and names the pair to add).

:func:`make_production_mesh` builds the JAX package's production meshes,
(16, 16) ``("data", "model")`` and (2, 16, 16) ``("pod", "data", "model")``,
as a ``torch.distributed.device_mesh.DeviceMesh`` over a fake process group
(:func:`make_fake_mesh`): 256 or 512 ranks in one process, seen from rank 0,
with no card and no communication. ``launch.dryrun`` lays DTensors out on
it. :func:`mesh_axes`, :func:`mesh_counts` and :func:`axis_sizes` read all
of these meshes.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


@dataclass(frozen=True)
class LocalMesh:
    """A (data, model) mesh of shards held by one process on one device."""
    shape: Dict[str, int]
    device: torch.device
    axis_names: Tuple[str, ...] = field(default=("data", "model"))


def make_local_mesh(model_parallel: int = 1, device="cuda") -> LocalMesh:
    """A mesh of ``model_parallel`` sequence shards on ``device``."""
    if model_parallel < 1:
        raise ValueError(f"model_parallel must be >= 1, got {model_parallel}")
    return LocalMesh(shape={"data": 1, "model": model_parallel}, device=torch.device(device))


# (backend, op) pairs whose CUDA tensors this module copies to the host and
# back around the collective; see the module's docstring
HOST_STAGED: frozenset = frozenset()

Axes = Union[str, Tuple[str, ...]]


@dataclass
class DistMesh:
    """This rank's view of a mesh of processes: the mesh's ``shape`` and
    ``axis_names``, this rank's ``coords`` on each axis, its ``device``, the
    process group of each axis (and of the batch axes together, and of the
    whole mesh) that holds this rank, and ``counts`` of the collectives run
    and of the host copies staged for them."""
    shape: Dict[str, int]
    axis_names: Tuple[str, ...]
    device: torch.device
    rank: int                           # in the default group
    coords: Dict[str, int]
    groups: Dict[Tuple[str, ...], object]
    backend: str
    counts: Dict[str, int] = field(default_factory=lambda: {"collectives": 0,
                                                            "staged_copies": 0})

    @staticmethod
    def _axes(axis: Axes) -> Tuple[str, ...]:
        return (axis,) if isinstance(axis, str) else tuple(axis)

    def axis_size(self, axis: Axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axis))

    def axis_index(self, axis: Axes) -> int:
        """This rank's index along ``axis`` (several axes: row-major over them)."""
        i = 0
        for a in self._axes(axis):
            i = i * self.shape[a] + self.coords[a]
        return i

    def _collective(self, op: str, t: torch.Tensor, axis: Axes, run) -> torch.Tensor:
        """``run(buffer, group)`` on a fresh contiguous copy of ``t``, over
        the group of ``axis``; the result on ``t``'s device. An axis of size
        1 runs nothing and returns ``t``'s copy."""
        axes = self._axes(axis)
        if self.axis_size(axes) == 1:
            return run(t.clone(), None)
        staged = t.is_cuda and (self.backend, op) in HOST_STAGED
        buf = (t.to("cpu", copy=True) if staged
               else t.clone(memory_format=torch.contiguous_format))
        self.counts["collectives"] += 1
        out = run(buf, self.groups[axes])
        if staged:
            self.counts["staged_copies"] += 2
            out = out.to(t.device)
        return out

    def psum(self, t: torch.Tensor, axis: Axes) -> torch.Tensor:
        """The sum of ``t`` over ``axis`` (``jax.lax.psum``), a new tensor."""
        def run(buf, group):
            if group is not None:
                dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
            return buf
        return self._collective("all_reduce", t, axis, run)

    def pmax(self, t: torch.Tensor, axis: Axes) -> torch.Tensor:
        """The elementwise maximum of ``t`` over ``axis`` (``jax.lax.pmax``)."""
        def run(buf, group):
            if group is not None:
                dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group)
            return buf
        return self._collective("all_reduce", t, axis, run)

    def pmean(self, t: torch.Tensor, axis: Axes) -> torch.Tensor:
        """The mean of ``t`` over ``axis`` (``jax.lax.pmean``): the sum, divided."""
        return self.psum(t, axis) / self.axis_size(axis)

    def all_gather(self, t: torch.Tensor, axis: Axes) -> torch.Tensor:
        """Every rank's ``t`` along ``axis``, stacked on a new leading axis in
        axis-index order (``jax.lax.all_gather``)."""
        def run(buf, group):
            if group is None:
                return buf[None]
            parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, buf, group=group)
            return torch.stack(parts)
        return self._collective("all_gather", t, axis, run)

    def barrier(self) -> None:
        """Wait for every rank of the mesh."""
        group = self.groups.get(self.axis_names)
        if group is not None:
            dist.barrier(group=group)


def make_dist_mesh(model_parallel: int = 1, *, pod: int = 1,
                   ranks: Optional[Sequence[int]] = None, device=None) -> Optional[DistMesh]:
    """A mesh over ``ranks`` of the initialised default group (all of them
    if None): axes (data, model), or (pod, data, model) with ``pod > 1``, of
    shape (n // model_parallel, model_parallel), or (pod, n // (pod *
    model_parallel), model_parallel), n = len(ranks), as
    ``repro.launch.mesh.make_local_mesh`` shapes devices. Every rank of the
    default group calls this with the same arguments, in the same order
    as its other ``new_group`` calls (each axis's groups are created
    collectively); a rank outside ``ranks`` gets None. ``device=None`` is
    ``cuda:{rank % torch.cuda.device_count()}``: every rank shares
    ``cuda:0`` on a machine with one card. The CPU only when asked for."""
    if not dist.is_initialized():
        raise RuntimeError("make_dist_mesh needs an initialised torch.distributed default "
                           "group (launch.dist.spawn, or torchrun)")
    members = list(range(dist.get_world_size())) if ranks is None else sorted(ranks)
    n, me = len(members), dist.get_rank()
    if model_parallel < 1 or pod < 1 or n % (pod * model_parallel):
        raise ValueError(f"{n} ranks do not make a mesh of pod {pod} x model "
                         f"{model_parallel}")
    shape = {"data": n // (pod * model_parallel), "model": model_parallel}
    if pod > 1:
        shape = {"pod": pod, **shape}
    names = tuple(shape)
    sizes = [shape[a] for a in names]
    points = list(itertools.product(*(range(s) for s in sizes)))   # row-major, as ranks
    batch_axes = names[:-1]
    groups: Dict[Tuple[str, ...], object] = {}
    made = set()
    for axes in [(a,) for a in names] + [batch_axes, names]:
        if axes in made or math.prod(shape[a] for a in axes) == 1:
            continue
        made.add(axes)
        rest = [i for i, a in enumerate(names) if a not in axes]
        lines: Dict[tuple, list] = {}
        for pos, point in enumerate(points):
            lines.setdefault(tuple(point[i] for i in rest), []).append(members[pos])
        for line in lines.values():     # every rank creates every line, in one order
            group = dist.new_group(line)
            if me in line:
                groups[axes] = group
    if me not in members:
        return None
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to put the mesh on the CPU")
        device = f"cuda:{me % torch.cuda.device_count()}"
    point = points[members.index(me)]
    return DistMesh(shape=shape, axis_names=names, device=torch.device(device), rank=me,
                    coords=dict(zip(names, point, strict=True)), groups=groups,
                    backend=dist.get_backend())


def on_ranks(mesh_info) -> bool:
    """Whether ``mesh_info`` (a ``models.model.MeshContext`` or None)
    describes a mesh of processes."""
    return mesh_info is not None and isinstance(mesh_info.mesh, DistMesh)


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.psum(g, ctx.axis), None, None


class _Reduced(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, mean):
        return mesh.pmean(x, axis) if mean else mesh.psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def sum_grads_over(x: torch.Tensor, mesh: DistMesh, axis: Axes) -> torch.Tensor:
    """``x`` unchanged; in the backward pass its gradient is summed over
    ``axis``. For a value every rank of the axis holds whole (replicated)
    that feeds a computation each rank does only its part of: the parts'
    gradients add up to the whole one on every rank."""
    return _SumGrads.apply(x, mesh, axis)


def reduced_over(x: torch.Tensor, mesh: DistMesh, axis: Axes, *, mean: bool = False
                 ) -> torch.Tensor:
    """``mesh.psum`` (or ``pmean``) of ``x`` over ``axis``, whose gradient
    passes to every rank's ``x`` unchanged: the counterpart of
    :func:`sum_grads_over` at the end of a computation split over the axis,
    whose result every rank then uses whole."""
    return _Reduced.apply(x, mesh, axis, mean)


# the JAX package's production meshes: (shape, axis names) by multi_pod
PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}
FAKE_WORLD = 512   # ranks of the fake default group: the largest production mesh


def make_fake_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> DeviceMesh:
    """A ``DeviceMesh`` of the first prod(shape) ranks, laid out row-major
    over ``axis_names``, on a fake process group, as rank 0 sees it.

    The first call initialises the default process group with the "fake"
    backend (``torch.testing._internal.distributed.fake_pg`` registers it)
    and ``max(FAKE_WORLD, prod(shape))`` ranks. That is a one-way step for
    the process: it cannot take another default group afterwards, so run
    this in a process of its own (the dry-run's CLI, or a subprocess). The
    fake group's collectives move nothing and return their output buffers
    as allocated; on meta tensors they only carry shapes."""
    n = math.prod(shape)
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=max(FAKE_WORLD, n))
    elif dist.get_backend() != "fake":
        raise RuntimeError(f"the default process group runs {dist.get_backend()!r}; a fake "
                           "mesh needs a process whose default group is fake")
    if n > dist.get_world_size():
        raise ValueError(f"a mesh of {n} ranks exceeds the fake world of "
                         f"{dist.get_world_size()}")
    return DeviceMesh("cuda", torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The 256-rank (16, 16) mesh, or with ``multi_pod`` the 512-rank
    (2, 16, 16) one, over a fake process group (:func:`make_fake_mesh`,
    which initialises the default group on first use)."""
    return make_fake_mesh(*PRODUCTION_MESHES[multi_pod])


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a mesh: a ``DeviceMesh`` (its ``mesh_dim_names``
    and ``shape``), or any mesh with ``axis_names`` and a ``shape`` mapping
    (LocalMesh, DistMesh, a JAX mesh)."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape, strict=True))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], str]:
    """(batch_axes, model_axis) for a production-style mesh."""
    names = tuple(axis_sizes(mesh))
    if "pod" in names:
        return ("pod", "data"), "model"
    return ("data",), "model"


def mesh_counts(mesh) -> Tuple[int, int]:
    """(n_batch, n_model)."""
    batch_axes, model_axis = mesh_axes(mesh)
    sizes = axis_sizes(mesh)
    nb = 1
    for a in batch_axes:
        nb *= sizes[a]
    return nb, sizes[model_axis]
