"""Partition specs for params / optimizer state / batches / caches: the port
of ``repro.launch.shardings``, and the blocks they give each rank of a
``launch.mesh.DistMesh``.

A spec is a :class:`Spec`, a tuple with one entry per dim of its leaf:
``None`` (not sharded), a mesh axis name, or a tuple of axis names (the
dim sharded over their product, row-major), as a ``jax.sharding.PartitionSpec``
holds them. :func:`param_specs`, :func:`opt_specs`, :func:`batch_specs` and
:func:`cache_specs` build the same trees as the JAX package's functions of
those names, from the same layout rules (DESIGN.md §7): batch dims over
("pod", "data") or ("data",), tensor parallelism over "model" (attention
heads, MLP d_ff, the vocab, SSM heads, MoE experts or expert d_ff), a dim
sharded only when it divides exactly (``_maybe``), caches' kv-heads over
"model" where they divide, else their sequence axis.

The specs keep the JAX package's stacked layout: a block leaf's spec has a
leading entry for the layer axis. The port keeps one dict per layer in
``params["blocks"]``; :func:`specs_for` gives each layer's leaf its spec
without that entry, and :func:`shard_tree` / :func:`gather_tree` go
through it. The FSDP layouts (:func:`fsdp_param_specs`,
:func:`fsdp_batch_axes`, :func:`fsdp_batch_specs`) follow the JAX package's
rules: every leaf over all mesh axes on the last dim their product divides,
never dim 0 of a leaf of two or more dims; block leaves are judged by their
stacked shape.

``to_named`` becomes :func:`to_placements`: a spec as DTensor placements on
a ``DeviceMesh`` (the production meshes of ``launch.mesh``), and
:func:`distribute_tree` lays a tree of meta tensors out as DTensors by
its specs, for the dry-run (``launch.dryrun``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import axis_sizes, mesh_axes, mesh_counts
from repro_torch.tree import leaves_with_paths


class Spec(tuple):
    """A partition spec: one entry per dim (None, an axis name, or a tuple
    of axis names; a tuple of one name is that name, as a PartitionSpec
    keeps it). A tuple subclass, so that a tree walk can tell a spec from a
    tuple of specs."""

    def __new__(cls, *parts):
        parts = (p[0] if isinstance(p, (tuple, list)) and len(p) == 1
                 else tuple(p) if isinstance(p, list) else p for p in parts)
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


P = Spec


def _maybe(axis, dim: int, n: int):
    return axis if (n > 1 and dim % n == 0 and dim >= n) else None


def attn_specs(cfg: ModelConfig, model_axis: str, nm: int, stacked: bool) -> Dict[str, Any]:
    H, KV, hd = cfg.eff_n_heads, cfg.eff_n_kv_heads, cfg.resolved_head_dim
    m_q = _maybe(model_axis, H * hd, nm)
    m_kv = _maybe(model_axis, KV * hd, nm)
    L = (None,) if stacked else ()
    s = {
        "wq": P(*L, None, m_q),
        "wk": P(*L, None, m_kv),
        "wv": P(*L, None, m_kv),
        "wo": P(*L, m_q, None),
    }
    if cfg.qkv_bias:
        s["bq"] = P(*L, m_q)
        s["bk"] = P(*L, m_kv)
        s["bv"] = P(*L, m_kv)
    return s


def ssm_specs(cfg: ModelConfig, model_axis: str, nm: int) -> Dict[str, Any]:
    ss = cfg.ssm
    di = ss.d_inner(cfg.d_model)
    nh = ss.n_heads(cfg.d_model)
    m_di = _maybe(model_axis, di, nm)
    m_nh = _maybe(model_axis, nh, nm)
    return {
        "w_z": P(None, None, m_di),
        "w_x": P(None, None, m_di),
        "w_B": P(None, None, None),
        "w_C": P(None, None, None),
        "w_dt": P(None, None, m_nh),
        "conv_x_w": P(None, None, m_di),
        "conv_x_b": P(None, m_di),
        "conv_B_w": P(None, None, None),
        "conv_B_b": P(None, None),
        "conv_C_w": P(None, None, None),
        "conv_C_b": P(None, None),
        "A_log": P(None, m_nh),
        "D": P(None, m_nh),
        "dt_bias": P(None, m_nh),
        "norm_w": P(None, m_di),
        "out_proj": P(None, m_di, None),
    }


def param_specs(cfg: ModelConfig, mesh) -> Dict[str, Any]:
    _, model_axis = mesh_axes(mesh)
    _, nm = mesh_counts(mesh)
    Vp, F = cfg.padded_vocab, cfg.d_ff
    m_v = _maybe(model_axis, Vp, nm)
    specs: Dict[str, Any] = {
        "embed": P(m_v, None),
        "final_norm": P(None),
        "lm_head": P(None, m_v),
    }
    if cfg.frontend != "tokens":
        specs["frontend_proj"] = P(None, None)

    if cfg.family in ("dense", "vlm", "audio", "moe"):
        blocks: Dict[str, Any] = {
            "ln1": P(None, None),
            "ln2": P(None, None),
            "attn": attn_specs(cfg, model_axis, nm, stacked=True),
        }
        if cfg.family == "moe":
            E, Fe = cfg.moe.n_experts, cfg.moe.d_ff_expert
            if E % nm == 0:
                blocks["moe"] = {
                    "router": P(None, None, None),
                    "w_gate": P(None, model_axis, None, None),
                    "w_up": P(None, model_axis, None, None),
                    "w_down": P(None, model_axis, None, None),
                }
            else:
                m_f = _maybe(model_axis, Fe, nm)
                blocks["moe"] = {
                    "router": P(None, None, None),
                    "w_gate": P(None, None, None, m_f),
                    "w_up": P(None, None, None, m_f),
                    "w_down": P(None, None, m_f, None),
                }
        else:
            m_f = _maybe(model_axis, F, nm)
            blocks["mlp"] = {
                "w_gate": P(None, None, m_f),
                "w_up": P(None, None, m_f),
                "w_down": P(None, m_f, None),
            }
        specs["blocks"] = blocks
    elif cfg.family == "ssm":
        specs["blocks"] = {"ln": P(None, None), "ssm": ssm_specs(cfg, model_axis, nm)}
    elif cfg.family == "hybrid":
        specs["blocks"] = {"ln": P(None, None), "ssm": ssm_specs(cfg, model_axis, nm)}
        specs["shared_attn"] = {
            "ln": P(None),
            "attn": attn_specs(cfg, model_axis, nm, stacked=False),
        }
    return specs


def rank_param_specs(cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """The blocks of the params that a rank of a ``launch.mesh.DistMesh``
    holds: an MoE block's experts (or their d_ff) as :func:`param_specs`
    shards them, every other leaf whole. The port runs attention, the MLP,
    the SSM layers and the embeddings whole on every rank of the model
    axis; the JAX package leaves their sharding to the compiler, with no
    collective of its own, so the results are the same."""
    specs = param_specs(cfg, mesh)
    whole = _spec_map(lambda s: P(*([None] * len(s))), specs)
    if cfg.family == "moe":
        whole["blocks"]["moe"] = specs["blocks"]["moe"]
    return whole


def _spec_map(fn, specs):
    if isinstance(specs, Spec):
        return fn(specs)
    if isinstance(specs, Mapping):
        return {k: _spec_map(fn, v) for k, v in specs.items()}
    return type(specs)(_spec_map(fn, v) for v in specs)


def opt_specs(cfg: ModelConfig, mesh, *, zero: bool = False) -> Dict[str, Any]:
    """AdamW state specs.  zero=True also shards m/v over the batch axes on
    the first unsharded dim after the leading one (ZeRO-1-style)."""
    pspecs = param_specs(cfg, mesh)
    if not zero:
        mv = pspecs
    else:
        batch_axes, _ = mesh_axes(mesh)

        def zero_one(spec: Spec) -> Spec:
            # the leading (layer) dim stays; the batch axes go on the first
            # None dim after it. Divisibility is checked where it is used
            parts = list(spec)
            for i, p in enumerate(parts):
                if i == 0:
                    continue
                if p is None:
                    parts[i] = batch_axes
                    break
            return P(*parts)

        mv = _spec_map(zero_one, pspecs)
    return {"m": mv, "v": mv, "step": P()}


def batch_specs(cfg: ModelConfig, mesh, kind: str) -> Dict[str, Any]:
    batch_axes, _ = mesh_axes(mesh)
    ba = batch_axes if len(batch_axes) > 1 else batch_axes[0]
    if kind == "train":
        if cfg.frontend == "tokens":
            return {"tokens": P(ba, None), "labels": P(ba, None)}
        return {"embeds": P(ba, None, None), "labels": P(ba, None)}
    if kind == "prefill":
        if cfg.frontend == "tokens":
            return {"tokens": P(ba, None)}
        return {"embeds": P(ba, None, None)}
    raise ValueError(kind)


def cache_specs(cfg: ModelConfig, mesh, batch: int, max_len: int) -> Dict[str, Any]:
    from repro_torch.models.model import _kv_smax

    batch_axes, model_axis = mesh_axes(mesh)
    nb, nm = mesh_counts(mesh)
    ba = batch_axes if len(batch_axes) > 1 else batch_axes[0]
    b_ax = ba if (batch % nb == 0 and batch >= nb) else None
    KV = cfg.eff_n_kv_heads
    smax = _kv_smax(cfg, max_len)
    kv_ax, seq_ax = _maybe(model_axis, KV, nm), None
    if kv_ax is None:
        seq_ax = _maybe(model_axis, smax, nm)
    specs: Dict[str, Any] = {"lengths": P(b_ax)}

    def kv(seq_ax, kv_ax):   # an int8 cache: (values, scales) pairs, laid out alike
        if cfg.kv_cache_dtype == "int8":
            return (P(None, b_ax, seq_ax, kv_ax, None), P(None, b_ax, seq_ax, kv_ax))
        return P(None, b_ax, seq_ax, kv_ax, None)

    if cfg.family in ("dense", "vlm", "audio", "moe"):
        specs["k"] = specs["v"] = kv(seq_ax, kv_ax)
    if cfg.family in ("ssm", "hybrid"):
        ss = cfg.ssm
        di = ss.d_inner(cfg.d_model)
        nh = ss.n_heads(cfg.d_model)
        m_di = _maybe(model_axis, di, nm)
        m_nh = _maybe(model_axis, nh, nm)
        specs["ssm_state"] = (
            P(None, b_ax, None, m_di),   # conv_x
            P(None, b_ax, None, None),   # conv_B
            P(None, b_ax, None, None),   # conv_C
            P(None, b_ax, m_nh, None, None),  # ssm
        )
    if cfg.family == "hybrid":
        kv_ax2 = _maybe(model_axis, KV, nm)
        seq_ax2 = None if kv_ax2 is not None else _maybe(model_axis, max_len, nm)
        # pairs with an int8 cache, the layout of the hybrid prefill's cache
        # (the JAX package gives its plain cfg.dtype cache's spec)
        specs["k"] = specs["v"] = kv(seq_ax2, kv_ax2)
    return specs


# ======================================================================
# Blocks of a tree on a DistMesh
# ======================================================================

def specs_for(tree, specs):
    """The spec of every leaf of ``tree``, in ``tree``'s structure. Where
    ``tree`` holds a list of per-layer dicts and ``specs`` one stacked dict
    (``params["blocks"]``), each layer's leaf gets its stacked spec without
    the leading layer entry."""
    if isinstance(specs, Spec):
        return specs
    if isinstance(tree, Mapping):
        return {k: specs_for(v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list) and isinstance(specs, Mapping):
        layer = _spec_map(lambda s: P(*s[1:]), specs)
        return [specs_for(v, layer) for v in tree]
    return type(tree)(specs_for(v, s) for v, s in zip(tree, specs, strict=True))


def specs_by_path(tree, specs) -> Dict[tuple, Spec]:
    """{path: spec} for every leaf of ``tree`` (its path as
    ``tree.leaves_with_paths`` gives it), the specs resolved by
    :func:`specs_for`."""
    resolved = specs_for(tree, specs)
    out = {}
    for path, _ in leaves_with_paths(tree):
        node = resolved
        for key in path:
            node = node[key]
        out[path] = node
    return out


def _walk(fn, tree, specs):
    if isinstance(specs, Spec):
        return fn(tree, specs)
    if isinstance(tree, Mapping):
        return {k: _walk(fn, v, specs[k]) for k, v in tree.items()}
    return type(tree)(_walk(fn, v, s) for v, s in zip(tree, specs, strict=True))


def block_of(leaf, spec: Spec, mesh):
    """This rank's block of one leaf (a tensor or a numpy array): on each
    sharded dim, the mesh index along its axes picks one of as many equal
    pieces as those axes have ranks. A view of the leaf, so that ranks that
    share a tree through CUDA IPC hold its blocks without a second copy;
    a block along the leaf's leading dims is contiguous."""
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        n = mesh.axis_size(axes)
        if leaf.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(leaf.shape)} does not split {n} ways")
        size = leaf.shape[dim] // n
        start = mesh.axis_index(axes) * size
        leaf = leaf[(slice(None),) * dim + (slice(start, start + size),)]
    return leaf


def shard_tree(tree, specs, mesh):
    """This rank's block of every leaf of ``tree`` (:func:`block_of`), the
    specs resolved by :func:`specs_for`."""
    return _walk(lambda leaf, spec: block_of(leaf, spec, mesh), tree, specs_for(tree, specs))


def _gather_leaf(block: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole leaf from every rank's block (the inverse of
    :func:`block_of`): an all-gather over the axes of each sharded dim."""
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        parts = mesh.all_gather(block, axes)          # (n, ...) in mesh-index order
        block = torch.cat(list(parts.unbind(0)), dim=dim)
    return block


def gather_tree(tree, specs, mesh):
    """Every leaf whole on every rank, from this rank's blocks."""
    return _walk(lambda leaf, spec: _gather_leaf(leaf, spec, mesh), tree, specs_for(tree, specs))


# ======================================================================
# FSDP layouts (JAX ``fsdp_param_specs`` / ``fsdp_batch_axes`` /
# ``fsdp_batch_specs``)
# ======================================================================

def fsdp_param_specs(cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """ZeRO-3/FSDP layout: every parameter sharded over ALL mesh axes on the
    last dim their product divides, never dim 0 of a leaf of two or more
    dims (the layer axis of a stacked block leaf, and dim 0 of ``embed``,
    ``lm_head`` and ``frontend_proj`` too, as in the JAX package). Block
    leaves are judged by their stacked shape (n_layers, ...) and keep the
    layer entry, as :func:`param_specs` does."""
    from repro_torch.launch.input_specs import param_structs

    sizes = axis_sizes(mesh)
    axes = tuple(sizes)
    n_all = math.prod(sizes.values())

    def spec_for(shape) -> Spec:
        start = 1 if len(shape) >= 2 else 0
        parts = [None] * len(shape)
        for i in range(len(shape) - 1, start - 1, -1):
            if shape[i] % n_all == 0 and shape[i] >= n_all:
                parts[i] = axes
                break
        return P(*parts)

    def specs_of(tree, lead=()):
        if isinstance(tree, torch.Tensor):
            return spec_for(lead + tuple(tree.shape))
        if isinstance(tree, Mapping):
            return {k: specs_of(v, lead) for k, v in tree.items()}
        return type(tree)(specs_of(v, lead) for v in tree)

    structs = param_structs(cfg)
    specs = {k: specs_of(v) for k, v in structs.items() if k != "blocks"}
    specs["blocks"] = specs_of(structs["blocks"][0], (cfg.n_layers,))
    return specs


def fsdp_batch_axes(mesh, batch: int) -> tuple:
    """Largest suffix of mesh axes whose size product divides the batch
    (multi-pod: batch 256 < 512 ranks -> shard over (data, model) only)."""
    sizes = axis_sizes(mesh)
    axes = tuple(sizes)
    for start in range(len(axes)):
        sub = axes[start:]
        n = math.prod(sizes[a] for a in sub)
        if n and batch % n == 0 and batch >= n:
            return sub
    return axes[-1:]


def fsdp_batch_specs(cfg: ModelConfig, mesh, kind: str, batch: int) -> Dict[str, Any]:
    axes = fsdp_batch_axes(mesh, batch)
    if kind == "train":
        if cfg.frontend == "tokens":
            return {"tokens": P(axes, None), "labels": P(axes, None)}
        return {"embeds": P(axes, None, None), "labels": P(axes, None)}
    raise ValueError(kind)


# ======================================================================
# DTensor layouts on a DeviceMesh
# ======================================================================

def to_placements(spec: Spec, mesh) -> Tuple:
    """The DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``
    (the twin of the JAX package's ``to_named``): one placement per mesh
    dim, ``Shard(d)`` where tensor dim d's entry names that mesh dim's axis,
    else ``Replicate()``.

    A dim sharded over several axes (a tuple) becomes ``Shard(d)`` on each
    of their mesh dims. DTensor splits a dim sharded on several mesh dims in
    mesh-dim order: the piece a rank holds is numbered row-major over its
    coordinates on those mesh dims, the first the slowest. That is the
    order of a PartitionSpec's tuple when it lists its axes in the mesh's
    order, as every spec of this module does; a tuple in another order
    raises ValueError (DTensor's plain Shard cannot express it)."""
    names = tuple(axis_sizes(mesh))
    placements = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        where = [names.index(a) for a in axes]
        if where != sorted(where):
            raise ValueError(f"axes {axes} of dim {dim} are not in the mesh's order {names}")
        for i in where:
            placements[i] = Shard(dim)
    return tuple(placements)


def local_shape(shape, placements, mesh) -> Tuple[int, ...]:
    """The shape of rank 0's block of a tensor of ``shape`` under
    ``placements``: each ``Shard(d)``, in mesh-dim order, keeps the first of
    as many pieces as its mesh dim has ranks, ceil(size / n) rows (DTensor's
    ``torch.chunk`` split)."""
    out = list(shape)
    for n, pl in zip(tuple(axis_sizes(mesh).values()), placements, strict=True):
        if isinstance(pl, Shard):
            out[pl.dim] = -(-out[pl.dim] // n)
    return tuple(out)


def distribute_leaf(leaf: torch.Tensor, spec: Spec, mesh) -> DTensor:
    """A meta DTensor of ``leaf``'s global shape and dtype laid out by
    ``spec`` on ``mesh``, rank 0's block of it local. Nothing is allocated
    and nothing is communicated."""
    placements = to_placements(spec, mesh)
    local = torch.empty(local_shape(leaf.shape, placements, mesh), dtype=leaf.dtype,
                        device="meta")
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=leaf.shape,
                              stride=torch.empty(leaf.shape, device="meta").stride())


def distribute_tree(tree, specs, mesh):
    """:func:`distribute_leaf` of every leaf of a tree of meta tensors, the
    specs resolved by :func:`specs_for` (per-layer blocks take their stacked
    spec without the layer entry)."""
    return _walk(lambda leaf, spec: distribute_leaf(leaf, spec, mesh), tree,
                 specs_for(tree, specs))


def shard_bytes(shape, dtype: torch.dtype, spec: Spec, mesh) -> int:
    """Per-device bytes of one array under ``spec`` (the JAX package's
    ``_shard_bytes``): ceil(dim / parts) on each sharded dim."""
    sizes = axis_sizes(mesh)
    n = dtype.itemsize
    for i, d in enumerate(shape):
        parts = 1
        if i < len(spec) and spec[i] is not None:
            axes = spec[i] if isinstance(spec[i], tuple) else (spec[i],)
            for a in axes:
                parts *= sizes[a]
        n *= math.ceil(d / parts)
    return n


def tree_device_bytes(tree, specs, mesh) -> int:
    """Per-device bytes of a tree of tensors (meta ones included) under its
    specs (the JAX package's ``tree_device_bytes``)."""
    total = [0]

    def acc(leaf, spec):
        total[0] += shard_bytes(tuple(leaf.shape), leaf.dtype, spec, mesh)

    _walk(acc, tree, specs_for(tree, specs))
    return total[0]
