"""Dry-run of every (arch × shape × mesh) cell on the production meshes: the
port of ``repro.launch.dryrun``, with no card.

The JAX package jits each cell's step on 512 fake host devices, lowers and
compiles it, and reads the FLOPs and the collectives out of the post-SPMD
HLO. Here each cell's params, optimizer state, batch and cache are meta
DTensors laid out by ``launch.shardings``' specs on a production
``DeviceMesh`` (16 × 16, or 2 × 16 × 16) over a fake process group
(``launch.mesh.make_production_mesh``): 256 or 512 ranks in one process,
seen from rank 0. The step (``training.steps.train_step``,
``prefill_step`` or ``serve_step``) runs once on them, with the
``MeshContext`` of that mesh. DTensor propagates the layouts, as GSPMD
does; where it refuses a layout change that GSPMD makes silently, the
models reshard explicitly (``models.model``'s docstring lists where).
Nothing is allocated and nothing is communicated: meta tensors carry
shapes, and the fake group's collectives carry nothing.

:class:`RankCounter` watches rank 0's local program while it runs: the
FLOPs of every product its local blocks run (mm, bmm, baddbmm, addmm,
convolution: what einsum and matmul come down to; the formulas of
``torch.utils.flop_counter``), and every collective, with its op, group
size, count and bytes. It takes the place of the HLO analysis of
``launch/hlo.py``, which has no twin: there is no compiled HLO in
PyTorch. ``compat.py`` has no twin either: it only wraps JAX APIs.
``FlopCounterMode`` alone would count DTensor ops at their global shapes.

What the counts include, against the card's kernels: the kernels cannot
run on meta tensors, so attention and the SSD scan run their plain
PyTorch versions (``attn_impl`` "auto" picks on a meta tensor what
``kernels.ops`` picks for any tensor off the card: "plain"), and the
record names the impl it counted. The plain flash attention computes
every 128-key block of the scores, those above the causal diagonal
(masked) or outside a window too, where the CUDA kernel skips a block that
no query of its tile sees: at S = 4096 the causal forward counts about
twice the kernel's score and value products. The plain decode attends over
the whole cache, to its last row, where the kernels stop at each
sequence's length. The plain SSD computes each chunk's quadratic part in
full, as the kernel does. Elementwise work (norms, softmax, the optimizer)
is not counted, as the JAX package counts only dots. ``attn_impl="ref"``
(the materialized oracle) counts the same attention FLOPs as "plain" with
far fewer ops to trace, for a long prefill.

Per-device bytes come from the specs, with the JAX package's arithmetic
(``launch.shardings.tree_device_bytes``), and the memory term from
``launch.roofline.traffic_model``, as in JAX. ``memory_analysis`` holds
rank 0's argument and output bytes; the trace has no allocator, so no
temp peak is measured.

Hardware: one NVIDIA H100 SXM5, from NVIDIA's "H100 Tensor Core GPU"
datasheet: 989.4 TFLOPS dense bf16 (the 1,979 figure assumes 2:4
sparsity), 3.35 TB/s HBM3, NVLink 900 GB/s in total, 450 GB/s each way.
The collective term is the bytes rank 0 sends over 450 GB/s: it assumes
every group talks over NVLink, where a 16-wide model axis spans two 8-GPU
nodes, and does not model the InfiniBand hop between them.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape decode_32k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time
import traceback
from collections.abc import Mapping
from typing import Any, Dict, Optional, Union

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, SHAPES_BY_NAME, cell_supported, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import roofline as roofline_mod
from repro_torch.launch import shardings as sh
from repro_torch.launch.input_specs import cache_structs, input_specs, opt_structs, param_structs
from repro_torch.launch.mesh import axis_sizes, make_production_mesh, mesh_counts
from repro_torch.models.model import mesh_context
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import steps

# NVIDIA H100 SXM5, per GPU (NVIDIA "H100 Tensor Core GPU" datasheet)
PEAK_FLOPS = 989.4e12     # bf16 dense tensor-core FLOP/s (1,979e12 is with sparsity)
HBM_BW = 3.35e12          # HBM3 bytes/s
NVLINK_BW = 450e9         # NVLink 4 bytes/s each way (900e9 both ways together)

OUT_DIR = "dryrun_out"    # the CLI's default --out-dir, listed in .gitignore

# bytes a rank sends in a ring implementation, as a multiple of the op's
# input (in) or output (out) bytes, by group size n
_SENT = {
    "all_reduce": ("in", lambda n: 2.0 * (n - 1) / n),
    "all_gather_into_tensor": ("out", lambda n: (n - 1) / n),
    "reduce_scatter_tensor": ("in", lambda n: (n - 1) / n),
    "all_to_all_single": ("in", lambda n: (n - 1) / n),
    "shard_dim_alltoall": ("in", lambda n: (n - 1) / n),
    "broadcast": ("in", lambda n: 1.0),
}


def _group_size(args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    group = [a for a in args if isinstance(a, (str, torch.distributed.ProcessGroup))][-1]
    return (_resolve_process_group(group) if isinstance(group, str) else group).size()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class RankCounter(TorchDispatchMode):
    """Counts the local program of this rank while it runs on DTensors (or
    on plain tensors, where it counts the whole program).

    A DTensor op is let through (``NotImplemented``): DTensor runs it,
    redistributing its arguments with collectives where their layouts ask
    for it, and runs the op on the local blocks, and those local ops come
    back here. ``flops`` sums ``torch.utils.flop_counter``'s formula of
    every product among them (``flops_by_op`` by op); ``collectives`` holds,
    for each collective op and group size, its count, ``bytes`` (the larger
    of its input and output, the JAX package's rule) and ``sent_bytes``
    (what this rank sends in a ring: 2 (n-1)/n of an all-reduce's input,
    (n-1)/n of an all-gather's output, of a reduce-scatter's or an
    all-to-all's input). Ops run on fake tensors, which DTensor uses to
    propagate global shapes, are not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.flops_by_op: Dict[str, int] = {}
        self.collectives: Dict[str, Dict[str, float]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        name = packet.__name__
        if packet in flop_registry:
            if not _on_fake(args):
                n = int(flop_registry[packet](*args, **kwargs, out_val=out))
                self.flops += n
                self.flops_by_op[name] = self.flops_by_op.get(name, 0) + n
        elif name in _SENT and func.namespace in ("_c10d_functional", "_dtensor", "c10d"):
            self._collective(name, args, out)
        return out

    def _collective(self, name, args, out) -> None:
        n = _group_size(args)
        size = {"in": _nbytes(args[0]), "out": _nbytes(out)}
        which, share = _SENT[name]
        rec = self.collectives.setdefault(f"{name}/{n}", {
            "op": name, "group": n, "count": 0, "bytes": 0.0, "sent_bytes": 0.0})
        rec["count"] += 1
        rec["bytes"] += max(size.values())
        rec["sent_bytes"] += size[which] * share(n)

    @property
    def collective_bytes(self) -> float:
        return sum(c["sent_bytes"] for c in self.collectives.values())


def _on_fake(args) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return any(isinstance(a, FakeTensor) for a in args)


def _local_bytes(tree) -> int:
    """Rank 0's bytes of the tensors of a tree: a DTensor's local block."""
    if isinstance(tree, DTensor):
        return _nbytes(tree.to_local())
    if isinstance(tree, torch.Tensor):
        return _nbytes(tree)
    if isinstance(tree, Mapping):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    return 0


def resolve_cell(arch: Union[str, ModelConfig], shape: Union[str, ShapeConfig],
                 overrides: Optional[Dict[str, Any]] = None):
    """(cfg, shape) of a cell named or given, with ``overrides`` applied;
    an unsupported cell raises ValueError."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES_BY_NAME[shape] if isinstance(shape, str) else shape
    ok, why = cell_supported(cfg, shape)
    if not ok:
        raise ValueError(f"unsupported cell: {why}")
    return cfg, shape


# the step's positional arguments by kind, named as in cell_structs
STEP_ARGS = {"train": ("params", "opt", "batch"), "prefill": ("params", "batch"),
             "decode": ("params", "cache", "tokens")}


def cell_structs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The cell's meta trees by name: "params", then "opt" and "batch" for
    train, "batch" and "cache" (the cache it makes) for prefill, "cache"
    and "tokens" for decode."""
    out = {"params": param_structs(cfg)}
    if shape.kind == "train":
        out["opt"] = opt_structs(cfg)
    if shape.kind == "decode":
        out.update(input_specs(cfg, shape))
    else:
        out["batch"] = input_specs(cfg, shape)["batch"]
    if shape.kind == "prefill":
        out["cache"] = cache_structs(cfg, shape.global_batch, shape.seq_len)
    return out


def cell_layout(cfg: ModelConfig, shape: ShapeConfig, mesh, *, zero_opt: bool = False,
                fsdp: bool = False) -> Dict[str, Any]:
    """:func:`cell_structs` with their specs on ``mesh``, {name: (tree,
    specs)}, as the JAX package's build_cell lays them out. Works on any
    mesh with axis names and sizes."""
    structs = cell_structs(cfg, shape)
    pspecs = sh.fsdp_param_specs(cfg, mesh) if fsdp else sh.param_specs(cfg, mesh)
    specs = {"params": pspecs}
    if shape.kind == "train":
        if fsdp:
            specs["opt"] = {"m": pspecs, "v": pspecs, "step": sh.P()}
            specs["batch"] = sh.fsdp_batch_specs(cfg, mesh, "train", shape.global_batch)
        else:
            specs["opt"] = sh.opt_specs(cfg, mesh, zero=zero_opt)
            specs["batch"] = sh.batch_specs(cfg, mesh, "train")
    else:
        specs["cache"] = sh.cache_specs(cfg, mesh, shape.global_batch, shape.seq_len)
        if shape.kind == "prefill":
            specs["batch"] = sh.batch_specs(cfg, mesh, "prefill")
        else:
            specs["tokens"] = specs["cache"]["lengths"]
    return {k: (structs[k], specs[k]) for k in structs}


def layout_bytes(layout: Dict[str, Any], mesh) -> Dict[str, int]:
    """The per-device bytes of a :func:`cell_layout` under the keys of the
    JAX package's record: params, state (params and optimizer state), the
    batch (train) and the cache (prefill's and decode's), with the JAX
    package's arithmetic."""
    nbytes = {k: sh.tree_device_bytes(tree, specs, mesh) for k, (tree, specs) in layout.items()}
    out = {"param_bytes_per_device": nbytes["params"],
           "state_bytes_per_device": nbytes["params"] + nbytes.get("opt", 0)}
    if "opt" in layout:
        out["batch_bytes_per_device"] = nbytes["batch"]
    if "cache" in layout:
        out["cache_bytes_per_device"] = nbytes["cache"]
    return out


def step_fn(cfg: ModelConfig, shape: ShapeConfig, mesh_info=None):
    """The cell's step: ``train_step`` (AdamW's defaults), ``prefill_step``
    to the shape's length, or ``serve_step``."""
    if shape.kind == "train":
        return functools.partial(steps.train_step, cfg=cfg, opt_cfg=opt_mod.AdamWConfig(),
                                 mesh_info=mesh_info)
    if shape.kind == "prefill":
        return functools.partial(steps.prefill_step, cfg=cfg, max_len=shape.seq_len,
                                 mesh_info=mesh_info)
    return functools.partial(steps.serve_step, cfg=cfg, mesh_info=mesh_info)


def build_cell(arch: Union[str, ModelConfig], shape: Union[str, ShapeConfig], mesh, *,
               zero_opt: bool = False, extra: Optional[Dict[str, Any]] = None,
               overrides: Optional[Dict[str, Any]] = None, fsdp: bool = False):
    """Returns (step_fn, args tuple of meta DTensors, meta) for one cell on
    the ``DeviceMesh`` ``mesh``. ``arch`` is a name or a ModelConfig,
    ``shape`` a name or a ShapeConfig."""
    cfg, shape = resolve_cell(arch, shape, overrides)
    layout = cell_layout(cfg, shape, mesh, zero_opt=zero_opt, fsdp=fsdp)
    meta: Dict[str, Any] = {"arch": cfg.name, "shape": shape.name, "kind": shape.kind}
    meta.update(layout_bytes(layout, mesh))
    if extra:
        meta.update(extra)

    def dist(name):
        tree, specs = layout[name]
        if isinstance(specs, sh.Spec):
            return sh.distribute_leaf(tree, specs, mesh)
        return sh.distribute_tree(tree, specs, mesh)

    args = tuple(dist(name) for name in STEP_ARGS[shape.kind])
    return step_fn(cfg, shape, mesh_context(mesh)), args, meta


def count_step(fn, args) -> Dict[str, Any]:
    """Runs ``fn(*args)`` once under a :class:`RankCounter` (with plain
    tensors among DTensors taken as replicated, as the JAX package's
    constants are): {"counter", "out", "trace_s"}."""
    from torch.distributed.tensor.experimental import implicit_replication

    t0 = time.time()
    with implicit_replication(), RankCounter() as counter:
        out = fn(*args)
    return {"counter": counter, "out": out, "trace_s": time.time() - t0}


def count_unsharded(arch: Union[str, ModelConfig], shape: Union[str, ShapeConfig], *,
                    overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The cell's step on one device: plain meta tensors, no mesh, counted
    by :func:`count_step` ({"counter", "out", "trace_s"}, plus "cfg",
    "shape", "state_bytes": params and optimizer state, "traffic": the
    traffic model, "terms": the compute and memory terms of the whole step
    on one H100)."""
    cfg, shape = resolve_cell(arch, shape, overrides)
    structs = cell_structs(cfg, shape)
    res = count_step(step_fn(cfg, shape), tuple(structs[n] for n in STEP_ARGS[shape.kind]))
    traffic = roofline_mod.traffic_model(cfg, shape, 1, 1, _local_bytes(structs["params"]),
                                         _local_bytes(structs.get("cache")))
    res.update(cfg=cfg, shape=shape, traffic=traffic,
               state_bytes=_local_bytes(structs["params"]) + _local_bytes(structs.get("opt")),
               terms={"compute": res["counter"].flops / PEAK_FLOPS,
                      "memory": traffic["total"] / HBM_BW})
    return res


def counted_impls(cfg: ModelConfig) -> Dict[str, str]:
    """The attention and SSD impls the count goes through on meta tensors:
    what ``kernels.ops`` resolves for a tensor off the card."""
    impl = {"auto": "plain", "pallas": "kernel", "ref": "ref"}[cfg.attn_impl]
    out = {}
    if not cfg.is_attention_free:
        out["attn_impl"] = impl
    if cfg.family in ("ssm", "hybrid"):
        out["ssd_impl"] = impl
    return out


def model_flops(cfg, shape) -> float:
    """Analytic 'useful' FLOPs for the cell (6·N·D train, 2·N·B decode)."""
    n_active = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def run_cell(arch: Union[str, ModelConfig], shape_name: Union[str, ShapeConfig],
             mesh_kind: str, out_dir: Optional[str], zero_opt: bool = False,
             overrides: Optional[Dict[str, Any]] = None, variant: str = "",
             fsdp: bool = False, mesh=None) -> Dict[str, Any]:
    """Builds, runs and counts one cell on the production mesh of
    ``mesh_kind`` ("single" or "multi"), or on ``mesh`` where given (named
    ``mesh_kind`` in the record); writes its record to ``out_dir`` if given.
    A failure is recorded with ``status: "error"`` and its exception."""
    t0 = time.time()
    record: Dict[str, Any] = {
        "arch": arch if isinstance(arch, str) else arch.name,
        "shape": shape_name if isinstance(shape_name, str) else shape_name.name,
        "mesh": mesh_kind, "variant": variant,
    }
    try:
        if mesh is None:
            mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
        n_dev = mesh.size()
        record["devices"] = n_dev
        record["mesh_shape"] = axis_sizes(mesh)
        fn, args, meta = build_cell(arch, shape_name, mesh, zero_opt=zero_opt,
                                    overrides=overrides, fsdp=fsdp)
        cfg, shape = resolve_cell(arch, shape_name, overrides)
        res = count_step(fn, args)
        counter = res["counter"]
        mf = model_flops(cfg, shape)
        perdev_flops = counter.flops
        record.update(meta)
        nb, nm = mesh_counts(mesh)
        traffic = roofline_mod.traffic_model(
            cfg, shape, nb, nm,
            meta.get("param_bytes_per_device", 0),
            meta.get("cache_bytes_per_device", 0),
        )
        record.update(
            status="ok",
            trace_s=round(res["trace_s"], 2),
            build_s=round(time.time() - t0 - res["trace_s"], 2),
            **counted_impls(cfg),
            memory_analysis={
                "argument_bytes": _local_bytes(args),
                "output_bytes": _local_bytes(res["out"]),
            },
            flops_per_device=perdev_flops,
            flops_by_op=counter.flops_by_op,
            analytic_bytes_per_device=traffic["total"],
            traffic_breakdown={k: v for k, v in traffic.items() if k != "total"},
            collective_bytes_per_device=counter.collective_bytes,
            collectives=counter.collectives,
            model_flops=mf,
            compute_term_s=perdev_flops / PEAK_FLOPS,
            memory_term_s=traffic["total"] / HBM_BW,
            collective_term_s=counter.collective_bytes / NVLINK_BW,
            useful_flops_ratio=(mf / (perdev_flops * n_dev)) if perdev_flops else 0.0,
        )
        terms = {
            "compute": record["compute_term_s"],
            "memory": record["memory_term_s"],
            "collective": record["collective_term_s"],
        }
        record["bottleneck"] = max(terms, key=terms.get)
        record["roofline_fraction"] = (
            max(terms.values()) and record["compute_term_s"] / max(terms.values())
        )
    except Exception as e:
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"__{variant}" if variant else ""
        path = os.path.join(out_dir, f"{record['arch']}__{record['shape']}__{mesh_kind}{tag}.json")
        with open(path, "w") as f:
            json.dump(record, f, indent=2, default=str)
    return record


def iter_cells():
    for arch, cfg in ARCHS.items():
        for shape_name, shape in SHAPES_BY_NAME.items():
            ok, why = cell_supported(cfg, shape)
            yield arch, shape_name, ok, why


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--zero-opt", action="store_true")
    ap.add_argument("--head-pad", type=int, default=0)
    ap.add_argument("--sharded-decode", action="store_true")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--variant", default="")
    args = ap.parse_args(argv)
    overrides = {}
    if args.head_pad:
        overrides["head_pad_multiple"] = args.head_pad
    if args.sharded_decode:
        overrides["sharded_decode_attn"] = True
    if args.fsdp:
        overrides["fsdp_act_constraint"] = True
    if args.kv_int8:
        overrides["kv_cache_dtype"] = "int8"
    if args.no_remat:
        overrides["remat"] = False
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    cells = []
    if args.all:
        for arch, shape_name, ok, why in iter_cells():
            if ok:
                cells.append((arch, shape_name))
            else:
                print(f"SKIP {arch} {shape_name}: {why}")
    else:
        cells.append((args.arch, args.shape))

    failed = 0
    for arch, shape_name in cells:
        for mk in meshes:
            rec = run_cell(arch, shape_name, mk, args.out_dir, zero_opt=args.zero_opt,
                           overrides=overrides, variant=args.variant, fsdp=args.fsdp)
            if rec["status"] == "ok":
                print(
                    f"OK {arch} {shape_name} {mk}: trace={rec['trace_s']}s "
                    f"compute={rec['compute_term_s']:.3f}s mem={rec['memory_term_s']:.3f}s "
                    f"coll={rec['collective_term_s']:.3f}s bottleneck={rec['bottleneck']}",
                    flush=True,
                )
            else:
                failed += 1
                print(f"FAIL {arch} {shape_name} {mk}: {rec['error']}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
