"""Subprocess bodies of the dry-run tests. Each sets up what must not touch
the pytest worker (the fake default process group of the port's dry-run,
or XLA's forced host-device count of the JAX package's), runs its cells and
prints one JSON object as its last line.

  python tests/torch_dryrun_cells.py port '<json cells>'
  python tests/torch_dryrun_cells.py jax_bytes '<json cells>'
  python tests/torch_dryrun_cells.py jax_flops '<json cell>'

A port cell is {"arch", "reduced", "kind", "seq", "batch", "mesh": [sizes],
"names": [axes], "overrides", "fsdp", "zero_opt", "unsharded"}; its record
is run_cell's, with the collectives kept and the traceback dropped, and
with "unsharded": the same step's FLOPs on one device.
"""
import json
import os
import sys


def _shape(cell):
    from repro_torch.configs.base import SHAPES_BY_NAME, ShapeConfig

    if "shape" in cell:
        return SHAPES_BY_NAME[cell["shape"]]
    return ShapeConfig(f"{cell['kind']}_{cell['batch']}x{cell['seq']}", cell["kind"],
                       cell["seq"], cell["batch"])


def port(cells):
    import torch

    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_fake_mesh

    out = []
    meshes = {}
    for cell in cells:
        key = (tuple(cell["mesh"]), tuple(cell["names"]))
        if key not in meshes:
            meshes[key] = make_fake_mesh(*key)
        cfg = get_config(cell["arch"])
        if cell.get("reduced", True):
            cfg = cfg.reduced()
        shape = _shape(cell)
        rec = dryrun.run_cell(cfg, shape, "x".join(map(str, key[0])), None,
                              overrides=cell.get("overrides"), fsdp=cell.get("fsdp", False),
                              zero_opt=cell.get("zero_opt", False), mesh=meshes[key])
        if cell.get("unsharded"):
            rec["unsharded_flops"] = dryrun.count_unsharded(
                cfg, shape, overrides=cell.get("overrides"))["counter"].flops
        out.append(rec)
    return out


def jax_bytes(cells):
    """JAX's build_cell meta (its per-device bytes) of each production cell."""
    import repro.launch.dryrun as jdry  # sets XLA_FLAGS to 512 host devices first

    out = []
    meshes = {}
    for cell in cells:
        multi = cell["mesh"] == "multi"
        if multi not in meshes:
            meshes[multi] = jdry.make_production_mesh(multi_pod=multi)
        overrides = cell.get("overrides") or None
        _, _, meta = jdry.build_cell(cell["arch"], cell["shape"], meshes[multi],
                                     zero_opt=cell.get("zero_opt", False),
                                     overrides=overrides, fsdp=cell.get("fsdp", False))
        out.append({k: v for k, v in meta.items() if k.endswith("_per_device")})
    return out


def jax_flops(cell):
    """The JAX package's per-device HLO FLOPs (launch.hlo.analyze) of one
    train step, compiled on host devices with the port's specs' twins."""
    n = 1
    for d in cell["mesh"]:
        n *= d
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
    import functools

    import jax

    from repro import compat
    from repro.configs import get_config
    from repro.configs.base import ShapeConfig
    from repro.launch import hlo
    from repro.launch import shardings as jsh
    from repro.launch.input_specs import input_specs, opt_structs, param_structs
    from repro.launch.mesh import mesh_axes, mesh_counts
    from repro.models.model import MeshContext
    from repro.training import optimizer as opt_mod
    from repro.training import steps

    cfg = get_config(cell["arch"])
    if cell.get("reduced", True):
        cfg = cfg.reduced()
    shape = ShapeConfig("t", "train", cell["seq"], cell["batch"])
    mesh = compat.make_mesh(tuple(cell["mesh"]), tuple(cell["names"]))
    ba, ma = mesh_axes(mesh)
    nb, nm = mesh_counts(mesh)
    mi = MeshContext(mesh, ba, ma, nm, nb)
    ns = functools.partial(jsh.to_named, mesh=mesh)
    pspecs, ospecs = jsh.param_specs(cfg, mesh), jsh.opt_specs(cfg, mesh)
    bspecs = jsh.batch_specs(cfg, mesh, "train")
    fn = functools.partial(steps.train_step, cfg=cfg, opt_cfg=opt_mod.AdamWConfig(), mesh_info=mi)
    jitted = jax.jit(fn, in_shardings=(ns(pspecs), ns(ospecs), ns(bspecs)),
                     out_shardings=(ns(pspecs), ns(ospecs), None))
    args = (param_structs(cfg), opt_structs(cfg), input_specs(cfg, shape)["batch"])
    stats = hlo.analyze(jitted.lower(*args).compile().as_text())
    return {"flops": stats["flops"], "collectives": stats["collectives"]}


if __name__ == "__main__":
    what, arg = sys.argv[1], json.loads(sys.argv[2])
    print(json.dumps({"port": port, "jax_bytes": jax_bytes, "jax_flops": jax_flops}[what](arg),
                     default=str))
