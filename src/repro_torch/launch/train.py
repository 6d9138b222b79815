"""Training driver: data pipeline -> train_step -> checkpoint, with
fault tolerance (resume from the latest checkpoint, async checkpointing,
a step-time watchdog for stragglers). The port of ``repro/launch/train.py``.

Usage (the full-width model on the card, or a reduced one on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch musicgen-medium \\
      --steps 5 --seq-len 128 --global-batch 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b \\
      --steps 3 --seq-len 512 --global-batch 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b --reduced \\
      --device cpu --steps 50 --ckpt-dir /tmp/ckpt --ckpt-every 20

Every family trains on the card: attention runs the hand-written forward
and backward kernels (``kernels.flash_attention.FlashAttentionFn``), and
the Mamba2 layers of the SSM and hybrid families the SSD scan's
(``kernels.ssd_scan.SsdScanFn``).

``--use-mesh`` (``use_mesh=True``) trains data parallel over a mesh of
processes: every rank of the ``torch.distributed`` default group (already
initialised, or launched by ``torchrun``, whose environment variables give
the rendezvous) builds ``launch.mesh.make_dist_mesh()``, data parallel
with a model axis of 1 as the JAX package's ``make_local_mesh()`` is, reads
the same global batch the JAX package's single controller reads and takes
its rows of it (``training.steps``). Rank 0 writes the checkpoints; a
resume restores every rank's block onto the mesh (``checkpoint.restore``);
each rank keeps its own step watchdog::

  torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch qwen2-7b \
      --reduced --device cpu --use-mesh --steps 20
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpoint as ckpt_mod
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.launch import shardings
from repro_torch.launch.mesh import make_dist_mesh
from repro_torch.models import model as model_mod
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import steps as steps_mod


class StepWatchdog:
    """Straggler detector: flags steps slower than `factor` × the trailing
    median (on real pods this triggers hot-spare swap / re-mesh)."""

    def __init__(self, factor: float = 3.0, window: int = 20):
        self.times = []
        self.factor = factor
        self.window = window
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        self.times.append(dt)
        hist = self.times[-self.window:-1]
        if len(hist) >= 5 and dt > self.factor * float(np.median(hist)):
            self.flagged += 1
            return True
        return False


def _batch_on(batch, device):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _join_mesh(device):
    """This rank's data-parallel mesh: over the initialised default group,
    or over the one the ``torchrun`` environment describes (gloo on the
    CPU, NCCL on the cards)."""
    if not dist.is_initialized():
        if "RANK" not in os.environ:
            raise RuntimeError("use_mesh needs torch.distributed: launch the ranks with torchrun "
                               "or launch.dist.spawn")
        dist.init_process_group("gloo" if torch.device(device).type == "cpu" else "nccl")
    mesh = make_dist_mesh(device=None if torch.device(device).type == "cuda" else device)
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    return mesh


def train(
    arch: str, *, reduced: bool = True, steps: int = 20, seq_len: int = 128,
    global_batch: int = 4, ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
    use_mesh: bool = False, microbatches: int = 1, log_every: int = 5,
    seed: int = 0, lr: float = 3e-4, device="cuda",
):
    """Train ``arch`` for ``steps`` steps (resuming from the latest
    checkpoint in ``ckpt_dir``, if any). Returns (params, opt_state, losses
    of the steps run by this call). With ``use_mesh``, every rank of the
    mesh calls this alike (see the module's docstring)."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    mesh = mi = specs = None
    if use_mesh:
        mesh = _join_mesh(device)
        mi = model_mod.mesh_context(mesh)
        device = mesh.device
        pspecs = shardings.rank_param_specs(cfg, mesh)
        specs = {"params": pspecs, "opt": {"m": pspecs, "v": pspecs, "step": shardings.P()}}
    device = torch.device(device)
    oc = opt_mod.AdamWConfig(lr=lr, total_steps=max(steps, 10),
                             warmup_steps=max(2, steps // 10))
    dc = DataConfig(seed=seed, seq_len=seq_len + 1, global_batch=global_batch)

    start = 0
    params = opt_state = None
    if ckpt_dir:
        latest = ckpt_mod.latest_step(ckpt_dir)
        if latest is not None:
            like_p = model_mod.init_params(cfg, torch.Generator(device="cpu"), device="meta")
            like_o = opt_mod.init_opt_state(like_p)
            state = ckpt_mod.restore(ckpt_dir, latest, {"params": like_p, "opt": like_o},
                                     device=device, mesh=mesh, spec_tree=specs)
            params, opt_state = state["params"], state["opt"]
            start = latest
            print(f"[train] resumed from step {latest}")
    if params is None:
        params = model_mod.init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                                       device=device)
        opt_state = opt_mod.init_opt_state(params)

    if mesh is not None:    # every rank's block of the same initial state
        params = shardings.shard_tree(params, specs["params"], mesh)
        opt_state = shardings.shard_tree(opt_state, specs["opt"], mesh)
    saver = None
    if ckpt_dir and (mesh is None or mesh.rank == 0):
        saver = ckpt_mod.AsyncCheckpointer(ckpt_dir)
    wd = StepWatchdog()
    losses = []
    for step in range(start, steps):
        t0 = time.time()
        batch = _batch_on(batch_at(cfg, dc, step), device)
        params, opt_state, metrics = steps_mod.train_step(
            params, opt_state, batch, cfg=cfg, opt_cfg=oc, mesh_info=mi,
            microbatches=microbatches)
        loss = float(metrics["loss"])
        losses.append(loss)
        dt = time.time() - t0
        if wd.observe(dt):
            print(f"[watchdog] step {step} straggled ({dt:.2f}s)")
        if log_every and step % log_every == 0:
            print(f"[train] step={step} loss={loss:.4f} gnorm={float(metrics['grad_norm']):.3f} "
                  f"dt={dt:.2f}s")
        if saver and ckpt_every and (step + 1) % ckpt_every == 0:
            saver.save({"params": params, "opt": opt_state}, step + 1,
                       extra={"arch": arch, "loss": loss})
    if saver:
        saver.save({"params": params, "opt": opt_state}, steps,
                   extra={"arch": arch, "loss": losses[-1]})
        saver.wait()
    if mesh is not None:      # the checkpoint is committed before any rank returns
        mesh.barrier()
    return params, opt_state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--use-mesh", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, _, losses = train(
        args.arch, reduced=args.reduced, steps=args.steps, seq_len=args.seq_len,
        global_batch=args.global_batch, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, use_mesh=args.use_mesh,
        microbatches=args.microbatches, device=args.device,
    )
    print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f})")


if __name__ == "__main__":
    main()
