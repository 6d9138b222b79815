"""Ranks on one host: the port's counterpart of
``--xla_force_host_platform_device_count``, with which the JAX package's
tests make a mesh of host devices.

:func:`spawn` starts ``world`` processes under ``torch.multiprocessing``
(the spawn start method), joins them in a ``torch.distributed`` group and
runs ``fn(rank, mesh, *args)`` on each, ``mesh`` the rank's
``launch.mesh.DistMesh``. The rendezvous is a file in a fresh temporary
directory, never a fixed TCP port, so that several spawns may run at once
(pytest-xdist workers do). gloo connects the ranks over the loopback
interface, unless ``GLOO_SOCKET_IFNAME`` says otherwise. Each rank keeps
one intra-op thread: four ranks under each of six test workers would
otherwise ask for far more threads than the host has cores.

``fn`` must be importable by name in a fresh interpreter (a module-level
function of an importable module), as must ``args`` be picklable. A CUDA
tensor in ``args`` reaches the ranks by CUDA IPC, not by copy: the caller
keeps it alive until the spawn returns. Each rank's return value is
pickled to the temporary directory and handed back in rank order (move
tensors to the host first). A rank that raises fails the spawn: the
others are stopped and the error is raised here.
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as torch_mp

from repro_torch.launch.mesh import make_dist_mesh


def _rank_main(rank: int, fn: Callable, world: int, backend: str, device, args: Sequence,
               model_parallel: int, pod: int, directory: str, timeout_s: float) -> None:
    torch.set_num_threads(1)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, init_method=f"file://{directory}/rendezvous", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        mesh = make_dist_mesh(model_parallel, pod=pod, device=device)
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        result = fn(rank, mesh, *args)
        with open(os.path.join(directory, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, *, backend: str = "gloo", device=None, args: Sequence = (),
          model_parallel: int = 1, pod: int = 1, timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(rank, mesh, *args)`` on ``world`` ranks of a (data, model)
    mesh (``model_parallel`` wide; (pod, data, model) with ``pod > 1``) on
    ``device`` (None: each rank's ``cuda:{rank % device_count}``); returns
    the ranks' results in rank order. ``timeout_s`` bounds each collective."""
    with tempfile.TemporaryDirectory(prefix="dist_") as directory:
        torch_mp.spawn(_rank_main, args=(fn, world, backend, device, tuple(args), model_parallel,
                                         pod, directory, timeout_s), nprocs=world, join=True)
        results = []
        for rank in range(world):
            with open(os.path.join(directory, f"result_{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
