"""Rank bodies of the port's distributed tests (tests/test_torch_dist_*.py).

``repro_torch.launch.dist.spawn`` starts each rank in a fresh interpreter
and imports its body by name, so the bodies live here, in a module that
imports torch and the port only (not JAX, which every rank would load
again), and not in the test files. Each body takes numpy inputs, runs on
its mesh's device (the CPU here; the card in
tests/test_torch_kernels_cuda.py, for the decode and MoE bodies) and
returns numpy arrays or plain values.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch import shardings as sh
from repro_torch.models import model as M


def config(arch: str, **kw):
    """The reduced ``arch`` at float32, with ``kw`` replaced (``moe`` as a
    dict of MoEConfig fields to replace)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    if "moe" in kw:
        kw["moe"] = dataclasses.replace(cfg.moe, **kw["moe"])
    return dataclasses.replace(cfg, **kw)


def rows_of(mesh, b: int) -> slice:
    """This rank's rows of a batch of ``b``: its block over the batch axes
    where ``b`` divides, else all of them (the JAX package's rule)."""
    mi = M.mesh_context(mesh)
    if b % mi.n_batch or b < mi.n_batch:
        return slice(0, b)
    n = b // mi.n_batch
    start = mesh.axis_index(mi.batch_axes) * n
    return slice(start, start + n)


def collectives(rank, mesh):
    """psum / pmax / pmean / all_gather / axis_index of rank-valued tensors
    over each axis, in bf16, f32 and int8 where the op takes it."""
    out = {"coords": dict(mesh.coords), "index": {}}
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10.0 * rank
    for axis in ("data", "model", ("data", "model")):
        key = axis if isinstance(axis, str) else "+".join(axis)
        out["index"][key] = mesh.axis_index(axis)
        for dtype in (torch.float32, torch.bfloat16):
            t = x.to(dtype)
            out[f"psum/{key}/{dtype}"] = mesh.psum(t, axis).float().numpy()
            out[f"pmax/{key}/{dtype}"] = mesh.pmax(t, axis).float().numpy()
            out[f"pmean/{key}/{dtype}"] = mesh.pmean(t, axis).float().numpy()
            out[f"all_gather/{key}/{dtype}"] = mesh.all_gather(t, axis).float().numpy()
        out[f"all_gather/{key}/int8"] = mesh.all_gather(x.to(torch.int8), axis).numpy()
    out["counts"] = dict(mesh.counts)
    return out


def shard_roundtrip(rank, mesh, arch):
    """shard_tree then gather_tree of a reduced model's params and AdamW
    state (ZeRO specs), against the whole trees: whether every leaf came
    back bitwise, and this rank's block shapes."""
    from repro_torch.training import optimizer as opt_mod
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = {"params": params, "opt": opt_mod.init_opt_state(params)}
    state["opt"]["m"] = M.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    specs = {"params": sh.param_specs(cfg, mesh), "opt": sh.opt_specs(cfg, mesh, zero=True)}
    blocks = sh.shard_tree(state, specs, mesh)
    back = sh.gather_tree(blocks, specs, mesh)
    from repro_torch.tree import leaves_with_paths
    whole = dict(leaves_with_paths(state))
    same = all(torch.equal(whole[path], leaf) for path, leaf in leaves_with_paths(back))
    shapes = {"/".join(map(str, path)): tuple(leaf.shape)
              for path, leaf in leaves_with_paths(blocks)}
    return {"same": same, "shapes": shapes}


def decode(rank, mesh, np_params, cfg_kw, prompt, feed, max_len, active=None,
           arch="qwen2-7b"):
    """Reduced ``arch``: a prefill of this rank's rows of ``prompt``, then
    one decode step per row of ``feed``, sequence-sharded over the model
    axis. Returns the rows, each step's logits of them, and this rank's
    K/V cache slices (every leaf, int8 pairs flattened)."""
    cfg = config(arch, sharded_decode_attn=True, **cfg_kw)
    dev = mesh.device
    params = M.params_from_numpy(np_params, cfg, device=dev)
    mi = M.mesh_context(mesh)
    mesh.counts.update(collectives=0, staged_copies=0)
    rows = rows_of(mesh, prompt.shape[0])
    _, cache = M.prefill(params, cfg, {"tokens": torch.from_numpy(prompt[rows]).long().to(dev)},
                         max_len=max_len, mesh_info=mi)
    before = [t.clone() for name in ("k", "v")
              for t in (cache[name] if isinstance(cache[name], tuple) else (cache[name],))]
    logits = []
    for tok in feed:
        act = None if active is None else torch.from_numpy(active[rows]).to(dev)
        lg, cache = M.decode_step(params, cfg, cache, torch.from_numpy(tok[rows]).long().to(dev),
                                  active=act, mesh_info=mi)
        logits.append(lg.cpu().numpy())
    after = [t for name in ("k", "v")
             for t in (cache[name] if isinstance(cache[name], tuple) else (cache[name],))]
    from repro_torch.kernels import decode_attention as da
    return {"rows": (rows.start, rows.stop), "logits": np.stack(logits),
            "partials_launches": da.partials_launches,
            "lengths": cache["lengths"].cpu().numpy(),
            "before": [t.cpu().numpy() for t in before], "after": [t.cpu().numpy() for t in after],
            "coords": dict(mesh.coords), "counts": dict(mesh.counts)}


def hybrid_int8_decode(rank, mesh, np_params, prompt, feed, max_len):
    """:func:`decode` on reduced zamba2-1.2b at 14 layers (two groups of the
    shared attention block) with an int8 cache."""
    return decode(rank, mesh, np_params, {"kv_cache_dtype": "int8", "n_layers": 14}, prompt,
                  feed, max_len, arch="zamba2-1.2b")


def serve(rank, mesh, np_params, episodes_seed):
    """A sequence-sharded engine (reduced qwen2-7b) serving the speculative
    agent loop: the loop's summary, every slot's tokens and this rank's
    partials launches, collectives and cache shape."""
    from repro_torch.core.patterns import PatternEngine
    from repro_torch.core.workload import WorkloadConfig, episodes_to_traces, make_episodes
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch.serve import serve_agent_loop
    from repro_torch.serving.engine import ServingEngine
    cfg = config("qwen2-7b", sharded_decode_attn=True)
    params = M.params_from_numpy(np_params, cfg, device="cpu")
    pe = PatternEngine(context_len=2, min_support=3).fit(
        episodes_to_traces(make_episodes(WorkloadConfig(seed=1, n_episodes=40))))
    episodes = make_episodes(WorkloadConfig(seed=episodes_seed, n_episodes=2))
    eng = ServingEngine(cfg, params, max_batch=4, max_len=64, device="cpu",
                        mesh_info=M.mesh_context(mesh))
    mesh.counts.update(collectives=0, staged_copies=0)
    _, steps, hits, spec = serve_agent_loop(True, cfg, eng, episodes, pe)
    return {"summary": (steps, eng.steps_executed, spec.admitted, spec.promotions, hits),
            "tokens": [list(s.tokens) for s in eng.slots], "cache_k": tuple(eng.cache["k"].shape),
            "partials_launches": da.partials_launches, "counts": dict(mesh.counts)}


def moe(rank, mesh, np_blk, x, cfg_kw, grad_seed=None):
    """One MoE block (params of one layer: router, w_gate, w_up, w_down as
    numpy) on this rank's rows of x, its params this rank's block. With
    ``grad_seed``, also the gradient of sum(y * r) (r from that seed) with
    respect to x and to this rank's block of the params."""
    from repro_torch.models import moe as moe_mod
    cfg = config("mixtral-8x7b", **cfg_kw)
    mi = M.mesh_context(mesh)
    whole = {k: torch.from_numpy(v).to(mesh.device) for k, v in np_blk.items()}
    spec = sh.specs_for([whole], sh.param_specs(cfg, mesh)["blocks"]["moe"])[0]
    p = {k: sh.block_of(v, spec[k], mesh) for k, v in whole.items()}
    rows = rows_of(mesh, x.shape[0])
    xl = torch.from_numpy(x[rows]).to(mesh.device).requires_grad_(grad_seed is not None)
    if grad_seed is not None:
        p = {k: v.clone().requires_grad_() for k, v in p.items()}
    y, aux = moe_mod.moe_forward(p, xl, cfg, mi)
    out = {"rows": (rows.start, rows.stop), "y": y.detach().cpu().numpy(),
           "lb_loss": aux["lb_loss"].item(), "drop_frac": aux["drop_frac"].item(),
           "expert_shape": tuple(p["w_gate"].shape), "rank_model": mesh.coords["model"]}
    if grad_seed is not None:
        r = torch.from_numpy(np.random.default_rng(grad_seed).normal(size=y.shape)
                             .astype(np.float32)).to(mesh.device)
        (y * r).sum().backward()
        out["dx"] = xl.grad.cpu().numpy()
        out["dp"] = {k: v.grad.cpu().numpy() for k, v in p.items()}
    return out


def dp_step(rank, mesh, np_params, arch, batch, microbatches, steps=1):
    """``steps`` data-parallel train steps of the reduced ``arch`` (f32) on
    the global ``batch`` (numpy), each rank holding its block of the params
    (``rank_param_specs``); returns each step's metrics, the collectives
    of a step and the whole params after them (gathered, as numpy)."""
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import steps as steps_mod
    cfg = config(arch)
    mi = M.mesh_context(mesh)
    specs = sh.rank_param_specs(cfg, mesh)
    params = _clone(sh.shard_tree(M.params_from_numpy(np_params, cfg, device="cpu"), specs,
                                  mesh))
    opt = opt_mod.init_opt_state(params)
    oc = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics = []
    for _ in range(steps):
        mesh.counts.update(collectives=0, staged_copies=0)
        params, opt, m = steps_mod.train_step(params, opt, tb, cfg=cfg, opt_cfg=oc, mesh_info=mi,
                                              microbatches=microbatches)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "counts": dict(mesh.counts),
            "params": _numpy(sh.gather_tree(params, specs, mesh))}


def _clone(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.clone(), tree)


def _numpy(tree):
    """The tree as numpy (bf16 leaves widened to f32, which holds them exactly)."""
    from repro_torch.tree import tree_map
    return tree_map(lambda t: (t.float() if t.dtype == torch.bfloat16 else t).numpy(), tree)


def train_on_mesh(rank, mesh, directory):
    """launch.train.train with use_mesh on every rank (reduced granite-8b,
    6 steps, a checkpoint every 3); then, from a copy of the step-3
    checkpoint alone, a run resumed onto the mesh to step 6."""
    import os
    import shutil

    from repro_torch.launch.train import train
    kw = dict(reduced=True, steps=6, seq_len=16, global_batch=4, ckpt_every=3, log_every=0,
              use_mesh=True, device="cpu")
    full, part = os.path.join(directory, "full"), os.path.join(directory, "part")
    params, opt, losses = train("granite-8b", ckpt_dir=full, **kw)
    if rank == 0:
        shutil.copytree(os.path.join(full, "step_3"), os.path.join(part, "step_3"))
    mesh.barrier()
    params2, opt2, resumed = train("granite-8b", ckpt_dir=part, **kw)
    same = all(torch.equal(a, b) for a, b in zip(leaves(params), leaves(params2), strict=True))
    return {"losses": losses, "resumed": resumed, "same_params": same,
            "step": int(opt2["step"]), "params": _numpy(params)}


def compressed_sync(rank, mesh, g_all, steps):
    """``steps`` rounds of compression.compressed_grad_sync over the pod
    axis, this rank's gradient g_all[rank] each round; the synced values."""
    from repro_torch.training import compression as C
    grads = {"g": torch.from_numpy(g_all[rank]), "h": torch.from_numpy(2 * g_all[rank, :5])}
    err = C.init_error_feedback(grads)
    out = []
    for _ in range(steps):
        synced, err = C.compressed_grad_sync(grads, err, mesh, axis="pod")
        out.append(_numpy(synced))
    return {"synced": out, "coords": dict(mesh.coords), "counts": dict(mesh.counts)}


def save_blocks(rank, mesh, arch, directory):
    """Each rank's block of a reduced MoE model's params and AdamW state
    (``rank_param_specs``: the experts over the model axis; bf16 params,
    f32 moments, made from seeds), saved by checkpoint.save over the mesh;
    the path rank 0 committed (None on the others)."""
    from repro_torch.checkpoint import checkpoint as ck
    cfg = get_config(arch).reduced()
    specs = _state_specs(cfg, mesh)
    blocks = sh.shard_tree(_state(cfg), specs, mesh)
    return ck.save(blocks, directory, 7, mesh=mesh, spec_tree=specs, extra={"ranks": 4})


def restore_blocks(rank, mesh, arch, directory):
    """checkpoint.restore onto this mesh: for every leaf of this rank's
    restored state, its shape and whether it is bitwise (dtype included)
    its block of the state that was saved."""
    from repro_torch.checkpoint import checkpoint as ck
    from repro_torch.tree import leaves_with_paths
    cfg = get_config(arch).reduced()
    specs = _state_specs(cfg, mesh)
    whole = _state(cfg)
    got = ck.restore(directory, 7, whole, mesh=mesh, spec_tree=specs)
    want = dict(leaves_with_paths(sh.shard_tree(whole, specs, mesh)))
    return {"/".join(map(str, p)): (tuple(t.shape), t.dtype == want[p].dtype
                                    and torch.equal(t, want[p]))
            for p, t in leaves_with_paths(got)}


def _state(cfg):
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.tree import tree_map
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = opt_mod.init_opt_state(params)
    opt["m"] = tree_map(lambda t: t.float(), M.init_params(cfg, torch.Generator().manual_seed(1),
                                                           device="cpu"))
    opt["step"] += 5
    return {"params": params, "opt": opt}


def _state_specs(cfg, mesh):
    p = sh.rank_param_specs(cfg, mesh)
    return {"params": p, "opt": {"m": p, "v": p, "step": sh.P()}}


def dp_suite(rank, mesh, np_params, arch, batch, runs):
    """:func:`dp_step` for each run (name -> (microbatches, steps)), with
    this rank's count of valid labels in its rows."""
    cfg = config(arch)
    rows = rows_of(mesh, batch["labels"].shape[0])
    labels = batch["labels"][rows]
    n_tokens = int(((labels >= 0) & (labels < cfg.vocab_size)).sum())
    return {name: dict(dp_step(rank, mesh, np_params, arch, batch, mb, steps), n_tokens=n_tokens)
            for name, (mb, steps) in runs.items()}


def params_of(np_params, cfg):
    return M.params_from_numpy(np_params, cfg, device="cpu")


def leaves(tree):
    from repro_torch.tree import leaves as tree_leaves
    return tree_leaves(tree)


def numpy_params(arch: str, seed: int = 0, **kw):
    """The port's random params of the reduced ``arch`` (f32) as numpy in
    the JAX package's layout (blocks stacked), as params_from_numpy takes
    them."""
    cfg = config(arch, **kw)
    params = M.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")

    def stack(blocks):
        if isinstance(blocks[0], dict):
            return {k: stack([b[k] for b in blocks]) for k in blocks[0]}
        return np.stack([b.numpy() for b in blocks])

    out = {k: v.numpy() for k, v in params.items() if k != "blocks"}
    out["blocks"] = stack(params["blocks"])
    return out


def staging(rank, mesh):
    """psum, pmax and all_gather of CUDA tensors in every dtype the port
    reduces, against the values they must give; the results' devices and
    the mesh's counts."""
    out = {}
    n = mesh.axis_size("model")
    for dtype in (torch.bfloat16, torch.float32, torch.int8, torch.int64):
        x = (torch.arange(6, device=mesh.device) + 3 * rank).to(dtype)
        want_sum = sum(torch.arange(6) + 3 * r for r in range(n)).to(dtype)
        want_max = (torch.arange(6) + 3 * (n - 1)).to(dtype)
        got_sum, got_max = mesh.psum(x, "model"), mesh.pmax(x, "model")
        got_all = mesh.all_gather(x, "model")
        out[str(dtype)] = {
            "psum": bool(torch.equal(got_sum.cpu(), want_sum)),
            "pmax": bool(torch.equal(got_max.cpu(), want_max)),
            "all_gather": bool(torch.equal(got_all.cpu(), torch.stack(
                [(torch.arange(6) + 3 * r).to(dtype) for r in range(n)]))),
            "devices": sorted({str(t.device) for t in (got_sum, got_max, got_all)})}
    out["counts"] = dict(mesh.counts)
    out["backend"] = mesh.backend
    return out


def mesh_suite(rank, mesh):
    """The collectives, then the shard / gather round trip of every arch."""
    from repro_torch.configs import ARCHS
    return {"collectives": collectives(rank, mesh),
            "roundtrip": {arch: shard_roundtrip(rank, mesh, arch) for arch in ARCHS}}


def fail_on_rank_one(rank, mesh):
    if rank == 1:
        raise ValueError("rank 1 fails")
    return rank


def decode_suite(rank, mesh, np_params, prompt, feed, active):
    """The sequence-sharded decode with an f32 and an int8 cache, a step
    with inactive rows, and the engine's agent loop, on one mesh."""
    return {"float32": decode(rank, mesh, np_params, {}, prompt, feed, 32),
            "int8": decode(rank, mesh, np_params, {"kv_cache_dtype": "int8"}, prompt, feed, 32),
            "inactive": decode(rank, mesh, np_params, {}, prompt[:, :5], feed[:1], 16,
                               active=active),
            "serve": serve(rank, mesh, np_params, 9)}


def moe_suite(rank, mesh, cases):
    """:func:`moe` for each case (name -> (block, x, config fields)), with
    the gradient of sum(y * r) for r from seed 5."""
    return {name: moe(rank, mesh, blk, x, kw, grad_seed=5) for name, (blk, x, kw) in cases.items()}
