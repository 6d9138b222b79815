"""Mixture-of-Experts block: the local path of ``repro.models.moe``.

Dispatch is sort-based with group-local capacity, as in the JAX package:
tokens are routed to their top-k experts by an f32 router, a stable sort
over expert ids gives each slot its arrival position in its expert, slots
past the capacity ``ceil(t k cf / E)`` drop into a dump row, and the
experts run as three batched products over (E, capacity, D). Every shape
comes from Python ints: the block makes no host sync (no ``nonzero``, no
boolean indexing, no ``.item()``).

The combine is deterministic: each token has exactly k slots, so its output
is the sum of a (t, k, D) view over k in a fixed order, where the JAX
package scatter-adds the slots (an atomic ``index_add_`` on the card would
sum them in a varying order). Several dropped slots write the dump row; it
is never read, so which of them lands there does not matter.

A decode step routes all B rows of the batch, inactive ones too, as the
JAX engine does (it masks the cache after the step): an inactive row can
take capacity from an active one.

Over a mesh of processes (``launch.mesh.DistMesh``) the block is the JAX
package's ``shard_map`` body on this rank: with ``E % n_model == 0``
(expert parallel) the rank holds experts ``[r E / n_model, (r + 1) E /
n_model)`` and routes every token over all E, keeping the slots of its
own experts; otherwise (expert tensor parallel) it holds every expert with
its d_ff sliced over the model axis. Either way its partial output is
summed over the model axis (in ``x``'s dtype, bf16 on the card, as the
JAX package's psum), the load-balance loss averaged and the kept slots
summed (averaged under expert TP, where every rank keeps the same). The
capacity and the load-balance loss are those of this rank's rows, as the
JAX package computes them per batch shard. Under autograd the token rows
that enter the local experts and the gates carry gradients that are
partial on each rank: they are summed over the model axis in the backward
pass (``launch.mesh.sum_grads_over``), so the router's, the input's and
every replicated parameter's gradient is whole and the same on every rank
of the axis. Over a ``LocalMesh`` (one process holds every shard) the
block runs all experts at once, which is what the shards' sum computes.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import on_ranks, reduced_over, sum_grads_over
from repro_torch.models.common import dense_init, from_block, local_block

F32_PARAMS = ("router",)  # float32 in every config, as in the JAX package


def init_moe_params(generator: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
                    device) -> dict:
    D = cfg.d_model
    E, Fd = cfg.moe.n_experts, cfg.moe.d_ff_expert
    return {
        "router": dense_init(generator, (D, E), dtype=torch.float32, device=device),
        "w_gate": dense_init(generator, (E, D, Fd), in_axis=1, dtype=dtype, device=device),
        "w_up": dense_init(generator, (E, D, Fd), in_axis=1, dtype=dtype, device=device),
        "w_down": dense_init(generator, (E, Fd, D), in_axis=1, dtype=dtype, device=device),
    }


def capacity(t: int, cfg: ModelConfig) -> int:
    """Slots per expert for ``t`` tokens."""
    return max(1, int(math.ceil(t * cfg.moe.top_k * cfg.moe.capacity_factor
                                / cfg.moe.n_experts)))


def _route(x2d: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """x2d (T, D) -> (gates (T,k) f32, experts (T,k) int64, router probs (T,E) f32).
    ``torch.topk`` returns the k largest in descending order, as
    ``jax.lax.top_k`` does."""
    probs = torch.softmax(x2d.float() @ router.float(), dim=-1)
    gate_vals, experts = torch.topk(probs, cfg.moe.top_k, dim=-1)
    if cfg.moe.renorm_gate:
        gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return gate_vals, experts, probs


def _positions_in_expert(e_flat: torch.Tensor) -> torch.Tensor:
    """e_flat (M,) -> pos (M,): the rank of slot i among the slots routed to
    its expert, in arrival order (a stable sort, then segment starts by a
    running maximum)."""
    m = e_flat.shape[0]
    order = torch.argsort(e_flat, stable=True)
    sorted_e = e_flat[order]
    idx = torch.arange(m, device=e_flat.device)
    is_start = torch.ones(m, dtype=torch.bool, device=e_flat.device)
    is_start[1:] = sorted_e[1:] != sorted_e[:-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    return torch.empty_like(idx).scatter_(0, order, idx - seg_start)


def _expert_ffn(xd: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """xd (E, C, D) -> (E, C, D): SwiGLU per expert."""
    return torch.bmm(F.silu(torch.bmm(xd, w_gate)) * torch.bmm(xd, w_up), w_down)


def _dispatch(experts: torch.Tensor, cap: int, n_local: int, offset: int = 0):
    """(keep (M,) bool, dest (M,) row of each slot in the (n_local cap +
    1)-row dispatch buffer, the last row the dump) for the flattened top-k
    experts, of which experts [offset, offset + n_local) are held here. A
    slot routed elsewhere goes to an overflow bin (expert n_local), which
    takes no capacity from the local experts, and is not kept."""
    e_flat = experts.reshape(-1)
    local = (e_flat >= offset) & (e_flat < offset + n_local)
    e_local = torch.where(local, e_flat - offset, n_local)
    pos = _positions_in_expert(e_local)
    keep = local & (pos < cap)
    return keep, torch.where(keep, e_local * cap + pos, n_local * cap)


def _moe_local(p: dict, x: torch.Tensor, cfg: ModelConfig, n_local_experts: int,
               expert_offset: int = 0, *, partial_grad=None):
    """The block over local experts [offset, offset + n_local) (their
    weights in ``p``), the reference's signature: x (B, S, D) -> (partial y
    (B, S, D), aux: lb_loss, kept, slots). Tokens routed to other experts
    contribute zero. ``partial_grad``, where given, is applied to the token
    rows that enter the experts and to the gates, whose gradients are this
    block's part of the whole (see the module's docstring)."""
    b, s, d = x.shape
    k, E = cfg.moe.top_k, cfg.moe.n_experts
    t = b * s
    x2d = x.reshape(t, d)
    gates, experts, probs = _route(x2d, p["router"], cfg)
    x_in = x2d
    if partial_grad is not None:
        x_in, gates = partial_grad(x2d), partial_grad(gates)
    cap = capacity(t, cfg)
    keep, dest = _dispatch(experts, cap, n_local_experts, expert_offset)
    dump = n_local_experts * cap
    disp = x.new_zeros((dump + 1, d)).index_copy_(0, dest, x_in.repeat_interleave(k, dim=0))
    yd = _expert_ffn(disp[:dump].view(n_local_experts, cap, d), p["w_gate"], p["w_up"],
                     p["w_down"])
    y_rep = yd.reshape(dump, d)[torch.clamp(dest, max=dump - 1)]
    y_rep = torch.where(keep[:, None], y_rep, 0.0)
    w = gates.reshape(t * k) * keep
    y = (y_rep.float() * w[:, None]).view(t, k, d).sum(dim=1)
    # Switch-style load-balance terms, over the full router probabilities
    counts = torch.zeros(E, dtype=torch.int64, device=x.device).scatter_add_(
        0, experts.reshape(-1), torch.ones_like(experts.reshape(-1)))
    lb_loss = E * torch.sum(probs.mean(dim=0) * counts.float() / (t * k))
    aux = {"lb_loss": lb_loss, "kept": keep.sum().float(), "slots": float(t * k)}
    return y.view(b, s, d).to(x.dtype), aux


def moe_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, mesh_info: Optional[object] = None):
    """MoE block.  x (B,S,D) -> (y (B,S,D), {"lb_loss", "drop_frac"}).
    Under a DistMesh, ``p`` is this rank's block and ``x`` its rows; on
    DTensors, the shard_map of the JAX package over their mesh
    (:func:`_moe_dtensor`)."""
    E = cfg.moe.n_experts
    if isinstance(x, DTensor):
        return _moe_dtensor(p, x, cfg, mesh_info)
    if not on_ranks(mesh_info):
        y, aux = _moe_local(p, x, cfg, E)
        return y, {"lb_loss": aux["lb_loss"], "drop_frac": 1.0 - aux["kept"] / aux["slots"]}
    mesh, ma, nm = mesh_info.mesh, mesh_info.model_axis, mesh_info.n_model
    ep = E % nm == 0              # expert parallel; else expert TP (d_ff sliced)
    if not ep and cfg.moe.d_ff_expert % nm:
        raise ValueError(f"{E} experts and d_ff_expert {cfg.moe.d_ff_expert} do not split "
                         f"over {nm} ranks")
    n_local = E // nm if ep else E
    y, aux = _moe_local(p, x, cfg, n_local, mesh.axis_index(ma) * n_local if ep else 0,
                        partial_grad=lambda t: sum_grads_over(t, mesh, ma))
    y = reduced_over(y, mesh, ma)
    lb = reduced_over(aux["lb_loss"], mesh, ma, mean=True)
    kept = mesh.psum(aux["kept"], ma) if ep else mesh.pmean(aux["kept"], ma)
    return y, {"lb_loss": lb, "drop_frac": 1.0 - kept / aux["slots"]}


def _moe_dtensor(p: dict, x: DTensor, cfg: ModelConfig, mesh_info):
    """The JAX package's ``shard_map`` of the block over a ``DeviceMesh``
    (the dry-run's DTensors), explicitly, as DTensor cannot propagate the
    routing's sorts and scatters: ``x`` laid out P(batch, None, None) (the
    batch axes where the batch divides over them), the experts over the
    model axis (expert parallel) or their d_ff (expert TP), :func:`_moe_local`
    on this rank's blocks, its output summed over the model axis, the
    load-balance loss and the kept slots averaged (summed under EP) over
    it and averaged over the batch shards."""
    from repro_torch.launch.shardings import P, to_placements

    mesh, ma, nm = x.device_mesh, mesh_info.model_axis, mesh_info.n_model
    E = cfg.moe.n_experts
    ep = E % nm == 0
    if not ep and cfg.moe.d_ff_expert % nm:
        raise ValueError(f"{E} experts and d_ff_expert {cfg.moe.d_ff_expert} do not split "
                         f"over {nm} ranks")
    shardable = x.shape[0] % mesh_info.n_batch == 0 and x.shape[0] >= mesh_info.n_batch
    batch = mesh_info.batch_axes if shardable else None
    w_spec = ({"w_gate": P(ma, None, None), "w_up": P(ma, None, None),
               "w_down": P(ma, None, None)} if ep else
              {"w_gate": P(None, None, ma), "w_up": P(None, None, ma),
               "w_down": P(None, ma, None)})
    w_spec["router"] = P(None, None)
    x_pl = to_placements(P(batch, None, None), mesh)
    n_local = E // nm if ep else E
    names = mesh.mesh_dim_names
    offset = mesh.get_local_rank(names.index(ma)) * n_local if ep else 0
    y, aux = _moe_local({k: local_block(v, to_placements(w_spec[k], mesh)) for k, v in p.items()},
                        local_block(x, x_pl), cfg, n_local, offset)
    model = {names.index(ma): "sum"}
    y = from_block(y, mesh, x_pl, model)
    scalar = [Replicate()] * mesh.ndim
    over_batch = {names.index(a): "avg" for a in (batch or ())}
    lb = from_block(aux["lb_loss"], mesh, scalar, {**over_batch, names.index(ma): "avg"})
    kept = from_block(aux["kept"], mesh, scalar,
                      {**over_batch, names.index(ma): "sum" if ep else "avg"})
    return y, {"lb_loss": lb, "drop_frac": 1.0 - kept / aux["slots"]}
