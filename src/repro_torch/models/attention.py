"""GQA attention block: init + full-sequence/prefill/decode application.

Ported: the plain (bf16 or f32) and the int8 KV cache, with or without a
sliding window, the sequence-sharded split-KV decode
(``attn_decode_sharded``) over a local mesh of shards on one device or over
a mesh of processes (``launch.mesh.DistMesh``), and head padding: with
``cfg.head_pad_multiple`` the query and KV head counts are rounded up to
``cfg.eff_n_heads`` / ``cfg.eff_n_kv_heads``, the padded heads' columns of
``wq``/``wk``/``wv`` and rows of ``wo`` are zero, and the kernels see Hp
query heads over KVp kv heads. A padded head's output never
reaches the residual stream, so the padded model computes what the
unpadded one does.

With a sliding window no longer than the cache (``smax <= window``, see
:func:`_decode_plan`), the cache is a rolling buffer that holds position p at
row ``p % smax``: a prefill keeps the last ``smax`` positions, decode writes
each new row at ``length % smax``, over the one that has just left the
window, and attends over the ``min(length + 1, smax)`` rows held, with no
window mask. The rows are rotated, which softmax does not see, since RoPE
was applied to each key before it was stored. The JAX package keeps a long
prompt's positions unrotated instead, so its decode overwrites a row still
in the window unless the prompt's length is a multiple of ``smax``; this
module does not copy that.

An int8 cache is a (values int8 (B,Smax,KV,hd), scales f32 (B,Smax,KV))
pair for each of K and V, quantized per head vector (``kv_quantize``) as in
the JAX package. Decode updates every cache in place.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import combine_partials
from repro_torch.launch.mesh import on_ranks
from repro_torch.models.common import (apply_rope, blocks, dense_init, from_block,
                                       kept_shards, merge_heads, reduce_partial,
                                       reduced_grad, whole_groups)


def init_attn_params(generator: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
                     device, d_in: Optional[int] = None) -> dict:
    """Random weights for the real heads, drawn as without padding; zero
    columns of ``wq``/``wk``/``wv`` and zero rows of ``wo`` for the padded
    ones, and biases sized to the padded heads. The projections read
    ``d_in`` features (Zamba2's concat input), d_model by default."""
    D, hd = cfg.d_model, cfg.resolved_head_dim
    Din = d_in or D
    H, KV = cfg.n_heads, cfg.n_kv_heads
    Hp, KVp = cfg.eff_n_heads, cfg.eff_n_kv_heads
    F = torch.nn.functional

    def init(shape, pad):  # pad: (columns, rows) of zeros after the drawn block
        return F.pad(dense_init(generator, shape, dtype=dtype, device=device), pad)

    p = {
        "wq": init((Din, H * hd), (0, (Hp - H) * hd)),
        "wk": init((Din, KV * hd), (0, (KVp - KV) * hd)),
        "wv": init((Din, KV * hd), (0, (KVp - KV) * hd)),
        "wo": init((H * hd, D), (0, 0, 0, (Hp - H) * hd)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((Hp * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((KVp * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((KVp * hd,), dtype=dtype, device=device)
    return p


def _qkv(p: dict, x: torch.Tensor, cfg: ModelConfig):
    b, s, _ = x.shape
    H, KV, hd = cfg.eff_n_heads, cfg.eff_n_kv_heads, cfg.resolved_head_dim
    x = reduced_grad(x)
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k, v = (whole_groups(t, KV) for t in (q, k, v))    # whole GQA groups a rank
    return q.reshape(b, s, H, hd), k.reshape(b, s, KV, hd), v.reshape(b, s, KV, hd)


def kv_quantize(k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(..., head)-vector absmax int8 quantization over head_dim:
    (values int8, scales f32 without the head_dim axis)."""
    kf = k.float()
    scale = torch.clamp(kf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(kf / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def _roped_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig):
    q, k, v = _qkv(p, x, cfg)
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    return apply_rope(q, pos, cfg.rope_theta), apply_rope(k, pos, cfg.rope_theta), v


def _flash(q, k, v, cfg: ModelConfig, impl: str) -> torch.Tensor:
    """``ops.flash_attention``, causal under the config's window and scale. On
    DTensors (the dry-run) each rank runs it on its block, its batch rows
    and its whole kv-head groups (as q holds them, k and v laid out alike,
    the sequence whole), as GSPMD partitions attention: DTensor would
    otherwise propagate every op of the attention's loop, merging sharded
    dims that it can only track at a cost that grows with the mesh."""
    if not isinstance(q, DTensor):
        return ops.flash_attention(q, k, v, causal=True, window=cfg.sliding_window,
                                   scale=cfg.attn_scale, impl=impl)
    pl = kept_shards(q, {0: 0, 2: 2})
    o = ops.flash_attention(*blocks(pl, q, k, v), causal=True, window=cfg.sliding_window,
                            scale=cfg.attn_scale, impl=impl)
    return DTensor.from_local(o, q.device_mesh, pl, run_check=False)


def attn_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, *, impl: str) -> torch.Tensor:
    """Full-sequence causal attention. x (B,S,D)."""
    b, s, _ = x.shape
    q, k, v = _roped_qkv(p, x, cfg)
    o = _flash(q, k, v, cfg, impl)
    return reduce_partial(merge_heads(o, cfg.eff_n_kv_heads) @ p["wo"])


def attn_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig, smax: int, *, impl: str):
    """Prefill: returns (out (B,S,D), k_cache, v_cache (B,Smax,KV,hd)), each
    cache an (int8 values, f32 scales) pair when ``cfg.kv_cache_dtype`` is
    int8. Under a sliding window with ``smax < s`` the cache is a rolling
    buffer that keeps the last ``smax`` positions, position p at row
    ``p % smax``."""
    b, s, _ = x.shape
    q, k, v = _roped_qkv(p, x, cfg)
    o = _flash(q, k, v, cfg, impl)
    out = reduce_partial(o.reshape(b, s, -1) @ p["wo"])
    if cfg.sliding_window is not None and smax < s:
        # the last smax positions, position p at row p % smax as decode expects
        k, v = (torch.roll(t[:, s - smax:], s % smax, dims=1) for t in (k, v))
    k_cache, v_cache = _padded(k, smax), _padded(v, smax)
    if cfg.kv_cache_dtype == "int8":
        return out, kv_quantize(k_cache), kv_quantize(v_cache)
    return out, k_cache, v_cache


def _padded(t: torch.Tensor, smax: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, smax, KV, hd), zero rows after the S held. A
    DTensor (the dry-run) is padded on each rank's block, its rows and heads
    as held: some PyTorch releases' DTensor cannot plan ``pad``'s layout."""
    pad = (0, 0, 0, 0, 0, smax - t.shape[1])
    if not isinstance(t, DTensor):
        return torch.nn.functional.pad(t, pad)
    pl = kept_shards(t, {0: 0, 2: 2})
    block, = blocks(pl, t)
    return DTensor.from_local(torch.nn.functional.pad(block, pad), t.device_mesh, pl,
                              run_check=False)


def _cache_smax(cache) -> int:
    return (cache[0] if isinstance(cache, tuple) else cache).shape[1]


def _write_row(cache: torch.Tensor, index: tuple, new: torch.Tensor,
               active: Optional[torch.Tensor]) -> None:
    """cache[index] = new in place, where the bool mask ``active`` (B,) is
    given only for active sequences. A DTensor cache (the dry-run's) is
    written by :func:`_write_row_dtensor`."""
    if isinstance(cache, DTensor):
        _write_row_dtensor(cache, index[1], new, active)
        return
    if active is not None:
        keep = active.view(-1, *([1] * (new.dim() - 1)))
        new = torch.where(keep, new, cache[index])
    cache[index] = new


def _write_row_dtensor(cache: DTensor, slot, new, active) -> None:
    """Each sequence's row ``new`` (B, ...) written at its ``slot`` (B,) of
    the DTensor ``cache`` (B, Smax, ...) in place, on this rank's block:
    the GSPMD partition of the JAX package's update, which DTensor does not
    propagate in place. ``new``, ``slot`` and ``active`` take the cache's
    layout of their dims (the sequence dim dropped); the rank whose block of
    a sequence-sharded cache holds a row's slot writes it, the others keep
    theirs (the sharded decode's ``in_rng``)."""
    mesh = cache.device_mesh
    rows_pl = kept_shards(cache, {0: 0})
    new_pl = kept_shards(cache, {0: 0, **{d: d - 1 for d in range(2, cache.dim())}})
    block = cache.to_local()
    n_rows, seq = block.shape[1], 0
    for i, pl in enumerate(cache.placements):
        if isinstance(pl, Shard) and pl.dim == 1:
            seq = seq * mesh.size(i) + mesh.get_local_rank(i)
    slot_l, new_l, active_l = blocks([rows_pl, new_pl, rows_pl], slot, new, active)
    slot_l = slot_l - seq * n_rows
    write = (slot_l >= 0) & (slot_l < n_rows)
    if active_l is not None:
        write = write & active_l
    index = (torch.arange(block.shape[0], device=block.device),
             torch.clamp(slot_l, 0, n_rows - 1))
    keep = write.view(-1, *([1] * (block.dim() - 2)))
    block[index] = torch.where(keep, new_l.to(block.dtype), block[index])


def _append(k_cache, v_cache, k_new, v_new, index, active):
    """Write each sequence's new K/V row at ``index`` in place: the values,
    or for an int8 cache (a pair) the quantized values and their scales."""
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        if isinstance(cache, tuple):
            for leaf, val in zip(cache, kv_quantize(new), strict=True):
                _write_row(leaf, index, val, active)
        else:
            _write_row(cache, index, new, active)


def _roped_decode_qkv(p, x, lengths, cfg):
    q, k, v = _qkv(p, x, cfg)                     # (B,1,H,hd)/(B,1,KV,hd)
    q = apply_rope(q, lengths[:, None], cfg.rope_theta)
    k = apply_rope(k, lengths[:, None], cfg.rope_theta)
    return q[:, 0], k[:, 0], v[:, 0]


def attn_decode(
    p: dict, x: torch.Tensor, k_cache, v_cache, lengths: torch.Tensor, cfg: ModelConfig, *,
    impl: str, active: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One-token decode.  x (B,1,D); cache (B,Smax,KV,hd), or with an int8
    cache a (values, scales) pair; lengths (B,) int32 = tokens already in
    the cache.  Returns out (B,1,D).

    The caches are updated in place: each sequence's new K/V row is written
    at its length (clamped to Smax-1; at ``length % Smax`` in a rolling
    buffer), and where the bool mask ``active`` (B,) is given, only active
    sequences' rows change. An int8 cache is dequantized to ``x.dtype`` for
    the attention, as in the JAX package. On DTensors (the dry-run) the
    attention runs on each rank's block (:func:`_decode_dtensor`)."""
    b = x.shape[0]
    smax = _cache_smax(k_cache)
    quant = cfg.kv_cache_dtype == "int8"
    q, k_new, v_new = _roped_decode_qkv(p, x, lengths, cfg)
    slot, eff_len, window = _decode_plan(cfg, lengths, smax)
    index = (torch.arange(b, device=x.device), slot)
    _append(k_cache, v_cache, k_new, v_new, index, active)
    if quant:
        k_cache, v_cache = kv_dequantize(*k_cache, x.dtype), kv_dequantize(*v_cache, x.dtype)
    if isinstance(x, DTensor):
        o = _decode_dtensor(q, k_cache, v_cache, eff_len, window, cfg.attn_scale, impl)
    else:
        o = ops.decode_attention(q.contiguous(), k_cache, v_cache, eff_len,
                                 scale=cfg.attn_scale, window=window, impl=impl)
    return reduce_partial(o.reshape(b, 1, -1) @ p["wo"])


def _decode_dtensor(q: DTensor, k_cache: DTensor, v_cache: DTensor, eff_len, window, scale,
                    impl):
    """``ops.decode_attention`` on this rank's block of DTensors (the
    dry-run): the cache's batch rows and kv heads as it holds them, its
    sequence gathered whole (as GSPMD gathers a sequence-sharded cache for
    the JAX package's decode), q's rows and query heads laid out alike."""
    cache_pl = kept_shards(k_cache, {0: 0, 2: 2})
    q_pl = kept_shards(k_cache, {0: 0, 2: 1})
    q_l, = blocks(q_pl, q)
    k_l, v_l = blocks(cache_pl, k_cache, v_cache)
    len_l, = blocks(kept_shards(k_cache, {0: 0}), eff_len)
    o = ops.decode_attention(q_l.contiguous(), k_l, v_l, len_l, scale=scale, window=window,
                             impl=impl)
    return DTensor.from_local(o, q.device_mesh, q_pl, run_check=False)


def _decode_plan(cfg: ModelConfig, lengths: torch.Tensor, smax: int):
    """(slot of the new row, effective lengths, window) of a decode step: in
    a rolling buffer the row goes to ``length % smax`` and the step attends
    over the ``min(length + 1, smax)`` rows held with no window; otherwise
    to ``min(length, smax - 1)``, over ``length + 1`` under the window."""
    if cfg.sliding_window is not None and smax <= cfg.sliding_window:
        return (lengths % smax).long(), torch.clamp(lengths + 1, max=smax), None
    return torch.clamp(lengths, max=smax - 1).long(), lengths + 1, cfg.sliding_window


# ======================================================================
# Sequence-sharded split-KV flash-decode (JAX ``attn_decode_sharded``)
#
# The cache's sequence axis is cut into n_model shards of Smax / n_model
# positions. Each shard attends over its own slice and only the per-head
# softmax partials (m, l, acc) are combined. In the JAX package each shard
# is a device of a shard_map. Under a LocalMesh the shards are views of one
# cache on one card, the partials kernel runs once per shard, and pmax/psum
# become a max and a sum over the shard axis. Under a DistMesh each rank
# holds its own slice and runs the kernel once, and pmax/psum are
# collectives over the model axis's process group.
# ======================================================================

def attn_decode_sharded(
    p: dict, x: torch.Tensor, k_cache, v_cache, lengths: torch.Tensor, cfg: ModelConfig,
    mesh_info, *, impl: str = "auto", active: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode with a sequence-sharded KV cache.  x (B,1,D); caches
    (B,Smax,KV,hd) (or int8 (values, scales) pairs) cut on axis 1 into
    ``mesh_info.n_model`` shards.  Returns out (B,1,D); the caches are
    updated in place as in :func:`attn_decode`. Under a DistMesh the caches
    are this rank's slice (B, Smax / n_model, KV, hd) and x its rows
    (:func:`_attn_decode_dist`)."""
    if on_ranks(mesh_info):
        return _attn_decode_dist(p, x, k_cache, v_cache, lengths, cfg, mesh_info, impl=impl,
                                 active=active)
    if isinstance(x, DTensor):
        return _attn_decode_dtensor(p, x, k_cache, v_cache, lengths, cfg, mesh_info,
                                    impl=impl, active=active)
    b = x.shape[0]
    quant = cfg.kv_cache_dtype == "int8"
    smax = _cache_smax(k_cache)
    hd, H = cfg.resolved_head_dim, cfg.eff_n_heads
    nm = mesh_info.n_model
    chunk = smax // nm

    q, k_new, v_new = _roped_decode_qkv(p, x, lengths, cfg)
    # pre-scaled f32 q, (B, KV*grp, hd) in kv-major order as the kernel reads it
    qg = (q.float() * cfg.attn_scale).contiguous()
    slot, eff_len, win = _decode_plan(cfg, lengths, smax)

    # the new row lands on the one shard whose range holds its slot (the
    # reference's in_rng test), at its local position there
    index = (torch.arange(b, device=x.device), slot // chunk, slot % chunk)

    def shards(c):  # (B, Smax, ...) -> (B, nm, chunk, ...), a view
        if isinstance(c, tuple):
            return tuple(map(shards, c))
        return c.view(c.shape[0], nm, chunk, *c.shape[2:])

    _append(shards(k_cache), shards(v_cache), k_new, v_new, index, active)
    k_eff, v_eff = k_cache, v_cache
    if quant:  # every shard attends over its dequantized slice, made in one pass
        k_eff, v_eff = kv_dequantize(*k_cache, x.dtype), kv_dequantize(*v_cache, x.dtype)

    offs = torch.arange(0, smax, chunk, device=x.device, dtype=lengths.dtype)
    eff_local = torch.clamp(eff_len[None, :] - offs[:, None], 0, chunk)      # (nm, B)
    parts = [ops.decode_attention_partials(
        qg, k_eff[:, r * chunk:(r + 1) * chunk], v_eff[:, r * chunk:(r + 1) * chunk],
        eff_local[r], scale=1.0, window=win, impl=impl) for r in range(nm)]
    # combine the shards' softmax partials (the reference's pmax / psum), shard axis first
    acc_g, _, l_g = combine_partials(*(torch.stack(t) for t in zip(*parts, strict=True)))
    o = (acc_g / torch.clamp(l_g[..., None], min=1e-30)).to(x.dtype)
    return o.reshape(b, 1, H * hd) @ p["wo"]


def _attn_decode_dist(p: dict, x: torch.Tensor, k_cache, v_cache, lengths: torch.Tensor,
                      cfg: ModelConfig, mesh_info, *, impl: str,
                      active: Optional[torch.Tensor]) -> torch.Tensor:
    """The shard_map body of the JAX package's ``attn_decode_sharded`` on
    this rank of a DistMesh: the new row is written only where this rank's
    slice holds its slot (``in_rng``, and for active rows), the partials
    kernel runs once over the slice, and the partials are combined by a
    pmax of m and psums of l and acc, each weighted by exp(m - pmax m), over
    the model axis: every rank of the axis ends with the same output."""
    b = x.shape[0]
    mesh, ma = mesh_info.mesh, mesh_info.model_axis
    quant = cfg.kv_cache_dtype == "int8"
    chunk = _cache_smax(k_cache)
    hd, H = cfg.resolved_head_dim, cfg.eff_n_heads
    q, k_new, v_new = _roped_decode_qkv(p, x, lengths, cfg)
    qg = (q.float() * cfg.attn_scale).contiguous()
    slot, eff_len, win = _decode_plan(cfg, lengths, chunk * mesh_info.n_model)
    off = mesh.axis_index(ma) * chunk
    in_rng = (slot >= off) & (slot < off + chunk)
    write = in_rng if active is None else in_rng & active
    index = (torch.arange(b, device=x.device), torch.clamp(slot - off, 0, chunk - 1))
    _append(k_cache, v_cache, k_new, v_new, index, write)
    k_eff, v_eff = k_cache, v_cache
    if quant:
        k_eff, v_eff = kv_dequantize(*k_cache, x.dtype), kv_dequantize(*v_cache, x.dtype)
    acc, m, l = ops.decode_attention_partials(
        qg, k_eff, v_eff, torch.clamp(eff_len - off, 0, chunk), scale=1.0, window=win,
        impl=impl)
    m_g = mesh.pmax(m, ma)
    coef = torch.where(torch.isfinite(m), torch.exp(m - m_g), 0.0)
    l_g = mesh.psum(l * coef, ma)
    acc_g = mesh.psum(acc * coef[..., None], ma)
    o = (acc_g / torch.clamp(l_g[..., None], min=1e-30)).to(x.dtype)
    return o.reshape(b, 1, H * hd) @ p["wo"]


def _attn_decode_dtensor(p: dict, x: DTensor, k_cache, v_cache, lengths, cfg: ModelConfig,
                         mesh_info, *, impl: str, active: Optional[torch.Tensor]) -> DTensor:
    """The JAX package's ``attn_decode_sharded`` on DTensors (the dry-run):
    the projections and ``wo`` as their layouts propagate; the caches laid
    out as its shard_map takes them, sequence over the model axis and rows
    over the batch axes where the batch divides (a cache held kv-head
    sharded is resharded, and written back after the step, as the step's
    out_shardings do); then :func:`_attn_decode_dist`'s body on this rank's
    blocks, the partials combined over the model axis."""
    b = x.shape[0]
    quant = cfg.kv_cache_dtype == "int8"
    hd, H = cfg.resolved_head_dim, cfg.eff_n_heads
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    ma = names.index(mesh_info.model_axis)
    shardable = b % mesh_info.n_batch == 0 and b >= mesh_info.n_batch
    rows = [Shard(0) if shardable and n in mesh_info.batch_axes else Replicate()
            for n in names]
    seq = [Shard(1) if i == ma else pl for i, pl in enumerate(rows)]

    def laid_out(c):
        return tuple(map(laid_out, c)) if isinstance(c, tuple) else c.redistribute(mesh, seq)

    kc, vc = laid_out(k_cache), laid_out(v_cache)
    q, k_new, v_new = _roped_decode_qkv(p, x, lengths, cfg)
    qg = (q.float() * cfg.attn_scale).redistribute(mesh, rows).to_local().contiguous()
    slot, eff_len, win = _decode_plan(cfg, lengths, _cache_smax(kc))
    _append(kc, vc, k_new, v_new, (None, slot), active)
    k_eff, v_eff = (tuple(t.to_local() for t in c) if quant else c.to_local()
                    for c in (kc, vc))
    if quant:
        k_eff, v_eff = kv_dequantize(*k_eff, x.dtype), kv_dequantize(*v_eff, x.dtype)
    chunk = k_eff.shape[1]
    off = mesh.get_local_rank(ma) * chunk
    eff = eff_len.redistribute(mesh, rows).to_local()
    acc, m, l = ops.decode_attention_partials(qg, k_eff, v_eff, torch.clamp(eff - off, 0, chunk),
                                              scale=1.0, window=win, impl=impl)

    def combined(t, op):
        return from_block(t, mesh, rows, {ma: op}).to_local()

    m_g = combined(m, "max")
    coef = torch.where(torch.isfinite(m), torch.exp(m - m_g), 0.0)
    l_g, acc_g = combined(l * coef, "sum"), combined(acc * coef[..., None], "sum")
    o = (acc_g / torch.clamp(l_g[..., None], min=1e-30)).to(x.dtype)
    for whole, part in ((k_cache, kc), (v_cache, vc)):
        for w, t in zip(*((whole, part) if quant else ((whole,), (part,))), strict=True):
            if w is not t:
                w.copy_(t)
    o = DTensor.from_local(o.reshape(o.shape[0], 1, H * hd), mesh, rows, run_check=False)
    return reduce_partial(o @ p["wo"])


def attn_decode_dispatch(p: dict, x: torch.Tensor, k_cache, v_cache, lengths: torch.Tensor,
                         cfg: ModelConfig, mesh_info, *, impl: str,
                         active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The sharded split-KV path when enabled and applicable (the JAX
    package's condition), else :func:`attn_decode`. Under a DistMesh the
    cache is this rank's slice whenever :func:`seq_sharded` held for it."""
    if on_ranks(mesh_info):
        sharded = cfg.sharded_decode_attn and mesh_info.n_model > 1
    else:
        sharded = seq_sharded(cfg, mesh_info, _cache_smax(k_cache))
    if sharded:
        return attn_decode_sharded(p, x, k_cache, v_cache, lengths, cfg, mesh_info,
                                   impl=impl, active=active)
    return attn_decode(p, x, k_cache, v_cache, lengths, cfg, impl=impl, active=active)


def seq_sharded(cfg: ModelConfig, mesh_info, smax: int) -> bool:
    """Whether a decode over a cache of ``smax`` rows runs sequence-sharded
    under ``mesh_info`` (the JAX package's condition). Under a DistMesh each
    rank then holds Smax / n_model rows of every K/V cache; an Smax that
    does not divide is refused there (a rank's slice would not say which
    layout it is in)."""
    if not (cfg.sharded_decode_attn and mesh_info is not None and mesh_info.n_model > 1):
        return False
    if smax % mesh_info.n_model == 0:
        return True
    if on_ranks(mesh_info):
        raise ValueError(f"the sequence-sharded decode over {mesh_info.n_model} ranks needs a "
                         f"cache of a multiple of {mesh_info.n_model} rows, not {smax}")
    return False
