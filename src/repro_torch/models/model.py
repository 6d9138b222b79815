"""Top-level model: init / full-sequence forward / prefill / decode.

Ported: every family of the JAX package: dense, MoE, SSM (Mamba2), hybrid
(zamba2: Mamba2 + shared attention), and the vlm and audio backbones with
their embedding frontends, with or without head padding, with a bf16 or an
int8 KV cache, on one device or over a mesh.

Design notes
------------
* **per-layer weights**: ``params["blocks"]`` is a list of one dict per
  layer (JAX stacks them on a leading L axis for ``lax.scan``); the forward
  is a Python loop over layers. :func:`params_from_numpy` splits the
  stacked arrays.
* **hybrid**: G groups of ``attn_every`` Mamba2 layers, each group followed
  by ONE shared attention block (``params["shared_attn"]``, the same
  weights every time, fresh K/V per application), then a tail of
  ``n_layers % attn_every`` Mamba2 layers (:func:`hybrid_split`). The
  Mamba2 layers are the SSM family's, in the same loop. With
  ``cfg.hybrid_sites`` the order is Zamba2's: before the Mamba2 of each of
  those G layers (site k), shared block k % ``n_shared_blocks``
  (``params["shared_blocks"]``: attention, then a gated-GELU MLP) reads
  ``concat(h, e)``, e the embeddings carried beside h; the site's own LoRA
  and projection (``params["sites"][k]``) finish it, and its output t
  enters that layer as ``h + Mamba2(RMSNorm(h + t))`` (:func:`_shared_block`,
  one device only). Site k's K/V go to the cache's G axis at k. With
  recording on (``repro_torch.obs``) each such call on the eager paths is a
  ``model.shared_block`` span (site, block, tokens).
* **weights are (in, out)** and applied as ``x @ w``, as in the JAX package.
* **MoE**: a block's ``moe`` (router f32, experts stacked on a leading E
  axis) takes the place of ``mlp``; :func:`forward` returns the layers'
  mean load-balance loss as its aux scalar, as the JAX package does.
* **frontends** (vlm, audio): a prefill or forward given ``batch["embeds"]``
  (B,S,D) embeds it through ``params["frontend_proj"]`` (D,D); decode embeds
  token ids from ``embed`` in every family, as the JAX package does.
* **caches** keep the JAX package's layouts: ``k``/``v`` ``(L, B, Smax, KV,
  hd)`` for the dense family (with ``kv_cache_dtype="int8"``, each a pair
  of int8 values ``(L, B, Smax, KV, hd)`` and f32 scales ``(L, B, Smax,
  KV)``), ``ssm_state`` = (conv_x, conv_B, conv_C, ssm) stacked on a
  leading L axis for the SSM family, both for the hybrid family (its
  ``k``/``v`` are ``(G, B, max_len, KV, hd)``, one per application of the
  shared block; with an int8 cache, pairs on the same G axis, the layout
  the JAX package's hybrid prefill returns, where its ``init_cache``
  allocates plain ``cfg.dtype`` arrays), plus ``lengths`` (B,) int32.
  :func:`decode_step` updates them in place.
* **meshes**: :class:`MeshContext` describes a mesh (:func:`mesh_context`).
  Over a ``launch.mesh.LocalMesh`` (shards held by this process on one
  device) a decode step with ``cfg.sharded_decode_attn`` cuts each layer's
  cache into ``n_model`` shards (``attention.attn_decode_dispatch``), and
  an MoE block runs all its experts at once (what its shards sum to).
  Over a ``launch.mesh.DistMesh`` (one rank a process) every entry point is
  the JAX package's ``shard_map`` body on this rank: it takes this rank's
  rows of the batch (the caller picks them, and sharding the batch over
  the data axes is the caller's choice) and this rank's block of the params
  (``launch.shardings.shard_tree``) and of the cache, and returns this
  rank's rows. The cache's K/V hold Smax / n_model rows a rank where the
  decode runs sequence-sharded (``attention.seq_sharded``); an MoE block
  holds E / n_model experts a rank, or every expert's d_ff / n_model
  (``moe.moe_forward``). After their collectives the model axis's ranks
  hold the same logits. On DTensors over a ``DeviceMesh`` (the dry-run,
  ``launch.dryrun``) every entry point runs the program GSPMD makes of the
  JAX package's jit, DTensor propagating the layouts, with the reshards
  GSPMD makes silently made explicit (``common``'s helpers, the blocks'
  ``*_dtensor`` paths, :func:`_embed_tokens`, :func:`_dtensor_cache`;
  README lists them), and ``cfg.fsdp_act_constraint`` pins the residual
  stream batch-sharded over every mesh axis (:func:`_act_constraint`). A
  plain tensor takes none of these branches.
* entry points default to ``device="cuda"``; nothing moves to the CPU
  unless the caller asks for it.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import mesh_axes, mesh_counts, on_ranks
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (dense_init, embed_init, reduce_partial, reduced_grad,
                                       rms_norm)

_IMPLS = {"auto": "auto", "pallas": "kernel", "ref": "ref"}


class MeshContext(NamedTuple):
    """The JAX package's ``MeshContext`` (``moe.MoEMeshInfo``)."""
    mesh: object                 # launch.mesh.LocalMesh or launch.mesh.DistMesh
    batch_axes: tuple            # e.g. ('data',)
    model_axis: str              # 'model'
    n_model: int
    n_batch: int


def mesh_context(mesh) -> MeshContext:
    """The MeshContext of a LocalMesh or a DistMesh."""
    n_batch, n_model = mesh_counts(mesh)
    return MeshContext(mesh, *mesh_axes(mesh), n_model, n_batch)


_F32_PARAMS = ssm_mod.F32_PARAMS + moe_mod.F32_PARAMS


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "vlm", "audio", "moe", "ssm", "hybrid"):
        raise ValueError(f"unknown family {cfg.family!r}")


def hybrid_split(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_groups, layers_per_group, n_tail) of a hybrid config."""
    g = cfg.n_layers // cfg.attn_every
    return g, cfg.attn_every, cfg.n_layers - g * cfg.attn_every


def _shared_attn_index(cfg: ModelConfig, i: int) -> Optional[int]:
    """In a hybrid, which application of the shared attention block follows
    Mamba2 layer i (the last of each group of ``attn_every``; the tail has
    none; none in the Zamba2 order), else None."""
    if cfg.family != "hybrid" or cfg.hybrid_sites is not None or (i + 1) % cfg.attn_every:
        return None
    return (i + 1) // cfg.attn_every - 1


def _sites(cfg: ModelConfig) -> Dict[int, int]:
    """In the Zamba2 order, {layer: site} of the layers a shared block
    feeds; else empty."""
    return {i: k for k, i in enumerate(cfg.hybrid_sites or ())}


def _shared_block(params, cfg: ModelConfig, k: int, h: torch.Tensor, e: torch.Tensor,
                  attn) -> torch.Tensor:
    """Site k's output t: shared block k % n_shared_blocks on concat(h, e),
    RMSNorm, attention (``attn(p, x)``, the forward's, prefill's or
    decode's, which fills the cache where it has one), RMSNorm, the gated
    GELU MLP with the site's LoRA, then the site's projection. The block
    keeps no residual of its own."""
    b = k % cfg.n_shared_blocks
    with _span(k, b, h):
        blk, site = params["shared_blocks"][b], params["sites"][k]
        a = attn(blk["attn"], rms_norm(torch.cat([h, e], dim=-1), blk["ln1"], cfg.norm_eps))
        y = mlp_mod.gelu_mlp_forward(blk["mlp"], rms_norm(a, blk["ln2"], cfg.norm_eps), site)
        return y @ site["proj"]


def _span(k: int, b: int, h: torch.Tensor):
    """``model.shared_block`` while recording, outside a graph capture
    (replays run no Python, so they record nothing)."""
    if not obs.recording() or (h.is_cuda and torch.cuda.is_current_stream_capturing()):
        return contextlib.nullcontext()
    return obs.span("model.shared_block", site=k, block=b, tokens=h.shape[0] * h.shape[1])


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ======================================================================
# Init and the numpy weight bridge
# ======================================================================

def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Dict[str, Any]:
    """Random weights: truncated-normal fan-in for matrices, normal(0.02) for
    the embedding and LM head, ones for norms, zeros for QKV biases. Drawn
    from ``generator`` (a seed-0 generator on ``device`` if None). On the
    meta device the leaves have shapes and dtypes and no values, and
    nothing is drawn (``launch.input_specs``)."""
    _check_family(cfg)
    device = torch.device(device)
    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device).manual_seed(0)
    dtype = _dtype(cfg)
    D, Vp = cfg.d_model, cfg.padded_vocab
    params: Dict[str, Any] = {
        "embed": embed_init(generator, (Vp, D), dtype=dtype, device=device),
        "final_norm": torch.ones((D,), dtype=dtype, device=device),
        "lm_head": embed_init(generator, (D, Vp), dtype=dtype, device=device),
        "blocks": [],
    }
    if cfg.frontend != "tokens":
        params["frontend_proj"] = embed_init(generator, (D, D), dtype=dtype, device=device)
    for _ in range(cfg.n_layers):
        if cfg.family in ("ssm", "hybrid"):
            params["blocks"].append({
                "ln": torch.ones((D,), dtype=dtype, device=device),
                "ssm": ssm_mod.init_ssm_params(generator, cfg, dtype, device),
            })
            continue
        blk = {
            "ln1": torch.ones((D,), dtype=dtype, device=device),
            "ln2": torch.ones((D,), dtype=dtype, device=device),
            "attn": attn_mod.init_attn_params(generator, cfg, dtype, device),
        }
        if cfg.family == "moe":
            blk["moe"] = moe_mod.init_moe_params(generator, cfg, dtype, device)
        else:
            blk["mlp"] = mlp_mod.init_mlp_params(generator, cfg, dtype, device)
        params["blocks"].append(blk)
    if cfg.family == "hybrid" and cfg.hybrid_sites is None:
        params["shared_attn"] = {
            "ln": torch.ones((D,), dtype=dtype, device=device),
            "attn": attn_mod.init_attn_params(generator, cfg, dtype, device),
        }
    elif cfg.family == "hybrid":
        W, Fs, r = 2 * D, cfg.d_ff, cfg.shared_lora_rank
        params["shared_blocks"] = [{
            "ln1": torch.ones((W,), dtype=dtype, device=device),
            "attn": attn_mod.init_attn_params(generator, cfg, dtype, device, d_in=W),
            "ln2": torch.ones((D,), dtype=dtype, device=device),
            "mlp": mlp_mod.init_gelu_mlp_params(generator, D, Fs, dtype, device),
        } for _ in range(cfg.n_shared_blocks)]
        params["sites"] = [{
            "lora_a": dense_init(generator, (D, r), dtype=dtype, device=device),
            "lora_b": dense_init(generator, (r, 2 * Fs), dtype=dtype, device=device),
            "proj": dense_init(generator, (D, D), dtype=dtype, device=device),
        } for _ in cfg.hybrid_sites]
    return params


def _from_numpy(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.array(a, order="C")            # a writable copy the tensor may own
    if a.dtype.name == "bfloat16":        # ml_dtypes' bfloat16: reinterpret the bits
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def params_from_numpy(np_params: Mapping[str, Any], cfg: ModelConfig,
                      device="cuda") -> Dict[str, Any]:
    """Convert the JAX package's params pytree, given as nested dicts of numpy
    arrays (blocks stacked on axis 0, weights (in, out)), into this package's
    parameters on ``device``: ``A_log``, ``D``, ``dt_bias`` and an MoE
    ``router`` in float32, as the JAX package keeps them, every other leaf in
    ``cfg.dtype``. A hybrid's ``shared_attn`` is one block, not stacked, and
    converts whole. Padded heads arrive padded."""
    _check_family(cfg)
    dtype = _dtype(cfg)

    def conv(tree, index=None, name=None):
        if isinstance(tree, Mapping):
            return {k: conv(v, index, k) for k, v in tree.items()}
        a = np.asarray(tree)
        leaf_dtype = torch.float32 if name in _F32_PARAMS else dtype
        return _from_numpy(a if index is None else a[index], leaf_dtype, device)

    params = {k: conv(v, name=k) for k, v in np_params.items() if k != "blocks"}
    params["blocks"] = [conv(np_params["blocks"], i) for i in range(cfg.n_layers)]
    return params


# ======================================================================
# Embedding / head
# ======================================================================

def embed_inputs(params, cfg: ModelConfig, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """batch has 'tokens' (B,S) integer ids or 'embeds' (B,S,D) frontend
    embeddings (patches or frames), which go through ``frontend_proj``."""
    if "embeds" in batch:
        return batch["embeds"].to(_dtype(cfg)) @ params["frontend_proj"]
    return _embed_tokens(params, batch["tokens"])


def _embed_tokens(params, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens``. A DTensor table (the dry-run's,
    vocab-sharded over the model axis) is read by a vocab-parallel lookup,
    each rank's rows of its own vocab range summed over the axis, as GSPMD
    partitions the JAX package's gather; DTensor would otherwise reshard
    the table and hand back rows split over their features."""
    if isinstance(params["embed"], DTensor):
        return reduced_grad(reduce_partial(torch.nn.functional.embedding(tokens, params["embed"])))
    return params["embed"][tokens]


def lm_logits(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head; padded vocab tail masked to -1e30.  fp32 out."""
    h = reduced_grad(rms_norm(h, params["final_norm"], cfg.norm_eps))
    logits = (h @ params["lm_head"]).float()
    if cfg.padded_vocab != cfg.vocab_size:
        mask = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab_size
        logits = torch.where(mask, logits, -1e30)
    return logits


# ======================================================================
# Full-sequence forward
# ======================================================================

def _ffn(blk, h: torch.Tensor, cfg: ModelConfig, mesh_info: Optional[MeshContext]):
    """The block's MLP or MoE on the normed residual: (out, load-balance
    loss or None)."""
    x = rms_norm(h, blk["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        y, aux = moe_mod.moe_forward(blk["moe"], x, cfg, mesh_info)
        return y, aux["lb_loss"]
    return mlp_mod.mlp_forward(blk["mlp"], x), None


def _remat(cfg: ModelConfig, fn, *args):
    """fn(*args), its activations recomputed in the backward pass under
    ``cfg.remat`` (``jax.checkpoint`` in the JAX package) while autograd
    records; a plain call otherwise."""
    if cfg.remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _act_constraint(h: torch.Tensor, cfg: ModelConfig, mesh_info: Optional[MeshContext]
                    ) -> torch.Tensor:
    """FSDP mode (``cfg.fsdp_act_constraint``): a DTensor residual stream
    redistributed batch-sharded over every mesh axis that divides it
    (``launch.shardings.fsdp_batch_axes``), so that the weights are
    gathered and the activations stay put, as the JAX package's sharding
    constraint makes GSPMD do. A plain tensor passes unchanged: under a
    DistMesh each rank already holds its rows."""
    if not (cfg.fsdp_act_constraint and mesh_info is not None and isinstance(h, DTensor)):
        return h
    from repro_torch.launch.shardings import P, fsdp_batch_axes, to_placements

    axes = fsdp_batch_axes(mesh_info.mesh, h.shape[0])
    return h.redistribute(h.device_mesh, to_placements(P(axes, None, None), mesh_info.mesh))


def forward(params, cfg: ModelConfig, batch: Mapping[str, torch.Tensor],
            mesh_info: Optional[MeshContext] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits (B,S,Vp) fp32, aux_loss
    scalar: the mean load-balance loss over the layers for MoE, else 0).
    Under ``cfg.remat`` each block (each Mamba2 layer of a hybrid, whose
    shared attention is not) is recomputed in the backward pass, as the JAX
    package checkpoints the body of its layer scan. Only the MoE blocks and,
    on DTensors, the FSDP constraint (:func:`_act_constraint`) read
    ``mesh_info``."""
    _check_family(cfg)
    impl = _IMPLS[cfg.attn_impl]
    h = _act_constraint(embed_inputs(params, cfg, batch), cfg, mesh_info)
    if cfg.family in ("ssm", "hybrid"):
        def ssm_block(blk, h, x):
            h = _act_constraint(h, cfg, mesh_info)
            return h + ssm_mod.ssm_forward(blk["ssm"], rms_norm(x, blk["ln"], cfg.norm_eps), cfg,
                                           impl=impl)

        def attn(p, x):
            return attn_mod.attn_forward(p, x, cfg, impl=impl)

        e, sites = h, _sites(cfg)
        for i, blk in enumerate(params["blocks"]):
            k = sites.get(i)
            x = h if k is None else h + _shared_block(params, cfg, k, h, e, attn)
            h = _remat(cfg, ssm_block, blk, h, x)
            if _shared_attn_index(cfg, i) is not None:
                shared = params["shared_attn"]
                h = h + attn_mod.attn_forward(shared["attn"],
                                              rms_norm(h, shared["ln"], cfg.norm_eps), cfg,
                                              impl=impl)
        return lm_logits(params, cfg, h), torch.zeros((), device=h.device)

    def attn_block(blk, h):
        h = _act_constraint(h, cfg, mesh_info)
        h = h + attn_mod.attn_forward(blk["attn"], rms_norm(h, blk["ln1"], cfg.norm_eps),
                                      cfg, impl=impl)
        y, lb_i = _ffn(blk, h, cfg, mesh_info)
        return _act_constraint(h + y, cfg, mesh_info), lb_i

    lb = torch.zeros((), device=h.device)
    for blk in params["blocks"]:
        h, lb_i = _remat(cfg, attn_block, blk, h)
        if lb_i is not None:
            lb = lb + lb_i
    return lm_logits(params, cfg, h), lb / cfg.n_layers


# ======================================================================
# Cache init / prefill / decode
# ======================================================================

def _kv_smax(cfg: ModelConfig, max_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(max_len, cfg.sliding_window)
    return max_len


def _seq_rows(cfg: ModelConfig, mesh_info: Optional[MeshContext], smax: int) -> slice:
    """The rows of a K/V cache of ``smax`` rows that this rank holds: its
    slice of Smax / n_model under a DistMesh whose decode runs
    sequence-sharded, else all."""
    if not (on_ranks(mesh_info) and attn_mod.seq_sharded(cfg, mesh_info, smax)):
        return slice(None)
    chunk = smax // mesh_info.n_model
    off = mesh_info.mesh.axis_index(mesh_info.model_axis) * chunk
    return slice(off, off + chunk)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda",
               mesh_info: Optional[MeshContext] = None) -> Dict[str, Any]:
    """An empty cache of ``batch`` rows; under a DistMesh this rank's
    block (:func:`_seq_rows`)."""
    _check_family(cfg)
    lengths = torch.zeros((batch,), dtype=torch.int32, device=device)
    KV, hd = cfg.eff_n_kv_heads, cfg.resolved_head_dim

    def leaf(n, smax):
        shape = (n, batch, len(range(smax)[_seq_rows(cfg, mesh_info, smax)]), KV, hd)
        if cfg.kv_cache_dtype == "int8":
            return (torch.zeros(shape, dtype=torch.int8, device=device),
                    torch.zeros(shape[:-1], dtype=torch.float32, device=device))
        return torch.zeros(shape, dtype=_dtype(cfg), device=device)

    if cfg.family in ("ssm", "hybrid"):
        st = ssm_mod.init_ssm_state(cfg, batch, _dtype(cfg), device)
        cache = {"lengths": lengths,
                 "ssm_state": tuple(a.expand(cfg.n_layers, *a.shape).clone() for a in st)}
        if cfg.family == "hybrid":   # max_len rows, as in the JAX package, window or not
            g = hybrid_split(cfg)[0]
            cache["k"], cache["v"] = leaf(g, max_len), leaf(g, max_len)
        return cache
    smax = _kv_smax(cfg, max_len)
    return {"lengths": lengths, "k": leaf(cfg.n_layers, smax), "v": leaf(cfg.n_layers, smax)}


def _dtensor_cache(cfg: ModelConfig, batch: int, max_len: int, mesh_info: MeshContext):
    """An empty cache of meta DTensors laid out on ``mesh_info``'s
    ``DeviceMesh`` by ``launch.shardings.cache_specs``, the out_shardings
    of the JAX package's prefill in the dry-run."""
    from repro_torch.launch import shardings

    mesh = mesh_info.mesh
    return shardings.distribute_tree(init_cache(cfg, batch, max_len, device="meta"),
                                     shardings.cache_specs(cfg, mesh, batch, max_len), mesh)


def _empty_cache(cfg: ModelConfig, h: torch.Tensor, max_len: int,
                 mesh_info: Optional[MeshContext]) -> Dict[str, Any]:
    """The cache a prefill of ``h`` (B, S, D) fills: meta DTensors laid out
    on the mesh (:func:`_dtensor_cache`) for a DTensor ``h``, else
    :func:`init_cache` on ``h``'s device."""
    if isinstance(h, DTensor):
        return _dtensor_cache(cfg, h.shape[0], max_len, mesh_info)
    return init_cache(cfg, h.shape[0], max_len, device=h.device, mesh_info=mesh_info)


def _layer(leaf, i: int):
    """Layer (or group) i of a K or V cache leaf: a tensor, or an int8
    (values, scales) pair."""
    return tuple(a[i] for a in leaf) if isinstance(leaf, tuple) else leaf[i]


def _fill(leaf, i: int, new, rows: slice) -> None:
    """Write ``new``'s ``rows`` (attn_prefill's (B, smax, ...) K or V) into
    layer (or group) i of a cache leaf: a tensor, or an int8 pair."""
    if isinstance(leaf, tuple):
        for dst, src in zip(leaf, new, strict=True):
            dst[i] = src[:, rows]
    else:
        leaf[i] = new[:, rows]


def prefill(params, cfg: ModelConfig, batch: Mapping[str, torch.Tensor], max_len: int,
            mesh_info: Optional[MeshContext] = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the prompt (``batch`` as :func:`embed_inputs` takes it); returns
    (last-position logits (B,Vp), filled cache). Under a DistMesh the cache
    is this rank's block (:func:`_seq_rows`); the MoE blocks read
    ``mesh_info`` too."""
    _check_family(cfg)
    impl = _IMPLS[cfg.attn_impl]
    h = embed_inputs(params, cfg, batch)
    b, s, _ = h.shape
    if cfg.family in ("ssm", "hybrid"):
        # a hybrid's K/V of max_len rows, as the JAX package's prefill has
        cache = _empty_cache(cfg, h, max_len, mesh_info) if cfg.family == "hybrid" else {}
        rows = _seq_rows(cfg, mesh_info, max_len)
        states = []
        e, sites = h, _sites(cfg)
        for i, blk in enumerate(params["blocks"]):
            x = h
            k = sites.get(i)
            if k is not None:
                def attn(p, x, k=k):
                    o, kc, vc = attn_mod.attn_prefill(p, x, cfg, max_len, impl=impl)
                    _fill(cache["k"], k, kc, rows)
                    _fill(cache["v"], k, vc, rows)
                    return o

                x = h + _shared_block(params, cfg, k, h, e, attn)
            x = rms_norm(x, blk["ln"], cfg.norm_eps)
            o, st = ssm_mod.ssm_forward(blk["ssm"], x, cfg, impl=impl, return_state=True)
            h = h + o
            states.append(st)
            gi = _shared_attn_index(cfg, i)
            if gi is not None:
                shared = params["shared_attn"]
                x = rms_norm(h, shared["ln"], cfg.norm_eps)
                o, kc, vc = attn_mod.attn_prefill(shared["attn"], x, cfg, max_len, impl=impl)
                h = h + o
                _fill(cache["k"], gi, kc, rows)
                _fill(cache["v"], gi, vc, rows)
        cache["lengths"] = torch.full((b,), s, dtype=torch.int32, device=h.device)
        cache["ssm_state"] = tuple(torch.stack(leaf) for leaf in zip(*states))
        return lm_logits(params, cfg, h[:, -1]), cache
    cache = _empty_cache(cfg, h, max_len, mesh_info)
    cache["lengths"].fill_(s)
    smax = _kv_smax(cfg, max_len)
    rows = _seq_rows(cfg, mesh_info, smax)
    for i, blk in enumerate(params["blocks"]):
        x = rms_norm(h, blk["ln1"], cfg.norm_eps)
        o, kc, vc = attn_mod.attn_prefill(blk["attn"], x, cfg, smax, impl=impl)
        _fill(cache["k"], i, kc, rows)
        _fill(cache["v"], i, vc, rows)
        h = h + o
        h = h + _ffn(blk, h, cfg, mesh_info)[0]
    return lm_logits(params, cfg, h[:, -1]), cache


def decode_step(params, cfg: ModelConfig, cache: Dict[str, Any], tokens: torch.Tensor,
                active: Optional[torch.Tensor] = None,
                mesh_info: Optional[MeshContext] = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step.  tokens (B,) -> (logits (B,Vp) fp32, new cache).

    The new cache shares ``cache``'s K/V or state tensors, which are
    updated in place: K/V rows at each length, every layer's conv and SSM
    states. With the bool mask ``active`` (B,), inactive sequences keep
    their rows, their states and their lengths. With ``mesh_info`` and
    ``cfg.sharded_decode_attn``, attention (a hybrid's shared block too)
    runs sequence-sharded. An MoE block routes all B rows, active or not,
    as the JAX package does."""
    _check_family(cfg)
    impl = _IMPLS[cfg.attn_impl]
    lengths = cache["lengths"]
    step = 1 if active is None else active.to(torch.int32)
    h = _embed_tokens(params, tokens)[:, None, :]       # (B,1,D)
    if cfg.family in ("ssm", "hybrid"):
        states = cache["ssm_state"]
        e, sites = h, _sites(cfg)
        for i, blk in enumerate(params["blocks"]):
            x = h
            k = sites.get(i)
            if k is not None:
                def attn(p, x, k=k):
                    return attn_mod.attn_decode_dispatch(
                        p, x, _layer(cache["k"], k), _layer(cache["v"], k), lengths, cfg,
                        mesh_info, impl=impl, active=active)

                x = h + _shared_block(params, cfg, k, h, e, attn)
            x = rms_norm(x, blk["ln"], cfg.norm_eps)
            o, new = ssm_mod.ssm_decode(blk["ssm"], x, tuple(a[i] for a in states), cfg)
            h = h + o
            for a, st in zip(states, new, strict=True):
                if active is not None:
                    keep = active.view(-1, *([1] * (st.dim() - 1)))
                    st = torch.where(keep, st, a[i])
                a[i].copy_(st)
            gi = _shared_attn_index(cfg, i)
            if gi is not None:
                shared = params["shared_attn"]
                h = h + attn_mod.attn_decode_dispatch(
                    shared["attn"], rms_norm(h, shared["ln"], cfg.norm_eps),
                    _layer(cache["k"], gi), _layer(cache["v"], gi), lengths, cfg, mesh_info,
                    impl=impl, active=active)
        return lm_logits(params, cfg, h[:, 0]), dict(cache, lengths=lengths + step)
    for i, blk in enumerate(params["blocks"]):
        x = rms_norm(h, blk["ln1"], cfg.norm_eps)
        h = h + attn_mod.attn_decode_dispatch(
            blk["attn"], x, _layer(cache["k"], i), _layer(cache["v"], i), lengths, cfg,
            mesh_info, impl=impl, active=active)
        h = h + _ffn(blk, h, cfg, mesh_info)[0]
    new_cache = {"lengths": lengths + step, "k": cache["k"], "v": cache["v"]}
    return lm_logits(params, cfg, h[:, 0]), new_cache
