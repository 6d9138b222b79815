"""Mamba2 (SSD) block: init + full-sequence/prefill/decode application.

The layout of ``repro.models.ssm``: the input projections stay split
(w_z, w_x, w_B, w_C, w_dt), weights are (in, out) and applied as
``x @ w``, and ``A_log``, ``D`` and ``dt_bias`` are float32 whatever the
config's dtype.

  z  = h @ w_z                       (B,S,di)
  x  = silu(conv_x(h @ w_x))         (B,S,di)
  Bm = silu(conv_B(h @ w_B))         (B,S,G·N)
  Cm = silu(conv_C(h @ w_C))         (B,S,G·N)
  dt = softplus(h @ w_dt + bias)     (B,S,nh)   fp32
  y  = SSD(x, dt, A, Bm, Cm, D)      (ops.ssd_scan: on the card the SSD kernel,
                                      and under autograd its backward too)
  out = RMSNorm(y ⊙ silu(z)) @ w_out  (the norm per group of d_inner / G)

A layer's state is the tuple (conv_x, conv_B, conv_C, ssm): the last K-1
raw conv inputs (B,K-1,C) in the config's dtype, and the SSM state
(B,nh,P,N) in float32.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import (blocks, dense_init, kept_shards, reduce_partial,
                                       reduced_grad, rms_norm)

F32_PARAMS = ("A_log", "D", "dt_bias")  # float32 in every config, as in the JAX package


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    gn = s.n_groups * s.d_state
    return s, di, nh, gn


def init_ssm_params(generator: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
                    device) -> dict:
    """Random weights with the JAX package's distributions: truncated-normal
    fan-in matrices and conv kernels, dt drawn log-uniform in [dt_min, dt_max]
    and stored as its inverse softplus, A = -U[1, 16]."""
    s, di, nh, gn = _dims(cfg)
    D = cfg.d_model

    def uniform(lo, hi):
        u = torch.empty((nh,), dtype=torch.float32, device=device)
        return u.uniform_(lo, hi, generator=generator)

    dt = torch.exp(uniform(math.log(s.dt_min), math.log(s.dt_max)))
    return {
        "w_z": dense_init(generator, (D, di), dtype=dtype, device=device),
        "w_x": dense_init(generator, (D, di), dtype=dtype, device=device),
        "w_B": dense_init(generator, (D, gn), dtype=dtype, device=device),
        "w_C": dense_init(generator, (D, gn), dtype=dtype, device=device),
        "w_dt": dense_init(generator, (D, nh), dtype=dtype, device=device),
        "conv_x_w": dense_init(generator, (s.d_conv, di), dtype=dtype, device=device),
        "conv_x_b": torch.zeros((di,), dtype=dtype, device=device),
        "conv_B_w": dense_init(generator, (s.d_conv, gn), dtype=dtype, device=device),
        "conv_B_b": torch.zeros((gn,), dtype=dtype, device=device),
        "conv_C_w": dense_init(generator, (s.d_conv, gn), dtype=dtype, device=device),
        "conv_C_b": torch.zeros((gn,), dtype=dtype, device=device),
        "A_log": torch.log(uniform(1.0, 16.0)),
        "D": torch.ones((nh,), dtype=torch.float32, device=device),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),     # inverse softplus
        "norm_w": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": dense_init(generator, (di, D), dtype=dtype, device=device),
    }


def _causal_conv(xc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d + SiLU, window K.  xc (B,S,C); state (B,K-1,C)
    carries trailing raw inputs of the previous segment."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((xc.shape[0], k - 1, xc.shape[2]), dtype=xc.dtype, device=xc.device)
    else:
        pad = state.to(xc.dtype)
    xp = torch.cat([pad, xc], dim=1)                  # (B, S+K-1, C)
    out = sum(xp[:, i:i + xc.shape[1]] * w[i] for i in range(k)) + b
    return F.silu(out), xp[:, xc.shape[1]:]           # last K-1 raw inputs


def _conv_step(x_t: torch.Tensor, w: torch.Tensor, b: torch.Tensor, state: torch.Tensor):
    """One-token conv update.  x_t (B,C), state (B,K-1,C)."""
    k = w.shape[0]
    window = torch.cat([state.to(x_t.dtype), x_t[:, None]], dim=1)   # (B,K,C)
    out = sum(window[:, i] * w[i] for i in range(k)) + b
    return F.silu(out), window[:, 1:]


def _gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """RMSNorm(y ⊙ silu(z)) taken per group of d_inner / n_groups, as Mamba2
    and Zamba2 normalise it; one group is the norm over d_inner, as before."""
    u = y * F.silu(z)
    g = cfg.ssm.n_groups
    if g == 1:
        return rms_norm(u, w, cfg.norm_eps)
    shape = u.shape
    return rms_norm(u.reshape(*shape[:-1], g, shape[-1] // g), w.reshape(g, -1),
                    cfg.norm_eps).reshape(shape)


def _dt(p: dict, h: torch.Tensor) -> torch.Tensor:
    return F.softplus((h @ p["w_dt"]).float() + p["dt_bias"])


def _ssd(x, dt, A, Bm, Cm, D, h0, s, impl: str):
    """``ops.ssd_scan`` (chunk ``s.chunk``), on DTensors (the dry-run) per
    rank (:func:`_per_head_block`)."""
    def scan(x, dt, A, Bm, Cm, D, h0):
        return ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=s.chunk, impl=impl, initial_state=h0)

    if not isinstance(x, DTensor):
        return scan(x, dt, A, Bm, Cm, D, h0)
    return _per_head_block(scan, x, dt, A, Bm, Cm, D, h0)


def _per_head_block(fn, x, dt, A, Bm, Cm, D, state):
    """``fn(x, dt, A, B, C, D, state) -> (y, state)`` (the SSD scan, or a
    decode step; x (B, [S,] H, P)) on this rank's block of DTensors, its
    batch rows and heads as x holds them, as GSPMD partitions the
    recurrence, which is independent across both: dt, A, D and the state
    laid out alike, B and C whole (one group) or split as the heads (whole
    groups a rank; else the heads are gathered). DTensor would otherwise
    propagate every op of the scan, merging sharded dims that it can only
    track at a cost that grows with the mesh. Plain tensors go to ``fn``
    as they are."""
    if not isinstance(x, DTensor):
        return fn(x, dt, A, Bm, Cm, D, state)
    h = x.dim() - 2                                   # the head dim of x
    mesh = x.device_mesh
    g = Bm.shape[-2]
    split = [i for i, pl in enumerate(x.placements) if isinstance(pl, Shard) and pl.dim == h]
    parts = 1
    for i in split:
        parts *= mesh.size(i)
    heads = g == 1 or g % parts == 0
    x_pl = kept_shards(x, {0: 0, h: h} if heads else {0: 0})
    head_pl = kept_shards(x, {h: 0} if heads else {})
    bc_pl = kept_shards(x, {0: 0} if g == 1 or not heads else {0: 0, h: h})
    state_pl = kept_shards(x, {0: 0, h: 1} if heads else {0: 0})
    y, out = fn(*blocks([x_pl, x_pl, head_pl, bc_pl, bc_pl, head_pl, state_pl],
                        x, dt, A, Bm, Cm, D, state))
    return (DTensor.from_local(y, mesh, x_pl, run_check=False),
            DTensor.from_local(out, mesh, state_pl, run_check=False))


def ssm_forward(p: dict, hidden: torch.Tensor, cfg: ModelConfig, *, impl: str,
                return_state: bool = False, initial_state=None):
    """Full-sequence Mamba2 block.  hidden (B,S,D).
    state = (conv_x, conv_B, conv_C, ssm) when return_state."""
    s, di, nh, gn = _dims(cfg)
    b, seq, _ = hidden.shape
    st = initial_state or (None, None, None, None)
    hidden = reduced_grad(hidden)
    z = hidden @ p["w_z"]
    x, cxs = _causal_conv(hidden @ p["w_x"], p["conv_x_w"], p["conv_x_b"], st[0])
    Bm, cbs = _causal_conv(hidden @ p["w_B"], p["conv_B_w"], p["conv_B_b"], st[1])
    Cm, ccs = _causal_conv(hidden @ p["w_C"], p["conv_C_w"], p["conv_C_b"], st[2])
    dt = _dt(p, hidden)
    A = -torch.exp(p["A_log"])
    x = x.reshape(b, seq, nh, s.head_dim)
    Bm = Bm.reshape(b, seq, s.n_groups, s.d_state)
    Cm = Cm.reshape(b, seq, s.n_groups, s.d_state)
    y, ssm_state = _ssd(x, dt, A, Bm, Cm, p["D"], st[3], s, impl)
    y = y.reshape(b, seq, di)
    y = _gated_norm(y, z, p["norm_w"], cfg)
    out = reduce_partial(y @ p["out_proj"])
    if return_state:
        return out, (cxs, cbs, ccs, ssm_state)
    return out


def ssm_decode(p: dict, hidden: torch.Tensor, state, cfg: ModelConfig):
    """One-token decode.  hidden (B,1,D); state=(conv_x (B,K-1,di),
    conv_B (B,K-1,gn), conv_C (B,K-1,gn), ssm (B,nh,P,N))."""
    s, di, nh, gn = _dims(cfg)
    b = hidden.shape[0]
    cx, cb, cc, ssm_state = state
    h_t = hidden[:, 0]                                # (B,D)
    z = h_t @ p["w_z"]
    x, cx = _conv_step(h_t @ p["w_x"], p["conv_x_w"], p["conv_x_b"], cx)
    Bm, cb = _conv_step(h_t @ p["w_B"], p["conv_B_w"], p["conv_B_b"], cb)
    Cm, cc = _conv_step(h_t @ p["w_C"], p["conv_C_w"], p["conv_C_b"], cc)
    dt = _dt(p, h_t)
    A = -torch.exp(p["A_log"])
    x = x.reshape(b, nh, s.head_dim)
    Bm = Bm.reshape(b, s.n_groups, s.d_state)
    Cm = Cm.reshape(b, s.n_groups, s.d_state)
    y, new_ssm = _per_head_block(ops.ssm_decode_step, x, dt, A, Bm, Cm, p["D"], ssm_state)
    y = y.reshape(b, di)
    y = _gated_norm(y, z, p["norm_w"], cfg)
    return reduce_partial(y @ p["out_proj"])[:, None], (cx, cb, cc, new_ssm)


def init_ssm_state(cfg: ModelConfig, batch: int, dtype: torch.dtype, device
                   ) -> Tuple[torch.Tensor, ...]:
    """Zero state: conv states in ``dtype`` (the config's), the SSM state in fp32."""
    s, di, nh, gn = _dims(cfg)
    return (
        torch.zeros((batch, s.d_conv - 1, di), dtype=dtype, device=device),
        torch.zeros((batch, s.d_conv - 1, gn), dtype=dtype, device=device),
        torch.zeros((batch, s.d_conv - 1, gn), dtype=dtype, device=device),
        torch.zeros((batch, nh, s.head_dim, s.d_state), dtype=torch.float32, device=device),
    )
