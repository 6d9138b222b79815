"""Flash attention (prefill and training): the hand-written CUDA kernels and
their plain PyTorch versions.

``flash_attention_kernel`` launches ``csrc/flash_attention.cu`` (the Hopper
port of ``repro/kernels/flash_attention.py::flash_attention_pallas``; its
source carries the design note); with ``return_lse`` it also returns the
per-row log-sum-exp. ``flash_attention_bwd_kernel`` launches
``csrc/flash_attention_bwd.cu``, the backward (dQ, dK, dV from q, k, v, o,
lse and dO; the JAX package has no Pallas backward and differentiates its
jnp path). :class:`FlashAttentionFn` joins the two for autograd.

``flash_attention_plain``, ``flash_attention_fwd_lse_plain`` and
``flash_attention_bwd_plain`` are the same computations in PyTorch: loops
over KV blocks with a streaming fp32 softmax, and for the backward a loop
that recomputes P from the LSE. The CPU tests run the plain versions; on
the card they are only the yardsticks the kernels are held against.
``flash_attention_bwd_tiled_plain`` is the bf16 backward kernel's algorithm
in PyTorch (its tiles and visibility limits, the per-query-head partials
and their fixed-order GQA sum, P and dS rounded to bf16), for the tests.

Layout: q (B, Sq, H, D), k/v (B, Sk, KV, D) -> (B, Sq, H, D) in q's dtype,
query positions right-aligned (qpos = i + Sk - Sq); lse (B, H, Sq) f32, in
the scaled units of the scores (scale * q k^T).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = _build.ATTENTION_HEAD_DIMS["flash_attention"]  # the forward's head_dims
BWD_HEAD_DIMS = _build.ATTENTION_HEAD_DIMS["flash_attention_bwd"]  # the backward's
_BLOCK_K = 128  # keys per step of the plain version's loop

launches = 0      # kernel launches made by flash_attention_kernel; callers may reset it
bwd_launches = 0  # kernel launches made by flash_attention_bwd_kernel; likewise
BWD_TILE = 64     # rows of the bf16 backward kernel's tiles: keys (dK/dV) or query rows (dQ)


def bwd_kernels(h: int, kv: int) -> int:
    """Launches a backward call makes: delta, dK/dV and dQ, and with GQA
    (h > kv) the fixed-order sum of each kv head's per-query-head partials."""
    return 3 if h == kv else 4


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=qpos.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    return mask


def _plain_forward(q, k, v, causal, window, scale):
    """The streaming softmax: (out (B,Sq,H,D) in q's dtype, running max m
    and sum l (B,Sq,KV,grp) f32)."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    grp = h // kv
    qf = (q.float() * scale).reshape(b, sq, kv, grp, d)
    qpos = torch.arange(sq, device=q.device) + (sk - sq)
    m = torch.full((b, sq, kv, grp), NEG_INF, dtype=torch.float32, device=q.device)
    denom = torch.zeros((b, sq, kv, grp), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, kv, grp, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, sk, _BLOCK_K):
        kblk = k[:, k0:k0 + _BLOCK_K].float()
        vblk = v[:, k0:k0 + _BLOCK_K].float()
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kblk)
        kpos = torch.arange(k0, k0 + kblk.shape[1], device=q.device)
        mask = _mask(qpos, kpos, causal, window)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        denom = denom * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p, vblk)
        m = m_new
    out = acc / torch.clamp(denom[..., None], min=1e-30)
    return out.reshape(b, sq, h, d).to(q.dtype), m, denom


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool, window: Optional[int], scale: float,
) -> torch.Tensor:
    """Streaming-softmax attention in PyTorch: a loop over KV blocks."""
    return _plain_forward(q, k, v, causal, window, scale)[0]


def flash_attention_fwd_lse_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool, window: Optional[int], scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_plain` and the per-row log-sum-exp m + log(l)
    (B, H, Sq) f32, as the kernel writes it."""
    out, m, denom = _plain_forward(q, k, v, causal, window, scale)
    b, sq, h, _ = q.shape
    lse = m + torch.log(torch.clamp(denom, min=1e-30))
    return out, lse.reshape(b, sq, h).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, *, causal: bool, window: Optional[int], scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward in PyTorch, as the kernel computes it: delta = rowsum(dO
    * O), then a loop over KV blocks that recomputes P = exp(scale q k^T -
    lse), with dS = P * (dO V^T - delta); dV = P^T dO, dK = scale dS^T Q,
    dQ = scale dS K, each summed over the grp query heads of a kv head.
    Returns (dq, dk, dv) in the dtypes of q, k and v."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    grp = h // kv
    qf = q.float().reshape(b, sq, kv, grp, d)
    dof = do.float().reshape(b, sq, kv, grp, d)
    delta = (dof * o.float().reshape(b, sq, kv, grp, d)).sum(dim=-1)
    lse_r = lse.transpose(1, 2).reshape(b, sq, kv, grp)
    qpos = torch.arange(sq, device=q.device) + (sk - sq)
    dq = torch.zeros((b, sq, kv, grp, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, sk, kv, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros((b, sk, kv, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, sk, _BLOCK_K):
        kblk = k[:, k0:k0 + _BLOCK_K].float()
        vblk = v[:, k0:k0 + _BLOCK_K].float()
        kpos = torch.arange(k0, k0 + kblk.shape[1], device=q.device)
        mask = _mask(qpos, kpos, causal, window)[None, :, None, None, :]
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kblk) * scale
        p = torch.where(mask, torch.exp(s - lse_r[..., None]), 0.0)
        dp = torch.einsum("bqhgd,bkhd->bqhgk", dof, vblk)
        ds = p * (dp - delta[..., None])
        dv[:, k0:k0 + _BLOCK_K] = torch.einsum("bqhgk,bqhgd->bkhd", p, dof)
        dk[:, k0:k0 + _BLOCK_K] = torch.einsum("bqhgk,bqhgd->bkhd", ds, qf) * scale
        dq += torch.einsum("bqhgk,bkhd->bqhgd", ds, kblk)
    dq = (dq * scale).reshape(b, sq, h, d)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bwd_query_rows(k0: int, sq: int, sk: int, causal: bool,
                   window: Optional[int]) -> Tuple[int, int]:
    """The query rows [i_lo, i_hi) that see some key of the backward
    kernel's key tile at k0 (its dK/dV pass), as the kernel computes them."""
    off = sk - sq
    k_last = min(k0 + BWD_TILE, sk) - 1
    i_lo = max(0, k0 - off) if causal else 0
    i_hi = min(sq, k_last + window - off) if window is not None else sq
    return i_lo, i_hi


def bwd_key_range(q0: int, sq: int, sk: int, causal: bool,
                  window: Optional[int]) -> Tuple[int, int]:
    """The keys [k_begin, k_end) that the backward kernel's dQ pass visits
    for the query tile at q0, in tiles from k_begin, as the kernel computes
    them (the forward's limits)."""
    off = sk - sq
    qpos_lo, qpos_hi = q0 + off, min(q0 + BWD_TILE, sq) - 1 + off
    k_end = min(sk, qpos_hi + 1) if causal else sk
    k_begin = max(0, qpos_lo - window + 1) // BWD_TILE * BWD_TILE if window is not None else 0
    return k_begin, k_end


def flash_attention_bwd_tiled_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, *, causal: bool, window: Optional[int], scale: float, round_p_ds: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bf16 backward kernel's algorithm in PyTorch, for the tests. dK/dV
    pass: per 64-key tile and query head, the 64-row query tiles from
    :func:`bwd_query_rows`; per-query-head f32 partials, summed over each
    kv head's grp query heads in the order g = 0 .. grp - 1, then dK times
    scale. dQ pass: per 64-row query tile, the 64-key tiles of
    :func:`bwd_key_range`. With ``round_p_ds`` (the kernel's bf16 body), P
    and dS are rounded to bf16 where the kernel packs them as mma operands;
    everything else is f32. Returns (dq, dk, dv) in the dtypes of q, k, v."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    grp = h // kv
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(grp, dim=2)  # query head h reads kv head h // grp
    vf = v.float().repeat_interleave(grp, dim=2)
    delta = (dof * o.float()).sum(dim=-1).transpose(1, 2)  # (b, h, sq)
    qpos = torch.arange(sq, device=q.device) + (sk - sq)
    kpos = torch.arange(sk, device=q.device)

    def p_ds(i0, i1, k0, k1):
        """P and dS (b, h, rows, keys) of query rows i0:i1 against keys k0:k1."""
        s = torch.einsum("bqhd,bkhd->bhqk", qf[:, i0:i1], kf[:, k0:k1]) * scale
        dp = torch.einsum("bqhd,bkhd->bhqk", dof[:, i0:i1], vf[:, k0:k1])
        mask = _mask(qpos[i0:i1], kpos[k0:k1], causal, window)
        p = torch.where(mask, torch.exp(s - lse[:, :, i0:i1, None]), 0.0)
        ds = p * (dp - delta[:, :, i0:i1, None])
        if round_p_ds:
            p, ds = p.bfloat16().float(), ds.bfloat16().float()
        return p, ds

    part_k = torch.zeros((b, sk, h, d), dtype=torch.float32, device=q.device)
    part_v = torch.zeros_like(part_k)
    for k0 in range(0, sk, BWD_TILE):
        k1 = min(k0 + BWD_TILE, sk)
        i_lo, i_hi = bwd_query_rows(k0, sq, sk, causal, window)
        for i0 in range(i_lo, i_hi, BWD_TILE):
            i1 = min(i0 + BWD_TILE, sq)
            p, ds = p_ds(i0, i1, k0, k1)
            part_v[:, k0:k1] += torch.einsum("bhqk,bqhd->bkhd", p, dof[:, i0:i1])
            part_k[:, k0:k1] += torch.einsum("bhqk,bqhd->bkhd", ds, qf[:, i0:i1])
    part_k = part_k.reshape(b, sk, kv, grp, d)
    part_v = part_v.reshape(b, sk, kv, grp, d)
    dk, dv = part_k[:, :, :, 0], part_v[:, :, :, 0]
    for g in range(1, grp):
        dk, dv = dk + part_k[:, :, :, g], dv + part_v[:, :, :, g]
    dk = dk * scale

    dq = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    for q0 in range(0, sq, BWD_TILE):
        q1 = min(q0 + BWD_TILE, sq)
        k_begin, k_end = bwd_key_range(q0, sq, sk, causal, window)
        for k0 in range(k_begin, k_end, BWD_TILE):
            _, ds = p_ds(q0, q1, k0, min(k0 + BWD_TILE, sk))
            dq[:, q0:q1] += torch.einsum("bhqk,bkhd->bqhd", ds, kf[:, k0:k0 + BWD_TILE])
    dq = dq * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _kernel():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernel():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _error_string(err: int, source: str = "flash_attention") -> str:
    fn = getattr(_build.load(source), f"{source}_error_string")
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: Optional[int],
           head_dims=HEAD_DIMS, who: str = "the kernel"):
    if not q.is_cuda:
        raise ValueError("flash_attention_kernel runs on CUDA tensors only; "
                         f"got a tensor on {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"dtype {q.dtype} not supported; use float32 or bfloat16")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"q is on {q.device} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,S,H,D) and k, v (B,S,KV,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v {tuple(k.shape)}")
    if d not in head_dims:
        raise ValueError(f"head_dim {d} not supported; {who} is built for {head_dims}")
    if sq > k.shape[1]:
        raise ValueError(f"more queries ({sq}) than keys ({k.shape[1]})")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def flash_attention_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool, window: Optional[int], scale: float, return_lse: bool = False,
):
    """Launch the CUDA kernel on PyTorch's current stream; raises on a CPU
    tensor, on an input it does not take, or if the launch fails. Returns
    o, or (o, lse (B,H,Sq) f32) with ``return_lse``."""
    global launches
    _check(q, k, v, window)
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None,
        b, sq, sk, h, kv, d, int(causal), -1 if window is None else int(window),
        float(scale), DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: {_error_string(err)}")
    launches += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, *, causal: bool, window: Optional[int], scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernel (``bwd_kernels(h, kv)`` launches on
    PyTorch's current stream): (dq, dk, dv) in q's dtype. Raises on a CPU
    tensor, on an input it does not take, or if a launch fails."""
    global bwd_launches
    _check(q, k, v, window, BWD_HEAD_DIMS, "the backward kernel (training only)")
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} on {t.device} does not match "
                             f"q {tuple(q.shape)} {q.dtype} on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (lse.shape != (b, h, sq) or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 {(b, h, sq)} tensor on {q.device}; "
                         f"got {tuple(lse.shape)} {lse.dtype} on {lse.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    # with GQA, the f32 partials of dK and dV of every query head
    part = torch.empty((2, b, sk, h, d), dtype=torch.float32, device=q.device) if h != kv else None
    err = _bwd_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), None if part is None else part.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, sq, sk, h, kv, d, int(causal), -1 if window is None else int(window),
        float(scale), DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream,
    )
    if err:
        raise RuntimeError("flash_attention backward kernel launch failed: "
                           f"{_error_string(err, 'flash_attention_bwd')}")
    bwd_launches += bwd_kernels(h, kv)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Attention with the kernels on both sides: the forward kernel, keeping
    its LSE for the backward, and the backward kernel. CUDA tensors only."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int], scale: float):
        o, lse = flash_attention_kernel(q, k, v, causal=causal, window=window, scale=scale,
                                        return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_kernel(
            q, k, v, o, lse, do.contiguous(), causal=ctx.causal, window=ctx.window,
            scale=ctx.scale)
        return dq, dk, dv, None, None, None
