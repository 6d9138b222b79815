"""Flash attention (prefill): the hand-written CUDA kernel and its plain
PyTorch version.

``flash_attention_kernel`` launches ``csrc/flash_attention.cu`` (the Hopper
port of ``repro/kernels/flash_attention.py::flash_attention_pallas``; its
source carries the design note). ``flash_attention_plain`` is the same
computation in PyTorch: a loop over KV blocks with a streaming fp32
softmax. The CPU tests run the plain version; on the card it is only the
yardstick the kernel is held against.

Layout: q (B, Sq, H, D), k/v (B, Sk, KV, D) -> (B, Sq, H, D) in q's dtype,
query positions right-aligned (qpos = i + Sk - Sq).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = _build.ATTENTION_HEAD_DIMS  # the head_dims the kernel is built for
_BLOCK_K = 128  # keys per step of the plain version's loop

launches = 0  # kernel launches made by flash_attention_kernel; callers may reset it


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool, window: Optional[int], scale: float,
) -> torch.Tensor:
    """Streaming-softmax attention in PyTorch: a loop over KV blocks."""
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
        mask = torch.ones((sq, kblk.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window is not None:
            mask &= (qpos[:, None] - kpos[None, :]) < window
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        denom = denom * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p, vblk)
        m = m_new
    out = acc / torch.clamp(denom[..., None], min=1e-30)
    return out.reshape(b, sq, h, d).to(q.dtype)


@functools.cache
def _kernel():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _error_string(err: int) -> str:
    fn = _build.load("flash_attention").flash_attention_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: Optional[int]):
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
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported; the kernel is built for {HEAD_DIMS}")
    if sq > k.shape[1]:
        raise ValueError(f"more queries ({sq}) than keys ({k.shape[1]})")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def flash_attention_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool, window: Optional[int], scale: float,
) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream; raises on a CPU
    tensor, on an input it does not take, or if the launch fails."""
    global launches
    _check(q, k, v, window)
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, sq, sk, h, kv, d, int(causal), -1 if window is None else int(window),
        float(scale), DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: {_error_string(err)}")
    launches += 1
    return out
