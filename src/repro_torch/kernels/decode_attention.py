"""Flash-decode and its split-KV partials: the hand-written CUDA kernel's
two entries and their plain PyTorch versions.

``decode_attention_kernel`` and ``decode_attention_partials_kernel`` launch
the two entries of ``csrc/decode_attention.cu`` (the Hopper port of
``repro/kernels/decode_attention.py``'s ``decode_attention_pallas`` and
``decode_attention_partials_pallas``; its source carries the design note).
``decode_attention_plain`` and ``decode_attention_partials_plain`` are the
same computations in PyTorch: a loop over cache blocks with a streaming
fp32 softmax. The CPU tests run the plain versions; on the card they are
only the yardsticks the kernel is held against.

The kernel cuts each row's visited keys into ``split_plan`` splits, one
block each, and merges the splits' softmax partials inside the same launch
(``combine_partials`` is that merge in PyTorch; ``decode_attention_split_plain``
mirrors the whole algorithm for the tests).

Layout: q (B, H, D), cache (B, Smax, KV, D), lengths (B,) -> (B, H, D) in
q's dtype; the query attends to [0, len) or [len - window, len). The
partials take a slice of the cache (a view is read in place) and lengths
measured against it, and return the unnormalized accumulator acc
(B, KV, G, D) with the running max m and sum l (B, KV, G), all fp32.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = _build.ATTENTION_HEAD_DIMS["decode_attention"]  # the plain entry's head_dims
PARTIALS_HEAD_DIMS = _build.ATTENTION_HEAD_DIMS["decode_attention_partials"]
MAX_GROUP = 16  # query heads per kv head the kernel holds (MAXG in the source)
_BLOCK_K = 1024  # cache rows per step of the plain version's loop
NUM_SMS = 132  # streaming multiprocessors of an H100 SXM, the card the split is sized for
SPLIT_ALIGN = 64  # keys per split are a multiple of this (4 warps x 16-key chunks)
MAX_KEYS_PER_SPLIT = 128  # each warp's keys fit its 2-stage ring, all in flight at once
MAX_SPLITS = 64  # the kernel's last block stages every split's m and l (MAX_SPLITS there)

# launches made by decode_attention_kernel through this module, which callers
# may reset; a CUDA graph's replay of a captured launch does not pass here
launches = 0
partials_launches = 0  # launches made by decode_attention_partials_kernel; likewise


def decode_attention_partials_plain(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    lengths: torch.Tensor, *, scale: float, window: Optional[int],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Streaming decode attention in PyTorch, a loop over cache blocks,
    without the final division: (acc, m, l). Masked keys get p = 0, so a
    slice of length 0 returns m = -1e30, l = 0 and acc = 0 (the Pallas
    kernel's initial state)."""
    b, h, d = q.shape
    smax, kv = k_cache.shape[1], k_cache.shape[2]
    grp = h // kv
    qf = (q.float() * scale).reshape(b, kv, grp, d)
    lens = lengths.to(device=q.device, dtype=torch.int64)[:, None]
    m = torch.full((b, kv, grp), NEG_INF, dtype=torch.float32, device=q.device)
    denom = torch.zeros((b, kv, grp), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kv, grp, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, smax, _BLOCK_K):
        kblk = k_cache[:, k0:k0 + _BLOCK_K].float()
        vblk = v_cache[:, k0:k0 + _BLOCK_K].float()
        s = torch.einsum("bhgd,bkhd->bhgk", qf, kblk)
        kpos = torch.arange(k0, k0 + kblk.shape[1], device=q.device)[None, :]
        mask = kpos < lens
        if window is not None:
            mask &= kpos >= lens - window
        mask = mask[:, None, None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]) * mask
        corr = torch.exp(m - m_new)
        denom = denom * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgk,bkhd->bhgd", p, vblk)
        m = m_new
    return acc, m, denom


def combine_partials(
    acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor, dim: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge softmax partials along axis ``dim`` of m and l (acc has one
    more, trailing, axis): (acc, m, l) unnormalized, as a single pass over
    all their keys would give them. A split's weight is exp(m - max m): 0
    for an empty split (m = -1e30) beside a real one, 1 where every split is
    empty, whose l = 0 and acc = 0 then merge to 0. The caller divides acc
    by l clamped at 1e-30."""
    m_g = m.amax(dim=dim, keepdim=True)
    coef = torch.where(torch.isfinite(m), torch.exp(m - m_g), 0.0)
    return ((acc * coef.unsqueeze(-1)).sum(dim=dim), m_g.squeeze(dim),
            (l * coef).sum(dim=dim))


def split_plan(smax: int, window: Optional[int], b: int, kv: int) -> Tuple[int, int]:
    """(number of splits, keys per split) of the kernel's sequence split,
    fixed from the cache's shape and the window alone, never from the
    lengths (they stay on the device). Each row's visited keys, from
    max(0, len - window) (or 0) up to min(len, smax), span at most
    ``smax`` (or ``min(window, smax)``) keys; the splits cut that span into
    consecutive pieces of ``keys per split``, enough of them to give the
    card about two blocks per SM over the b * kv (batch, kv head) rows: a
    multiple of 64 keys, at most 128 (all of a split's copies in flight at
    once), unless that would take more than ``MAX_SPLITS`` splits."""
    span = smax if window is None else min(window, smax)
    target = -(-2 * NUM_SMS // (b * kv))
    kps = max(min(-(-span // target), MAX_KEYS_PER_SPLIT), -(-span // MAX_SPLITS), 1)
    kps = -(-kps // SPLIT_ALIGN) * SPLIT_ALIGN
    return -(-span // kps), kps


def decode_attention_split_plain(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    lengths: torch.Tensor, *, scale: float, window: Optional[int],
) -> torch.Tensor:
    """The kernel's algorithm in PyTorch, for the tests: each row's visited
    keys cut by :func:`split_plan` from the row's own first key, the
    partials of every split (:func:`decode_attention_partials_plain` over
    the split's rows, gathered), merged by :func:`combine_partials`. The
    kernel leaves out the splits past a row's length, which weigh 0 here."""
    b, h, _ = q.shape
    smax, kv = k_cache.shape[1], k_cache.shape[2]
    n_splits, kps = split_plan(smax, window, b, kv)
    lens = lengths.to(device=q.device, dtype=torch.int64)
    start = torch.clamp(lens - window, min=0) if window is not None else torch.zeros_like(lens)
    end = torch.clamp(lens, max=smax)
    rows = torch.arange(b, device=q.device)[:, None]
    parts = []
    for i in range(n_splits):
        lo = start + i * kps
        pos = torch.clamp(lo[:, None] + torch.arange(kps, device=q.device)[None, :], max=smax - 1)
        n_keys = torch.clamp(end - lo, 0, kps).to(torch.int32)
        parts.append(decode_attention_partials_plain(
            q, k_cache[rows, pos], v_cache[rows, pos], n_keys, scale=scale, window=None))
    acc, _, denom = combine_partials(*(torch.stack(t) for t in zip(*parts, strict=True)))
    out = acc / torch.clamp(denom[..., None], min=1e-30)
    return out.reshape(q.shape).to(q.dtype)


def decode_attention_plain(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    lengths: torch.Tensor, *, scale: float, window: Optional[int],
) -> torch.Tensor:
    """Streaming decode attention in PyTorch: the partials, divided."""
    acc, _, denom = decode_attention_partials_plain(q, k_cache, v_cache, lengths, scale=scale,
                                                    window=window)
    out = acc / torch.clamp(denom[..., None], min=1e-30)
    return out.reshape(q.shape).to(q.dtype)


@functools.cache
def _kernel():
    fn = _build.load("decode_attention").decode_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _partials_kernel():
    fn = _build.load("decode_attention").decode_attention_partials_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 + [ctypes.c_long] + [
        ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


_counters = {}  # device index -> int32 arrival counters, zeroed once; the kernel resets them
_outgrown = []  # counters a larger batch replaced, kept: a captured CUDA graph holds their address


def _split_buffers(q, b, kv, grp, d, n_splits):
    """The split partials' scratch (acc, then m and l, of every split) and
    the per-(batch, kv head) arrival counters the kernel's last block of a
    row finds its turn with. The counters are allocated zeroed at first use
    (or when a larger batch needs more) and every launch leaves them 0; so
    launches that share a device run in one stream's order. A counter is
    never freed: a CUDA graph that captured a launch replays it on the same
    address."""
    part = torch.empty(n_splits * b * kv * grp * (d + 2) if n_splits > 1 else 0,
                       dtype=torch.float32, device=q.device)
    counter = _counters.get(q.device.index)
    if counter is None or counter.numel() < b * kv:
        if counter is not None:
            _outgrown.append(counter)
        counter = torch.zeros(b * kv, dtype=torch.int32, device=q.device)
        _counters[q.device.index] = counter
    return part, counter


@functools.cache
def _error_string(err: int) -> str:
    fn = _build.load("decode_attention").decode_attention_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()


def _check_common(who, q, k_cache, v_cache, lengths, window, head_dims=HEAD_DIMS):
    if not q.is_cuda:
        raise ValueError(f"{who} runs on CUDA tensors only; got a tensor on {q.device}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if v_cache.dtype != k_cache.dtype:
        raise ValueError(f"v_cache is {v_cache.dtype}, k_cache is {k_cache.dtype}")
    if k_cache.dtype not in DTYPE_CODES:
        raise ValueError(f"dtype {k_cache.dtype} not supported; use float32 or bfloat16")
    if lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be int32, got {lengths.dtype}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"q is on {q.device} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"want q (B,H,D) and caches (B,Smax,KV,D); got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, h, d = q.shape
    kv = k_cache.shape[2]
    if k_cache.shape[0] != b or k_cache.shape[3] != d or h % kv or lengths.shape != (b,):
        raise ValueError(f"q {tuple(q.shape)}, cache {tuple(k_cache.shape)} and lengths "
                         f"{tuple(lengths.shape)} do not match")
    if d not in head_dims:
        raise ValueError(f"head_dim {d} not supported; {who} is built for {head_dims}")
    if h // kv > MAX_GROUP:
        raise ValueError(f"GQA group {h // kv} exceeds the kernel's {MAX_GROUP}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    for name, t in (("q", q), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the kernel loads "
                             "16 bytes at a time)")


def _check(q, k_cache, v_cache, lengths, window):
    _check_common("decode_attention_kernel", q, k_cache, v_cache, lengths, window)
    if k_cache.dtype != q.dtype:
        raise ValueError(f"k_cache is {k_cache.dtype}, q is {q.dtype}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_partials(q, k_cache, v_cache, lengths, window):
    """As :func:`_check`, but q is float32 against a float32 or bfloat16
    cache, and the cache may be a slice of the sequence axis of a larger
    one: rows contiguous, sequences any 16-byte multiple apart."""
    _check_common("decode_attention_partials_kernel", q, k_cache, v_cache, lengths, window,
                  PARTIALS_HEAD_DIMS)
    if q.dtype != torch.float32:
        raise ValueError(f"q must be float32 (pre-scaled), got {q.dtype}")
    _, chunk, kv, d = k_cache.shape
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.stride()[1:] != (kv * d, d, 1):
            raise ValueError(f"{name} rows must be contiguous (strides (*, {kv * d}, {d}, 1)),"
                             f" got {t.stride()}")
    if v_cache.stride(0) != k_cache.stride(0):
        raise ValueError(f"k_cache and v_cache have batch strides {k_cache.stride(0)} and "
                         f"{v_cache.stride(0)}")
    bs = k_cache.stride(0)
    if bs < chunk * kv * d or bs * k_cache.element_size() % 16:
        raise ValueError(f"batch stride {bs} must cover a slice of {chunk} rows and be a "
                         "multiple of 16 bytes")


def decode_attention_kernel(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    lengths: torch.Tensor, *, scale: float, window: Optional[int],
) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream; raises on a CPU
    tensor, on an input it does not take, or if the launch fails."""
    global launches
    _check(q, k_cache, v_cache, lengths, window)
    b, h, d = q.shape
    smax, kv = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    n_splits, kps = split_plan(smax, window, b, kv)
    part, counter = _split_buffers(q, b, kv, h // kv, d, n_splits)
    err = _kernel()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), part.data_ptr(), counter.data_ptr(), b, smax, h, kv, d,
        -1 if window is None else int(window), float(scale), DTYPE_CODES[q.dtype],
        n_splits, kps, torch.cuda.current_stream().cuda_stream,
    )
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: {_error_string(err)}")
    launches += 1
    return out


def decode_attention_partials_kernel(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    lengths: torch.Tensor, *, scale: float, window: Optional[int],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the partials entry of the CUDA kernel on PyTorch's current
    stream, reading the cache slice in place; raises on a CPU tensor, on an
    input it does not take, or if the launch fails."""
    global partials_launches
    _check_partials(q, k_cache, v_cache, lengths, window)
    b, h, d = q.shape
    chunk, kv = k_cache.shape[1], k_cache.shape[2]
    acc = torch.empty((b, kv, h // kv, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, kv, h // kv), dtype=torch.float32, device=q.device)
    denom = torch.empty_like(m)
    if acc.numel() == 0:
        return acc, m, denom
    n_splits, kps = split_plan(chunk, window, b, kv)
    part, counter = _split_buffers(q, b, kv, h // kv, d, n_splits)
    err = _partials_kernel()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        acc.data_ptr(), m.data_ptr(), denom.data_ptr(), part.data_ptr(), counter.data_ptr(),
        b, chunk, k_cache.stride(0), h, kv, d, -1 if window is None else int(window),
        float(scale), DTYPE_CODES[k_cache.dtype], n_splits, kps,
        torch.cuda.current_stream().cuda_stream,
    )
    if err:
        raise RuntimeError(f"decode_attention_partials kernel launch failed: "
                           f"{_error_string(err)}")
    partials_launches += 1
    return acc, m, denom
