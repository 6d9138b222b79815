"""Mamba2 SSD chunked scan: the hand-written CUDA kernel and its plain PyTorch version.

``ssd_scan_kernel`` launches ``csrc/ssd_scan.cu`` (the Hopper port of
``repro/kernels/ssd_scan.py::ssd_scan_pallas``; its source carries the
design note). ``ssd_scan_plain`` is the same computation in PyTorch, the
port of ``repro.kernels.ops._jnp_ssd_chunked``: per chunk the quadratic
intra-chunk part and the chunk's end state, then a sequential pass of the
state over chunks. The CPU tests run the plain version; on the card it is
only the yardstick the kernel is held against.

The kernel runs the chunks in parallel, a block per chunk and 32 head_dim
columns, and passes the state from chunk to chunk in the same launch, in
the order of the tickets its blocks draw (``ticket_block``);
``ssd_scan_chained_plain`` mirrors that algorithm, with the kernel's bf16
rounding points, for the tests. The kernel is built for the (head_dim P,
d_state N, chunk) of ``SHAPES``: mamba2-2.7b's (64, 128, 128), zamba2-1.2b's
(64, 64, 128) and both configs reduced, (32, 16, 32); it raises for any
other.

Layout: x (B,S,H,P), dt (B,S,H) f32, A (H,) f32, B/C (B,S,G,N), D (H,) f32,
optional initial state (B,H,P,N) f32 -> (y (B,S,H,P) in x's dtype,
final state (B,H,P,N) f32). Head h reads group h // (H/G).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (P, N, chunk) the kernel is built for: mamba2-2.7b, zamba2-1.2b, and both reduced
SHAPES = ((64, 128, 128), (64, 64, 128), (32, 16, 32))
COLUMNS = 32           # head_dim columns per block of the kernel (PB in the source)

launches = 0  # kernel launches made by ssd_scan_kernel; callers may reset it


def ticket_block(ticket: int, h: int, b: int, p: int) -> Tuple[int, int, int, int]:
    """(chunk, column half, head, batch) of the block that draws ``ticket``
    at head_dim ``p`` (p / 32 column halves): chunk-major, so every block of
    chunk c - 1 has drawn its ticket (and runs) before any block of chunk c,
    and a block waits only on running blocks."""
    halves = p // COLUMNS
    return ticket // (halves * h * b), ticket % halves, ticket // halves % h, \
        ticket // halves // h % b


def _bf16_pair(a: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """An f32 operand as the kernel's bf16 hi + lo pair, each back in f32."""
    hi = a.to(torch.bfloat16).float()
    return hi, (a - hi).to(torch.bfloat16).float()


def ssd_scan_plain(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor, D: torch.Tensor, *, chunk: int,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD in PyTorch, float32 throughout (heads grouped, never
    repeated over a group)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    r = h // g
    nc = -(-s // chunk)
    pad = nc * chunk - s

    def chunked(a, *tail):
        a = torch.nn.functional.pad(a.float(), (0, 0) * (a.dim() - 2) + (0, pad))
        return a.reshape(b, nc, chunk, *tail)

    xf = chunked(x, g, r, p)                              # (b,c,Q,g,r,p)
    dtf = chunked(dt, g, r)                               # (b,c,Q,g,r)
    Bf = chunked(B, g, n)                                 # (b,c,Q,g,n)
    Cf = chunked(C, g, n)
    cs = torch.cumsum(dtf * A.float().reshape(g, r), dim=2)   # inclusive, within chunk
    # --- intra-chunk (quadratic, attention-like) ---
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    diff = cs[:, :, :, None] - cs[:, :, None, :]          # (b,c,i,j,g,r)
    L = torch.exp(diff.masked_fill(~causal[:, :, None, None], float("-inf")))
    cb = torch.einsum("bcign,bcjgn->bcijg", Cf, Bf)
    scores = cb[..., None] * L * dtf[:, :, None]
    y = torch.einsum("bcijgr,bcjgrp->bcigrp", scores, xf)
    # --- per-chunk end states ---
    w = torch.exp(cs[:, :, -1:] - cs) * dtf               # (b,c,Q,g,r)
    s_c = torch.einsum("bcjgr,bcjgn,bcjgrp->bcgrnp", w, Bf, xf)
    decay = torch.exp(cs[:, :, -1])                       # (b,c,g,r)
    # --- inter-chunk state passing (sequential over chunks) ---
    state = (initial_state.float().transpose(-1, -2).reshape(b, g, r, n, p)
             if initial_state is not None
             else torch.zeros((b, g, r, n, p), dtype=torch.float32, device=x.device))
    h_in = []
    for c in range(nc):
        h_in.append(state)                                # the state entering chunk c
        state = decay[:, c, ..., None, None] * state + s_c[:, c]
    h_in = torch.stack(h_in, dim=1)                       # (b,c,g,r,n,p)
    y = y + torch.einsum("bcign,bcgrnp->bcigrp", Cf, h_in) * torch.exp(cs)[..., None]
    y = y.reshape(b, nc * chunk, h, p)[:, :s] + D.float()[None, None, :, None] * x.float()
    return y.to(x.dtype), state.reshape(b, h, n, p).transpose(-1, -2).contiguous()


def ssd_scan_chained_plain(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor, D: torch.Tensor, *, chunk: int,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's algorithm in PyTorch, for the tests. One block per
    (chunk, 32 head_dim columns, head, batch) computes its chunk's
    intra-chunk part and its local end state for its columns; then the
    blocks, in ticket order (:func:`ticket_block`), each read the state
    entering their chunk, publish ``exp(cs_last) S + s_c`` and add
    ``exp(cs) C S`` to their y. For bf16 inputs it rounds where the
    kernel's tensor-core products do: the scores, the state operand of
    ``C S`` and ``w B`` of the state update enter as bf16 hi + lo pairs, and
    ``C B^T`` takes the bf16 operands as they are. For f32 inputs nothing is
    rounded, as in the kernel's scalar f32 instantiation."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    r = h // g
    nc = -(-s // chunk)
    pad = nc * chunk - s
    pair = _bf16_pair if x.dtype == torch.bfloat16 else (lambda a: (a,))

    def chunked(a, *tail):
        a = torch.nn.functional.pad(a.float(), (0, 0) * (a.dim() - 2) + (0, pad))
        return a.reshape(b, nc, chunk, *tail)

    xf = chunked(x, g, r, p)                              # (b,c,Q,g,r,p)
    dtf = chunked(dt, g, r)                               # (b,c,Q,g,r)
    Bf = chunked(B, g, n)                                 # (b,c,Q,g,n)
    Cf = chunked(C, g, n)
    cs = torch.cumsum(dtf * A.float().reshape(g, r), dim=2)
    # --- every block at once: the intra-chunk part and the local end state ---
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    diff = cs[:, :, :, None] - cs[:, :, None, :]          # (b,c,i,j,g,r)
    L = torch.exp(diff.masked_fill(~causal[:, :, None, None], float("-inf")))
    cb = torch.einsum("bcign,bcjgn->bcijg", Cf, Bf)
    scores = cb[..., None] * L * dtf[:, :, None]
    y = sum(torch.einsum("bcijgr,bcjgrp->bcigrp", part, xf) for part in pair(scores))
    w = torch.exp(cs[:, :, -1:] - cs) * dtf               # (b,c,Q,g,r)
    wB = w[..., None] * Bf[:, :, :, :, None]              # (b,c,Q,g,r,n)
    local = sum(torch.einsum("bcjgrp,bcjgrn->bcgrpn", xf, part) for part in pair(wB))
    decay = torch.exp(cs[:, :, -1])                       # (b,c,g,r)
    # --- the chain, in ticket order; one state slot per (batch, head) ---
    slot = (initial_state.float().reshape(b, g, r, p, n).clone()
            if initial_state is not None
            else torch.zeros((b, g, r, p, n), dtype=torch.float32, device=x.device))
    y_inter = torch.zeros_like(y)
    for t in range(nc * (p // COLUMNS) * h * b):
        c, half, hh, bb = ticket_block(t, h, b, p)
        gg, rr = divmod(hh, r)
        cols = slice(half * COLUMNS, (half + 1) * COLUMNS)
        prev = slot[bb, gg, rr, cols].clone()             # S_{c-1}, (columns, n)
        slot[bb, gg, rr, cols] = decay[bb, c, gg, rr] * prev + local[bb, c, gg, rr, cols]
        if c > 0 or initial_state is not None:
            cs_prod = sum(Cf[bb, c, :, gg] @ part.T for part in pair(prev))   # (Q, columns)
            y_inter[bb, c, :, gg, rr, cols] = torch.exp(cs[bb, c, :, gg, rr])[:, None] * cs_prod
    y = (y + y_inter).reshape(b, nc * chunk, h, p)[:, :s]
    y = y + D.float()[None, None, :, None] * x.float()
    return y.to(x.dtype), slot.reshape(b, h, p, n)


@functools.cache
def _kernel():
    fn = _build.load("ssd_scan").ssd_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _error_string(err: int) -> str:
    fn = _build.load("ssd_scan").ssd_scan_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()


_syncs = {}  # device index -> int32 ticket counter and the chain's flags, zeroed once


def _sync_buffer(x, b, h, p):
    """The chained scan's ticket counter and its per-(batch, head, column
    half) flags, allocated zeroed at first use (or when a larger batch or
    more heads need more) and left zero by every launch; so launches that
    share a device run in one stream's order."""
    buf = _syncs.get(x.device.index)
    n = 1 + p // COLUMNS * b * h
    if buf is None or buf.numel() < n:
        buf = torch.zeros(n, dtype=torch.int32, device=x.device)
        _syncs[x.device.index] = buf
    return buf


def _check(x, dt, A, B, C, D, chunk, initial_state):
    if not x.is_cuda:
        raise ValueError("ssd_scan_kernel runs on CUDA tensors only; "
                         f"got a tensor on {x.device}")
    named = {"x": x, "dt": dt, "A": A, "B": B, "C": C, "D": D}
    if initial_state is not None:
        named["initial_state"] = initial_state
    for name, t in named.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"x is on {x.device} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"dtype {x.dtype} not supported; use float32 or bfloat16")
    for name in ("B", "C"):
        if named[name].dtype != x.dtype:
            raise ValueError(f"{name} is {named[name].dtype}, x is {x.dtype}")
    for name in ("dt", "A", "D", "initial_state"):
        if name in named and named[name].dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {named[name].dtype}")
    if x.dim() != 4 or B.dim() != 4 or B.shape != C.shape:
        raise ValueError(f"want x (B,S,H,P) and B/C (B,S,G,N); got {tuple(x.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if (B.shape[:2] != (b, s) or dt.shape != (b, s, h) or A.shape != (h,) or D.shape != (h,)
            or g < 1 or h % g):
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
                         f"B/C {tuple(B.shape)} and D {tuple(D.shape)} do not match")
    if initial_state is not None and initial_state.shape != (b, h, p, n):
        raise ValueError(f"initial_state is {tuple(initial_state.shape)}, want {(b, h, p, n)}")
    built = f"the kernel is built for (P, N, chunk) in {SHAPES}"
    if p not in {shape[0] for shape in SHAPES}:
        raise ValueError(f"head_dim P={p} not supported; {built}")
    if (p, n) not in {shape[:2] for shape in SHAPES}:
        raise ValueError(f"d_state N={n} not supported at head_dim P={p}; {built}")
    if (p, n, chunk) not in SHAPES:
        raise ValueError(f"chunk {chunk} not supported at (P, N) = ({p}, {n}); {built}")
    for name in ("x", "B", "C"):
        if named[name].data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the kernel loads "
                             "16 bytes at a time)")


def ssd_scan_kernel(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor, D: torch.Tensor, *, chunk: int,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on PyTorch's current stream; raises on a CPU
    tensor, on an input it does not take, or if the launch fails."""
    global launches
    _check(x, dt, A, B, C, D, chunk, initial_state)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    y = torch.empty_like(x)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    err = _kernel()(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(),
        0 if initial_state is None else initial_state.data_ptr(), y.data_ptr(),
        final.data_ptr(), _sync_buffer(x, b, h, p).data_ptr(), b, s, h, p, g, n, chunk,
        DTYPE_CODES[x.dtype],
        torch.cuda.current_stream().cuda_stream,
    )
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: {_error_string(err)}")
    launches += 1
    return y, final
