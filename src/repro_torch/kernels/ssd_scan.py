"""Mamba2 SSD chunked scan: the hand-written CUDA kernels (forward and
backward) and their plain PyTorch versions.

``ssd_scan_kernel`` launches ``csrc/ssd_scan.cu`` (the Hopper port of
``repro/kernels/ssd_scan.py::ssd_scan_pallas``; its source carries the
design note); with ``return_chunk_states`` it also returns the state
entering each chunk. ``ssd_scan_bwd_kernel`` launches
``csrc/ssd_scan_bwd.cu``, the backward (dx, ddt, dA, dB, dC, dD and dh0
from dy, the cotangent of the final state and those chunk states; the JAX
package has no Pallas backward and differentiates its jnp path).
:class:`SsdScanFn` joins the two for autograd. ``ssd_scan_plain`` is the
forward in PyTorch, the port of ``repro.kernels.ops._jnp_ssd_chunked``: per
chunk the quadratic intra-chunk part and the chunk's end state, then a
sequential pass of the state over chunks. ``ssd_scan_bwd_plain`` is the
backward in PyTorch, written out from the chunk states with no autograd
inside. The CPU tests run the plain versions; on the card they are only
the yardsticks the kernels are held against.

The kernel runs the chunks in parallel, a block per chunk and 32 head_dim
columns, and passes the state from chunk to chunk in the same launch, in
the order of the tickets its blocks draw (``ticket_block``);
``ssd_scan_chained_plain`` mirrors that algorithm, with the kernel's bf16
rounding points, for the tests; ``ssd_scan_bwd_tiled_plain`` mirrors the
backward kernel's (a block per chunk, block of heads of one group and
batch, taking its heads in turn; the reverse chain in ``bwd_ticket_block``
order; one partial of dB and of dC per block of heads and per-head
partials of dA and dD, summed in index order; the f32 operands of its
tensor-core products as bf16 hi + lo pairs). The kernels are built for
the (head_dim P,
d_state N, chunk) of ``SHAPES``: mamba2-2.7b's (64, 128, 128), zamba2-1.2b's
(64, 64, 128) and both configs reduced, (32, 16, 32); they raise for any
other.

Layout: x (B,S,H,P), dt (B,S,H) f32, A (H,) f32, B/C (B,S,G,N), D (H,) f32,
optional initial state (B,H,P,N) f32 -> (y (B,S,H,P) in x's dtype,
final state (B,H,P,N) f32). Head h reads group h // (H/G). The chunk
states are (B, nc, H, P, N) f32, nc = ceil(S / chunk).
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

launches = 0      # kernel launches made by ssd_scan_kernel; callers may reset it
bwd_launches = 0  # kernel launches made by ssd_scan_bwd_kernel; likewise
BWD_KERNELS = 2   # launches a backward call makes: the chunks, then the fixed-order sums
MAX_HEADS_PER_BLOCK = 16   # heads a backward block may take in turn (its per-head scratch)


def ticket_block(ticket: int, h: int, b: int, p: int) -> Tuple[int, int, int, int]:
    """(chunk, column half, head, batch) of the block that draws ``ticket``
    at head_dim ``p`` (p / 32 column halves): chunk-major, so every block of
    chunk c - 1 has drawn its ticket (and runs) before any block of chunk c,
    and a block waits only on running blocks."""
    halves = p // COLUMNS
    return ticket // (halves * h * b), ticket % halves, ticket // halves % h, \
        ticket // halves // h % b


def bwd_ticket_block(ticket: int, nc: int, hb: int, b: int) -> Tuple[int, int, int]:
    """(chunk, head block, batch) of the backward block that draws
    ``ticket``, with ``hb`` head blocks: reverse chunk-major, so every block
    of chunk c + 1 has drawn its ticket (and runs) before any block of chunk
    c, which waits on it."""
    return nc - 1 - ticket // (hb * b), ticket % hb, ticket // hb % b


def _bf16_pair(a: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """An f32 operand as the kernel's bf16 hi + lo pair, each back in f32."""
    hi = a.to(torch.bfloat16).float()
    return hi, (a - hi).to(torch.bfloat16).float()


def _chunked(a: torch.Tensor, nc: int, chunk: int, *tail) -> torch.Tensor:
    """(B, S, ...) zero-padded to nc chunks, float32, as (B, nc, chunk, *tail)."""
    pad = nc * chunk - a.shape[1]
    a = torch.nn.functional.pad(a.float(), (0, 0) * (a.dim() - 2) + (0, pad))
    return a.reshape(a.shape[0], nc, chunk, *tail)


def ssd_scan_plain(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor, D: torch.Tensor, *, chunk: int,
    initial_state: Optional[torch.Tensor] = None, return_chunk_states: bool = False,
):
    """Chunked SSD in PyTorch, float32 throughout (heads grouped, never
    repeated over a group). With ``return_chunk_states`` it also returns the
    state entering each chunk, (B, nc, H, P, N) f32."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    r = h // g
    nc = -(-s // chunk)
    xf = _chunked(x, nc, chunk, g, r, p)                  # (b,c,Q,g,r,p)
    dtf = _chunked(dt, nc, chunk, g, r)                   # (b,c,Q,g,r)
    Bf = _chunked(B, nc, chunk, g, n)                     # (b,c,Q,g,n)
    Cf = _chunked(C, nc, chunk, g, n)
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
    final = state.reshape(b, h, n, p).transpose(-1, -2).contiguous()
    if return_chunk_states:
        return y.to(x.dtype), final, h_in.reshape(b, nc, h, n, p).transpose(-1, -2).contiguous()
    return y.to(x.dtype), final


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
    pair = _bf16_pair if x.dtype == torch.bfloat16 else (lambda a: (a,))
    xf = _chunked(x, nc, chunk, g, r, p)                  # (b,c,Q,g,r,p)
    dtf = _chunked(dt, nc, chunk, g, r)                   # (b,c,Q,g,r)
    Bf = _chunked(B, nc, chunk, g, n)                     # (b,c,Q,g,n)
    Cf = _chunked(C, nc, chunk, g, n)
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


def ssd_scan_bwd_plain(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor, D: torch.Tensor, h_in: torch.Tensor, dy: torch.Tensor,
    dfinal: Optional[torch.Tensor] = None, *, chunk: int,
) -> Tuple[torch.Tensor, ...]:
    """The backward of :func:`ssd_scan_plain`, written out in PyTorch (no
    autograd inside), float32 throughout. ``h_in`` (B, nc, H, P, N) holds
    the state entering each chunk (the forward's, or from
    ``ssd_scan_kernel(..., return_chunk_states=True)``); ``dfinal`` is the
    cotangent of the final state, None for zero. Per chunk, with a_k = dt_k
    A, cs the inclusive cumsum of a, L_ij = exp(cs_i - cs_j) (j <= i),
    G_ij = C_i . B_j, M_ij = G_ij L_ij dt_j, w_j = exp(cs_last - cs_j) dt_j
    and gn the cotangent of the state leaving the chunk:
      the reverse chain: g_nc = dfinal, g_c = exp(cs_last) g_{c+1}
        + sum_i exp(cs_i) dy_i (outer) C_i, dh0 = g_0;
      dx_j = sum_{i>=j} M_ij dy_i + w_j gn B_j + D dy_j;
      dM_ij = dy_i . x_j, dG_ij = dM_ij L_ij dt_j;
      dC_i = sum_j dG_ij B_j + exp(cs_i) h_c^T dy_i;
      dB_j = sum_i dG_ij C_i + w_j gn^T x_j (both summed over the group's heads);
      ddt_j = sum_i dM_ij G_ij L_ij + exp(cs_last - cs_j) x_j . gn B_j + A da_j,
    where da_k = sum_{i>=k} dcs_i collects the decays' cotangents: R_ij =
    dM_ij M_ij to dcs_i and minus to dcs_j; exp(cs_i) dy_i . h_c C_i to
    dcs_i; T_j = w_j x_j . gn B_j minus to dcs_j and to dcs_last;
    exp(cs_last) <gn, h_c> to dcs_last. dA = sum dt da, dD = sum dy . x.
    Returns (dx, ddt, dA, dB, dC, dD, dh0) in the dtypes of x, dt, A, B, C,
    D and float32."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    r = h // g
    nc = -(-s // chunk)
    xf = _chunked(x, nc, chunk, g, r, p)                  # (b,c,Q,g,r,p)
    dyf = _chunked(dy, nc, chunk, g, r, p)
    dtf = _chunked(dt, nc, chunk, g, r)                   # (b,c,Q,g,r)
    Bf = _chunked(B, nc, chunk, g, n)                     # (b,c,Q,g,n)
    Cf = _chunked(C, nc, chunk, g, n)
    hin = h_in.float().reshape(b, nc, g, r, p, n)
    Af = A.float().reshape(g, r)
    cs = torch.cumsum(dtf * Af, dim=2)
    e = torch.exp(cs)
    last = cs[:, :, -1]                                   # (b,c,g,r)
    to_end = torch.exp(last[:, :, None] - cs)
    w = to_end * dtf
    # --- the reverse chain: gn[:, c] is the cotangent of the state leaving chunk c ---
    u = torch.einsum("bcigr,bcigrp,bcign->bcgrpn", e, dyf, Cf)
    state = (dfinal.float().reshape(b, g, r, p, n) if dfinal is not None
             else torch.zeros((b, g, r, p, n), dtype=torch.float32, device=x.device))
    gn = [state] * nc
    for c in reversed(range(nc)):
        gn[c] = state
        state = torch.exp(last[:, c])[..., None, None] * state + u[:, c]
    gn = torch.stack(gn, dim=1)                           # (b,c,g,r,p,n)
    # --- intra-chunk ---
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    diff = cs[:, :, :, None] - cs[:, :, None, :]          # (b,c,i,j,g,r)
    L = torch.exp(diff.masked_fill(~causal[:, :, None, None], float("-inf")))
    G = torch.einsum("bcign,bcjgn->bcijg", Cf, Bf)[..., None]
    dM = torch.einsum("bcigrp,bcjgrp->bcijgr", dyf, xf)
    Ldt = L * dtf[:, :, None]
    M = G * Ldt
    dG = dM * Ldt
    R = dM * M
    U = torch.einsum("bcgrpn,bcjgn->bcjgrp", gn, Bf)      # gn B_j
    xU = (xf * U).sum(-1)                                 # (b,c,Q,g,r)
    Dr = D.float().reshape(g, r)
    dx = (torch.einsum("bcijgr,bcigrp->bcjgrp", M, dyf) + w[..., None] * U
          + Dr[..., None] * dyf)
    V = torch.einsum("bcgrpn,bcigrp->bcigrn", hin, dyf)   # h_c^T dy_i
    dC = (torch.einsum("bcijgr,bcjgn->bcign", dG, Bf)
          + torch.einsum("bcigr,bcigrn->bcign", e, V))
    dB = (torch.einsum("bcijgr,bcign->bcjgn", dG, Cf)
          + torch.einsum("bcjgr,bcgrpn,bcjgrp->bcjgn", w, gn, xf))
    # --- the decays' cotangents ---
    dcs = (R.sum(3) - R.sum(2) + e * torch.einsum("bcigrn,bcign->bcigr", V, Cf) - w * xU)
    dcs[:, :, -1] += (w * xU).sum(2) + torch.exp(last) * (gn * hin).sum((-2, -1))
    da = torch.flip(torch.cumsum(torch.flip(dcs, [2]), dim=2), [2])
    ddt = (dM * G * L).sum(2) + to_end * xU + Af * da
    dA = (dtf * da).sum((0, 1, 2)).reshape(h)
    dD = (dyf * xf).sum((0, 1, 2, -1)).reshape(h)

    def rows(a, *tail):
        return a.reshape(b, nc * chunk, *tail)[:, :s]

    return (rows(dx, h, p).to(x.dtype), rows(ddt, h).to(dt.dtype), dA.to(A.dtype),
            rows(dB, g, n).to(B.dtype), rows(dC, g, n).to(C.dtype), dD.to(D.dtype),
            state.reshape(b, h, p, n))


def bwd_heads_per_block(h: int, g: int, blocks_per_head: int, slots: int) -> int:
    """Heads one backward block takes in turn: the divisor r of a group's
    H / G heads, at most ``MAX_HEADS_PER_BLOCK``, that needs the fewest
    head-times, waves x r, where a wave is ``slots`` blocks (the card's SMs
    times the blocks an SM holds) and the launch has ``blocks_per_head`` x
    H / r blocks; the larger r on a tie (fewer dB and dC partials, and B and
    C loaded once for more heads). mamba2-2.7b's training step (16 blocks a
    head over 132 SMs): 10 of its 80 heads, one wave of 128 blocks."""
    best = (0, 0)
    for r in range(1, min(h // g, MAX_HEADS_PER_BLOCK) + 1):
        if (h // g) % r == 0:
            cost = -(-(blocks_per_head * h // r) // slots) * r
            if best[1] == 0 or cost <= best[0]:
                best = (cost, r)
    return best[1]


def ssd_scan_bwd_tiled_plain(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor, D: torch.Tensor, h_in: torch.Tensor, dy: torch.Tensor,
    dfinal: Optional[torch.Tensor] = None, *, chunk: int, heads_per_block: int = 1,
) -> Tuple[torch.Tensor, ...]:
    """The backward kernel's algorithm in PyTorch, for the tests. One block
    per (chunk, block of ``heads_per_block`` heads of one group, batch), in
    ``bwd_ticket_block`` order, takes its heads in turn three times. Pass A,
    per head: gn, the cotangent of the state leaving the chunk (``dfinal``
    or zero for the last chunk, else the chain's slot for its (batch, head)),
    kept for pass B; g = exp(cs_last) gn + u published in the slot in place
    (it ends as dh0), u = sum_i exp(cs_i) dy_i (outer) C_i; <gn, h_c>; dx
    from G = C B^T tile by tile. Pass B, per head: G and dM = dy x^T, their
    sums over i (R and dM G L, for dcs and ddt), and the head's dB terms
    added to the block's dB. Pass C, per head: G and dM again, their sums
    over j, the head's dC terms added to the block's dC, then dcs, its
    reverse cumsum da, ddt and the head's partials of dA and dD. The block
    writes its dB and dC as one partial each; a second launch sums them
    over a group's head blocks in order, and dA and dD over the (batch,
    chunk) blocks in order. For bf16 inputs it rounds where the kernel's
    tensor-core products do: the f32 operands (M, dG, gn, the chunk state
    h_c and exp(cs) dy) enter as bf16 hi + lo pairs against the exact bf16
    partner, and <gn, h_c> takes gn as its pair; G and dM take the bf16
    inputs as they are. For f32 inputs nothing is rounded, as in the
    kernel's scalar f32 instantiation. Returns what
    :func:`ssd_scan_bwd_plain` returns."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    r, hb_n = h // g, h // heads_per_block
    if r % heads_per_block:
        raise ValueError(f"heads_per_block {heads_per_block} does not divide {r} heads a group")
    nc = -(-s // chunk)
    dev = x.device
    pair = _bf16_pair if x.dtype == torch.bfloat16 else (lambda a: (a,))
    xf, dyf = _chunked(x, nc, chunk, h, p), _chunked(dy, nc, chunk, h, p)
    dtf = _chunked(dt, nc, chunk, h)
    Bf, Cf = _chunked(B, nc, chunk, g, n), _chunked(C, nc, chunk, g, n)
    hin = h_in.float()
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=dev).tril()
    dx = torch.zeros((b, nc, chunk, h, p), dtype=torch.float32, device=dev)
    ddt = torch.zeros((b, nc, chunk, h), dtype=torch.float32, device=dev)
    part_B = torch.zeros((b, nc, chunk, hb_n, n), dtype=torch.float32, device=dev)
    part_C = torch.zeros_like(part_B)
    part_A = torch.zeros((b, nc, h), dtype=torch.float32, device=dev)
    part_D = torch.zeros_like(part_A)
    slot = torch.zeros((b, h, p, n), dtype=torch.float32, device=dev)

    def head(bb, c, hh, Bs, Cs):
        """Per-head values both passes recompute: cs and its decays, G, dM
        and L."""
        xs, dys, dts = xf[bb, c, :, hh], dyf[bb, c, :, hh], dtf[bb, c, :, hh]
        cs = torch.cumsum(dts * A[hh].float(), dim=0)
        L = torch.exp((cs[:, None] - cs[None, :]).masked_fill(~causal, float("-inf")))
        return xs, dys, dts, cs, L, Cs @ Bs.T, dys @ xs.T

    for t in range(nc * hb_n * b):
        c, hb, bb = bwd_ticket_block(t, nc, hb_n, b)
        heads = range(hb * heads_per_block, (hb + 1) * heads_per_block)
        gg = heads[0] // r
        Bs, Cs = Bf[bb, c, :, gg], Cf[bb, c, :, gg]
        dB, dC, saved = 0.0, 0.0, {}
        for hh in heads:        # pass A: the chain, dx
            xs, dys, dts, cs, L, G, dM = head(bb, c, hh, Bs, Cs)
            e, el, to_end = torch.exp(cs), torch.exp(cs[-1]), torch.exp(cs[-1] - cs)
            w = to_end * dts
            u = sum(part.T @ Cs for part in pair(e[:, None] * dys))          # (p, n)
            if c < nc - 1:
                gn = slot[bb, hh].clone()
            elif dfinal is not None:
                gn = dfinal[bb, hh].float()
            else:
                gn = torch.zeros((p, n), dtype=torch.float32, device=dev)
            slot[bb, hh] = el * gn + u
            M = G * L * dts[None, :]
            U = sum(Bs @ part.T for part in pair(gn))                        # (Q, p): gn B_j
            xU = (xs * U).sum(1)
            dx[bb, c, :, hh] = (w[:, None] * U + D[hh].float() * dys
                                + sum(part.T @ dys for part in pair(M)))
            dcs = -w * xU
            dcs[-1] += (w * xU).sum() + el * (sum(pair(gn)) * hin[bb, c, hh]).sum()
            saved[hh] = (gn, dcs, to_end * xU)
            part_D[bb, c, hh] = (dys * xs).sum()
        for hh in heads:        # pass B: dB
            xs, dys, dts, cs, L, G, dM = head(bb, c, hh, Bs, Cs)
            gn, dcs, ddt_a = saved[hh]
            w = torch.exp(cs[-1] - cs) * dts
            K = dM * G * L
            dB = dB + sum(part.T @ Cs for part in pair(dM * L * dts[None, :]))
            dB = dB + w[:, None] * sum(xs @ part for part in pair(gn))
            saved[hh] = (dcs - (K * dts[None, :]).sum(0), ddt_a + K.sum(0))
        for hh in heads:        # pass C: dC, dcs, ddt, dA
            dcs, ddt_a = saved[hh]
            xs, dys, dts, cs, L, G, dM = head(bb, c, hh, Bs, Cs)
            e = torch.exp(cs)
            V = sum(dys @ part for part in pair(hin[bb, c, hh]))            # (Q, n): h_c^T dy_i
            dC = dC + e[:, None] * V + sum(part @ Bs for part in pair(dM * L * dts[None, :]))
            dcs = dcs + (dM * G * L * dts[None, :]).sum(1) + e * (V * Cs).sum(1)
            da = torch.flip(torch.cumsum(torch.flip(dcs, [0]), dim=0), [0])
            ddt[bb, c, :, hh] = ddt_a + A[hh].float() * da
            part_A[bb, c, hh] = (dts * da).sum()
        part_B[bb, c, :, hb], part_C[bb, c, :, hb] = dB, dC
    # the fixed-order sums: a group's head blocks in order, the blocks in (batch, chunk) order
    per = hb_n // g
    part_B = part_B.reshape(b, nc, chunk, g, per, n)
    part_C = part_C.reshape(b, nc, chunk, g, per, n)
    dB, dC = part_B[..., 0, :], part_C[..., 0, :]
    for k in range(1, per):
        dB, dC = dB + part_B[..., k, :], dC + part_C[..., k, :]
    dA, dD = torch.zeros(h, device=dev), torch.zeros(h, device=dev)
    for k in range(b * nc):
        dA, dD = dA + part_A.reshape(b * nc, h)[k], dD + part_D.reshape(b * nc, h)[k]

    def rows(t, *tail):
        return t.reshape(b, nc * chunk, *tail)[:, :s]

    return (rows(dx, h, p).to(x.dtype), rows(ddt, h).to(dt.dtype), dA.to(A.dtype),
            rows(dB, g, n).to(B.dtype), rows(dC, g, n).to(C.dtype), dD.to(D.dtype), slot)


@functools.cache
def _kernel():
    fn = _build.load("ssd_scan").ssd_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernel():
    fn = _build.load("ssd_scan_bwd").ssd_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def bwd_slots(device_index: int, p: int, n: int, chunk: int, dtype: torch.dtype) -> int:
    """Backward blocks the card runs at once at (P, N, chunk) and dtype:
    its SMs times the blocks an SM holds (the CUDA occupancy query)."""
    fn = _build.load("ssd_scan_bwd").ssd_scan_bwd_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = fn(p, n, chunk, DTYPE_CODES[dtype], ctypes.byref(per_sm))
    if err or per_sm.value < 1:
        raise RuntimeError("ssd_scan backward occupancy query failed: "
                           f"{_error_string(err, 'ssd_scan_bwd')} ({per_sm.value} blocks an SM)")
    return per_sm.value * torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.cache
def _error_string(err: int, source: str = "ssd_scan") -> str:
    fn = getattr(_build.load(source), f"{source}_error_string")
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()


_syncs = {}  # device index -> int32 ticket counter and the chain's flags, zeroed once


def _sync_buffer(x, n):
    """The chained scans' ticket counter and their flags (the forward's per
    (batch, head, column half), the backward's per (batch, head)): ``n``
    int32, allocated zeroed at first use (or when a launch needs more) and
    left zero by every launch of either kernel; so launches that share a
    device run in one stream's order."""
    buf = _syncs.get(x.device.index)
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
    initial_state: Optional[torch.Tensor] = None, return_chunk_states: bool = False,
):
    """Launch the CUDA kernel on PyTorch's current stream; raises on a CPU
    tensor, on an input it does not take, or if the launch fails. Returns
    (y, final state), and with ``return_chunk_states`` also the state
    entering each chunk, (B, nc, H, P, N) f32, for the backward."""
    global launches
    _check(x, dt, A, B, C, D, chunk, initial_state)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    y = torch.empty_like(x)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    h_in = (torch.empty((b, -(-s // chunk), h, p, n), dtype=torch.float32, device=x.device)
            if return_chunk_states else None)
    err = _kernel()(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(),
        0 if initial_state is None else initial_state.data_ptr(), y.data_ptr(),
        final.data_ptr(), 0 if h_in is None else h_in.data_ptr(),
        _sync_buffer(x, 1 + p // COLUMNS * b * h).data_ptr(), b, s, h, p, g, n, chunk,
        DTYPE_CODES[x.dtype],
        torch.cuda.current_stream().cuda_stream,
    )
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: {_error_string(err)}")
    launches += 1
    return (y, final, h_in) if return_chunk_states else (y, final)


def ssd_scan_bwd_kernel(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor, D: torch.Tensor, h_in: torch.Tensor, dy: torch.Tensor,
    dfinal: Optional[torch.Tensor] = None, *, chunk: int, drop_decay_grad: bool = False,
    heads_per_block: Optional[int] = None,
) -> Tuple[torch.Tensor, ...]:
    """Launch the backward kernel (``BWD_KERNELS`` launches on PyTorch's
    current stream): (dx, ddt, dA, dB, dC, dD, dh0) as
    :func:`ssd_scan_bwd_plain` returns them. ``dfinal`` None is a zero
    cotangent of the final state. ``drop_decay_grad`` drops the decays'
    cotangent (dcs = 0: ddt keeps its direct terms, dA is zero), a wrong
    gradient for controls that must be caught. ``heads_per_block`` (a
    divisor of H / G, at most ``MAX_HEADS_PER_BLOCK``) defaults to
    :func:`bwd_heads_per_block` for this card. Raises on a CPU tensor, on
    an input it does not take, or if a launch fails."""
    global bwd_launches
    _check(x, dt, A, B, C, D, chunk, None)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc = -(-s // chunk)
    if heads_per_block is None:
        heads_per_block = bwd_heads_per_block(
            h, g, nc * b, bwd_slots(x.device.index, p, n, chunk, x.dtype))
    if not (1 <= heads_per_block <= MAX_HEADS_PER_BLOCK and (h // g) % heads_per_block == 0):
        raise ValueError(f"heads_per_block {heads_per_block} must divide the {h // g} heads of "
                         f"a group and be at most {MAX_HEADS_PER_BLOCK}")
    wants = {"h_in": (h_in, (b, nc, h, p, n), torch.float32), "dy": (dy, x.shape, x.dtype)}
    if dfinal is not None:
        wants["dfinal"] = (dfinal, (b, h, p, n), torch.float32)
    for name, (t, shape, dtype) in wants.items():
        if (t.shape != shape or t.dtype != dtype or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dtype} {tuple(shape)} tensor on "
                             f"{x.device}; got {tuple(t.shape)} {t.dtype} on {t.device}")
    if dy.data_ptr() % 16:
        raise ValueError("dy must start on a 16-byte boundary")
    if max(x.numel(), B.numel(), h_in.numel()) >= 2 ** 31:
        raise ValueError("the backward kernel indexes x, B and the chunk states in 32 bits; "
                         f"got {x.numel()}, {B.numel()} and {h_in.numel()} elements")
    dev = x.device
    dx, dB, dC = torch.empty_like(x), torch.empty_like(B), torch.empty_like(C)
    ddt = torch.empty((b, s, h), dtype=torch.float32, device=dev)
    dA, dD = (torch.empty((h,), dtype=torch.float32, device=dev) for _ in range(2))
    dh0 = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)   # also the chain's slot
    gsave = torch.empty_like(h_in)                        # gn of each chunk, for the dB pass
    part_B, part_C = (torch.empty((b, s, h // heads_per_block, n), dtype=torch.float32,
                                  device=dev) for _ in range(2))   # per head block
    part_A, part_D = (torch.empty((b, nc, h), dtype=torch.float32, device=dev)
                      for _ in range(2))                  # per (batch, chunk, head)
    err = _bwd_kernel()(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(),
        h_in.data_ptr(), dy.data_ptr(), 0 if dfinal is None else dfinal.data_ptr(),
        dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        dD.data_ptr(), dh0.data_ptr(), gsave.data_ptr(), part_B.data_ptr(), part_C.data_ptr(),
        part_A.data_ptr(), part_D.data_ptr(), _sync_buffer(x, 1 + b * h).data_ptr(),
        b, s, h, p, g, n, chunk, heads_per_block, DTYPE_CODES[x.dtype], int(drop_decay_grad),
        torch.cuda.current_stream().cuda_stream,
    )
    if err:
        raise RuntimeError("ssd_scan backward kernel launch failed: "
                           f"{_error_string(err, 'ssd_scan_bwd')}")
    bwd_launches += BWD_KERNELS
    return dx, ddt, dA, dB, dC, dD, dh0


class SsdScanFn(torch.autograd.Function):
    """The SSD scan with the kernels on both sides: the forward kernel,
    keeping the state entering each chunk for the backward, and the
    backward kernel. CUDA tensors only."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, initial_state, chunk: int):
        y, final, h_in = ssd_scan_kernel(x, dt, A, B, C, D, chunk=chunk,
                                         initial_state=initial_state, return_chunk_states=True)
        ctx.save_for_backward(x, dt, A, B, C, D, h_in)
        ctx.chunk, ctx.has_h0 = chunk, initial_state is not None
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, B, C, D, h_in = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.to(x.dtype).contiguous()
        if dfinal is not None:
            dfinal = dfinal.float().contiguous()
        dx, ddt, dA, dB, dC, dD, dh0 = ssd_scan_bwd_kernel(
            x, dt, A, B, C, D, h_in, dy, dfinal, chunk=ctx.chunk)
        return dx, ddt, dA, dB, dC, dD, dh0 if ctx.has_h0 else None, None
