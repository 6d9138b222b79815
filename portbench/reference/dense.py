"""The plain f32 forward of a dense GQA decoder (Qwen2's layer equations).

    h = embed[tokens]
    per layer:  x = rms(h) * ln1;  q, k, v = x Wq + bq, x Wk + bk, x Wv + bv
                q, k = rope(q), rope(k)     (half-split, theta ** (-2i / hd))
                h += softmax(q k^T / sqrt(hd), causal) v  Wo      (GQA: H / KV
                                                                  query heads a kv head)
                x = rms(h) * ln2;  h += (silu(x Wg) * (x Wu)) Wd
    logits = (rms(h) * final_norm) lm_head

Plain torch in float32 with TF32 off, streamed layer by layer: every
sequence is carried through one layer before the next is read, each
layer's weights are cast to f32 once and dropped, attention runs over
blocks of query rows, and the sequences' common first ``trunk`` tokens
(the shared system prompt) are computed once, their keys and values
reused by every sequence. Weights are the tree the benchmark drew (the
port's parameter layout); nothing else is taken from the program.

``quant`` (``reference.quant.Fp8``) computes every product in fp8 instead:
the control of the correctness check.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch

from portbench.reference.common import Seqs, lm_logits, mm, rms

Q_BLOCK = 512
ROW_BLOCK = 2048


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, hd) f32 at positions ``pos`` (S,)."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = pos.to(torch.float32)[:, None] * inv[None, :]
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, q0: int, quant) -> torch.Tensor:
    """Causal GQA attention of queries at positions q0 .. q0 + Sq - 1
    against keys at 0 .. Sk - 1. q (Sq, H, hd), k / v (Sk, KV, hd)."""
    sq, h, hd = q.shape
    kv = k.shape[1]
    g = h // kv
    if quant is not None:
        q, k, v = quant.act(q), quant.act(k), quant.act(v)
    out = torch.empty_like(q)
    kpos = torch.arange(k.shape[0], device=q.device)
    for a in range(0, sq, Q_BLOCK):
        b = min(a + Q_BLOCK, sq)
        qb = q[a:b].reshape(b - a, kv, g, hd)
        hi = q0 + b                                   # keys visible to the block's last row
        s = torch.einsum("qkgd,skd->kgqs", qb, k[:hi]) / math.sqrt(hd)
        qpos = torch.arange(q0 + a, q0 + b, device=q.device)
        s = s.masked_fill(kpos[None, :hi] > qpos[:, None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        if quant is not None:
            p = quant.act(p)
        out[a:b] = torch.einsum("kgqs,skd->qkgd", p, v[:hi]).reshape(b - a, h, hd)
    return out


def _layer(blk, cfg, hs: List[torch.Tensor], seqs: Seqs, quant) -> None:
    """One decoder layer over the trunk (hs[0]) and every branch (hs[1:]),
    in place."""
    w = {k: v.float() for k, v in blk["attn"].items()}
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    ln1, ln2 = blk["ln1"].float(), blk["ln2"].float()
    trunk_kv = None
    for i, h in enumerate(hs):
        x = rms(h, ln1, cfg.norm_eps)
        q, k, v = mm(x, w["wq"], quant), mm(x, w["wk"], quant), mm(x, w["wv"], quant)
        if "bq" in w:
            q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
        off = 0 if i == 0 else seqs.trunk
        pos = torch.arange(off, off + h.shape[0], device=h.device)
        q = _rope(q.view(-1, H, hd), pos, cfg.rope_theta)
        k = _rope(k.view(-1, KV, hd), pos, cfg.rope_theta)
        v = v.view(-1, KV, hd)
        if i == 0:
            trunk_kv = (k, v)
        elif seqs.trunk:
            k, v = torch.cat([trunk_kv[0], k]), torch.cat([trunk_kv[1], v])
        o = _attend(q, k, v, off, quant)
        h += mm(o.reshape(h.shape[0], H * hd), w["wo"], quant)
    del w
    m = {k: v.float() for k, v in blk["mlp"].items()}
    for h in hs:
        for a in range(0, h.shape[0], ROW_BLOCK):
            x = rms(h[a:a + ROW_BLOCK], ln2, cfg.norm_eps)
            y = torch.nn.functional.silu(mm(x, m["w_gate"], quant)) * mm(x, m["w_up"], quant)
            h[a:a + ROW_BLOCK] += mm(y, m["w_down"], quant)


def logits(params, cfg, seqs: Seqs, quant: Optional[object] = None) -> List[torch.Tensor]:
    """For each sequence, the f32 logits (len(positions), vocab) that
    predict the tokens at its ``positions``."""
    emb = params["embed"]
    hs = [emb[t].float() for t in seqs.pieces()]
    for blk in params["blocks"]:
        _layer(blk, cfg, hs, seqs, quant)
    return lm_logits(params, cfg, hs, seqs, quant)


def check_cfg(cfg) -> None:
    if cfg.family != "dense" or cfg.sliding_window is not None or cfg.head_pad_multiple:
        raise ValueError(f"the dense reference runs a plain dense decoder, not {cfg.name}")

