"""The plain f32 forward of a Zamba2 hybrid (Zamba2-7B's layer equations).

    h = e = embed[tokens]
    per layer i:  x = h
                  at a hybrid layer (site k, the k-th of ``hybrid_sites``),
                  with shared block b = k mod n_shared_blocks:
                    u = rms(concat(h, e)) * ln1_b                        (width 2d)
                    q, k, v = u Wq_b, u Wk_b, u Wv_b;  q, k = rope(q), rope(k)
                    a = softmax(q k^T * s, causal) v  Wo_b,  s = (hd / 2)^-1/2
                    y = rms(a) * ln2_b;  g | up = y W_gate_up_b + (y A_k) B_k
                    x = h + (gelu(g) * up) W_down_b  P_k           (A_k, B_k: the
                                                         site's LoRA; P_k its projection)
                  h += Mamba2(rms(x) * ln)       (the residual is h, not x)
    logits = (rms(h) * final_norm) lm_head

The Mamba2 mixer is the SSD reference's (``reference.mamba2``: the causal
convolutions and the exact chunked recurrence), with its gated norm taken
per group of d_inner / n_groups. Plain torch in float32 with TF32 off,
streamed layer by layer like the other references: each layer's weights are
cast to f32 once and dropped, and the sequences' common trunk is run once,
its conv inputs, final states and each site's keys and values starting every
sequence after it. Weights are the tree the benchmark drew (the port's
parameter layout); nothing else is taken from the program.

``quant`` (``reference.quant.Fp8``) computes every product, the scan's
inputs and the attention's operands in fp8 instead: the control.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from portbench.reference.common import Seqs, lm_logits, mm, rms
from portbench.reference.mamba2 import _conv, ssd

Q_BLOCK = 512
ROW_BLOCK = 2048


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding over all of x's (S, heads, hd) dims."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = pos.to(torch.float32)[:, None] * inv[None, :]
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, q0: int, scale: float, quant) -> torch.Tensor:
    """Causal attention (one kv head a query head) of queries at positions
    q0 .. q0 + Sq - 1 against keys at 0 .. Sk - 1. q (Sq, H, hd), k / v
    (Sk, H, hd)."""
    if quant is not None:
        q, k, v = quant.act(q), quant.act(k), quant.act(v)
    out = torch.empty_like(q)
    kpos = torch.arange(k.shape[0], device=q.device)
    for a in range(0, q.shape[0], Q_BLOCK):
        b = min(a + Q_BLOCK, q.shape[0])
        hi = q0 + b
        s = torch.einsum("qhd,shd->hqs", q[a:b], k[:hi]) * scale
        qpos = torch.arange(q0 + a, q0 + b, device=q.device)
        s = s.masked_fill(kpos[None, :hi] > qpos[:, None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        if quant is not None:
            p = quant.act(p)
        out[a:b] = torch.einsum("hqs,shd->qhd", p, v[:hi])
    return out


def _shared(params, cfg, k: int, hs, es, seqs: Seqs, quant) -> List[torch.Tensor]:
    """Site k's output for the trunk and every branch."""
    blk = params["shared_blocks"][k % cfg.n_shared_blocks]
    site = {n: w.float() for n, w in params["sites"][k].items()}
    w = {n: t.float() for n, t in blk["attn"].items()}
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    scale = (hd / 2) ** -0.5
    ln1, ln2 = blk["ln1"].float(), blk["ln2"].float()
    attn, trunk_kv = [], None
    for i, (h, e) in enumerate(zip(hs, es, strict=True)):
        u = rms(torch.cat([h, e], dim=-1), ln1, cfg.norm_eps)
        off = 0 if i == 0 else seqs.trunk
        pos = torch.arange(off, off + h.shape[0], device=h.device)
        q = _rope(mm(u, w["wq"], quant).view(-1, H, hd), pos, cfg.rope_theta)
        kk = _rope(mm(u, w["wk"], quant).view(-1, H, hd), pos, cfg.rope_theta)
        v = mm(u, w["wv"], quant).view(-1, H, hd)
        if i == 0:
            trunk_kv = (kk, v)
        elif seqs.trunk:
            kk, v = torch.cat([trunk_kv[0], kk]), torch.cat([trunk_kv[1], v])
        attn.append(mm(_attend(q, kk, v, off, scale, quant).reshape(-1, H * hd), w["wo"],
                       quant))
    del w, trunk_kv
    m = {n: t.float() for n, t in blk["mlp"].items()}
    out = []
    for a in attn:
        t = torch.empty_like(a)
        for r in range(0, a.shape[0], ROW_BLOCK):
            y = rms(a[r:r + ROW_BLOCK], ln2, cfg.norm_eps)
            gu = mm(y, m["w_gate_up"], quant) + mm(mm(y, site["lora_a"], quant), site["lora_b"],
                                                   quant)
            g, up = gu.chunk(2, dim=-1)
            t[r:r + ROW_BLOCK] = mm(mm(F.gelu(g) * up, m["w_down"], quant), site["proj"], quant)
        out.append(t)
    return out


def _mamba(blk, cfg, hs, xs, seqs: Seqs, quant) -> None:
    """h += Mamba2(rms(x) * ln) for the trunk and every branch, in place."""
    p = {k: v.float() for k, v in blk["ssm"].items()}
    s = cfg.ssm
    nh, hp, g, n = s.n_heads(cfg.d_model), s.head_dim, s.n_groups, s.d_state
    ln = blk["ln"].float()
    A = -torch.exp(p["A_log"])
    trunk_state = (None, None, None, None)
    for i, (h, x_in) in enumerate(zip(hs, xs, strict=True)):
        start = trunk_state if i > 0 and seqs.trunk else (None, None, None, None)
        u = rms(x_in, ln, cfg.norm_eps)
        z = mm(u, p["w_z"], quant)
        x, tx = _conv(mm(u, p["w_x"], quant), p["conv_x_w"], p["conv_x_b"], start[0])
        Bm, tb = _conv(mm(u, p["w_B"], quant), p["conv_B_w"], p["conv_B_b"], start[1])
        Cm, tc = _conv(mm(u, p["w_C"], quant), p["conv_C_w"], p["conv_C_b"], start[2])
        dt = F.softplus(mm(u, p["w_dt"], quant) + p["dt_bias"])
        if quant is not None:
            x, Bm, Cm = quant.act(x), quant.act(Bm), quant.act(Cm)
        st0 = start[3] if start[3] is not None else x.new_zeros((nh, hp, n))
        S = h.shape[0]
        y, st = ssd(x.view(S, nh, hp), dt, A, Bm.view(S, g, n), Cm.view(S, g, n), st0)
        y = y.reshape(S, nh * hp) + (p["D"].repeat_interleave(hp) * x)
        if i == 0:
            trunk_state = (tx, tb, tc, st)
        di = nh * hp
        for a in range(0, S, ROW_BLOCK):
            gated = (y[a:a + ROW_BLOCK] * F.silu(z[a:a + ROW_BLOCK])).view(-1, g, di // g)
            o = rms(gated, p["norm_w"].view(g, di // g), cfg.norm_eps).reshape(-1, di)
            h[a:a + ROW_BLOCK] += mm(o, p["out_proj"], quant)


def logits(params, cfg, seqs: Seqs, quant: Optional[object] = None) -> List[torch.Tensor]:
    """For each sequence, the f32 logits that predict its ``positions``."""
    emb = params["embed"]
    es = [emb[t].float() for t in seqs.pieces()]
    hs = [e.clone() for e in es]
    sites = {layer: k for k, layer in enumerate(cfg.hybrid_sites)}
    for i, blk in enumerate(params["blocks"]):
        xs = hs
        if i in sites:
            ts = _shared(params, cfg, sites[i], hs, es, seqs, quant)
            xs = [h + t for h, t in zip(hs, ts, strict=True)]
        _mamba(blk, cfg, hs, xs, seqs, quant)
    return lm_logits(params, cfg, hs, seqs, quant)


def check_cfg(cfg) -> None:
    if (cfg.family != "hybrid" or not cfg.hybrid_sites or cfg.n_heads != cfg.n_kv_heads
            or cfg.head_pad_multiple or cfg.sliding_window is not None):
        raise ValueError(f"the Zamba2 reference runs a Zamba2 hybrid, not {cfg.name}")
