"""The plain f32 forward of a Mamba2 (SSD) model.

    h = embed[tokens]
    per layer:  u = rms(h) * ln
                z = u Wz;  x = silu(conv_x(u Wx));  B = silu(conv_B(u WB));
                C = silu(conv_C(u WC));  dt = softplus(u Wdt + dt_bias)
                (conv: depthwise, causal, kernel K, with bias)
                y_t = C_t . s_t + D x_t,   s_t = exp(dt_t A) s_{t-1} + dt_t x_t B_t^T,
                A = -exp(A_log), s_{-1} = 0          (per head; B, C shared by a group)
                h += rms(y * silu(z)) * norm_w  Wout
    logits = (rms(h) * final_norm) lm_head

The recurrence is evaluated exactly in chunks of ``CHUNK`` tokens (the
state-space dual form: within a chunk the decays between every pair of
positions, between chunks the carried state), all in f32 with TF32 off.
Streamed layer by layer like the dense reference; the shared trunk is run
once and its conv inputs and final state start every sequence after it.

``quant`` computes the products and the scan's inputs in fp8: the control.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.common import Seqs, lm_logits, mm, rms

CHUNK = 128
ROW_BLOCK = 4096


def _conv(xc: torch.Tensor, w: torch.Tensor, b: torch.Tensor, tail: Optional[torch.Tensor]
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise conv + SiLU of xc (S, C); ``tail`` (K-1, C) are the
    raw inputs before it (zeros where None). Returns (out, the last K-1 raw
    inputs)."""
    k = w.shape[0]
    pad = tail if tail is not None else xc.new_zeros((k - 1, xc.shape[1]))
    xp = torch.cat([pad, xc])
    s = xc.shape[0]
    out = b + sum(xp[i:i + s] * w[i] for i in range(k))
    return F.silu(out), xp[s:]


def ssd(x, dt, A, B, C, state) -> Tuple[torch.Tensor, torch.Tensor]:
    """y (S, H, P) and the final state (H, P, N) of the recurrence from
    ``state``. x (S, H, P), dt (S, H), A (H,), B / C (S, G, N)."""
    s, h, p = x.shape
    if s == 0:
        return x, state
    g, n = B.shape[1], B.shape[2]
    rep = h // g
    nc = -(-s // CHUNK)
    pad = nc * CHUNK - s

    def chunks(t):              # (S, ...) -> (nc, Q, ...), zero-padded; dt = 0 there
        return F.pad(t, (0, 0) * (t.dim() - 1) + (0, pad)).view(nc, CHUNK, *t.shape[1:])

    cs = torch.cumsum(chunks(dt * A), dim=1)                       # (c, Q, H) log decays
    xb = chunks(x * dt[:, :, None])                                # (c, Q, H, P)
    Bh = chunks(B.repeat_interleave(rep, dim=1))                   # (c, Q, H, N)
    Ch = chunks(C.repeat_interleave(rep, dim=1))
    causal = torch.ones((CHUNK, CHUNK), dtype=torch.bool, device=x.device).tril()
    decay = torch.where(causal[None, :, :, None],
                        torch.exp((cs[:, :, None, :] - cs[:, None, :, :]).clamp(max=0.0)), 0.0)
    cb = torch.einsum("cihn,cjhn->cijh", Ch, Bh) * decay           # (c, Qi, Qj, H)
    y = torch.einsum("cijh,cjhp->cihp", cb, xb)
    del cb, decay
    last = cs[:, -1]                                               # (c, H)
    adds = torch.einsum("cjh,cjhp,cjhn->chpn", torch.exp(last[:, None, :] - cs), xb, Bh)
    starts = []
    for c in range(nc):                                            # the carried state
        starts.append(state)
        state = state * torch.exp(last[c])[:, None, None] + adds[c]
    y += torch.einsum("cihn,chpn->cihp", Ch, torch.stack(starts)) * torch.exp(cs)[..., None]
    return y.reshape(nc * CHUNK, h, p)[:s], state


def _layer(blk, cfg, hs: List[torch.Tensor], seqs: Seqs, quant) -> None:
    p = {k: v.float() for k, v in blk["ssm"].items()}
    s = cfg.ssm
    nh, hp, g, n = s.n_heads(cfg.d_model), s.head_dim, s.n_groups, s.d_state
    ln = blk["ln"].float()
    A = -torch.exp(p["A_log"])
    trunk_state = (None, None, None, None)
    for i, h in enumerate(hs):
        start = trunk_state if i > 0 and seqs.trunk else (None, None, None, None)
        u = rms(h, ln, cfg.norm_eps)
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
        for a in range(0, h.shape[0], ROW_BLOCK):
            o = rms(y[a:a + ROW_BLOCK] * F.silu(z[a:a + ROW_BLOCK]), p["norm_w"], cfg.norm_eps)
            h[a:a + ROW_BLOCK] += mm(o, p["out_proj"], quant)


def logits(params, cfg, seqs: Seqs, quant: Optional[object] = None) -> List[torch.Tensor]:
    """For each sequence, the f32 logits that predict its ``positions``."""
    emb = params["embed"]
    hs = [emb[t].float() for t in seqs.pieces()]
    for blk in params["blocks"]:
        _layer(blk, cfg, hs, seqs, quant)
    return lm_logits(params, cfg, hs, seqs, quant)


def check_cfg(cfg) -> None:
    if cfg.family != "ssm":
        raise ValueError(f"the Mamba2 reference runs a pure SSM model, not {cfg.name}")
