"""Peaks of the card and the operations and bytes of each kernel call.

Peaks: NVIDIA's data sheet for one H100 SXM, dense rates, at its full power
limit of 700 W (``POWER_LIMIT_W``); a run prints the card's own limit
beside them. A kernel's least time is the larger of its operations over the
peak rate and its bytes over the peak bandwidth, with each input byte read
once and each output byte written once. The counts follow the work these
inputs need, not what a kernel re-reads:

* ``flash_attention`` (causal, q (S, H, hd) against k/v (S, KV, hd)):
  QK^T and PV over the S (S + 1) / 2 visible pairs of every head;
* ``decode_attention`` (q (B, H, hd) against each row's first ``len``
  cached keys and values, ``len`` the row's effective length, never Smax);
* ``ssd_scan`` (x (S, H, P), dt (S, H), B / C (S, G, N)): the recurrence,
  per token and head a decay of the (P, N) state, the dt x B^T update, the
  C h read-out and the D skip.

Model FLOPs (for ``model.mfu``) count the matrix products of the weights
(2 per parameter and token), the attention or scan above, and the LM head
only where the program computes logits: the last position of a prefill and
every row of a decode step.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

PEAK_FLOPS_BF16 = 989e12      # dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12          # HBM3
POWER_LIMIT_W = 700.0         # the limit the peaks assume

# the __global__ functions of each kernel, as the profiler names them
KERNELS: Dict[str, Tuple[str, ...]] = {
    "flash_attention": ("flash_attention_bf16_kernel", "flash_attention_f32_kernel"),
    "decode_attention": ("decode_attention_kernel",),
    "ssd_scan": ("ssd_scan_kernel",),
}


def kernel_of(name: str):
    """Which of :data:`KERNELS` a profiled kernel name is, or None."""
    for k, symbols in KERNELS.items():
        if any(s in name for s in symbols) and "bwd" not in name:
            return k
    return None


def least_seconds(flops: float, nbytes: float, peak_flops: float = PEAK_FLOPS_BF16) -> float:
    return max(flops / peak_flops, nbytes / PEAK_BYTES)


def flash_counts(s: int, h: int, kv: int, hd: int, el: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of one causal prefill attention."""
    pairs = s * (s + 1) / 2
    return 4.0 * pairs * h * hd, float(el * (2 * s * h * hd + 2 * s * kv * hd))


def decode_counts(lens: Sequence[int], h: int, kv: int, hd: int, el: int = 2
                  ) -> Tuple[float, float]:
    """(operations, bytes) of one batched decode attention; ``lens`` are the
    rows' effective lengths (the keys each row attends to)."""
    n = float(sum(lens))
    b = len(lens)
    return 4.0 * n * h * hd, el * (2.0 * n * kv * hd + 2.0 * b * h * hd) + 4.0 * b


def ssd_counts(s: int, h: int, p: int, g: int, n: int, el: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of one SSD scan of a sequence of ``s`` tokens
    from a zero state, returning y and the final state."""
    flops = float(s) * h * (5.0 * p * n + 2.0 * p)
    nbytes = (el * s * h * p * 2          # x in, y out
              + 4 * s * h                 # dt (f32)
              + el * 2 * s * g * n        # B, C
              + 4 * 2 * h                 # A, D
              + 4 * h * p * n)            # final state (f32)
    return flops, float(nbytes)


# -- the model ---------------------------------------------------------------

def _dims(cfg):
    hd = cfg.resolved_head_dim
    return cfg.d_model, cfg.n_heads, cfg.n_kv_heads, hd


def attention_layers(cfg) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def ssd_layers(cfg) -> int:
    return cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0


def ssd_dims(cfg) -> Tuple[int, int, int, int]:
    s = cfg.ssm
    return s.n_heads(cfg.d_model), s.head_dim, s.n_groups, s.d_state


def matmul_params(cfg) -> int:
    """Weights that enter a matrix product for every token (not the
    embedding, not the LM head)."""
    d, h, kv, hd = _dims(cfg)
    n = 0
    if cfg.family in ("ssm", "hybrid"):
        nh, _, g, st = ssd_dims(cfg)
        di = cfg.ssm.d_inner(d)
        n += cfg.n_layers * (d * (2 * di + 2 * g * st + nh) + di * d)
    if cfg.family == "dense":
        n += cfg.n_layers * (d * (h + 2 * kv) * hd + h * hd * d + 3 * d * cfg.d_ff)
    if cfg.family == "hybrid":
        n += attention_layers(cfg) * (d * (h + 2 * kv) * hd + h * hd * d)
    return n


def prefill_flops(cfg, s: int) -> float:
    d, h, kv, hd = _dims(cfg)
    f = 2.0 * matmul_params(cfg) * s + 2.0 * d * cfg.vocab_size
    f += attention_layers(cfg) * flash_counts(s, h, kv, hd)[0]
    if ssd_layers(cfg):
        nh, p, g, n = ssd_dims(cfg)
        f += ssd_layers(cfg) * ssd_counts(s, nh, p, g, n)[0]
    return f


def decode_flops(cfg, lens: Sequence[int]) -> float:
    """FLOPs of a decode step's rows of effective lengths ``lens``."""
    d, h, kv, hd = _dims(cfg)
    f = len(lens) * (2.0 * matmul_params(cfg) + 2.0 * d * cfg.vocab_size)
    f += attention_layers(cfg) * decode_counts(lens, h, kv, hd)[0]
    if ssd_layers(cfg):
        nh, p, g, n = ssd_dims(cfg)
        f += ssd_layers(cfg) * len(lens) * ssd_counts(1, nh, p, g, n)[0]
    return f


def effective_lengths(lengths: Sequence[int], smax: int) -> Sequence[int]:
    """The keys each row's decode attention visits: its cached length,
    clamped as the engine writes the new row at ``min(len, smax - 1)``,
    plus the new one."""
    return [min(n, smax - 1) + 1 for n in lengths]


def kernel_least_seconds(cfg, shapes: Dict[str, list], smax: int) -> Dict[str, float]:
    """The least seconds of every call of each kernel over a traced window,
    from the calls' shapes the loop logged: one prefill (its length) calls
    flash_attention once an attention layer and ssd_scan once an SSD layer;
    one step (every row's cached length) calls decode_attention once an
    attention layer."""
    d, h, kv, hd = _dims(cfg)
    out = {k: 0.0 for k in KERNELS}
    for s, _spec in shapes["prefill"]:
        if attention_layers(cfg):
            out["flash_attention"] += attention_layers(cfg) * least_seconds(
                *flash_counts(s, h, kv, hd))
        if ssd_layers(cfg):
            nh, p, g, n = ssd_dims(cfg)
            out["ssd_scan"] += ssd_layers(cfg) * least_seconds(*ssd_counts(s, nh, p, g, n))
    if attention_layers(cfg):
        for lengths, _auth in shapes["step"]:
            out["decode_attention"] += attention_layers(cfg) * least_seconds(
                *decode_counts(effective_lengths(lengths, smax), h, kv, hd))
    return out


def model_flops(cfg, shapes: Dict[str, list], smax: int) -> float:
    """Model FLOPs of the authoritative prefills and decode rows logged
    over a traced window (speculative work is left out)."""
    f = sum(prefill_flops(cfg, s) for s, spec in shapes["prefill"] if not spec)
    for lengths, auth in shapes["step"]:
        rows = [n for n, a in zip(effective_lengths(lengths, smax), auth, strict=True) if a]
        if rows:
            f += decode_flops(cfg, rows)
    return f
