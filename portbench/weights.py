"""Random weights from the seed, made on the device in a few large calls.

The tree has the port's parameter layout (its leaves' names, shapes and
dtypes, read from ``init_params`` on the meta device, which draws nothing).
Every leaf is a view into one flat buffer per dtype: the bf16 buffer is
drawn with one ``normal_`` call and scaled in a few calls, one a run of
leaves of one kind and scale; the float32 leaves of the SSM layers
(``A_log``, ``D``, ``dt_bias``) are drawn with one ``uniform_`` and mapped
the same way. The distributions:

* ``embed``, ``lm_head``: normal, std 0.02 (``lm_head`` is ``embed``'s
  transpose where the configuration ties them);
* every other matrix (in, out): normal, std 1 / sqrt(in);
* norms' weights and ``D``: ones;
* attention's QKV biases: normal, std 0.02 (the port draws zeros; a bias
  that is drawn makes the check see its path). A std of 0.5 adds to every
  layer a vector that is the same at every position (softmax weights sum
  to one), which then sets every logit: the model served one token over
  and over, and the check saw nothing;
* the Mamba2 convolutions' biases: normal, std 0.5 (PyTorch's ``Conv1d``
  draws them from U[-0.5, 0.5] at a kernel of 4);
* ``A_log``: log U[1, 16]; ``dt_bias``: the inverse softplus of a dt drawn
  log-uniform in [dt_min, dt_max], as Mamba2 initialises them.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

NORMS = ("ln", "ln1", "ln2", "final_norm", "norm_w")
QKV_BIASES = ("bq", "bk", "bv")
QKV_BIAS_STD = 0.02
CONV_BIASES = ("conv_x_b", "conv_B_b", "conv_C_b")
CONV_BIAS_STD = 0.5
ALIGN = 64  # elements: every leaf starts 128-byte aligned in its buffer


def _leaves(tree, path=()) -> List[Tuple[tuple, Any]]:
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [(path, tree)]


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_skeleton(v) for v in tree]
    return None


def _rule(path, meta) -> Tuple[str, float]:
    """(kind, scale) of a leaf: kind is normal, ones, a_log, dt_bias."""
    name = path[-1]
    if name in ("embed", "lm_head", "frontend_proj"):
        return "normal", 0.02
    if name in NORMS or name == "D":
        return "ones", 1.0
    if name in QKV_BIASES:
        return "normal", QKV_BIAS_STD
    if name in CONV_BIASES:
        return "normal", CONV_BIAS_STD
    if name == "A_log":
        return "a_log", 1.0
    if name == "dt_bias":
        return "dt_bias", 1.0
    return "normal", meta.shape[0] ** -0.5


def make_params(cfg, seed: int, device, tie_embeddings: bool = False) -> Dict[str, Any]:
    """The port's parameter tree for ``cfg``, drawn from ``seed`` on ``device``."""
    from repro_torch.models import model as model_mod

    meta = model_mod.init_params(cfg, device="meta")
    leaves = [(p, m) for p, m in _leaves(meta) if not (tie_embeddings and p == ("lm_head",))]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    params = _skeleton(meta)
    for dtype in sorted({m.dtype for _, m in leaves}, key=str):
        group = sorted(((p, m, *_rule(p, m)) for p, m in leaves if m.dtype == dtype),
                       key=lambda x: (x[2], x[3]))
        offsets, n = [], 0
        for _, m, _, _ in group:
            offsets.append(n)
            n += -(-m.numel() // ALIGN) * ALIGN
        buf = torch.empty((n,), dtype=dtype, device=device)
        if dtype == torch.float32:      # only A_log and dt_bias, drawn uniform
            buf.uniform_(0.0, 1.0, generator=gen)
        else:
            buf.normal_(0.0, 1.0, generator=gen)
        # one call a run of leaves of the same kind and scale
        i = 0
        while i < len(group):
            j = i
            while j < len(group) and group[j][2:] == group[i][2:]:
                j += 1
            kind, scale = group[i][2:]
            lo = offsets[i]
            hi = offsets[j - 1] + group[j - 1][1].numel()
            seg = buf[lo:hi]
            if kind == "ones":
                seg.fill_(1.0)
            elif kind == "normal":
                seg.mul_(scale)
            elif kind == "a_log":
                seg.mul_(15.0).add_(1.0).log_()
            elif kind == "dt_bias":
                s = cfg.ssm
                lo_dt, hi_dt = math.log(s.dt_min), math.log(s.dt_max)
                dt = torch.exp(seg * (hi_dt - lo_dt) + lo_dt)
                seg.copy_(dt + torch.log(-torch.expm1(-dt)))
            i = j
        for (p, m, _, _), off in zip(group, offsets, strict=True):
            _set(params, p, buf[off:off + m.numel()].view(m.shape))
    if tie_embeddings:
        params["lm_head"] = params["embed"].t()
    return params
