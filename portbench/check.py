"""How ``correct`` is decided for a served model.

Once the window has closed and the engine is freed, a sample of the turns
the run finished, drawn from the seed with the longest in it, is run
through the plain f32 reference over each prompt with its served tokens,
and every served token is judged by how far its reference logit lies below
the reference's best at that position (``served_logit_gap``; greedy
decoding serves the program's best, which rounding may reorder among
near-equal logits). Turns of one episode that extend each other form one
chain, scored in one sequence; the chains share the system prompt, which
the reference runs once.

The control (the reference in fp8, in the program's place) is read at the
same positions: its own best token's gap under the f32 reference.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from portbench.reference import module as reference_module
from portbench.reference.common import Seqs, common_prefix, no_tf32
from portbench.reference.quant import Fp8


@dataclass
class Chain:
    tokens: List[int]
    positions: List[int]          # served tokens' positions


def chains(turns: Sequence) -> List[Chain]:
    """The finished turns as chains: each episode's turns in order, a turn
    joining the chain when its prompt extends the last turn's prompt and
    served tokens (history truncation starts a new chain)."""
    groups: Dict[tuple, list] = defaultdict(list)
    for t in turns:
        if t.end is not None and t.served:
            groups[(t.agent, t.ep)].append(t)
    out: List[Chain] = []
    for _, ts in sorted(groups.items()):
        ts.sort(key=lambda t: t.start)
        cur: Optional[Chain] = None
        for t in ts:
            full = t.prompt + t.served
            pos = list(range(len(t.prompt), len(full)))
            if cur is not None and full[:len(cur.tokens)] == cur.tokens:
                cur.tokens = full
                cur.positions += pos
            else:
                cur = Chain(full, pos)
                out.append(cur)
    return out


def sample(all_chains: List[Chain], n: int, seed: int) -> List[Chain]:
    """``n`` chains drawn from ``seed``, the longest among them."""
    if not all_chains:
        return []
    longest = max(range(len(all_chains)), key=lambda i: len(all_chains[i].tokens))
    rest = [i for i in range(len(all_chains)) if i != longest]
    rng = np.random.default_rng(seed)
    pick = rng.choice(rest, size=min(n - 1, len(rest)), replace=False).tolist() if rest else []
    return [all_chains[i] for i in [longest] + sorted(pick)]


def _seqs(picked: List[Chain], device) -> Seqs:
    toks = [c.tokens for c in picked]
    return Seqs(toks, [c.positions for c in picked], common_prefix(toks), device)


@torch.no_grad()
def served_gaps(params, cfg, reference: str, picked: List[Chain], device,
                control: bool = False) -> Dict[str, float]:
    """The widest gap of a served token under the f32 reference, and with
    ``control`` the widest gap of the fp8 reference's own best tokens."""
    ref = reference_module(reference)
    ref.check_cfg(cfg)
    seqs = _seqs(picked, device)
    out = {"chains": len(picked), "tokens_checked": sum(len(c.positions) for c in picked),
           "trunk": seqs.trunk}
    with no_tf32():
        logits = ref.logits(params, cfg, seqs)
        gap, ctrl = 0.0, 0.0
        best = []
        for c, lg in zip(picked, logits, strict=True):
            served = torch.tensor([c.tokens[p] for p in c.positions], device=lg.device)
            top = lg.max(dim=-1).values
            best.append((lg, top))
            if len(served):
                gap = max(gap, float((top - lg.gather(1, served[:, None])[:, 0]).max()))
        out["served_logit_gap"] = gap
        if control:
            q = ref.logits(params, cfg, seqs, quant=Fp8())
            for (lg, top), ql in zip(best, q, strict=True):
                if len(ql):
                    pick = ql.argmax(dim=-1)
                    ctrl = max(ctrl, float((top - lg.gather(1, pick[:, None])[:, 0]).max()))
            out["control_logit_gap"] = ctrl
    return out
