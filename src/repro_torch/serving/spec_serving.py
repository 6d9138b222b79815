"""B-PASTE ⨯ serving: batch-slot speculation on the TPU substrate.

Model nodes in a branch hypothesis are future reasoning boundaries: on the
serving engine they become *speculative sequences* — the predicted tool
result is rendered into tokens and prefilled into a free slot, so the
reasoning that will follow the tool is already decoding while the tool runs
on the host.  When the authoritative tool result arrives and matches the
prediction, the slot is promoted (zero-copy, per engine.promote); otherwise
it is preempted at the next step boundary.

This module is the hardware-adaptation of the paper's slack-resource rule:
slack = free batch slots, preemption = slot reclaim, budget B = the max
number of speculative slots the operator allows.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.hypothesis import BranchHypothesis, NodeKind
from repro_torch.serving.engine import ServingEngine


def render_observation(tool: str, args: Dict[str, Any], result: Any,
                       vocab_size: int, length: int = 16) -> List[int]:
    """Deterministic 'tokenizer' stub: hash the observation into token ids.
    Identical (tool, args, result) always renders identically, so a matching
    speculative prefill is exactly reusable."""
    key = f"{tool}|{sorted(args.items())!r}|{result!r}"
    h = hashlib.sha256(key.encode()).digest()
    return [2 + (h[i % len(h)] * 256 + h[(i + 1) % len(h)]) % (vocab_size - 3)
            for i in range(length)]


@dataclass
class SpecSequence:
    hid: int
    node_idx: int
    slot: int
    predicted_obs: Tuple[int, ...]
    eu: float


@dataclass
class SlotSpeculator:
    """Admits speculative continuations into free engine slots by EU order,
    under a speculative-slot budget; preempts ascending-EU under pressure."""
    engine: ServingEngine
    budget_slots: int = 2
    active: Dict[int, SpecSequence] = field(default_factory=dict)  # slot -> seq
    promotions: int = 0
    preemptions: int = 0
    admitted: int = 0

    def spec_slots_used(self) -> int:
        return len(self.active)

    def admit(self, hyps: List[Tuple[BranchHypothesis, float]],
              history_prompt: List[int]) -> int:
        """hyps: (hypothesis, EU) sorted desc; admit best into free slots."""
        n = 0
        for hyp, eu in sorted(hyps, key=lambda x: -x[1]):
            if eu <= 0:
                continue
            if self.spec_slots_used() >= self.budget_slots:
                break
            if self.engine.slack() == 0:
                break
            node = hyp.first_tool()
            if node is None:
                continue
            # predicted observation for the model node after this tool
            obs = render_observation(node.tool, {}, f"pred:{hyp.hid}:{node.idx}",
                                     self.engine.cfg.vocab_size)
            prompt = history_prompt + obs
            slot = self.engine.add_request(
                prompt, request_id=-hyp.hid, speculative=True, eu=eu
            )
            if slot is None:
                break
            self.active[slot] = SpecSequence(hyp.hid, node.idx, slot, tuple(obs), eu)
            self.admitted += 1
            n += 1
        return n

    def ensure_authoritative_room(self, needed_slots: int):
        """Phase-2 analogue: preempt speculative slots (ascending EU) until
        `needed_slots` are free."""
        while self.engine.slack() < needed_slots and self.active:
            victim_slot = min(self.active, key=lambda s: self.active[s].eu)
            self.engine.preempt(victim_slot)
            del self.active[victim_slot]
            self.preemptions += 1

    def match_and_promote(self, authoritative_obs: List[int],
                          request_id: int) -> Optional[int]:
        """Phase-1 analogue: if a speculative slot decoded from exactly this
        observation, promote it (its generated tokens are already valid)."""
        for slot, seq in list(self.active.items()):
            if tuple(authoritative_obs) == seq.predicted_obs:
                self.engine.promote(slot, request_id)
                del self.active[slot]
                self.promotions += 1
                return slot
        return None

    def squash_all(self):
        for slot in list(self.active):
            self.engine.preempt(slot)
            del self.active[slot]
            self.preemptions += 1
