"""Batched decode engine with slot management (continuous batching).

The engine owns a fixed-capacity batched KV or state cache; requests occupy
*slots*.  Free slots are the serving-side analogue of the paper's "slack
resources": B-PASTE admits speculative sequences into them, preempts by
dropping a slot at the next decode-step boundary (one step = the preemption
granularity on an accelerator), and promotes by re-tagging a slot
authoritative — zero-copy, KV rows are slot-stable.

Unlike the JAX engine, which masks the whole cache with ``jnp.where`` after
every step and rewrites the whole cache tree when it admits a request, this
engine updates the cache in place: a step writes only the new K/V rows or
states of active slots (inactive slots keep theirs and their lengths), and
``add_request`` copies every leaf of the prefilled cache into its slot
(for an int8 cache, the values and the scales), cast to the batched leaf's
dtype as the JAX engine's ``_write_slot`` does.

With ``mesh_info`` (``models.model.MeshContext`` over
``launch.mesh.make_local_mesh(n)``) and a config with
``sharded_decode_attn``, every decode step runs the sequence-sharded
split-KV attention over n shards of the cache.

Over a mesh of processes (``mesh_info`` over a ``launch.mesh.DistMesh``)
every rank runs its own engine, with the same calls in the same order
(lockstep), and holds its block of the cache: its slice of the sequence
where the decode runs sequence-sharded, and its rows of the batch where
``max_batch`` divides over the batch axes. A prefill of one prompt runs on
every rank (batch 1 is not sharded) and lands in the slot's rows only on
the ranks that hold them; a step decodes this rank's rows and gathers the
logits of all rows over the batch axes, so every rank samples the same
tokens and keeps the same slots.

On a card, outside a mesh of processes, ``step`` replays one CUDA graph
of the decode step (:class:`DecodeGraph`) instead of launching its
kernels one by one: on an H100 the ~5.7 k small launches of a
mamba2-2.7b step cost the host more than twice the device's time. The graph reads the
engine's cache tensors in place, and two buffers of the pending tokens
and the active mask; it writes the new lengths back into
``cache["lengths"]`` and the rows' argmax into a buffer of its own. The
engine captures it at its first step, and again if ``cache`` has been
replaced since. Elsewhere (the CPU, gloo collectives, which a graph
cannot hold) the same decode runs eagerly: both write the lengths in
place, so ``cache["lengths"]`` stays the tensor ``add_request`` writes.

With recording on (``repro_torch.obs``), ``add_request`` is a
``serving.prefill`` span (slot, prompt tokens, speculative or not, and
the slots mid-decode that it holds back, all and authoritative) and
``step`` a ``serving.step`` span (rows decoded, the speculative ones among
them) with two children:
``serving.step.model``, the host enqueuing the decode and the argmax (and
the batch gather on a mesh; ``graph``: whether it replayed the graph), and
``serving.step.readback``, the host waiting for the sampled tokens. The
rest of the step is the span's own time: the active mask, the two copies
to the device and the slots' bookkeeping. ``graph_replays`` counts the
steps that replayed, beside ``steps_executed``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import on_ranks
from repro_torch.models import model as model_mod

def replays(device: torch.device, mesh_info: Optional[model_mod.MeshContext]) -> bool:
    """Whether an engine on ``device`` under ``mesh_info`` replays its
    decode step as a CUDA graph: on a card, unless over a mesh of
    processes, whose gloo collectives cannot be captured."""
    return device.type == "cuda" and not on_ranks(mesh_info)


def _leaves(cache: Dict[str, Any]) -> List[torch.Tensor]:
    return [t for leaf in cache.values() for t in (leaf if isinstance(leaf, tuple) else (leaf,))]


class DecodeGraph:
    """One CUDA graph of an engine's decode step over the engine's cache.

    Capture leaves the cache as it found it: the warm-up that precedes it
    (on a side stream, as ``torch.cuda.graph`` wants) runs with every row
    inactive, and the capture itself runs nothing. The graph has its own
    memory pool. A replay launches the captured kernels without calling
    their Python wrappers, so the wrappers' launch counters count eager
    launches alone; a profiler's trace lists each replayed kernel by name."""

    def __init__(self, engine: "ServingEngine"):
        dev = engine.device
        self.leaves = _leaves(engine.cache)
        self.tokens = torch.zeros((engine.rows,), dtype=torch.int64, device=dev)
        self.active = torch.zeros((engine.rows,), dtype=torch.bool, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            engine._decode(self.tokens, self.active)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits, self.out = engine._decode(self.tokens, self.active)

    def holds(self, cache: Dict[str, Any]) -> bool:
        """Whether the graph reads ``cache``'s tensors."""
        leaves = _leaves(cache)
        return len(leaves) == len(self.leaves) and all(
            a is b for a, b in zip(leaves, self.leaves, strict=True))

    def replay(self, tokens: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        """The decode step on the host's ``tokens`` and ``active`` mask;
        returns the rows' argmax on the device (their logits are in
        ``logits`` until the next replay)."""
        self.tokens.copy_(tokens)
        self.active.copy_(active)
        self.graph.replay()
        return self.out


@dataclass
class Slot:
    idx: int
    request_id: Optional[int] = None
    speculative: bool = False
    eu: float = 0.0
    tokens: List[int] = field(default_factory=list)
    active: bool = False
    done: bool = False


class ServingEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        max_batch: int = 8,
        max_len: int = 1024,
        eos_id: int = 1,
        mesh_info: Optional[model_mod.MeshContext] = None,
        device="cuda",
    ):
        self.device = torch.device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params are on {params['embed'].device}, engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.mesh_info = mesh_info
        # the rows of the batch this rank holds: [row0, row0 + rows)
        self.row0, self.rows = 0, max_batch
        if on_ranks(mesh_info) and max_batch % mesh_info.n_batch == 0:
            self.rows = max_batch // mesh_info.n_batch
            self.row0 = mesh_info.mesh.axis_index(mesh_info.batch_axes) * self.rows
        self.cache = model_mod.init_cache(cfg, self.rows, max_len, device=self.device,
                                          mesh_info=mesh_info)
        self.slots = [Slot(i) for i in range(max_batch)]
        self.pending_tokens = np.zeros((max_batch,), np.int32)
        self.steps_executed = 0
        self.graph_replays = 0
        self.graph: Optional[DecodeGraph] = None

    # ------------------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [s.idx for s in self.slots if not s.active]

    def slack(self) -> int:
        """Idle batch capacity = the engine's slack resource."""
        return len(self.free_slots())

    @torch.no_grad()
    def add_request(
        self, prompt: List[int], *, request_id: int, speculative: bool = False,
        eu: float = 0.0,
    ) -> Optional[int]:
        free = self.free_slots()
        if not free:
            return None
        slot = free[0]
        with obs.span("serving.prefill") as sp:
            if sp is not None:
                sp.attrs.update(self._prefill_attrs(slot, len(prompt), speculative))
            s = self.slots[slot]
            s.request_id = request_id
            s.speculative = speculative
            s.eu = eu
            s.tokens = list(prompt)
            s.active = True
            s.done = False
            toks = torch.tensor([prompt], dtype=torch.int64, device=self.device)
            logits, cache1 = model_mod.prefill(self.params, self.cfg, {"tokens": toks},
                                               self.max_len, mesh_info=self.mesh_info)
            row = slot - self.row0
            if 0 <= row < self.rows:
                for name, leaf in cache1.items():
                    if name == "lengths":
                        continue
                    # every other leaf is (L, batch, ...): k/v, an int8 (values,
                    # scales) pair, or the ssm state tuple
                    pairs = zip(self.cache[name], leaf, strict=True) if isinstance(leaf, tuple) \
                        else ((self.cache[name], leaf),)
                    for big, small in pairs:
                        big[:, row].copy_(small[:, 0])
                self.cache["lengths"][row] = len(prompt)
            self.pending_tokens[slot] = int(torch.argmax(logits[0]))
        return slot

    def _prefill_attrs(self, slot: int, tokens: int, speculative: bool) -> Dict[str, Any]:
        others = [s for s in self.slots if s.active and not s.done and s.idx != slot]
        return {"slot": slot, "tokens": tokens,
                "speculative": speculative, "decoding": len(others),
                "auth_decoding": sum(1 for s in others if not s.speculative)}

    def preempt(self, slot: int):
        """Reclaim a speculative slot at a step boundary (drop, zero-copy)."""
        s = self.slots[slot]
        assert s.speculative, "authoritative slots are never preempted"
        s.active = False
        s.request_id = None

    def promote(self, slot: int, request_id: int):
        """Speculative -> authoritative (non-preemptible), zero-copy."""
        s = self.slots[slot]
        s.speculative = False
        s.request_id = request_id
        s.eu = float("inf")

    @torch.no_grad()
    def step(self) -> Dict[int, int]:
        """One batched decode step; returns {slot: new_token} for active slots."""
        with obs.span("serving.step") as sp:
            active = np.array([s.active and not s.done for s in self.slots])
            if sp is not None:
                sp.attrs.update(self._step_attrs())
            if not active.any():
                return {}
            mine = slice(self.row0, self.row0 + self.rows)
            tokens = torch.as_tensor(self.pending_tokens[mine], dtype=torch.int64)
            active_t = torch.as_tensor(active[mine])
            graph = replays(self.device, self.mesh_info)
            with obs.span("serving.step.model", graph=graph):
                if graph:
                    if self.graph is None or not self.graph.holds(self.cache):
                        self.graph = None       # its pool goes before the next is captured
                        self.graph = DecodeGraph(self)
                    nxt = self.graph.replay(tokens, active_t)
                    self.graph_replays += 1
                else:
                    nxt = self._decode(tokens.to(self.device), active_t.to(self.device))[1]
            with obs.span("serving.step.readback"):
                nxt = nxt.cpu().numpy()
            out: Dict[int, int] = {}
            self.steps_executed += 1
            for s in self.slots:
                if not (s.active and not s.done):
                    continue
                tok = int(nxt[s.idx])
                s.tokens.append(int(self.pending_tokens[s.idx]))
                self.pending_tokens[s.idx] = tok
                out[s.idx] = tok
                if tok == self.eos_id or len(s.tokens) >= self.max_len - 1:
                    s.done = True
                    s.active = False
        return out

    def _decode(self, tokens: torch.Tensor, active: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The decode step over the cache, its new lengths written into
        ``cache["lengths"]``; returns each row's logits and argmax (every
        row's, on every rank of a mesh)."""
        logits, new = model_mod.decode_step(self.params, self.cfg, self.cache, tokens,
                                            active=active, mesh_info=self.mesh_info)
        self.cache["lengths"].copy_(new["lengths"])
        if self.rows < self.max_batch:      # every row's logits, on every rank
            logits = self.mesh_info.mesh.all_gather(logits, self.mesh_info.batch_axes)
            logits = logits.reshape(self.max_batch, -1)
        return logits, torch.argmax(logits, dim=-1)

    def _step_attrs(self) -> Dict[str, int]:
        live = [s for s in self.slots if s.active and not s.done]
        return {"rows": len(live), "spec_rows": sum(1 for s in live if s.speculative)}
