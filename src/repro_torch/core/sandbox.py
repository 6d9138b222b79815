"""Copy-on-write execution sandbox S = (M, F, E, H)  (paper Eq. 2, §4.2).

Reads fall through to the base state; writes are overlay-isolated until
promotion.  Mis-speculation consumes bounded resources but never corrupts
the live authoritative state.  Promotion (`commit`) merges the overlay into
the base iff the base has not diverged under the sandbox (version check);
`squash` drops everything.

Paper anchor: Eq. 2 / §4.2 (sandbox tuple S, state-safety constraints σ).
Upstream: runtime.py creates one Sandbox per admitted branch.
Downstream: executor.py runs tools against the CoW views; memo.py
validates store entries through them (``state_reader``) and uses the
shared ABSENT marker for footprint reads.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set

from repro_torch.core.events import Event


_TOMBSTONE = object()


class _Absent:
    """Footprint marker: a read fell through to the caller's default — the
    key was not present in the state.  Shared by the executor's per-call
    footprint recording and the result store's validation (memo.py); it must
    be one object so identity checks agree across modules."""

    def __repr__(self):  # pragma: no cover - debug aid
        return "<ABSENT>"


ABSENT = _Absent()


class CowView:
    """Copy-on-write dict view over a base dict."""

    def __init__(self, base: Dict[str, Any]):
        self._base = base
        self._overlay: Dict[str, Any] = {}
        self.base_reads: Set[str] = set()   # keys read THROUGH to the base

    # -- reads fall through --
    def get(self, key: str, default=None):
        if key in self._overlay:
            v = self._overlay[key]
            return default if v is _TOMBSTONE else v
        self.base_reads.add(key)
        return self._base.get(key, default)

    def __contains__(self, key: str) -> bool:
        if key in self._overlay:
            return self._overlay[key] is not _TOMBSTONE
        return key in self._base

    def keys(self) -> Set[str]:
        ks = {k for k, v in self._overlay.items() if v is not _TOMBSTONE}
        ks |= {k for k in self._base if self._overlay.get(k) is not _TOMBSTONE}
        return ks

    # -- writes isolate --
    def set(self, key: str, value: Any):
        self._overlay[key] = value

    def delete(self, key: str):
        self._overlay[key] = _TOMBSTONE

    @property
    def dirty(self) -> Dict[str, Any]:
        return dict(self._overlay)

    def apply_to(self, target: Dict[str, Any]):
        for k, v in self._overlay.items():
            if v is _TOMBSTONE:
                target.pop(k, None)
            else:
                target[k] = v


@dataclass
class AgentState:
    """Authoritative live state: memory/context M, filesystem F, env E,
    history H — plus a version counter for promotion validity."""
    memory: Dict[str, Any] = field(default_factory=dict)
    fs: Dict[str, Any] = field(default_factory=dict)
    env: Dict[str, Any] = field(default_factory=dict)
    history: List[Event] = field(default_factory=list)
    version: int = 0

    def bump(self):
        self.version += 1


class Sandbox:
    """Branch-local S_i = (M_i, F_i, E_i, H_i) over an AgentState."""

    def __init__(self, base: AgentState, hid: int):
        self.hid = hid
        self._base = base
        self.base_version = base.version
        self.M = CowView(base.memory)
        self.F = CowView(base.fs)
        self.E = CowView(base.env)
        self.H: List[Event] = []          # branch-local execution history
        self.committed = False
        self.squashed = False

    # -- state-safety interface used by the executor --
    def record(self, ev: Event):
        self.H.append(ev)

    @property
    def write_set(self) -> Set[str]:
        return (
            {f"M:{k}" for k in self.M.dirty}
            | {f"F:{k}" for k in self.F.dirty}
            | {f"E:{k}" for k in self.E.dirty}
        )

    @property
    def base_read_set(self) -> Set[str]:
        """Keys this branch read from the LIVE base (speculation is invalid
        once an authoritative write touches any of them)."""
        return (
            {f"M:{k}" for k in self.M.base_reads}
            | {f"F:{k}" for k in self.F.base_reads}
            | {f"E:{k}" for k in self.E.base_reads}
        )

    def is_stale(self) -> bool:
        """Base advanced since the fork — replay validity must be re-checked."""
        return self._base.version != self.base_version

    def commit(self) -> bool:
        """Promote: merge overlay into the authoritative state.  Refuses when
        stale (the authoritative path wrote concurrently) — the caller then
        replays or squashes."""
        if self.squashed or self.committed:
            return False
        if self.is_stale():
            return False
        self.M.apply_to(self._base.memory)
        self.F.apply_to(self._base.fs)
        self.E.apply_to(self._base.env)
        self._base.history.extend(self.H)
        self._base.bump()
        self.base_version = self._base.version
        self.committed = True
        return True

    def squash(self):
        """Drop all speculative effects (bounded waste, zero corruption)."""
        self.squashed = True
        self.M = CowView(self._base.memory)
        self.F = CowView(self._base.fs)
        self.E = CowView(self._base.env)
        self.H = []

    def fork(self, hid: int) -> "Sandbox":
        """Nested branch prefix: fork a sandbox whose base view is this one."""
        child = Sandbox(self._base, hid)
        # seed child overlays with our current overlay (copy-on-write chain
        # flattened at fork time — overlays are small by construction)
        child.M._overlay.update(self.M._overlay)
        child.F._overlay.update(self.F._overlay)
        child.E._overlay.update(self.E._overlay)
        # the child's validity depends on everything its inherited prefix
        # read from the live base: without seeding the read-sets, an
        # authoritative write to a key only the PARENT prefix read slips
        # past the runtime's write-conflict check and the child replays on
        # silently-invalidated state
        child.M.base_reads |= self.M.base_reads
        child.F.base_reads |= self.F.base_reads
        child.E.base_reads |= self.E.base_reads
        child.H = list(self.H)
        return child
