"""Runtime-global, safety-versioned speculative result store.

The serving bench showed the limit of execution-only speculation: at
saturation there is no slack to convert, so speculation stops paying.  This
module decouples speculative *value* from speculative *execution*: a tool
result computed once — speculatively in any tenant's sandbox, or
authoritatively on any tenant's live state — is published here and can be
*served* to a later identical invocation at zero execution cost ("Speculative
Actions" / SPORK's observation that a validated speculated result is
losslessly reusable).

Correctness model
-----------------
Entries are keyed on ``(tool, canonical args)`` and carry the call's exact
**footprint**: the namespaced keys it read (with the values observed — or an
ABSENT marker when the read fell through to the tool's internal default) and
the overlay it wrote (values, with TOMBSTONEs for deletes).  Tools are
deterministic functions of ``(args, reads)``, so a stored result is valid
for a target state iff every read key currently holds the recorded value
(absent keys must still be absent).  Serving then replays the stored write
overlay, which is exactly what re-execution would have produced.

Two mechanisms keep lookups cheap and entries honest:

* **Footprint invalidation** — every batch of authoritative writes bumps the
  store ``version`` and is intersected against the read index; an entry
  whose recorded read value now conflicts with a written value is
  invalidated eagerly (never whole-store, never whole-sandbox staleness).
* **Versioned validation cache** — value validation against a tenant's live
  state is memoized per ``(entry, tenant)`` at the store version it
  succeeded; any later authoritative write bumps the version and expires
  every cache implicitly.

The store is deliberately ignorant of episodes' AgentState internals: it
validates through a tiny reader protocol (``state_reader``) that works for
both live states and CoW sandboxes.

Pending entries (in-flight dedup)
---------------------------------
``begin`` registers an in-flight computation for a key; duplicate
speculative launches ``subscribe`` instead of burning slack twice, and the
first run's ``publish`` fires every subscriber with the finished entry
(``abort`` fires them with ``None`` so waiters can re-arm).

Paper anchor: the §4.2/§6 replayable-prefix reuse semantics, extended
runtime-global (a validated speculated result is losslessly reusable —
"Speculative Actions" / SPORK); safety gating follows §7 via
``EligibilityPolicy.servable``.
Upstream: executor.StateFacade (per-call read/write footprints),
sandbox.py (state readers for validation).  Downstream: runtime.py
(``_try_serve`` / ``_serve_spec`` / launch dedup), admission's EU reuse
term (``memo_mask`` + memo-excluded prefix ρ in scoring.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple, Union

from repro_torch.core.events import SafetyLevel
from repro_torch.core.sandbox import ABSENT, AgentState, Sandbox, _TOMBSTONE

MemoKey = Tuple[str, Tuple[Tuple[str, str], ...]]


def canonical_args(args: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    """Order-free, hashable argument skeleton.  ``repr`` keeps unhashable
    values (lists in results-derived args) keyable while staying exact for
    the str/int/bool payloads tools actually take."""
    return tuple(sorted((k, repr(v)) for k, v in args.items()))


def memo_key(tool: str, args: Dict[str, Any]) -> MemoKey:
    return (tool, canonical_args(args))


def state_reader(st: Union[AgentState, Sandbox],
                 track: bool = True) -> Callable[[str], Tuple[bool, Any]]:
    """(present, value) accessor over namespaced keys for either a live
    AgentState or a CoW Sandbox.

    For sandboxes, ``track=True`` reads through the CowView, so a
    validation read lands in the branch's base read-set — a SERVED entry's
    dependencies stay conflict-tracked exactly like executed reads.
    ``track=False`` peeks at overlay+base without recording: scoring-time
    validation runs for the whole candidate pool every tick, and recording
    those reads would hand every candidate branch a read-set it never
    earned (spurious write-conflict squashes)."""
    if isinstance(st, Sandbox):
        views = {"M": st.M, "F": st.F, "E": st.E}

        if track:
            def read(nskey: str) -> Tuple[bool, Any]:
                ns, k = nskey.split(":", 1)
                v = views[ns]
                return (k in v, v.get(k))
        else:
            def read(nskey: str) -> Tuple[bool, Any]:
                ns, k = nskey.split(":", 1)
                v = views[ns]
                if k in v._overlay:
                    ov = v._overlay[k]
                    if ov is _TOMBSTONE:
                        return (False, None)
                    return (True, ov)
                return (k in v._base, v._base.get(k))
    else:
        dicts = {"M": st.memory, "F": st.fs, "E": st.env}

        def read(nskey: str) -> Tuple[bool, Any]:
            ns, k = nskey.split(":", 1)
            d = dicts[ns]
            return (k in d, d.get(k))
    return read


@dataclass
class MemoEntry:
    tool: str
    args: Dict[str, Any]
    result: Any
    reads: Dict[str, Any]          # ns key -> observed value | ABSENT
    writes: Dict[str, Any]         # ns key -> written value | _TOMBSTONE
    level: SafetyLevel
    solo_work: float               # counterfactual solo latency (savings)
    base_version: int              # store version at publish time
    producer_eid: int
    valid: bool = True
    serves: int = 0
    # eid -> store version at which value validation last succeeded against
    # that tenant's live state (expires implicitly on any version bump)
    validated_at: Dict[int, int] = field(default_factory=dict)


@dataclass
class _Pending:
    owner_jid: int
    subscribers: List[Callable[[Optional[MemoEntry]], None]] = field(
        default_factory=list)


class ResultStore:
    """One per runtime: spans every episode/tenant (`BPasteRuntime.store`)."""

    def __init__(self):
        self.version: int = 0
        self.entries: Dict[MemoKey, MemoEntry] = {}
        self.pending: Dict[MemoKey, _Pending] = {}
        self._read_index: Dict[str, Set[MemoKey]] = {}
        self._tools: Dict[str, int] = {}     # tool -> live entry count
        # tool -> MONOTONE publish count.  A key can only BECOME servable
        # through a publish of its tool (invalidation/replacement only
        # retract), so a scoring-time "nothing for this node" verdict stays
        # correct until this counter moves — the memo-mask pass caches its
        # per-node verdicts against it (see BPasteRuntime._memo_terms).
        self.tool_pubs: Dict[str, int] = {}
        # counters (runtime copies these into Metrics at run end)
        self.publishes: int = 0
        self.invalidations: int = 0

    # -- lookup ---------------------------------------------------------
    def has_tool(self, tool: str) -> bool:
        """Cheap pre-filter for hot loops (memo-mask scoring): any valid
        entry for this tool at all?"""
        return self._tools.get(tool, 0) > 0

    def peek(self, tool: str, args: Dict[str, Any]) -> Optional[MemoEntry]:
        e = self.entries.get(memo_key(tool, args))
        return e if e is not None and e.valid else None

    def is_pending(self, key: MemoKey) -> bool:
        return key in self.pending

    # -- validation -----------------------------------------------------
    def validate(self, entry: MemoEntry,
                 st: Union[AgentState, Sandbox],
                 eid: Optional[int] = None, track: bool = True) -> bool:
        """Value-validate the entry's read footprint against ``st``.

        ``eid`` enables the versioned cache and must only be passed for a
        tenant's LIVE state (sandboxes of one episode diverge per branch, so
        a per-eid cache entry would alias across overlays).  ``track=False``
        keeps sandbox validation reads out of the branch's base read-set
        (see ``state_reader``) — use it for scoring-time peeks that do not
        commit to serving."""
        if not entry.valid:
            return False
        if eid is not None and entry.validated_at.get(eid) == self.version:
            return True
        read = state_reader(st, track=track)
        for nk, want in entry.reads.items():
            present, got = read(nk)
            if want is ABSENT:
                if present:
                    return False
            elif not present or got != want:
                return False
        if eid is not None:
            entry.validated_at[eid] = self.version
        return True

    def apply_writes(self, entry: MemoEntry,
                     st: Union[AgentState, Sandbox]) -> Set[str]:
        """Replay the stored overlay onto ``st`` (live dict or sandbox CoW
        view — sandbox writes stay overlay-isolated like executed ones).
        Returns the namespaced keys touched."""
        if isinstance(st, Sandbox):
            views = {"M": st.M, "F": st.F, "E": st.E}
            for nk, v in entry.writes.items():
                ns, k = nk.split(":", 1)
                if v is _TOMBSTONE:
                    views[ns].delete(k)
                else:
                    views[ns].set(k, v)
        else:
            dicts = {"M": st.memory, "F": st.fs, "E": st.env}
            for nk, v in entry.writes.items():
                ns, k = nk.split(":", 1)
                if v is _TOMBSTONE:
                    dicts[ns].pop(k, None)
                else:
                    dicts[ns][k] = v
        return set(entry.writes)

    # -- publication ----------------------------------------------------
    def publish(self, tool: str, args: Dict[str, Any], result: Any, *,
                reads: Dict[str, Any], writes: Dict[str, Any],
                level: SafetyLevel, solo_work: float,
                eid: int) -> MemoEntry:
        """Insert/refresh the entry for ``(tool, args)`` and resolve any
        pending computation for the key (subscribers fire with the entry)."""
        key = memo_key(tool, args)
        old = self.entries.get(key)
        if old is not None:
            self._deindex(key, old)
        entry = MemoEntry(tool, dict(args), result, dict(reads), dict(writes),
                          level, solo_work, self.version, eid)
        self.entries[key] = entry
        for nk in entry.reads:
            self._read_index.setdefault(nk, set()).add(key)
        self._tools[tool] = self._tools.get(tool, 0) + 1
        self.tool_pubs[tool] = self.tool_pubs.get(tool, 0) + 1
        self.publishes += 1
        self._resolve_pending(key, entry)
        return entry

    # -- in-flight dedup ------------------------------------------------
    def begin(self, key: MemoKey, owner_jid: int) -> None:
        self.pending[key] = _Pending(owner_jid)

    def subscribe(self, key: MemoKey,
                  cb: Callable[[Optional[MemoEntry]], None]) -> bool:
        p = self.pending.get(key)
        if p is None:
            return False
        p.subscribers.append(cb)
        return True

    def abort(self, key: Optional[MemoKey], owner_jid: int) -> None:
        """Owner died (preemption/squash): drop the pending entry and wake
        subscribers with None so their nodes can re-arm and launch
        themselves next tick."""
        if key is None:
            return
        p = self.pending.get(key)
        if p is None or p.owner_jid != owner_jid:
            return
        del self.pending[key]
        for cb in p.subscribers:
            cb(None)

    def _resolve_pending(self, key: MemoKey, entry: MemoEntry) -> None:
        p = self.pending.pop(key, None)
        if p is None:
            return
        for cb in p.subscribers:
            cb(entry)

    # -- invalidation ---------------------------------------------------
    def note_writes(self, write_values: Dict[str, Any]) -> None:
        """Authoritative writes landed (any tenant): bump the safety version
        and invalidate by FOOTPRINT INTERSECTION — only entries that read one
        of the written keys, and only when the written value actually
        conflicts with the value the entry observed (a write that re-asserts
        the observed value leaves the entry valid; serving still
        value-validates per target state either way)."""
        if not write_values:
            return
        self.version += 1
        for nk, wv in write_values.items():
            for key in list(self._read_index.get(nk, ())):
                entry = self.entries.get(key)
                if entry is None or not entry.valid:
                    continue
                want = entry.reads.get(nk, ABSENT)
                consistent = (
                    (want is ABSENT and wv is _TOMBSTONE)
                    or (want is not ABSENT and wv is not _TOMBSTONE
                        and wv == want)
                )
                if not consistent:
                    self.invalidate(key)

    def invalidate(self, key: MemoKey) -> None:
        entry = self.entries.get(key)
        if entry is None or not entry.valid:
            return
        entry.valid = False
        self.invalidations += 1
        self._deindex(key, entry)
        self.entries.pop(key, None)

    def _deindex(self, key: MemoKey, entry: MemoEntry) -> None:
        for nk in entry.reads:
            s = self._read_index.get(nk)
            if s is not None:
                s.discard(key)
                if not s:
                    del self._read_index[nk]
        n = self._tools.get(entry.tool, 0) - 1
        if n > 0:
            self._tools[entry.tool] = n
        else:
            self._tools.pop(entry.tool, None)

    # -- sanitizer support ----------------------------------------------
    def check_integrity(self) -> List[str]:
        """Cross-check the derived indices against the entry table (runtime
        sanitizer check S5).  Returns human-readable divergence descriptions
        (empty = coherent): read-index entries must point at live entries
        that actually read the key, every live entry must be indexed under
        each of its read keys, and the per-tool live counts must match."""
        problems: List[str] = []
        for nk, keys in self._read_index.items():
            for key in keys:
                e = self.entries.get(key)
                if e is None or not e.valid:
                    problems.append(f"read_index[{nk!r}] -> dead entry {key!r}")
                elif nk not in e.reads:
                    problems.append(
                        f"read_index[{nk!r}] -> entry {key!r} that never read it")
        tools: Dict[str, int] = {}
        for key, e in self.entries.items():
            if not e.valid:
                problems.append(f"entries[{key!r}] held while invalid")
                continue
            tools[e.tool] = tools.get(e.tool, 0) + 1
            for nk in e.reads:
                if key not in self._read_index.get(nk, ()):
                    problems.append(f"entry {key!r} missing from read_index[{nk!r}]")
        if tools != self._tools:
            problems.append(f"tool counts drifted: derived {tools} != cached {self._tools}")
        return problems

    def __len__(self) -> int:
        return len(self.entries)
