"""Tool execution semantics: deterministic results over sandboxed state.

Every tool is a pure function of (args, state views); speculative runs get a
Sandbox (CoW views), authoritative runs get the live AgentState.  Results
are structured dicts so late-binding transforms (patterns.py) have fields to
key on — mirroring PASTE's observation that many arguments are derivable
from prior outputs.

The ``StateFacade`` additionally records a **per-call footprint** — the
namespaced keys each tool invocation read (with the observed value, or an
ABSENT marker when the read fell through to the tool's internal default) and
the overlay it wrote.  The cross-episode result store (memo.py) keys entry
validity on exactly this footprint; the old whole-sandbox
``CowView.base_reads`` set is lifetime-cumulative (over-broad for per-call
entries) and live ``_DictView`` reads were not tracked at all.  A read of a
key the same call already wrote is a self-read — replay reproduces it — and
is excluded from the footprint.

Paper anchor: §4.2 (deterministic replayable tools — the Level-1/Level-2
execution contract of §7).  Upstream: runtime.py (authoritative and
speculative calls), workload.py (episode scripting uses the same
semantics).  Downstream: sandbox.py views, memo.py (footprints key entry
validity).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Dict, Optional, Union

from repro_torch.core.sandbox import ABSENT, AgentState, CowView, Sandbox, _TOMBSTONE


def _h(s: str) -> str:
    return hashlib.sha1(str(s).encode()).hexdigest()[:8]


class StateFacade:
    """Uniform M/F/E access over AgentState or Sandbox, with per-call
    read/write footprint tracking (memo.py consumes it)."""

    def __init__(self, st: Union[AgentState, Sandbox]):
        self._st = st
        self.writes: set = set()             # namespaced keys written (cumulative)
        self.reads: Dict[str, Any] = {}      # per-call: ns key -> value | ABSENT
        self.write_values: Dict[str, Any] = {}  # per-call: ns key -> value | _TOMBSTONE
        if isinstance(st, Sandbox):
            inner = {"M": st.M, "F": st.F, "E": st.E}
            self.sandboxed = True
        else:
            inner = {"M": _DictView(st.memory), "F": _DictView(st.fs),
                     "E": _DictView(st.env)}
            self.sandboxed = False
        self.M = _TrackedView(inner["M"], "M", self)
        self.F = _TrackedView(inner["F"], "F", self)
        self.E = _TrackedView(inner["E"], "E", self)

    def begin_call(self):
        """Reset the per-call footprint (``writes`` stays cumulative — the
        runtime unions it across a replayed path for conflict pruning)."""
        self.reads = {}
        self.write_values = {}

    def footprint(self):
        """(reads, write overlay) of the current call."""
        return dict(self.reads), dict(self.write_values)

    def bump_if_live(self):
        if not self.sandboxed:
            self._st.bump()


class _DictView:
    """Plain dict adapter giving live AgentState namespaces the CowView
    read/write protocol (footprint recording lives in _TrackedView)."""

    def __init__(self, d: Dict[str, Any]):
        self._d = d

    def get(self, k, default=None):
        return self._d.get(k, default)

    def set(self, k, v):
        self._d[k] = v

    def delete(self, k):
        self._d.pop(k, None)

    def __contains__(self, k):
        return k in self._d

    def keys(self):
        return set(self._d.keys())


class _TrackedView:
    """Footprint-recording wrapper over a CowView (sandbox) or _DictView
    (live).  Writes pass straight through; reads record (key, observed
    value) unless the same call already wrote the key (self-read)."""

    def __init__(self, inner, ns: str, fac: StateFacade):
        self._inner = inner
        self._ns = ns
        self._fac = fac

    def get(self, k, default=None):
        nk = f"{self._ns}:{k}"
        wv = self._fac.write_values
        if nk in wv:
            v = wv[nk]
            return default if v is _TOMBSTONE else v
        present = k in self._inner
        v = self._inner.get(k, default)
        self._fac.reads[nk] = v if present else ABSENT
        return v

    def set(self, k, v):
        nk = f"{self._ns}:{k}"
        self._inner.set(k, v)
        self._fac.writes.add(nk)
        self._fac.write_values[nk] = v

    def delete(self, k):
        nk = f"{self._ns}:{k}"
        self._inner.delete(k)
        self._fac.writes.add(nk)
        self._fac.write_values[nk] = _TOMBSTONE

    def __contains__(self, k):
        nk = f"{self._ns}:{k}"
        wv = self._fac.write_values
        if nk in wv:
            return wv[nk] is not _TOMBSTONE
        return k in self._inner

    def keys(self):
        return self._inner.keys()


def execute_tool(tool: str, args: Dict[str, Any], state: StateFacade) -> Dict[str, Any]:
    """Deterministic tool semantics (synthetic but stateful)."""
    if tool == "search":
        q = str(args.get("query", ""))
        urls = [f"url://{_h(q)}/{i}" for i in range(3)]
        return {"results": urls, "top": urls[0]}
    if tool in ("visit", "fetch"):
        url = str(args.get("url", args.get("path", "")))
        content = f"content::{_h(url)}"
        state.F.set(url, content)          # read-through cache write (L1-safe)
        # any live base mutation must advance the version or Sandbox.is_stale
        # misses it (bump is a no-op for sandboxed runs)
        state.bump_if_live()
        return {"path": url, "content": content}
    if tool == "grep":
        pat = str(args.get("pattern", ""))
        path = f"src/{_h(pat)}.py"
        return {"path": path, "matches": 3}
    if tool == "read":
        path = str(args.get("path", ""))
        return {"path": path, "content": state.F.get(path, f"orig::{_h(path)}")}
    if tool == "parse":
        path = str(args.get("path", ""))
        content = state.F.get(path, "")
        return {"path": path, "summary": f"sum::{_h(str(content))}"}
    if tool == "edit":
        path = str(args.get("path", ""))
        change = str(args.get("change", ""))
        state.F.set(path, f"edited::{change}")
        state.bump_if_live()
        return {"path": path, "ok": True}
    if tool == "test":
        target = str(args.get("target", ""))
        content = str(state.F.get(target, ""))
        ok = content.startswith("edited::fix")
        return {"target": target, "pass": ok}
    if tool == "build":
        state.E.set("built", True)
        state.bump_if_live()
        return {"ok": True}
    if tool == "pip_install":
        pkg = str(args.get("pkg", ""))
        state.E.set(f"pkg:{pkg}", "installed")
        state.bump_if_live()
        return {"pkg": pkg, "ok": True}
    if tool == "pip_download":
        pkg = str(args.get("pkg", ""))
        state.F.set(f"cache/{pkg}.whl", "wheel")
        state.bump_if_live()
        return {"pkg": pkg, "cached": True}
    if tool in ("session_init", "env_warmup"):
        state.E.set(f"warm:{tool}", True)
        # live base mutation like every other env write: without the bump a
        # pre-existing sandbox would keep validating (is_stale()==False)
        # against a base that has diverged, and execution would disagree
        # with cache-serving of the identical action (which does bump)
        state.bump_if_live()
        return {"ok": True}
    if tool == "deploy":
        state.E.set("deployed", True)
        state.bump_if_live()
        return {"ok": True}
    if tool == "model_step":
        return {"ok": True}
    raise KeyError(f"unknown tool {tool!r}")


# ----------------------------------------------------------------------
# Dry-run support for the static analyzer (core/analysis.py rule R1).
# ----------------------------------------------------------------------

# Representative concrete arguments per tool: enough to drive every state
# access in execute_tool's semantics (the implementations key state touches
# on arg *presence*, not payload, so any concrete value exercises the same
# footprint shape).
SAMPLE_ARGS: Dict[str, Dict[str, Any]] = {
    "search": {"query": "q"},
    "visit": {"url": "u"},
    "fetch": {"url": "u"},
    "grep": {"pattern": "p"},
    "read": {"path": "f"},
    "parse": {"path": "f"},
    "edit": {"path": "f", "change": "c"},
    "test": {"target": "f"},
    "pip_install": {"pkg": "p"},
    "pip_download": {"pkg": "p"},
    "session_init": {},
    "env_warmup": {},
    "deploy": {},
    "model_step": {},
}


def dry_run_footprint(tool: str, args: Optional[Dict[str, Any]] = None):
    """Execute ``tool`` against a throwaway AgentState and return its tracked
    per-call ``(reads, write overlay)`` footprint.  Raises KeyError for tools
    without an executor implementation (the analyzer skips those)."""
    fac = StateFacade(AgentState())
    fac.begin_call()
    execute_tool(tool, dict(args if args is not None else SAMPLE_ARGS.get(tool, {})), fac)
    return fac.footprint()
