"""Scripted agent episodes: a frozen copy of the port's episode generator.

``make_episodes`` draws the same episodes, draw for draw, as
``repro_torch.core.workload.make_episodes`` (ReAct-style motifs: fix_bug,
research, setup, and the cross-cutting audit that ``variation`` adds), with
the tool semantics of ``repro_torch.core.executor.execute_tool`` that those
motifs reach. It is kept here so that the traffic the benchmark offers stays
fixed whatever a later change does to the program's copy. The tool latencies
are data: each traffic mix names its own table.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Step:
    tool: str
    args: Dict[str, Any]
    result: Dict[str, Any]


@dataclass
class Episode:
    eid: int
    kind: str
    steps: List[Step]


def _h(s: str) -> str:
    return hashlib.sha1(str(s).encode()).hexdigest()[:8]


class _State:
    """The files and environment one episode's tools read and write."""

    def __init__(self):
        self.fs: Dict[str, Any] = {}
        self.env: Dict[str, Any] = {}


def execute_tool(tool: str, args: Dict[str, Any], st: _State) -> Dict[str, Any]:
    """Deterministic tool semantics over the episode's state."""
    if tool == "search":
        urls = [f"url://{_h(str(args.get('query', '')))}/{i}" for i in range(3)]
        return {"results": urls, "top": urls[0]}
    if tool in ("visit", "fetch"):
        url = str(args.get("url", args.get("path", "")))
        content = f"content::{_h(url)}"
        st.fs[url] = content
        return {"path": url, "content": content}
    if tool == "grep":
        return {"path": f"src/{_h(str(args.get('pattern', '')))}.py", "matches": 3}
    if tool == "read":
        path = str(args.get("path", ""))
        return {"path": path, "content": st.fs.get(path, f"orig::{_h(path)}")}
    if tool == "parse":
        path = str(args.get("path", ""))
        return {"path": path, "summary": f"sum::{_h(str(st.fs.get(path, '')))}"}
    if tool == "edit":
        path = str(args.get("path", ""))
        st.fs[path] = f"edited::{args.get('change', '')}"
        return {"path": path, "ok": True}
    if tool == "test":
        target = str(args.get("target", ""))
        return {"target": target, "pass": str(st.fs.get(target, "")).startswith("edited::fix")}
    if tool == "build":
        st.env["built"] = True
        return {"ok": True}
    if tool == "pip_install":
        pkg = str(args.get("pkg", ""))
        st.env[f"pkg:{pkg}"] = "installed"
        return {"pkg": pkg, "ok": True}
    raise KeyError(f"unknown tool {tool!r}")


class _Script:
    """Collects one episode's steps, executing each as it is scripted. Each
    step draws its reasoning time as the original does, so that the draws
    that follow stay in step."""

    def __init__(self, rng):
        self.rng = rng
        self.state = _State()
        self.steps: List[Step] = []

    def act(self, tool, **args):
        float(np.clip(self.rng.normal(2.5, 0.5), 1.0, 5.0))
        result = execute_tool(tool, args, self.state)
        self.steps.append(Step(tool, dict(args), result))
        return result


def _fix_bug(sc: _Script, ident: str, var: float) -> None:
    rng = sc.rng
    path = sc.act("grep", pattern=f"bug_{ident}")["path"]
    sc.act("read", path=path)
    if var > 0 and rng.random() < 0.35 * var:
        sc.act("parse", path=path)
    for j in range(int(rng.integers(1, 4)) - 1):
        sc.act("edit", path=path, change=f"attempt{j}")
        sc.act("test", target=path)
        if var > 0 and rng.random() < 0.25 * var:
            sc.act("read", path=path)
    sc.act("edit", path=path, change="fix")
    sc.act("test", target=path)


def _research(sc: _Script, ident: str, var: float) -> None:
    rng = sc.rng
    for k in range(int(rng.integers(1, 4))):
        r = sc.act("search", query=f"topic_{ident}_{k}")
        if var > 0 and rng.random() < 0.3 * var:
            r2 = sc.act("fetch", url=r["top"])
        else:
            r2 = sc.act("visit", url=r["top"])
        sc.act("parse", path=r2["path"])
        if var > 0 and rng.random() < 0.25 * var:
            sc.act("read", path=r2["path"])


def _setup(sc: _Script, ident: str, var: float) -> None:
    rng = sc.rng
    sc.act("pip_install", pkg=f"dep_{ident}")
    if var > 0 and rng.random() < 0.3 * var:
        sc.act("pip_install", pkg=f"extra_{ident}")
    sc.act("build")
    r = sc.act("grep", pattern=f"entry_{ident}")
    sc.act("test", target=r["path"])
    if var > 0 and rng.random() < 0.25 * var:
        sc.act("edit", path=r["path"], change="fix")
        sc.act("test", target=r["path"])


def _audit(sc: _Script, ident: str, var: float) -> None:
    r = sc.act("grep", pattern=f"audit_{ident}")
    sc.act("read", path=r["path"])
    s = sc.act("search", query=f"ref_{ident}")
    v = sc.act("visit", url=s["top"])
    sc.act("parse", path=v["path"])
    sc.act("edit", path=r["path"], change="fix")
    sc.act("test", target=r["path"])


KINDS = {"fix_bug": _fix_bug, "research": _research, "setup": _setup, "audit": _audit}


def make_episodes(seed: int, n_episodes: int, mix: Sequence[Tuple[str, float]],
                  variation: float = 1.0) -> List[Episode]:
    """``n_episodes`` scripted episodes drawn from ``seed``: the kinds in
    ``mix`` by their weights, each turned into an audit with probability
    0.25 * ``variation`` where the mix has none."""
    rng = np.random.default_rng(seed)
    kinds, probs = zip(*mix, strict=True)
    out = []
    for eid in range(n_episodes):
        kind = str(rng.choice(kinds, p=np.array(probs) / sum(probs)))
        if variation > 0 and "audit" not in dict(mix) and rng.random() < 0.25 * variation:
            kind = "audit"
        sc = _Script(rng)
        KINDS[kind](sc, str(eid), variation)
        out.append(Episode(eid, kind, sc.steps))
    return out


def render_observation(tool: str, args: Dict[str, Any], result: Any, vocab_size: int,
                       length: int, salt: Optional[int] = None) -> List[int]:
    """Token ids of a tool's observation: a hash of (tool, args, result),
    and of ``salt`` where given, spread over ids 2 .. vocab_size - 2. The
    same inputs always render alike (the program's tokenizer stub, with a
    salt so that each seed draws other ids)."""
    key = f"{tool}|{sorted(args.items())!r}|{result!r}"
    if salt is not None:
        key += f"|{salt}"
    h = hashlib.sha256(key.encode()).digest()
    ids = []
    block = 0
    while len(ids) < length:
        if block:
            h = hashlib.sha256(h + block.to_bytes(4, "little")).digest()
        ids.extend(2 + (h[i] * 256 + h[i + 1]) % (vocab_size - 3) for i in range(0, len(h), 2))
        block += 1
    return ids[:length]
