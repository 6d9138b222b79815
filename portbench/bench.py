"""Finding a cell's pieces by name: ``BENCHMARK.json`` names the cell, its
configuration and its traffic mix; each lives in a file of its own
(``configs/<config>.json``, ``traffic/<mix>.json``, ``metrics/<metric>.py``)
that the harness finds by that name, so a later change adds a model, a mix
or a metric by adding files and entries, never by editing one."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    config: Dict[str, Any]       # the configuration's file
    mix: Dict[str, Any]          # the traffic mix's file
    chips: int
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of the benchmark at ``root``, with its files read."""
    bench = load_benchmark(root)
    matches = [w for w in bench["workloads"] if w["name"] == name]
    if not matches:
        raise KeyError(f"no workload {name!r} in {Path(root) / 'BENCHMARK.json'}")
    w = matches[0]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((Path(root) / cfg_entry["file"]).read_text())
    from portbench.traffic import load_mix
    mix = load_mix(Path(root) / "portbench" / "traffic" / f"{w['traffic']}.json")
    return Cell(name, config, mix, int(w["chips"]),
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def model_config(config: Dict[str, Any]):
    """The port's ``ModelConfig`` of a configuration file's ``model`` group."""
    from repro_torch.configs.base import ModelConfig, SSMConfig

    kw = dict(config["model"])
    if kw.get("ssm") is not None:
        kw["ssm"] = SSMConfig(**kw["ssm"])
    return ModelConfig(**kw)


def metric_reader(name: str, root: Path = ROOT) -> Callable[[Any], Optional[float]]:
    """``read`` of ``metrics/<name>.py``: it takes the run's record and
    returns the metric's value, or None where it finds nothing to read."""
    path = Path(root) / "portbench" / "metrics" / f"{name}.py"
    modname = "portbench_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
