"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of `workloads`) names a configuration (`configs/<file>`,
as `configs` says) and a traffic mix (`traffic/<traffic>.json`). Every
metric, end-to-end or per-layer, is read by `metrics/<name>.py`; the
comparison that decides `correct` is `checks/<check>.py`, as the
configuration's `check` names it; a kernel stage is the union of the
kernel-name patterns in `stages/<stage>/*.json`. Adding a cell, a metric,
a check or a stage adds files and entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(work)}")
    w = work[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((Path(root) / conf["file"]).read_text())
    config["sequence"]["frames"] = int(config["frames"])
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name=name, config=config, traffic=traffic, chips=int(w["chips"]),
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def _read_fn(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metric_reader(name: str):
    """The `read(run)` function of metrics/<name>.py: the metric from the
    run's record, or None where there is nothing to read."""
    return _read_fn("metrics", name)


def check_reader(name: str):
    """The `read(config, traffic, seq, sessions, seed, device)` function of
    checks/<name>.py: {number: {"value", "limit"}} for the window's
    sessions."""
    return _read_fn("checks", name)


def stage(name: str) -> list[dict]:
    """The entries of stages/<name>/*.json, in file order."""
    return [json.loads(p.read_text()) for p in sorted((HERE / "stages" / name).glob("*.json"))]


def stages() -> dict[str, list[dict]]:
    return {p.name: stage(p.name) for p in sorted((HERE / "stages").iterdir()) if p.is_dir()}
