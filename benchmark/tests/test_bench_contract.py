"""BENCHMARK.json and the files it names: loadable, named and sized as the
benchmark's contract requires."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_run_seconds_fits_the_check():
    """A full check of 24 cells fits in 43200 s: 2 + 14 x 24 runs of
    run_seconds + 60 s, 2 x 90 s a cell to compile, 1200 s spare."""
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]]
                         + CELLS + [m["name"] for m in METRICS])
def test_names(name):
    assert spec.NAME.match(name), name


def test_names_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert conf["file"].startswith("benchmark/configs/")
    body = json.loads((spec.ROOT / conf["file"]).read_text())
    assert body["name"] == conf["name"] and body["reduced"] == conf["reduced"]
    assert LINE.match(conf["source"]) and LINE.match(conf["why"])
    assert len(conf["reduced"]) <= 16
    for key in conf["reduced"]:
        assert spec.NAME.match(key) and key in body
        assert not key.endswith(("_dim", "_rank")) and "width" not in key
    assert body["precision"] == "float32"
    assert callable(spec.check_reader(body["check"]))
    assert all(spec.NAME.match(k) and str(v) for k, v in body.get("environment", {}).items())
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])
    others = [c["file"] for c in BENCH["configs"] if c is not conf]
    assert conf["file"] not in others


@pytest.mark.parametrize("name", CELLS)
def test_cell(name):
    w = next(x for x in BENCH["workloads"] if x["name"] == name)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and LINE.match(w["why"]) and spec.NAME.match(w["traffic"])
    cell = spec.load_cell(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert {"check_frames", "driver_args"} <= set(cell.traffic)
    pairs = [(x["config"], x["traffic"]) for x in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_four_chip_cells_at_most_a_quarter():
    n4 = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert n4 <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric(m):
    assert spec.UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    if m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        if m["name"].endswith("_roofline") or m["name"].startswith("roofline."):
            assert m["unit"] == "%"
    assert callable(spec.metric_reader(m["name"]))
    for w in m.get("workloads", []):
        assert w in CELLS


def test_layers_spelled_alike():
    """Metrics of one layer name it letter for letter alike (case apart)."""
    by = {}
    for m in BENCH["per_layer"]:
        by.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by.values())


@pytest.mark.parametrize("stage", sorted(spec.stages()))
def test_stage(stage):
    entries = spec.stage(stage)
    assert entries
    for e in entries:
        assert e["kernels"] and all(isinstance(k, str) and k for k in e["kernels"])
        for t in e["terms"]:
            assert t["bytes_per_point"] >= 0 and t["flops_per_point"] >= 0 and t["per"]
