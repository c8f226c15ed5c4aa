"""Fixtures of the benchmark's own tests (CPU, tiny sizes).

Tests that need a card carry the `card` marker and skip where there is
none, deciding inside the test (the `card` fixture), never at import.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU (skips where there is none)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="session")
def bench_run():
    """benchmark/run.py as a module."""
    spec = importlib.util.spec_from_file_location("benchmark_run_script",
                                                  ROOT / "benchmark" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def shrink(cell):
    """A cell cut to a size the CPU runs in seconds: 1900-point scans
    (n_pad 2048) of a small scene; the SLAM loop shrunk so that it closes."""
    cfg = cell.config
    cfg["overrides"]["cloud.n_pad"] = 2048
    if cfg["check"] == "odometry":
        cfg["frames"] = 6
        cfg["sequence"].update(frames=6, points_per_scan=1900, max_range=8.0,
                               scene={"points": 8000, "extent": 10.0, "tiled": True,
                                      "clusters": "grid"})
    else:
        cfg["frames"] = 24
        cfg["sequence"].update(frames=24, points_per_scan=1900, max_range=8.0,
                               scene={"points": 8000, "extent": 10.0, "tiled": False},
                               trajectory={"kind": "loop", "step": 0.4})
        cfg["overrides"].update({"slam.lc_min_gap": 4, "slam.lc_max_dist": 7.0})
        cfg["algorithm"]["loop_gate"] = 3.5
        cell.traffic.update(check_loops=2, loop_passes=12)
    cell.traffic["check_frames"] = 3
    return cell


@pytest.fixture
def tiny_cell():
    from benchmark import spec

    return lambda name: shrink(spec.load_cell(name))
