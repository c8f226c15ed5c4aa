"""The control, the reference in bfloat16 in the system's place, comes out
as not correct by the run's own rule (judge.passed): it fails at least one
of the cell's numbers against the cell's limits. On the CPU at a tiny
size; on a card at the cell's own size."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import control, judge, scenes

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["odom.seq-replay", "slam.loop-f2f"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_a_tiny_size(cell, tiny_cell):
    import torch

    torch.set_num_threads(2)
    c = tiny_cell(cell)
    seq = scenes.make_sequence(c.config["sequence"], 1, "cpu")
    out = control.aligns(c.config, seq, 1, 3, "cpu", torch.bfloat16)
    if c.config["check"] == "slam":
        out.update(control.slam_back_end(c, seq, 1, "cpu", torch.bfloat16))
    assert not judge.passed(control.judged(out, c.config["correct"])), out


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cell_size(cell, card):
    out = subprocess.run([sys.executable, str(ROOT / "benchmark" / "control.py"), "--workload",
                          cell, "--seeds", "20240611"], capture_output=True, text=True,
                         timeout=1800, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is False and not judge.passed(line["checks"]), line
