"""The dense-LiDAR odometry deployment (benchmark/configs/
ouster-os1-128-dual-odom.json) through run_odometry on the CPU, judged by
the benchmark's float64 reference.

At the cell's size (n_pad 524288, the OS1-128's 128 x 2048 pixels with two
returns each) every E-step takes the fused branch (K6) by the dispatch
rule alone. Here a small KITTI-layout sequence drawn from a seed (6
frames of 1900-point scans, n_pad 2048: the benchmark's own CPU
shrinking) runs the sparse engine with the fused E-step's plain path
(K6's contract, `estep_fused_plain`) and with the split one (K2 then
K3). Every aligned frame is judged at the configuration's `correct`
limits: they are what the cell holds the card's answers to, and a pose
computed in a precision below float32 fails them (PERF.md §2).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import judge, reference, scenes  # noqa: E402
from semicp_torch.cli.run_odometry import main as odometry_main  # noqa: E402
from semicp_torch.config import Config  # noqa: E402
from semicp_torch.register.em_icp import use_fused_estep  # noqa: E402

CONFIG = json.loads(
    (ROOT / "benchmark" / "configs" / "ouster-os1-128-dual-odom.json").read_text())
FRAMES, N_PAD, SEED = 6, 2048, 2**31 + 20


def small_sequence():
    """The configuration's sequence at the benchmark's CPU size."""
    seq = dict(CONFIG["sequence"], frames=FRAMES, points_per_scan=1900, max_range=8.0,
               scene={"points": 8000, "extent": 10.0, "tiled": True, "clusters": "grid"})
    return scenes.make_sequence(seq, SEED, "cpu")


def test_the_sensor_slot_count_takes_the_fused_estep():
    cfg = Config().override(CONFIG["overrides"])
    assert cfg.cloud.n_pad == 128 * 2048 * 2
    assert use_fused_estep(cfg, cfg.cloud.n_pad)


@pytest.mark.parametrize("fused", [True, False])
def test_dense_odometry_matches_the_reference(fused, tmp_path):
    seq = small_sequence()
    seq_dir = scenes.write_sequence(seq, tmp_path / "seq", CONFIG["sequence"]["classes"] + 1)
    over = dict(CONFIG["overrides"], **{"cloud.n_pad": N_PAD, "corr.engine": "sparse",
                                        "em.fused_estep": str(fused).lower()})
    argv = (["--seq", str(seq_dir)] + CONFIG["driver_args"]
            + ["--prefetch", "2", "--device", "cpu", "--out", str(tmp_path / "poses.txt"),
               "--jsonl", str(tmp_path / "m.jsonl")] + [f"--{k}={v}" for k, v in over.items()])
    out = odometry_main(argv)
    assert out["frames"] == FRAMES
    recs = {r["frame"]: r for r in map(json.loads, (tmp_path / "m.jsonl").read_text().splitlines())}
    assert sorted(recs) == list(range(1, FRAMES))
    # a health check's retried align adds E-steps beyond the JSONL's passes
    n_fused = out["timing"]["estep.fused"]["count"]
    if fused:
        assert n_fused >= sum(r["iterations"] for r in recs.values())
    else:
        assert n_fused == 0

    P = np.loadtxt(tmp_path / "poses.txt").reshape(-1, 3, 4)
    P = np.concatenate([P, np.tile([[[0.0, 0.0, 0.0, 1.0]]], (len(P), 1, 1))], 1)
    checks = {}
    # every aligned frame is judged, at the configuration's limits
    limits = dict(CONFIG["correct"], frames=FRAMES - 1)
    judge.aligned(checks, limits, seq, reference.Params.from_dict(CONFIG["algorithm"]), "cpu",
                  SEED, FRAMES, lambda f: np.linalg.inv(P[f - 1]) @ P[f],
                  {f: bool(r["converged"]) for f, r in recs.items()},
                  lambda f: float(recs[f]["n_corr"]), f"fused={fused}")
    assert judge.passed(checks), checks
