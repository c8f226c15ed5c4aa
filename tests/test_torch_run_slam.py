"""The port's run_slam on the CPU: the properties tests/test_slam.py and
tests/test_slam_resume.py hold the JAX run_slam to, at those tests' sizes
and with their bounds, on `semicp_torch.cli.run_slam`.

These runs are the port against itself; tests/test_torch_slam_loop.py
holds the 60-frame loop, and the loop-free parity of all of run_slam
with semicp is in tests/test_torch_slam.py.
"""

import numpy as np
import pytest
import torch

from semicp_torch.cli.run_slam import main as slam_main

CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """The SLAM runs' tensors are small: two intra-op threads run them no
    slower than eight, and leave the suite's other workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# tests/test_slam.py's drifted loop
DRIFT = ["--synthetic", "48", "--loop", "--n-points", "1000", "--drift", "0.01",
         "--cloud.n_pad=1024", "--cloud.num_classes=8", "--em.max_iters=12",
         "--slam.keyframe_trans=1.5", "--slam.lc_min_gap=14", "--slam.lc_max_dist=5.0"] + CPU


def test_loop_closure_corrects_drift(tmp_path):
    """Yaw-biased odometry on a closed loop: loop closure and PGO must
    beat pure odometry (ATE below 0.7 of it)."""
    with_lc = slam_main(DRIFT + ["--out", str(tmp_path / "pgo.txt")])
    no_lc = slam_main(DRIFT + ["--out", str(tmp_path / "nopgo.txt"),
                                "--slam.lc_desc_thresh=-1.0"])
    assert with_lc["loop_edges"] >= 1
    assert no_lc["loop_edges"] == 0
    assert with_lc["edges"] == with_lc["keyframes"] - 1 + with_lc["loop_edges"]
    assert with_lc["ate_rmse_m"] < 0.7 * no_lc["ate_rmse_m"], (
        with_lc["ate_rmse_m"], no_lc["ate_rmse_m"])
    assert "pgo" in with_lc["timing"] and "pgo" not in no_lc["timing"]


def test_slam_resume_matches_clean_run(tmp_path):
    """Crash after 14 frames with checkpoints, resume to 24: the resumed
    trajectory within 0.05 m of the clean run's."""
    common = [
        "--synthetic", "24", "--n-points", "700",
        "--cloud.n_pad=1024", "--cloud.num_classes=8", "--em.max_iters=10",
        "--slam.keyframe_trans=1.2", "--slam.checkpoint_every=2",
    ] + CPU
    clean = slam_main(common + ["--out", str(tmp_path / "clean.txt")])
    slam_main(common[:1] + ["14"] + common[2:] + [
        "--out", str(tmp_path / "crash.txt"), "--checkpoint-dir", str(tmp_path / "ckpt")])
    assert sorted(tmp_path.joinpath("ckpt").iterdir())       # checkpoints were written
    resumed = slam_main(common + [
        "--out", str(tmp_path / "resumed.txt"),
        "--checkpoint-dir", str(tmp_path / "ckpt"), "--resume"])
    a = np.loadtxt(tmp_path / "clean.txt")
    b = np.loadtxt(tmp_path / "resumed.txt")
    assert a.shape == b.shape == (24, 12)
    tdiff = np.linalg.norm(a.reshape(-1, 3, 4)[:, :, 3] - b.reshape(-1, 3, 4)[:, :, 3], axis=1)
    assert tdiff.max() < 0.05, tdiff.max()
    assert resumed["ate_rmse_m"] < clean["ate_rmse_m"] + 0.05


def test_scan_to_map_tracks(tmp_path):
    """--scan-to-map on the drifted loop: odometry against submaps of the
    last keyframes (rebuilt at each keyframe), with loop closure, keeps
    the ATE under tests/test_slam.py's 0.5 m bound."""
    out = slam_main(DRIFT + ["--scan-to-map", "--out", str(tmp_path / "poses.txt")])
    assert out["frames"] == 48 and out["keyframes"] >= 4 and out["loop_edges"] >= 1
    assert out["timing"]["submap"]["count"] == out["keyframes"]
    assert out["ate_rmse_m"] < 0.5, out["ate_rmse_m"]
