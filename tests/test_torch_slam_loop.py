"""The port's run_slam on tests/test_slam.py's 60-frame closed square
loop, on the CPU, with that test's bounds (its own file: the longest
run of the port's SLAM tests).
"""

import numpy as np
import pytest
import torch

from semicp_torch.cli.run_slam import main as slam_main


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """The SLAM runs' tensors are small: two intra-op threads run them no
    slower than eight, and leave the suite's other workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_run_slam_synthetic_loop(tmp_path):
    """A closed square loop: 60 frames, at least 4 keyframes, ATE < 0.5 m."""
    out = slam_main([
        "--synthetic", "60", "--loop", "--n-points", "1200",
        "--out", str(tmp_path / "poses.txt"),
        "--cloud.n_pad=2048", "--cloud.num_classes=8",
        "--em.max_iters=15", "--slam.keyframe_trans=1.5",
        "--slam.lc_min_gap=8", "--slam.lc_max_dist=8.0",
        "--device", "cpu",
    ])
    assert out["frames"] == 60
    assert out["keyframes"] >= 4
    assert out["ate_rmse_m"] < 0.5, out["ate_rmse_m"]
    assert np.loadtxt(tmp_path / "poses.txt").shape == (60, 12)
