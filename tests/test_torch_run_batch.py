"""The port's run_batch (plain and --slam) on the CPU, against the JAX
driver and against the port's run_slam.

Tolerances:
- Plain run_batch against the JAX driver on its 8-device mesh: every
  relative pose agrees to about 1e-4 (tests/test_torch_register.py), so
  each sequence's ATE over 8 frames agrees to 1e-3 m.
- run_batch --slam against independent run_slam runs: the same aligns in
  the same order (a batch is serial aligns; its gather adds zeros), so the
  keyframes and loop edges are equal and the trajectories agree to 1e-5 m
  (within the 2e-2 m ATE of tests/test_batch_slam.py).
- Over 2 gloo ranks, with the sequences shared unevenly, the poses equal
  the one-rank run's to the bit.
"""

import numpy as np
import pytest
import torch

import torch_gloo_workers as workers
from semicp.cli.run_batch import main as j_batch_main
from semicp_torch.cli.run_batch import build_parser, run_batch, run_batch_slam
from semicp_torch.cli.run_batch import main as t_batch_main
from semicp_torch.cli.run_slam import main as t_slam_main
from semicp_torch.config import Config, parse_overrides

CPU = ["--device", "cpu"]
# tests/test_batch.py's arguments
BATCH = ["--synthetic", "8", "--sequences", "8", "--n-points", "700", "--cloud.n_pad=1024",
         "--cloud.num_classes=8", "--em.max_iters=10"]
# tests/test_batch_slam.py's drifted loop
SLAM = ["--synthetic", "40", "--loop", "--n-points", "1000", "--drift", "0.01",
        "--cloud.n_pad=1024", "--cloud.num_classes=8", "--em.max_iters=12",
        "--slam.keyframe_trans=1.5", "--slam.lc_min_gap=10", "--slam.lc_max_dist=5.0"]


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """The runs' tensors are small: two intra-op threads run them no slower
    than eight, and leave the suite's other workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def parse(argv):
    args, extra = build_parser().parse_known_args(argv)
    return args, Config().override(parse_overrides(extra))


def test_run_batch_matches_jax(tmp_path):
    """tests/test_batch.py's run on both drivers: 8 sequences of 8 frames
    at 700 points, bare-CovConfig preprocessing (raw layout)."""
    oj = j_batch_main(BATCH + ["--jsonl", str(tmp_path / "j.jsonl")])
    ot = t_batch_main(BATCH + CPU + ["--jsonl", str(tmp_path / "t.jsonl")])
    assert ot["sequences"] == oj["sequences"] == 8
    assert ot["aligns_total"] == oj["aligns_total"] == 8 * 7
    assert ot["devices"] == 1 and ot["device"] == "cpu"
    assert set(ot) == set(oj) | {"device"}
    np.testing.assert_allclose(ot["ate_rmse_m"], oj["ate_rmse_m"], atol=1e-3)
    assert ot["ate_rmse_mean"] < 0.1 and all(a < 0.2 for a in ot["ate_rmse_m"])
    recs = (tmp_path / "t.jsonl").read_text().splitlines()
    assert len(recs) == 7


def test_run_batch_slam_matches_run_slam(tmp_path):
    """Two sequences of batch SLAM reproduce two independent run_slam runs
    of the same seeds: keyframes, loop edges and trajectories."""
    args, cfg = parse(SLAM + ["--slam", "--sequences", "2"] + CPU)
    out, trajs, _ = run_batch_slam(args, cfg)
    assert all(k >= 3 for k in out["keyframes"]), out["keyframes"]
    assert sum(out["loop_edges"]) >= 1, out["loop_edges"]
    for s in range(2):
        ref = t_slam_main(SLAM + CPU + ["--seed", str(s), "--out", str(tmp_path / f"r{s}.txt")])
        assert ref["keyframes"] == out["keyframes"][s]
        assert ref["loop_edges"] == out["loop_edges"][s]
        traj = np.loadtxt(tmp_path / f"r{s}.txt").reshape(-1, 3, 4)
        assert len(traj) == len(trajs[s]) == 40
        np.testing.assert_allclose(trajs[s][:, :3, 3], traj[:, :, 3], atol=1e-5)
        assert abs(ref["ate_rmse_m"] - out["ate_rmse_m"][s]) < 2e-2


def test_run_batch_over_two_ranks(tmp_path):
    """Three sequences over 2 gloo ranks (2 and 1 a rank): every rank holds
    every sequence's poses, equal to the one-rank run's."""
    argv = ["--synthetic", "5", "--sequences", "3", "--n-points", "700", "--cloud.n_pad=1024",
            "--cloud.num_classes=8", "--em.max_iters=10"] + CPU
    np.savez(tmp_path / "in.npz", argv=np.asarray(argv))
    outs = workers.spawn("run_batch", 2, tmp_path)
    _, poses, _ = run_batch(*parse(argv))
    ref = np.stack([np.stack(p) for p in poses])
    for o in outs:
        assert int(o["devices"]) == 2 and int(o["aligns_total"]) == 3 * 4
        np.testing.assert_array_equal(o["poses"], ref)


def test_run_batch_raises_without_card():
    """--device defaults to cuda, and nothing falls back to the CPU."""
    argv = ["--synthetic", "2", "--sequences", "1", "--n-points", "300"]
    assert build_parser().parse_args(argv).device == "cuda"
    if not torch.cuda.is_available():
        for extra in ([], ["--slam"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                t_batch_main(argv + extra)
