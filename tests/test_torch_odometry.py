"""semicp_torch's odometry and pair drivers against semicp's, on the CPU.

Tolerances, as in tests/test_torch_register.py: each align runs the same
algorithm in f32 with sums in another order, so every relative pose
agrees to 1e-4 and the EM trip count to +-1; ATE, a float64 score of
poses chained over 8 frames, to 1e-3 m. Where the port runs against
itself (the pipelined against the serial chain, prefetch depths, the
resumed prefix) the poses are equal to the bit.
"""

import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import semicp
import semicp_torch
from semicp.cli.run_odometry import main as j_odometry_main
from semicp.cli.run_pair import main as j_pair_main
from semicp.register import make_robust_align_fn as j_make_robust
from semicp_torch.cli.common import to_device_cloud
from semicp_torch.cli.run_odometry import main as t_odometry_main
from semicp_torch.cli.run_odometry import synthetic_frames
from semicp_torch.cli.run_pair import main as t_pair_main
from semicp_torch.cli.run_pair import parse_t_init
from semicp_torch.data import SEMANTICKITTI_REMAP, load_kitti_poses, save_kitti_poses
from semicp_torch.register.em_icp import PipelinedAligner, make_robust_align_fn

OVER = ["--cloud.n_pad=1024", "--cloud.num_classes=8", "--em.max_iters=10"]
ODO = ["--synthetic", "8", "--n-points", "800"] + OVER
CFG = {"cloud.n_pad": 1024, "cloud.num_classes": 8, "em.max_iters": 10}


def relative(poses):
    return np.linalg.inv(poses[:-1]) @ poses[1:]


def read_poses(path):
    return load_kitti_poses(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The synthetic sequence through semicp, and through the port at
    prefetch depths 0 and 3."""
    d = tmp_path_factory.mktemp("odo")
    out = {"jax": j_odometry_main(ODO + ["--out", str(d / "jax.txt"),
                                         "--jsonl", str(d / "jax.jsonl")])}
    for depth in (0, 3):
        out[depth] = t_odometry_main(ODO + ["--device", "cpu", "--prefetch", str(depth),
                                            "--out", str(d / f"t{depth}.txt"),
                                            "--jsonl", str(d / f"t{depth}.jsonl")])
    return d, out


def test_odometry_matches_jax(runs):
    d, out = runs
    pj, pt = read_poses(d / "jax.txt"), read_poses(d / "t3.txt")
    assert pt.shape == pj.shape == (8, 4, 4)
    np.testing.assert_allclose(relative(pt), relative(pj), atol=1e-4)
    assert out[3]["frames"] == out["jax"]["frames"] == 8
    assert abs(out[3]["ate_rmse_m"] - out["jax"]["ate_rmse_m"]) < 1e-3
    assert out[3]["ate_rmse_m"] < 0.05 and out[3]["rpe_trans_m"] < 0.02
    assert set(out[3]) == set(out["jax"]) | {"device"}
    # the JAX driver's phases, and the port's own spans and counters
    assert set(out["jax"]["timing"]) == {"preprocess", "align"}
    assert set(out[3]["timing"]) == {"preprocess", "align"} | {
        "session_setup", "scan_wait", "write_poses", "session_finish", "preprocess.upload",
        "preprocess.sort", "preprocess.moments", "em.wait", "align.retry", "upload.pinned",
        "estep", "estep.fused"}
    rj, rt = ([json.loads(line) for line in (d / f"{n}.jsonl").read_text().splitlines()]
              for n in ("jax", "t3"))
    assert len(rt) == len(rj) == 7
    for a, b in zip(rt, rj):
        assert set(a) == set(b)
        assert a["frame"] == b["frame"] and a["n_points"] == b["n_points"]
        assert abs(a["iterations"] - b["iterations"]) <= 1 and a["converged"]


def test_prefetch_depth_changes_no_pose(runs):
    d, _ = runs
    np.testing.assert_array_equal(np.loadtxt(d / "t0.txt"), np.loadtxt(d / "t3.txt"))


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_resume_keeps_prefix(runs, tmp_path, writer):
    """A poses.txt cut after 4 frames, by either package, resumes in the
    port without rewriting the prefix."""
    d, _ = runs
    src = d / ("t3.txt" if writer == "torch" else "jax.txt")
    full_text = src.read_text().splitlines()
    path = tmp_path / "poses.txt"
    path.write_text("\n".join(full_text[:4]) + "\n")
    t_odometry_main(ODO + ["--device", "cpu", "--out", str(path), "--resume"])
    got = path.read_text().splitlines()
    assert len(got) == 8
    assert got[:4] == full_text[:4]
    np.testing.assert_allclose(relative(read_poses(path)), relative(read_poses(src)), atol=1e-4)


def test_pipelined_aligner_equals_serial_robust_chain():
    cfg = semicp_torch.Config().override(CFG)
    frames = [f for f, _ in synthetic_frames(6, 800)]
    clouds = [to_device_cloud(p, lab, cfg, "cpu") for p, lab in frames]
    robust = make_robust_align_fn(cfg)
    serial, T0 = [], None
    for src, tgt in zip(clouds[1:], clouds[:-1]):
        res = robust(src, tgt, T0)
        serial.append(res)
        T0 = res.T
    aligner = PipelinedAligner(cfg)
    piped = [r for r in (aligner.submit(s, t) for s, t in zip(clouds[1:], clouds[:-1]))
             if r is not None] + [aligner.flush()]
    assert len(piped) == len(serial) == 5
    for p, s in zip(piped, serial):
        for f in ("T", "H", "iterations", "converged", "cost", "n_corr"):
            assert torch.equal(getattr(p, f), getattr(s, f)), f


@pytest.mark.parametrize("frac", [0.8, 0.999])
def test_robust_align_matches_jax(frac):
    """A healthy warm start is kept; at frac 0.999 the health check fails
    and both packages re-solve from identity and pick the same solution."""
    over = {**CFG, "em.retry_overlap_frac": frac}
    frames = [f for f, _ in synthetic_frames(3, 800)]
    (sp, sl), (tp, tl) = frames[1], frames[0]
    T0 = np.asarray(semicp_torch.geom.se3_exp(torch.tensor([0.45, 0.1, 0.0, 0.0, 0.0, 0.03])))
    cj, ct = semicp.Config().override(over), semicp_torch.Config().override(over)
    jsrc, jtgt = (semicp.preprocess_cloud(semicp.make_cloud(p, lab, n_pad=1024), cj)
                  for p, lab in ((sp, sl), (tp, tl)))
    tsrc, ttgt = (to_device_cloud(p, lab, ct, "cpu") for p, lab in ((sp, sl), (tp, tl)))
    rj = j_make_robust(cj)(jsrc, jtgt, jnp.asarray(T0))
    rt = make_robust_align_fn(ct)(tsrc, ttgt, torch.from_numpy(T0))
    np.testing.assert_allclose(rt.T.numpy(), np.asarray(rj.T), atol=1e-4)
    # which solution each package kept: the warm-started one or the retry
    base_j, base_t = semicp.make_align_fn(cj), semicp_torch.make_align_fn(ct)
    warm_j = np.array_equal(np.asarray(rj.T), np.asarray(base_j(jsrc, jtgt, jnp.asarray(T0)).T))
    warm_t = torch.equal(rt.T, base_t(tsrc, ttgt, torch.from_numpy(T0)).T)
    assert warm_t == warm_j
    if frac == 0.8:
        assert warm_t                      # healthy: no retry
    else:
        # n_corr can never reach 99.9% of the points: the retry ran, and
        # the kept solution is the one with more correspondences
        retry = base_t(tsrc, ttgt)
        warm = base_t(tsrc, ttgt, torch.from_numpy(T0))
        assert float(rt.n_corr) == max(float(retry.n_corr), float(warm.n_corr))


def test_run_pair_matches_jax(tmp_path):
    args = ["--synthetic", "900"] + OVER
    oj = j_pair_main(args)
    ot = t_pair_main(args + ["--device", "cpu", "--jsonl", str(tmp_path / "p.jsonl")])
    np.testing.assert_allclose(ot["T"], oj["T"], atol=1e-4)
    assert set(ot) == set(oj) | {"device"}
    assert set(ot["timing"]) == set(oj["timing"])
    assert ot["trans_err_m"] < 0.02 and ot["converged"]
    rec = json.loads((tmp_path / "p.jsonl").read_text())
    assert rec["T"] == ot["T"]


def test_t_init_parsing():
    T = np.arange(12, dtype=np.float32)
    np.testing.assert_array_equal(parse_t_init(" ".join(map(str, T)))[:3].reshape(-1), T)
    np.testing.assert_array_equal(parse_t_init(",".join(map(str, T)))[3], [0, 0, 0, 1])
    np.testing.assert_array_equal(parse_t_init(" ".join(["1"] * 16)), np.ones((4, 4)))
    with pytest.raises(ValueError, match="12 or 16"):
        parse_t_init("1 2 3")


def test_run_pair_t_init_and_profile(tmp_path):
    """An identity --t-init is the default start; --profile writes a trace."""
    args = ["--synthetic", "900", "--device", "cpu"] + OVER
    base = t_pair_main(args)
    eye = " ".join(map(str, np.eye(4)[:3].reshape(-1)))
    init = t_pair_main(args + ["--t-init", eye, "--profile", str(tmp_path / "prof")])
    assert init["T"] == base["T"]
    assert json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]


def test_label_out_of_range_raises():
    cfg = semicp_torch.Config().override(CFG)
    pts = np.zeros((10, 3), np.float32)
    with pytest.raises(ValueError, match="num_classes"):
        to_device_cloud(pts, np.full(10, 8, np.int32), cfg, "cpu")


def test_cuda_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_odometry_main(ODO + ["--out", str(tmp_path / "p.txt")])


def write_sequence(root, rng):
    """A KITTI-layout sequence of 6 scans with raw SemanticKITTI labels and
    ground truth in a camera frame (tests/test_odometry.py's recipe)."""
    from semicp_torch.data import make_scene, render_scan
    from semicp_torch.geom import se3_exp

    scene, labels = make_scene(rng, n_points=4000, extent=15.0)
    raw_of = {}
    for raw, train in sorted(SEMANTICKITTI_REMAP.items(), reverse=True):
        raw_of[train] = raw                          # the smallest raw id of each class
    step = se3_exp(torch.tensor([0.5, 0, 0, 0, 0, 0.02])).numpy().astype(np.float64)
    traj = [np.eye(4)]
    for _ in range(5):
        traj.append(traj[-1] @ step)
    traj = np.stack(traj)
    seq = root / "seq"
    (seq / "velodyne").mkdir(parents=True)
    (seq / "labels").mkdir()
    for i, pose in enumerate(traj):
        pts, lab = render_scan(rng, scene, labels - 1, pose, max_range=14.0, max_points=900)
        arr = np.zeros((len(pts), 4), np.float32)
        arr[:, :3] = pts
        arr.tofile(seq / "velodyne" / f"{i:06d}.bin")
        np.array([raw_of[k] for k in lab], np.uint32).tofile(seq / "labels" / f"{i:06d}.label")
    Tr = np.eye(4)
    Tr[:3, :3] = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], np.float64)
    save_kitti_poses(root / "gt.txt", Tr[None] @ traj @ np.linalg.inv(Tr)[None])
    (root / "calib.txt").write_text("Tr: " + " ".join(str(v) for v in Tr[:3].reshape(-1)) + "\n")
    return seq


def test_sequence_with_gt_and_calib_matches_jax(tmp_path):
    seq = write_sequence(tmp_path, np.random.default_rng(0))
    args = ["--seq", str(seq), "--voxel", "0", "--gt", str(tmp_path / "gt.txt"),
            "--calib", str(tmp_path / "calib.txt")] + OVER
    oj = j_odometry_main(args + ["--out", str(tmp_path / "j.txt")])
    ot = t_odometry_main(args + ["--device", "cpu", "--out", str(tmp_path / "t.txt"),
                                 "--max-frames", "6"])
    assert ot["frames"] == oj["frames"] == 6
    np.testing.assert_allclose(relative(read_poses(tmp_path / "t.txt")),
                               relative(read_poses(tmp_path / "j.txt")), atol=1e-4)
    assert abs(ot["ate_rmse_m"] - oj["ate_rmse_m"]) < 1e-3
    assert ot["ate_rmse_m"] < 0.05, ot["ate_rmse_m"]
    shutil.rmtree(seq)
