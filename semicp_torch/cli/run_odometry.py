"""Frame-to-frame odometry driver.

Port of `semicp/cli/run_odometry.py`: loop over the scans of a sequence,
align each against the previous one with the previous relative pose as
warm start, chain the transforms and write KITTI-format poses.txt. Each
scan is preprocessed once and used as source, then as target. The poses
file is rewritten after every frame, so --resume re-enters at the last
written frame (also from a file the JAX package's driver wrote).

Per frame the host waits on the device only for the EM convergence flag
of each pass and for one copy of the previous frame's result (its
health check and its log record together, register/em_icp.py
PipelinedAligner). The scan loader runs --prefetch scans ahead in a
thread that does numpy work only; upload and preprocess stay on the main
thread.

The session's PhaseTimer (the result's "timing", the table on stderr) is
installed for the run: the driver's spans `session_setup`, `scan_wait`,
`preprocess`, `align`, `write_poses` and `session_finish`, and the
library's `preprocess.upload`, `.sort`, `.moments`, `em.wait` and the
counters `align.retry`, `estep` and `estep.fused`. Under a torch profiler
each span is also a `record_function` of its name.

Usage:
  python -m semicp_torch.cli.run_odometry --seq /path/to/sequence [--voxel 0.3]
      [--out poses.txt] [--jsonl metrics.jsonl] [--resume] [--max-frames N]
      [--gt gt_poses.txt [--calib calib.txt]] [--prefetch 2] [--device cuda|cpu]
  python -m semicp_torch.cli.run_odometry --synthetic 60 [--n-points 4000]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from semicp_torch.cli.common import (
    device_name,
    load_scan_np,
    print_result,
    sequence_frames,
    setup_device,
    to_device_cloud,
)
from semicp_torch.config import Config, parse_overrides
from semicp_torch.data import load_kitti_calib, load_kitti_poses, save_kitti_poses
from semicp_torch.register.em_icp import PipelinedAligner
from semicp_torch.slam.pipeline import ScanPrefetcher
from semicp_torch.utils import MetricsLogger, PhaseTimer, drain, installed


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seq", help="KITTI sequence dir (velodyne/ + optional labels/)")
    ap.add_argument("--voxel", type=float, default=0.3)
    ap.add_argument("--out", default="poses.txt")
    ap.add_argument("--jsonl", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--synthetic", type=int, default=0, help="run N synthetic frames")
    ap.add_argument("--n-points", type=int, default=4000)
    ap.add_argument("--prefetch", type=int, default=2,
                    help="scan-ingest pipeline depth (slam/pipeline.py): host IO runs "
                         "this many scans ahead; 0 = serial (identical results either way)")
    ap.add_argument("--gt", default=None,
                    help="KITTI ground-truth poses.txt: evaluate ATE/RPE against it")
    ap.add_argument("--calib", default=None,
                    help="KITTI calib.txt with a Tr line: --gt poses are camera-frame; "
                         "Tr^-1 P Tr moves them into the velodyne frame estimated here")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; raises without a card)")
    return ap


def load_gt_traj(gt_path, calib_path=None):
    """Ground-truth trajectory in the velodyne frame, (N, 4, 4)."""
    gt = load_kitti_poses(gt_path)
    if calib_path:
        Tr = load_kitti_calib(calib_path)
        gt = np.linalg.inv(Tr)[None] @ gt @ Tr[None]
    return gt


def synthetic_frames(n_frames, n_points, seed=0):
    from semicp_torch.data import make_scene, make_trajectory, render_scan

    rng = np.random.default_rng(seed)
    scene, labels = make_scene(rng, n_points=n_points * 4, extent=30.0)
    labels = labels - 1
    traj = make_trajectory(n_frames, step=0.6, turn=0.05, seed=seed)
    for pose in traj:
        yield render_scan(rng, scene, labels, pose, max_range=25.0, max_points=n_points), traj


def run_odometry(args, cfg: Config):
    """One session: (the result, its PhaseTimer). The timer is installed
    for the session, so the spans and counters of the library code it runs
    (preprocess.*, em.wait, align.retry, estep, estep.fused) land in its table."""
    timer = PhaseTimer()
    timer.count("align.retry", 0)
    with installed(timer):
        return _odometry(args, cfg, timer), timer


def _odometry(args, cfg: Config, timer: PhaseTimer) -> dict:
    with timer.phase("session_setup"):
        dev = setup_device(args.device)
        aligner = PipelinedAligner(cfg)

        poses = [np.eye(4)]
        gt_traj = None
        out_path = Path(args.out)

        if args.synthetic:
            frames = []
            for (pts, lab), traj in synthetic_frames(args.synthetic, args.n_points):
                frames.append((pts, lab))
                gt_traj = traj
            loader = iter(frames)

            def next_scan():
                return next(loader, None)
        else:
            seq = sequence_frames(args.seq)
            if args.max_frames:
                seq = seq[: args.max_frames]
            it = iter(seq)

            def next_scan():
                item = next(it, None)
                if item is None:
                    return None
                b, lbl = item
                return load_scan_np(b, lbl, args.voxel)

            if args.gt:
                gt_traj = load_gt_traj(args.gt, args.calib)

        start_frame = 0
        if args.resume and out_path.exists():
            existing = np.loadtxt(out_path).reshape(-1, 3, 4)
            poses = [np.vstack([p, [0, 0, 0, 1]]) for p in existing]
            start_frame = len(poses) - 1
            print(f"resuming at frame {start_frame}", file=sys.stderr)

        ml = MetricsLogger(args.jsonl)
        pf = ScanPrefetcher(next_scan, depth=max(args.prefetch, 0))
    serial = args.prefetch == 0
    prev_cloud = None
    pending_meta = None   # (frame, n_points) of the in-flight pair
    frame = 0

    def chain(res, meta):
        # res is the host copy PipelinedAligner resolved: no device reads
        f, n_pts = meta
        poses.append(poses[-1] @ res.T.numpy().astype(np.float64))
        ml.log(frame=f, iterations=int(res.iterations), converged=bool(res.converged),
               cost=float(res.cost), n_corr=float(res.n_corr), n_points=n_pts)
        with timer.phase("write_poses"):
            save_kitti_poses(out_path, np.asarray(poses))

    while True:
        with timer.phase("scan_wait"):
            scan = pf.get()
        if scan is None:
            break
        pts, lab = scan
        if frame < start_frame:
            frame += 1
            continue
        with timer.phase("preprocess"):
            # queued on the stream; the align below queues behind it
            cloud = to_device_cloud(pts, lab, cfg, dev)
            if serial:
                drain(cloud.cov6)
        if prev_cloud is not None:
            with timer.phase("align"):
                # queue align(t), warm-started from the previous result's
                # device pose; get back frame t-1's resolved result
                res_prev = aligner.submit(cloud, prev_cloud)
            if res_prev is not None:
                chain(res_prev, pending_meta)
            pending_meta = (frame, len(pts))
        prev_cloud = cloud
        frame += 1

    with timer.phase("session_finish"):
        with timer.phase("align"):
            res_last = aligner.flush()
        if res_last is not None:
            chain(res_last, pending_meta)
        ml.close()
    out = {"frames": len(poses), "out": str(out_path), "device": device_name(dev),
           "timing": timer.summary()}
    if gt_traj is not None and len(poses) > 2:
        from semicp_torch.eval import ate_rmse, rpe

        est = np.asarray(poses)
        gt = gt_traj[: len(poses)]
        out["ate_rmse_m"] = ate_rmse(est, gt)
        out["rpe_trans_m"], out["rpe_rot_rad"] = rpe(est, gt)
    return out


def main(argv=None):
    ap = build_parser()
    args, extra = ap.parse_known_args(argv if argv is not None else sys.argv[1:])
    cfg = Config().override(parse_overrides(extra))
    if not args.synthetic and not args.seq:
        ap.error("--seq or --synthetic required")
    out, timer = run_odometry(args, cfg)
    print_result("run_odometry", out)
    print(timer.table(), file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
