"""Keyframe SLAM (`run_slam`): submaps, loop closure and pose-graph optimisation.

Port of `semicp/cli/run_slam.py` (the system's third configuration). The
host runs the control plane: frame scheduling, keyframe decisions, loop
gating, checkpoints. The device (the card, unless --device cpu) runs the
preprocessing (kernel K1), the alignments (K2 or K4, K3, G1; odometry
and loop verification) and the pose-graph LM.

Per frame:
  odometry   align the scan onto the previous scan, or with --scan-to-map
             onto the current submap (the last `slam.submap_keyframes`
             keyframe clouds fused in the newest keyframe's frame,
             slam/submap.py), warm-started by constant velocity
  keyframe   spawned after enough motion; adds a pose-graph node and an
             odometry edge weighted by the align's GN Hessian
  loop       older keyframes gated by pose proximity and semantic
             descriptor; the survivors verified by wide-gate EM aligns in
             one batch; accepted edges trigger pose-graph optimisation
Every frame stores (anchor keyframe, relative pose); the trajectory is
recomposed against the FINAL optimised keyframe poses.

The host waits on the device, per frame, for the EM convergence flag of
each pass and for one copy of the align's result (its health check and
everything the host reads of it, register/em_icp.py
`make_robust_align_fn`); the pose graph lives on the host.
The warm start goes up from pinned memory without a wait.

The session's PhaseTimer (the result's "timing", the table on stderr) is
installed for the run: the driver's spans `session_setup`, `scan_wait`,
`preprocess`, `odometry`, `keyframe` (each frame's bookkeeping),
`submap`, `loop_search` and `loop_verify`, `pgo` (after an accepted loop
edge), `session_finish` with `pgo_final` and `write_poses`, and the
library's `preprocess.*`, `em.wait`, `pgo.*` and the counters
`align.retry`, `estep` and `estep.fused`. Under a torch profiler each span
is also a `record_function` of its name.

With --dist (the fourth configuration) the submap becomes map blocks
sharded over the mesh's ranks (dist/mesh.py; on one card a group of one
under NCCL): scan-to-map odometry runs the distributed EM align (the ring
NN and G1's distributed mode, dist/align_dist.py), with no health retry
as in the reference, and the run ends with the Schur-complement map BA
over the same mesh (slam/map_ba.py), whose statistics the result carries
under "map_ba". Every rank runs the control plane; the poses of each PGO
are rank 0's.

Usage:
  python -m semicp_torch.cli.run_slam --synthetic 120 [--loop] [--scan-to-map] [--dist]
  python -m semicp_torch.cli.run_slam --seq <kitti-seq-dir> [--voxel 0.3]
      [--out poses.txt] [--jsonl metrics.jsonl] [--checkpoint-dir ckpt/ --resume]
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from semicp_torch.cli.common import (
    device_name,
    load_scan_np,
    print_result,
    sequence_frames,
    setup_device,
    to_device_cloud,
)
from semicp_torch.cloud import Cloud
from semicp_torch.config import Config, parse_overrides
from semicp_torch.data import save_kitti_poses
from semicp_torch.geom.se3 import se3_exp
from semicp_torch.register import make_robust_align_fn
from semicp_torch.register.em_icp import _to_host
from semicp_torch.slam.keyframes import KeyframeStore, keyframe_due, semantic_descriptor
from semicp_torch.slam.loop_closure import (
    LoopVerifier,
    edge_info_from_hessian,
    propose_loop_closures,
)
from semicp_torch.slam.pose_graph import PoseGraph, add_edge, add_pose, optimize_pose_graph
from semicp_torch.slam.submap import build_submap
from semicp_torch.utils import MetricsLogger, PhaseTimer, drain, installed


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seq")
    ap.add_argument("--voxel", type=float, default=0.3)
    ap.add_argument("--out", default="poses_slam.txt")
    ap.add_argument("--jsonl", default=None)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--n-points", type=int, default=3000)
    ap.add_argument("--loop", action="store_true",
                    help="synthetic: drive a closed loop (tests loop closure)")
    ap.add_argument("--seed", type=int, default=0, help="synthetic: scene/trajectory seed")
    ap.add_argument("--drift", type=float, default=0.0,
                    help="synthetic: inject a per-frame odometry yaw bias (rad)")
    ap.add_argument("--scan-to-map", action="store_true",
                    help="odometry aligns against the current submap instead of the "
                         "previous scan")
    ap.add_argument("--dist", action="store_true",
                    help="shard the submap over the mesh's ranks (implies --scan-to-map) "
                         "and finish with the distributed map BA")
    ap.add_argument("--gt", default=None, help="KITTI ground-truth poses.txt for ATE/RPE")
    ap.add_argument("--calib", default=None,
                    help="KITTI calib.txt (Tr): move --gt into the velodyne frame before "
                         "evaluation")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--max-keyframes", type=int, default=256)
    ap.add_argument("--max-edges", type=int, default=1024)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; raises without a card)")
    return ap


def _exp(v) -> np.ndarray:
    """se3_exp of a 6-vector, in float32 on the CPU, as a numpy array."""
    return se3_exp(torch.from_numpy(np.asarray(v, np.float32))).numpy()


def synthetic_loop_frames(n_frames, n_points, closed=True, seed=0):
    """Square-loop trajectory over a structured scene -> frames + GT."""
    from semicp_torch.data import make_scene, render_scan

    rng = np.random.default_rng(seed)
    scene, labels = make_scene(rng, n_points=n_points * 6, extent=30.0)
    labels = labels - 1
    side = n_frames // 4 if closed else n_frames
    turn_frames = max(3, side // 3)
    poses = [np.eye(4, dtype=np.float32)]
    for i in range(1, n_frames):
        turn = 0.0
        if closed and (i % side) >= side - turn_frames:
            # each 90-degree corner spread over several frames, so the
            # per-frame rotation stays within reach of the EM gate
            turn = (np.pi / 2) / turn_frames
        poses.append(poses[-1] @ _exp([0.8, 0, 0, 0, 0, turn]))
    traj = np.stack(poses)
    frames = [render_scan(rng, scene, labels, p, max_range=28.0, max_points=n_points)
              for p in traj]
    return frames, traj


def _cloud_state(c: Cloud) -> dict:
    return {"xyz": c.xyz.cpu().numpy(), "label": c.label.cpu().numpy(),
            "cov6": c.cov6.cpu().numpy(), "valid": c.valid.cpu().numpy(),
            "count": c.count.cpu().numpy()}


def _capture_state(graph, store, anchors, T_now, T_rel_prev, prev_cloud, frame):
    """Full SLAM state -> dict of numpy arrays, in the layout of the JAX package's run_slam."""
    kfs = [_cloud_state(k.cloud) for k in store.keyframes]
    kf_clouds = {f: np.stack([k[f] for k in kfs]) for f in ("xyz", "label", "cov6", "valid")}
    kf_clouds["count"] = np.asarray([int(k["count"]) for k in kfs], np.int32)
    return {
        "graph": {
            "poses": graph.poses, "n_poses": np.asarray(graph.n_poses, np.int32),
            "edge_i": graph.edge_i, "edge_j": graph.edge_j, "edge_z": graph.edge_z,
            "edge_info": graph.edge_info, "edge_W": graph.edge_W,
            "n_edges": np.asarray(graph.n_edges, np.int32),
        },
        "kf_frames": np.asarray([k.frame for k in store.keyframes], np.int32),
        "kf_poses": np.stack([k.pose for k in store.keyframes]),
        "kf_desc": np.stack([k.descriptor for k in store.keyframes]),
        "kf_clouds": kf_clouds,
        "anchor_idx": np.asarray([a for a, _ in anchors], np.int32),
        "anchor_rel": np.stack([r for _, r in anchors]),
        "T_now": np.asarray(T_now), "T_rel_prev": np.asarray(T_rel_prev),
        "prev_cloud": _cloud_state(prev_cloud),
        "frame": np.asarray(frame, np.int32),
    }


def _cloud_from_state(d, device, i=None) -> Cloud:
    """A preprocessed cloud of the state (class-major: run_slam
    preprocesses every scan with the full Config)."""
    from semicp_torch.convert import cloud_from_numpy

    sel = (lambda x: np.asarray(x)[i]) if i is not None else np.asarray
    return cloud_from_numpy(sel(d["xyz"]), sel(d["label"]), sel(d["cov6"]), sel(d["valid"]),
                            sel(d["count"]), layout="cm", device=device)


def _restore_state(state, cfg, device):
    """run_slam's objects from a state dict of arrays: one the port's
    `_capture_state` wrote, or the JAX package's, turned into numpy."""
    from semicp_torch.convert import pose_graph_from_numpy

    g = state["graph"]
    graph = pose_graph_from_numpy(**{k: g[k] for k in (
        "poses", "n_poses", "edge_i", "edge_j", "edge_z", "edge_info", "edge_W", "n_edges")})
    store = KeyframeStore()
    for i in range(len(state["kf_frames"])):
        store.add(int(state["kf_frames"][i]), np.asarray(state["kf_poses"][i]),
                  _cloud_from_state(state["kf_clouds"], device, i),
                  np.asarray(state["kf_desc"][i]))
    anchors = [(int(a), np.asarray(r)) for a, r in zip(state["anchor_idx"], state["anchor_rel"])]
    prev_cloud = _cloud_from_state(state["prev_cloud"], device)
    return (graph, store, anchors, np.asarray(state["T_now"], np.float64),
            np.asarray(state["T_rel_prev"], np.float32), prev_cloud, int(state["frame"]))


def _upload_pose(T, dev) -> torch.Tensor:
    """A host pose as a (4, 4) f32 tensor on dev; to the card from pinned
    memory without a host wait (the align queues behind the copy)."""
    t = torch.from_numpy(np.ascontiguousarray(T, np.float32))
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def _pgo(graph, cfg: Config, dev, mesh):
    """optimize_pose_graph on dev; over a mesh every rank keeps rank 0's
    poses (the LM's sums may differ from card to card)."""
    graph = optimize_pose_graph(graph, cfg.slam, device=dev)
    return graph if mesh is None else graph.replace(poses=mesh.agree(graph.poses))


def run_slam(args, cfg: Config):
    """One session: (the result, its PhaseTimer). The timer is installed
    for the session, so the spans and counters of the library code it runs
    (preprocess.*, em.wait, align.retry, estep, estep.fused, pgo.*) land in its table."""
    timer = PhaseTimer()
    timer.count("align.retry", 0)
    with installed(timer):
        return _slam(args, cfg, timer), timer


def _slam(args, cfg: Config, timer: PhaseTimer) -> dict:
    with timer.phase("session_setup"):
        dev = setup_device(args.device)
        align_fn = make_robust_align_fn(cfg)
        verifier = LoopVerifier(cfg)
        mesh = map_align_fn = None
        if args.dist:
            from semicp_torch.dist.align_dist import make_dist_align_fn
            from semicp_torch.dist.mesh import make_mesh

            args.scan_to_map = True
            mesh = make_mesh(dev)
            dev = mesh.device
            map_align_fn = make_dist_align_fn(mesh, cfg)
        ml = MetricsLogger(args.jsonl)

        gt_traj = None
        if args.synthetic:
            frames, gt_traj = synthetic_loop_frames(args.synthetic, args.n_points,
                                                    closed=args.loop, seed=args.seed)
            frame_iter = iter(frames)

            def next_scan():
                return next(frame_iter, None)
        else:
            if args.gt:
                from semicp_torch.cli.run_odometry import load_gt_traj

                gt_traj = load_gt_traj(args.gt, args.calib)
            seq = sequence_frames(args.seq)
            if args.max_frames:
                seq = seq[: args.max_frames]
            it = iter(seq)

            def next_scan():
                item = next(it, None)
                if item is None:
                    return None
                return load_scan_np(item[0], item[1], args.voxel)

        graph = PoseGraph.empty(args.max_keyframes, args.max_edges)
        store = KeyframeStore()
        anchors: list[tuple[int, np.ndarray]] = []  # per frame: (kf_idx, T_kf_frame)
        T_now = np.eye(4)
        prev_cloud = None
        T_rel_prev = np.eye(4, dtype=np.float32)
        frame = 0
        n_loop_edges = 0
        submap = None            # (anchor kf index, fused Cloud) for --scan-to-map
        bias = _exp([0, 0, 0, 0, 0, args.drift]).astype(np.float64) if args.drift else None

        def rebuild_submap():
            """Fuse the last submap_keyframes keyframe clouds into the newest
            keyframe's frame. Rebuilt per keyframe; poses a PGO corrects are
            taken up at the next rebuild."""
            poses_cur = graph.poses.astype(np.float64)
            kfs = store.keyframes[-cfg.slam.submap_keyframes:]
            anchor = store[-1].index
            with timer.phase("submap"):
                sm = build_submap(kfs, poses_cur, anchor, cfg,
                                  voxel=args.voxel if args.seq else 0.1)
                drain(sm.cov6)
            return anchor, sm

        start_frame = 0
        if args.resume and args.checkpoint_dir:
            from semicp_torch.utils.checkpoint import latest_checkpoint

            step, state = latest_checkpoint(args.checkpoint_dir)
            if state is not None:
                graph, store, anchors, T_now, T_rel_prev, prev_cloud, start_frame = \
                    _restore_state(state, cfg, dev)
                frame = start_frame
                if args.scan_to_map and len(store):
                    submap = rebuild_submap()
                print(f"resumed at frame {start_frame} ({len(store)} keyframes, "
                      f"{graph.n_edges} edges)", file=sys.stderr)

    consumed = 0
    while True:
        with timer.phase("scan_wait"):
            scan = next_scan()
        if scan is None:
            break
        if consumed < start_frame:
            consumed += 1
            continue
        consumed += 1
        pts, lab = scan
        with timer.phase("preprocess"):
            # queued on the device; the align below waits behind it
            cloud = to_device_cloud(pts, lab, cfg, dev)

        if prev_cloud is None:
            with timer.phase("keyframe"):
                desc = semantic_descriptor(lab, cfg.cloud.num_classes, pts)
                store.add(frame, T_now, cloud, desc)
                graph = add_pose(graph, T_now.astype(np.float32))
            anchors.append((0, np.eye(4)))
            if args.scan_to_map:
                submap = rebuild_submap()
        else:
            with timer.phase("odometry"):
                # the result is the host copy its health check made
                if submap is not None:
                    # scan-to-map: align against the fused submap in its
                    # anchor keyframe's frame
                    anchor_idx, sm_cloud = submap
                    anchor_pose = graph.poses[anchor_idx].astype(np.float64)
                    T_pred = T_now @ np.asarray(T_rel_prev, np.float64)
                    T_init = np.linalg.inv(anchor_pose) @ T_pred
                    if map_align_fn is not None:
                        res = _to_host(map_align_fn(cloud, sm_cloud, _upload_pose(T_init, dev)),
                                       cloud, sm_cloud)[0]
                    else:
                        res = align_fn(cloud, sm_cloud, _upload_pose(T_init, dev))
                    T_new = anchor_pose @ res.T.numpy().astype(np.float64)
                    T_rel = np.linalg.inv(T_now) @ T_new
                else:
                    res = align_fn(cloud, prev_cloud, _upload_pose(T_rel_prev, dev))
                    T_rel = res.T.numpy().astype(np.float64)
            with timer.phase("keyframe"):
                # every frame: the running pose, its record and anchor, the
                # keyframe decision; when due, the keyframe and its edge
                T_rel_prev = T_rel.astype(np.float32)
                if bias is not None:
                    # simulated biased odometry: a per-frame yaw bias (a constant
                    # translational bias on a closed loop is a global rotation,
                    # which the rigid ATE alignment absorbs)
                    T_rel = T_rel @ bias
                T_now = T_now @ T_rel
                ml.log(frame=frame, kind="odom", iters=int(res.iterations),
                       cost=float(res.cost), n_corr=float(res.n_corr))

                kf_last = store[-1]
                last_kf_pose = graph.poses[kf_last.index].astype(np.float64)
                anchors.append((kf_last.index, np.linalg.inv(last_kf_pose) @ T_now))

                kf = None
                if keyframe_due(last_kf_pose, T_now, cfg.slam):
                    desc = semantic_descriptor(lab, cfg.cloud.num_classes, pts)
                    kf = store.add(frame, T_now, cloud, desc)
                    graph = add_pose(graph, T_now.astype(np.float32))
                    Z = np.linalg.inv(last_kf_pose) @ T_now
                    H = res.H.numpy()
                    graph = add_edge(graph, kf_last.index, kf.index, Z.astype(np.float32),
                                     edge_info_from_hessian(H), H=H)
            if kf is not None:
                if args.scan_to_map:
                    submap = rebuild_submap()

                with timer.phase("loop_search"):
                    poses_now = graph.poses.astype(np.float64)
                    cands = propose_loop_closures(store, kf, poses_now, cfg)
                    with timer.phase("loop_verify"):
                        # every candidate verified in one batch
                        verified = verifier.verify(store, cands[:cfg.slam.lc_max_candidates],
                                                   kf.index, poses_now)
                    accepted = []
                    for c, ok, Zl, info, Hl in verified:
                        if ok:
                            graph = add_edge(graph, c, kf.index, Zl.astype(np.float32),
                                             info, H=Hl)
                            accepted.append(c)
                            n_loop_edges += 1
                if accepted:
                    with timer.phase("pgo"):
                        graph = _pgo(graph, cfg, dev, mesh)
                    # re-anchor the running pose on the corrected keyframe
                    T_now = graph.poses[kf.index].astype(np.float64)
                    ml.log(frame=frame, kind="pgo", edges=graph.n_edges, loops=len(accepted))

                if args.checkpoint_dir and len(store) % cfg.slam.checkpoint_every == 0:
                    from semicp_torch.utils.checkpoint import save_checkpoint

                    save_checkpoint(args.checkpoint_dir,
                                    _capture_state(graph, store, anchors, T_now, T_rel_prev,
                                                   cloud, frame + 1),
                                    step=len(store))

        prev_cloud = cloud
        frame += 1

    with timer.phase("session_finish"):
        # final PGO + trajectory recomposition against optimized keyframe poses
        if graph.n_edges > 0:
            with timer.phase("pgo_final"):
                graph = _pgo(graph, cfg, dev, mesh)
        final_kf = graph.poses.astype(np.float64)
        ba_stats = None
        if args.dist and len(store) >= 2:
            # the fourth configuration's closer: the keyframe poses refined
            # against the fused world map by the Schur BA over the mesh
            from semicp_torch.slam.map_ba import refine_keyframes

            with timer.phase("map_ba"):
                final_kf, ba_stats = refine_keyframes(store, final_kf, cfg, mesh=mesh,
                                                      voxel=args.voxel if args.seq else 0.1)
            ml.log(frame=frame, kind="map_ba", **ba_stats)
        traj = np.stack([final_kf[a] @ rel for a, rel in anchors])
        with timer.phase("write_poses"):
            save_kitti_poses(args.out, traj)
        ml.close()

    out = {"frames": len(traj), "keyframes": len(store), "edges": graph.n_edges,
           "loop_edges": n_loop_edges, "out": str(args.out), "device": device_name(dev),
           "timing": timer.summary()}
    if ba_stats is not None:
        out["map_ba"] = ba_stats
    if gt_traj is not None and len(traj) > 2:
        from semicp_torch.eval import ate_rmse, rpe

        gt = gt_traj[: len(traj)]
        out["ate_rmse_m"] = ate_rmse(traj, gt)
        out["rpe_trans_m"], out["rpe_rot_rad"] = rpe(traj, gt)
    return out


def main(argv=None):
    ap = build_parser()
    args, extra = ap.parse_known_args(argv if argv is not None else sys.argv[1:])
    cfg = Config().override(parse_overrides(extra))
    if not args.synthetic and not args.seq:
        ap.error("--seq or --synthetic required")
    out, timer = run_slam(args, cfg)
    print_result("run_slam", out)
    print(timer.table(), file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
