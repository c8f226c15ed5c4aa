"""Multi-sequence batch odometry and batch SLAM (`run_batch`).

Port of `semicp/cli/run_batch.py`, the system's fifth configuration. S
sequences advance in lockstep; each step aligns the S scan pairs as one
batch over the mesh (dist/batch.py `batched_align` over the "pairs"
axis, dist/mesh.py): every rank aligns its contiguous share of the
sequences and the results are gathered to every rank. As in the JAX
package, every rank runs the host control plane and preprocesses every
scan; only the aligns are sharded. On one card the mesh is a group of
one (NCCL), and the batch is the card's aligns in turn.

Plain `run_batch` preprocesses each scan with the bare `CovConfig`, as
the reference does (`run_batch.py:316`): the clouds stay in raw layout,
so their moments run kernel K5 on the card, and every align sorts its
source and target class-major itself (K2 or K4, K3, G1).

`--slam` runs full SLAM per sequence: keyframes, loop-closure proposal,
the verification of every sequence's candidates in one batched wide-gate
align, per-sequence pose-graph optimisation and the trajectory against
the final keyframe poses; the per-sequence logic is cli/run_slam.py's,
so a batched run reproduces S independent run_slam runs. Its scans are
preprocessed with the full Config (K1).

The host reads each batch's results in one device-to-host copy, after
the EM convergence flag of each pass of each align.

Usage:
  python -m semicp_torch.cli.run_batch --synthetic 30 --sequences 8 [--n-points 2000]
  python -m semicp_torch.cli.run_batch --synthetic 40 --slam --loop --drift 0.004
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from semicp_torch.cli.common import device_name, print_result, setup_device, to_device_cloud
from semicp_torch.cloud import make_cloud, preprocess_cloud
from semicp_torch.config import Config, parse_overrides
from semicp_torch.dist.batch import batched_align, to_host
from semicp_torch.dist.mesh import make_mesh
from semicp_torch.utils import MetricsLogger, PhaseTimer, drain


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--synthetic", type=int, required=True, help="frames per sequence")
    ap.add_argument("--sequences", type=int, default=0,
                    help="number of sequences (default: one per rank of the mesh)")
    ap.add_argument("--n-points", type=int, default=2000)
    ap.add_argument("--jsonl", default=None)
    ap.add_argument("--slam", action="store_true",
                    help="full batch SLAM per sequence (keyframes, batched loop-closure "
                         "verification, PGO) instead of plain batched odometry")
    ap.add_argument("--loop", action="store_true", help="--slam synthetic: drive closed loops")
    ap.add_argument("--drift", type=float, default=0.0,
                    help="--slam synthetic: per-frame yaw drift (rad)")
    ap.add_argument("--max-keyframes", type=int, default=128)
    ap.add_argument("--max-edges", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; raises without a card)")
    return ap


def synthetic_sequences(n_seq: int, n_frames: int, n_points: int) -> list:
    """Plain run_batch's S synthetic sequences, the JAX driver's: per
    sequence (frames [(points (n,3), labels (n,))] in the sensor frame,
    the ground-truth poses (n_frames,4,4)), sequence s from seed s."""
    from semicp_torch.data import make_scene, make_trajectory, render_scan

    seqs = []
    for s in range(n_seq):
        rng = np.random.default_rng(s)
        scene, labels = make_scene(rng, n_points=n_points * 4, extent=30.0)
        labels = labels - 1
        traj = make_trajectory(n_frames, step=0.6, turn=0.05, seed=s)
        frames = [render_scan(rng, scene, labels, p, max_range=25.0, max_points=n_points)
                  for p in traj]
        seqs.append((frames, traj))
    return seqs


def run_batch_slam(args, cfg: Config):
    """S sequences of full SLAM in lockstep. The aligns of a step (odometry,
    then every sequence's loop verifications) run as batches over the mesh;
    the control plane (keyframes, candidate gating, the graphs, PGO) runs
    per sequence as cli/run_slam.py runs it. Returns (the result dict, the
    trajectories, the PhaseTimer)."""
    from semicp_torch.cli.run_slam import _exp, synthetic_loop_frames
    from semicp_torch.slam.keyframes import KeyframeStore, keyframe_due, semantic_descriptor
    from semicp_torch.slam.loop_closure import (
        VERIFY_MAX_ITERS,
        edge_info_from_hessian,
        propose_loop_closures,
    )
    from semicp_torch.slam.pose_graph import PoseGraph, add_edge, add_pose, optimize_pose_graph

    dev = setup_device(args.device)
    mesh = make_mesh(dev)
    dev = mesh.device
    timer = PhaseTimer()
    S = args.sequences or mesh.world
    align_b = batched_align(cfg, mesh)

    with timer.phase("generate"):
        seqs = [synthetic_loop_frames(args.synthetic, args.n_points, closed=args.loop, seed=s)
                for s in range(S)]

    graphs = [PoseGraph.empty(args.max_keyframes, args.max_edges) for _ in range(S)]
    stores = [KeyframeStore() for _ in range(S)]
    kf_count: list[list[int]] = [[] for _ in range(S)]   # each keyframe's points, on the host
    anchors: list[list] = [[] for _ in range(S)]
    T_now = [np.eye(4) for _ in range(S)]
    T_rel_prev = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
    n_loop_edges = [0] * S
    drift_T = _exp([0, 0, 0, 0, 0, args.drift]).astype(np.float64) if args.drift else None

    def pgo(s):
        g = optimize_pose_graph(graphs[s], cfg.slam, device=dev)
        # every rank keeps rank 0's poses: the LM's sums may differ by card
        graphs[s] = g.replace(poses=mesh.agree(g.poses))

    def flush_verifications(reqs):
        """Verify every sequence's loop-closure candidates in one batched
        wide-gate align; returns the accepted (s, c, j, Z, H)."""
        if not reqs:
            return []
        res = to_host(align_b([stores[s][j].cloud for s, c, j, _ in reqs],
                              [stores[s][c].cloud for s, c, j, _ in reqs],
                              np.stack([Ti for *_, Ti in reqs]).astype(np.float32),
                              gate=cfg.slam.lc_max_dist / 2.0, max_iters=VERIFY_MAX_ITERS))
        out = []
        for r, (s, c, j, _) in enumerate(reqs):
            if bool(res.converged[r]) and float(res.n_corr[r]) > 0.25 * kf_count[s][j]:
                out.append((s, c, j, res.T[r].numpy().astype(np.float64),
                            res.H[r].numpy().astype(np.float64)))
        return out

    prev, prev_n = None, None
    n_aligns = 0
    t_start = time.perf_counter()
    for t in range(args.synthetic):
        with timer.phase("preprocess"):
            batch = [to_device_cloud(*seqs[s][0][t], cfg, dev) for s in range(S)]
            drain(batch)
        n_now = [len(seqs[s][0][t][0]) for s in range(S)]
        if prev is None:
            for s in range(S):
                pts, lab = seqs[s][0][t]
                desc = semantic_descriptor(lab, cfg.cloud.num_classes, pts)
                stores[s].add(t, T_now[s], batch[s], desc)
                kf_count[s].append(n_now[s])
                graphs[s] = add_pose(graphs[s], np.eye(4, dtype=np.float32))
                anchors[s].append((0, np.eye(4)))
            prev, prev_n = batch, n_now
            continue

        with timer.phase("align_batch"):
            res = to_host(align_b(batch, prev, T_rel_prev))
        n_aligns += S
        T_rel_all = res.T.numpy().astype(np.float64)
        H_all = res.H.numpy().astype(np.float64)

        # the batched form of make_robust_align_fn's health retry: warm
        # starts that landed in a bad basin (correspondence starvation) are
        # solved again from identity in one more batched align
        frac = cfg.em.retry_overlap_frac
        if frac > 0.0:
            n_corr = res.n_corr.numpy()
            bad = [s for s in range(S)
                   if not (bool(res.converged[s])
                           and float(n_corr[s]) >= frac * min(n_now[s], prev_n[s]))]
            if bad:
                res_r = to_host(align_b([batch[s] for s in bad], [prev[s] for s in bad],
                                        np.tile(np.eye(4, dtype=np.float32), (len(bad), 1, 1))))
                n_aligns += len(bad)
                for r, s in enumerate(bad):
                    if float(res_r.n_corr[r]) > float(n_corr[s]):
                        T_rel_all[s] = res_r.T[r].numpy().astype(np.float64)
                        H_all[s] = res_r.H[r].numpy().astype(np.float64)

        verify_reqs = []
        new_kf = {}
        for s in range(S):
            T_rel = T_rel_all[s]
            T_rel_prev[s] = T_rel.astype(np.float32)
            if drift_T is not None:
                T_rel = T_rel @ drift_T
            T_now[s] = T_now[s] @ T_rel

            kf_last = stores[s][-1]
            last_kf_pose = graphs[s].poses[kf_last.index].astype(np.float64)
            anchors[s].append((kf_last.index, np.linalg.inv(last_kf_pose) @ T_now[s]))

            if keyframe_due(last_kf_pose, T_now[s], cfg.slam):
                pts, lab = seqs[s][0][t]
                desc = semantic_descriptor(lab, cfg.cloud.num_classes, pts)
                kf = stores[s].add(t, T_now[s], batch[s], desc)
                kf_count[s].append(n_now[s])
                graphs[s] = add_pose(graphs[s], T_now[s].astype(np.float32))
                Z = np.linalg.inv(last_kf_pose) @ T_now[s]
                graphs[s] = add_edge(graphs[s], kf_last.index, kf.index, Z.astype(np.float32),
                                     edge_info_from_hessian(H_all[s]), H=H_all[s])
                new_kf[s] = kf.index
                poses_now = graphs[s].poses.astype(np.float64)
                cands = propose_loop_closures(stores[s], kf, poses_now, cfg)
                for c in cands[:cfg.slam.lc_max_candidates]:
                    T_init = np.linalg.inv(poses_now[c]) @ poses_now[kf.index]
                    verify_reqs.append((s, c, kf.index, T_init))

        with timer.phase("loop_verify"):
            accepted = flush_verifications(verify_reqs)
        n_aligns += len(verify_reqs)
        pgo_seqs = []
        for s, c, j, Z, H in accepted:
            graphs[s] = add_edge(graphs[s], c, j, Z.astype(np.float32),
                                 edge_info_from_hessian(H), H=H)
            n_loop_edges[s] += 1
            if s not in pgo_seqs:
                pgo_seqs.append(s)
        for s in pgo_seqs:
            with timer.phase("pgo"):
                pgo(s)
            T_now[s] = graphs[s].poses[new_kf[s]].astype(np.float64)
        prev, prev_n = batch, n_now
    wall = time.perf_counter() - t_start

    from semicp_torch.eval import ate_rmse

    trajs, ates = [], []
    for s in range(S):
        if graphs[s].n_edges > 0:
            pgo(s)
        final_kf = graphs[s].poses.astype(np.float64)
        traj = np.stack([final_kf[a] @ rel for a, rel in anchors[s]])
        trajs.append(traj)
        ates.append(ate_rmse(traj, seqs[s][1][: len(traj)]))

    out = {
        "sequences": S,
        "frames_per_seq": args.synthetic,
        "aligns_total": n_aligns,
        "aligns_per_s": round(n_aligns / max(wall, 1e-9), 3),
        "devices": mesh.world,
        "keyframes": [len(st) for st in stores],
        "loop_edges": n_loop_edges,
        "ate_rmse_m": [round(a, 4) for a in ates],
        "ate_rmse_mean": float(np.mean(ates)),
        "device": device_name(dev),
        "timing": timer.summary(),
    }
    return out, trajs, timer


def run_batch(args, cfg: Config):
    """Plain batched odometry over S synthetic sequences. Returns (the
    result dict, the per-sequence chained poses (S lists of (4,4)), the
    PhaseTimer)."""
    from semicp_torch.eval import ate_rmse

    dev = setup_device(args.device)
    mesh = make_mesh(dev)
    dev = mesh.device
    S = args.sequences or mesh.world

    timer = PhaseTimer()
    with timer.phase("generate"):
        seqs = synthetic_sequences(S, args.synthetic, args.n_points)

    align_b = batched_align(cfg, mesh)
    poses = [[np.eye(4)] for _ in range(S)]
    T_rel_prev = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
    prev = None
    ml = MetricsLogger(args.jsonl)
    n_aligns = 0
    t_start = time.perf_counter()
    for t in range(args.synthetic):
        with timer.phase("preprocess"):
            # the bare CovConfig: raw layout (K5), as the reference preprocesses
            batch = [preprocess_cloud(make_cloud(*seqs[s][0][t], n_pad=cfg.cloud.n_pad,
                                                 device=dev), cfg.cov) for s in range(S)]
            drain(batch)
        if prev is not None:
            with timer.phase("align_batch"):
                res = to_host(align_b(batch, prev, T_rel_prev))
            T_rel_prev = res.T.numpy()
            for s in range(S):
                poses[s].append(poses[s][-1] @ T_rel_prev[s].astype(np.float64))
            n_aligns += S
            ml.log(frame=t, mean_iters=float(np.mean(res.iterations.numpy())),
                   mean_cost=float(np.mean(res.cost.numpy())))
        prev = batch
    wall = time.perf_counter() - t_start
    ml.close()

    ates = [ate_rmse(np.stack(poses[s]), seqs[s][1][: len(poses[s])]) for s in range(S)]
    out = {
        "sequences": S,
        "frames_per_seq": args.synthetic,
        "aligns_total": n_aligns,
        "aligns_per_s": round(n_aligns / max(wall, 1e-9), 3),
        "devices": mesh.world,
        "ate_rmse_m": [round(a, 4) for a in ates],
        "ate_rmse_mean": float(np.mean(ates)),
        "device": device_name(dev),
        "timing": timer.summary(),
    }
    return out, poses, timer


def main(argv=None):
    ap = build_parser()
    args, extra = ap.parse_known_args(argv if argv is not None else sys.argv[1:])
    cfg = Config().override(parse_overrides(extra))
    if args.slam:
        out, _, timer = run_batch_slam(args, cfg)
        print_result("run_batch_slam", out)
    else:
        out, _, timer = run_batch(args, cfg)
        print_result("run_batch", out)
    print(timer.table(), file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
