"""The checks of a keyframe-SLAM cell (run_slam, its answers kept by the
recorder). Beside `frames_missing` and `loops_missing` (sessions that
closed no loop), over one session drawn from the seed:
* `unconverged_share`, `pose_gap` and `corr_gap`: its frames' odometry
  aligns (scan f onto scan f - 1), as its align returned them (judge.py);
* `loop_gap`: accepted loop edges drawn from the seed, each verification's
  align (keyframe j's scan onto candidate c's) judged at the verifier's
  gate;
* `pgo_gap`: its last pose-graph optimisation. The plain pose-graph
  reference optimises the graph the system handed it with every judged
  loop edge rebuilt from the reference's own align of that pair (its
  pose, and its information from the reference's Hessian); the
  odometry edges are the system's (each chains frame aligns that
  `pose_gap` samples). The system's poses are judged by how far the
  reference moves them.
"""

import math
import sys

import numpy as np

from benchmark import judge, pgo_reference, reference


def read(config: dict, traffic: dict, seq, sessions, seed: int, device) -> dict:
    frames = int(config["sequence"]["frames"])
    limits = dict(config["correct"], frames=int(traffic["check_frames"]))
    params = reference.Params.from_dict(config["algorithm"])
    checks = {"frames_missing": {"value": judge.missing_frames(sessions, frames), "limit": 0}}
    loops = [sum(c["ok"] for v in s.captured["verify"] for c in v["c"]) for s in sessions]
    checks["loops_missing"] = {"value": sum(1 for n in loops if n == 0), "limit": 0}
    whole = judge.whole_sessions(sessions, frames,
                                 lambda s: len(s.captured["align"]) == frames - 1)
    if not whole:
        for k in ("unconverged_share", "pose_gap", "corr_gap", "loop_gap", "pgo_gap"):
            checks[k] = {"value": math.inf, "limit": limits[k]}
        return checks
    rng = np.random.default_rng([int(seed), 2])
    one = whole[int(rng.integers(len(whole)))]
    aligns = one.captured["align"]
    judge.aligned(checks, limits, seq, params, device, seed, frames,
                  lambda f: aligns[f - 1].T.numpy(),
                  {f: bool(aligns[f - 1].converged) for f in range(1, frames)},
                  lambda f: float(aligns[f - 1].n_corr), f"session {one.index}")

    edges = [(v["j"], c["frame"], c["Z"], v["ji"], c["index"])
             for v in one.captured["verify"] for c in v["c"] if c["ok"]]
    edges = [edges[i] for i in sorted(rng.choice(len(edges), size=min(len(edges),
                                                 int(traffic["check_loops"])), replace=False))]
    gate = float(config["algorithm"]["loop_gate"])
    lg = judge.pair_gaps(seq, [(fj, fc, Z, gate) for fj, fc, Z, _, _ in edges], params, device,
                         passes=int(traffic["loop_passes"]))
    for (fj, fc, _, _, _), j in zip(edges, lg):
        print(f"check: loop edge {fj} -> {fc} (session {one.index}): loop_gap {j.gap:.6e} after "
              f"{j.passes} reference passes (last step {j.step:.2e})", file=sys.stderr)
    checks["loop_gap"] = {"value": max([j.gap for j in lg], default=math.inf),
                          "limit": limits["loop_gap"]}

    graph_in, graph_out = one.captured["pgo"][-1]
    poses_out, _ = pgo_reference.graph_edges(graph_out)
    _, edges_in = pgo_reference.graph_edges(graph_in)
    rebuilt = 0
    for (_, _, _, ji, ci), j in zip(edges, lg):
        hit = np.nonzero((edges_in["i"] == ci) & (edges_in["j"] == ji))[0]
        if j.T is not None and len(hit):
            e = hit[-1]
            edges_in["z"][e] = j.T
            edges_in["info"][e], edges_in["W"][e] = pgo_reference.edge_weight(j.H)
            rebuilt += 1
    ref = pgo_reference.optimise(poses_out, edges_in, float(config["algorithm"]["pgo_huber"]))
    g = pgo_reference.pose_set_gap(ref, poses_out)
    print(f"check: last pose-graph optimisation (session {one.index}, {len(poses_out)} poses, "
          f"{len(edges_in['i'])} edges, {rebuilt} loop edges rebuilt by the reference): "
          f"pgo_gap {g:.6e}", file=sys.stderr)
    checks["pgo_gap"] = {"value": g, "limit": limits["pgo_gap"]}
    return checks
