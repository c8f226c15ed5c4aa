#!/usr/bin/env python3
"""The control of the comparison: the reference in bfloat16 in the system's place.

    python3 benchmark/control.py --workload <name> --seeds 1 2 3

For each seed it draws the cell's sequence, puts the reference in the
system's place with every per-point array kept in bfloat16 (the scans,
their covariances, the moved points and the E-step's planes; the poses of
the pose graph), the arithmetic in float32, the precision below the
configuration's float32, and reads each number the run's checks compare,
judged as a run's answers are (judge.py):
* `unconverged_share`, `pose_gap` and `corr_gap`: frames drawn from the
  seed, each aligned onto the previous scan from the true motion of the
  frame before (the system's constant-velocity warm start), stopping as
  the system does (a pose step under `trans_eps`, or `max_passes`), its
  correspondence count that of its last E-step, as an align reports it;
* for a SLAM cell, from one session of the system itself (whose loop
  pairs and pose graph the control takes as its input): `loop_gap`, the
  accepted loop pairs aligned from their true relative pose at the
  verifier's gate and pass limit, and `pgo_gap`, the last pose graph
  optimised from the poses it was handed.
The limits are set between the largest readings of sound runs and the
smallest of this control. Each seed's numbers are judged against the
cell's limits by the run's own rule (judge.passed): `correct` has to come
out false. The benchmark's own runs never run this. Prints one JSON line a
seed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "benchmark"]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import judge, pgo_reference, reference, scenes, spec  # noqa: E402

STORE = torch.bfloat16


def control_align(seq, src, tgt, T0, params, device, store, passes, tol):
    """(T, converged, correspondence count) of the control's align of scan
    src onto scan tgt."""
    a = reference.prepare(seq.points[src], seq.labels[src], params, torch.float32, device, store)
    b = reference.prepare(seq.points[tgt], seq.labels[tgt], params, torch.float32, device, store)
    r = reference.em(a, b, T0, params, passes, tol)
    return r.T, r.step < tol, r.n_last


def aligns(config, seq, seed, n, device, store) -> dict:
    """unconverged_share, pose_gap and corr_gap of the control's aligns on
    2 n frames drawn from the seed (at most n judged, drawn among the
    converged)."""
    alg = config["algorithm"]
    params = reference.Params.from_dict(alg)
    frames = judge.sample_frames(config["sequence"]["frames"], 2 * n, seed)
    P = seq.poses
    out = {}
    for f in frames:
        T0 = np.eye(4) if f < 2 else np.linalg.inv(P[f - 2]) @ P[f - 1]
        out[f] = control_align(seq, f, f - 1, T0, params, device, store, alg["max_passes"],
                               alg["trans_eps"])
    conv = [f for f in frames if out[f][1]]
    rng = np.random.default_rng([int(seed), 1])
    picks = sorted(rng.choice(conv, size=min(n, len(conv)), replace=False).tolist()) if conv else []
    got = judge.pose_gaps(seq, picks, lambda f: out[f][0], params, device)
    return {"unconverged_share": 1.0 - len(conv) / len(frames),
            "pose_gap": max((j.gap for _, j in got), default=None),
            "corr_gap": max((judge.count_gap(out[f][2], j.n_ref) for f, j in got), default=None),
            "frames": [[f, bool(out[f][1])] + [j.gap for ff, j in got if ff == f]
                       for f in frames]}


def one_session(cell, seq, device):
    """One session of the system over the sequence, with what the recorder
    keeps of its answers."""
    from benchmark import recorders, sessions

    rec = recorders.Recorder(cell.config.get("record", []))
    with tempfile.TemporaryDirectory(prefix="semicp-control-") as tmp, rec.active():
        seq_dir = scenes.write_sequence(seq, Path(tmp) / "seq",
                                        cell.config["sequence"]["classes"] + 1)
        drv = sessions.Driver(cell.config, cell.traffic, seq_dir, Path(tmp) / "out", device,
                              recorder=rec)
        return drv.session("c").captured


def slam_back_end(cell, seq, seed, device, store) -> dict:
    """loop_gap and pgo_gap of the control on a session's loop pairs and
    last pose graph."""
    alg = cell.config["algorithm"]
    params = reference.Params.from_dict(alg)
    cap = one_session(cell, seq, device)
    pairs = [(v["j"], c["frame"]) for v in cap["verify"] for c in v["c"] if c["ok"]]
    rng = np.random.default_rng([int(seed), 2])
    pairs = [pairs[i] for i in sorted(rng.choice(len(pairs), size=min(
        len(pairs), int(cell.traffic["check_loops"])), replace=False))] if pairs else []
    loop_p = dataclasses.replace(params, gate=alg["loop_gate"])
    P = seq.poses
    found = []
    for fj, fc in pairs:
        T, ok, _ = control_align(seq, fj, fc, np.linalg.inv(P[fc]) @ P[fj], loop_p, device,
                                 store, alg["loop_max_passes"], alg["trans_eps"])
        if ok:
            found.append((fj, fc, T))
    lg = judge.pair_gaps(seq, [(fj, fc, T, alg["loop_gate"]) for fj, fc, T in found], params,
                         device, passes=int(cell.traffic["loop_passes"]))
    graph_in, _ = cap["pgo"][-1]
    poses_in, edges = pgo_reference.graph_edges(graph_in)
    ctl = pgo_reference.optimise(poses_in, edges, alg["pgo_huber"], torch.float32, store,
                                 iters=alg["pgo_iters"])
    ref = pgo_reference.optimise(ctl, edges, alg["pgo_huber"])
    return {"loop_gap": max((j.gap for j in lg), default=None),
            "loops_converged": f"{len(found)} of {len(pairs)}",
            "pgo_gap": pgo_reference.pose_set_gap(ref, ctl)}


def judged(out: dict, limits: dict) -> dict:
    """The control's numbers as a run's checks: each number the cell
    compares, beside its limit (a number the control could not give is
    missing, which fails)."""
    return {k: {"value": out.get(k), "limit": lim} for k, lim in limits.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = spec.load_cell(args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        seq = scenes.make_sequence(cell.config["sequence"], seed, args.device)
        out = aligns(cell.config, seq, seed, int(cell.traffic["check_frames"]), args.device, STORE)
        if cell.config["check"] == "slam":
            out.update(slam_back_end(cell, seq, seed, args.device, STORE))
        checks = judged(out, cell.config["correct"])
        print(json.dumps({"workload": args.workload, "seed": seed, **out,
                          "correct": judge.passed(checks), "checks": judge.printable(checks),
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
