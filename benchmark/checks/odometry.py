"""The checks of a cell whose driver writes one relative pose a frame and a
per-frame JSONL record (run_odometry): `frames_missing`, then, over one
session drawn from the seed (every session replays the same sequence),
`unconverged_share`, `pose_gap` and `corr_gap` (judge.py)."""

import math

import numpy as np

from benchmark import judge, reference


def read(config: dict, traffic: dict, seq, sessions, seed: int, device) -> dict:
    frames = int(config["sequence"]["frames"])
    limits = dict(config["correct"], frames=int(traffic["check_frames"]))
    checks = {"frames_missing": {"value": judge.missing_frames(sessions, frames), "limit": 0}}
    whole = judge.whole_sessions(sessions, frames, lambda s: len(s.records()) == frames - 1)
    if not whole:
        for k in ("unconverged_share", "pose_gap", "corr_gap"):
            checks[k] = {"value": math.inf, "limit": limits[k]}
        return checks
    one = whole[int(np.random.default_rng([int(seed), 2]).integers(len(whole)))]
    P = one.poses()
    recs = {r["frame"]: r for r in one.records()}
    judge.aligned(checks, limits, seq, reference.Params.from_dict(config["algorithm"]), device,
                  seed, frames, lambda f: np.linalg.inv(P[f - 1]) @ P[f],
                  {f: bool(r["converged"]) for f, r in recs.items()},
                  lambda f: float(recs[f]["n_corr"]), f"session {one.index}")
    return checks
