"""What the checks that decide `correct` share (checks/<check>.py use it).

Every answer the window's sessions owed is accounted for: each session has
to leave one pose for every frame of the sequence, all finite
(`frames_missing`, limit 0). Then a sample of the aligned frames, drawn
from the seed, is judged by the plain reference in float64 (`reference.py`):
the frame's relative pose as the session wrote it, inv(P[f-1]) P[f], is the
start of the reference's EM on the same two scans; the reference moves it
to its own fixed point, and `pose_gap` is the largest distance moved,
||log(T_ref T^-1)|| (metres and radians in one norm, the system's own
convergence measure). A pose the system converged to under the same
semantics moves by about its stopping tolerance; a pose computed in a lower
precision, or an answer left at its warm start or altered, moves further.
`corr_gap` holds the correspondence count the system reported for the
frame to the reference's count at the same pose (relative): an E-step that
leaves points out moves the pose little and the count much.

The reference runs after the window has closed and the system's state is
freed; each sampled frame is two scans prepared and one EM.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import NamedTuple

import numpy as np
import torch

from benchmark import geom, reference


class Judged(NamedTuple):
    gap: float             # ||log(T_ref T^-1)||
    passes: int            # the reference's EM passes
    step: float            # its last pose step
    n_ref: float           # its correspondence count at the judged pose
    T: np.ndarray | None   # where the reference stopped
    H: np.ndarray | None   # its Gauss-Newton Hessian there


def sample_frames(n_frames: int, count: int, seed: int) -> list[int]:
    """`count` distinct aligned frames (1 .. n_frames - 1), drawn from seed."""
    rng = np.random.default_rng([int(seed), 1])
    return sorted(rng.choice(np.arange(1, n_frames), size=min(count, n_frames - 1),
                             replace=False).tolist())


def missing_frames(sessions, frames: int) -> int:
    """Poses a session owed and did not leave (or left non-finite)."""
    miss = 0
    for s in sessions:
        P = s.poses()
        good = int(np.isfinite(P.reshape(len(P), -1)).all(1).sum()) if len(P) else 0
        miss += frames - min(good, frames) + max(len(P) - frames, 0)
    return miss


def pair_gaps(seq, pairs, params, device, dtype=torch.float64, passes=8,
              tol=2e-6) -> list[Judged]:
    """For each pair (source frame, target frame, pose, gate): the reference's
    EM on the source scan onto the target scan from the pose, judged."""
    prep = {}

    def prepared(i):
        if i not in prep:
            prep[i] = reference.prepare(seq.points[i], seq.labels[i], params, dtype, device)
        return prep[i]

    out = []
    for src, tgt, T, gate in pairs:
        T = np.asarray(T, np.float64)
        if not np.isfinite(T).all():
            out.append(Judged(math.inf, 0, math.inf, math.nan, None, None))
            continue
        p = dataclasses.replace(params, gate=gate)
        r = reference.em(prepared(src), prepared(tgt), T, p, passes, tol)
        out.append(Judged(geom.gap(torch.from_numpy(r.T), torch.from_numpy(T)), r.passes,
                          r.step, r.n_first, r.T, r.H))
    return out


def pose_gaps(seq, frames, pose_of, params, device, dtype=torch.float64):
    """[(frame, Judged)]: each frame f's pose (scan f onto scan f - 1) from
    pose_of(f), judged by `pair_gaps` at the odometry gate."""
    got = pair_gaps(seq, [(f, f - 1, pose_of(f), params.gate) for f in frames], params, device,
                    dtype)
    return list(zip(frames, got))


def count_gap(n_sys: float, n_ref: float) -> float:
    """|n_sys - n_ref| / n_ref; inf where either is missing."""
    if not (np.isfinite(n_sys) and np.isfinite(n_ref)) or n_ref <= 0:
        return math.inf
    return abs(float(n_sys) - float(n_ref)) / float(n_ref)


def aligned(checks, limits, seq, params, device, seed, frames, pose_of, converged, n_corr_of,
            tag):
    """`unconverged_share`, `pose_gap` and `corr_gap` of one session's aligns
    (frame f: scan f onto scan f - 1; converged[f] and n_corr_of(f) as the
    system reported them). A frame whose align stopped at the
    configuration's pass limit is no fixed point, so it is counted and not
    judged; the judged frames are drawn, from the seed, among the converged
    ones."""
    conv = [f for f in range(1, frames) if converged[f]]
    checks["unconverged_share"] = {"value": 1.0 - len(conv) / (frames - 1),
                                   "limit": limits["unconverged_share"]}
    if not conv:
        for k in ("pose_gap", "corr_gap"):
            checks[k] = {"value": math.inf, "limit": limits[k]}
        return
    rng = np.random.default_rng([int(seed), 1])
    picks = sorted(rng.choice(conv, size=min(limits["frames"], len(conv)), replace=False).tolist())
    got = pose_gaps(seq, picks, pose_of, params, device)
    corr = []
    for f, j in got:
        corr.append(count_gap(n_corr_of(f), j.n_ref))
        print(f"check: frame {f} ({tag}): pose_gap {j.gap:.6e} after {j.passes} reference passes "
              f"(last step {j.step:.2e}); correspondences {n_corr_of(f):.1f} against "
              f"{j.n_ref:.1f}", file=sys.stderr)
    checks["pose_gap"] = {"value": max(j.gap for _, j in got), "limit": limits["pose_gap"]}
    checks["corr_gap"] = {"value": max(corr), "limit": limits["corr_gap"]}


def whole_sessions(sessions, frames: int, done) -> list:
    """The sessions that left every pose and every answer (done(s) true)."""
    return [s for s in sessions if len(s.poses()) == frames and done(s)]


def passed(checks: dict) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())


def printable(checks: dict) -> dict:
    """The checks with a number that is not finite (an answer that never
    came) as null, which JSON can carry."""
    return {k: {"value": v["value"] if v["value"] is not None and np.isfinite(v["value"])
                else None, "limit": v["limit"]}
            for k, v in checks.items()}
