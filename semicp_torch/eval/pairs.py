"""Judging pairwise aligns: the error against a ground truth, and the
agreement of two aligns whose EM trip counts may differ by a pass.

Two arithmetics of one EM align (the dist align's float64 moment M-step
and the single device's f32 one; or the JAX package's per-pass
all-reduced sums and its single-device sums) follow one EM trajectory to
rounding. Where an em_step lies within rounding of em.trans_eps, one of
them stops a pass earlier. `trip_parity` holds two such aligns to the
same trajectory: with equal trip counts their T agree within `tol`;
with counts apart, their T at the smaller count agree within `tol`, and
the final T's differ by at most `tol` plus the extra passes' own motion.
Counts one apart need no more. Counts further apart need every pass the
longer path went on from beyond the smaller count to be a tail step of a
converging EM, its em_step at most `TAIL_STEP` times em.trans_eps: the
paths part by about an EM tail step (T up to 8.6e-5 apart at the common
pass over the 47 pairs of a dist SLAM run on the H100), so their
em_steps near the end differ by tens of percent, and the one-apart pairs
went on at up to 1.46 trans_eps; one pair went on at 1.0005 and 1.08 and
stopped at 0.81, 11 passes against 9. Poses are numpy arrays, judged in
float64; tests and chip_smoke.py share these.
"""

from __future__ import annotations

import numpy as np
import torch

from semicp_torch.geom.se3 import se3_log

# the largest em_step, in em.trans_eps, of an extra pass that counts as
# a tail step where trip counts lie more than one apart
TAIL_STEP = 2.0


def pose_errors(T, T_ref) -> tuple[float, float]:
    """(translation error m, rotation error rad) of T against T_ref."""
    err = np.asarray(T, np.float64) @ np.linalg.inv(np.asarray(T_ref, np.float64))
    terr = float(np.linalg.norm(err[:3, 3]))
    rerr = float(np.arccos(np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)))
    return terr, rerr


def em_step(T, T_prev) -> float:
    """An EM pass's step, ||se3_log(T T_prev^-1)|| (the align's convergence
    measure), in float64."""
    D = np.asarray(T, np.float64) @ np.linalg.inv(np.asarray(T_prev, np.float64))
    return float(torch.linalg.vector_norm(se3_log(torch.from_numpy(D))))


def trip_parity(run_a, run_b, trans_eps: float, tol: float = 1e-4) -> dict:
    """Hold two aligns of one pair to one EM trajectory.

    run_x(max_iters) -> (T (4,4), EM iterations) runs align x from the
    pair's initial pose with em.max_iters set to max_iters (None: the
    config's own), so run_x(k) is x's pose after pass k where x runs k
    passes or more, and run_x(0) the initial pose. Returns a dict: the trip
    counts, max |T_a - T_b|, whether the rule holds (`ok`), and where the
    counts differ the T's at the smaller count, the extra passes' motion,
    each path's stopping margin |em_step / trans_eps - 1| at that pass,
    and the longer path's margins at that pass and each after it
    (`go_on_margins`; it went on after each but the last)."""
    Ta, na = run_a(None)
    Tb, nb = run_b(None)
    Ta, Tb = np.asarray(Ta, np.float64), np.asarray(Tb, np.float64)
    out = {"iterations": (int(na), int(nb)), "max_T_diff": float(np.max(np.abs(Ta - Tb)))}
    if na == nb:
        out["ok"] = out["max_T_diff"] <= tol
        return out
    lo, hi = int(min(na, nb)), int(max(na, nb))
    at = {x: [np.asarray(run(k)[0], np.float64) for k in (lo - 1, lo)]
          for x, run in (("a", run_a), ("b", run_b))}
    longer, T_long = ("a", Ta) if na > nb else ("b", Tb)
    # the longer path's poses after passes lo - 1 .. hi
    path = at[longer] + [np.asarray((run_a if longer == "a" else run_b)(k)[0], np.float64)
                         for k in range(lo + 1, hi)] + [T_long]
    # its margin at passes lo .. hi: it went on after each but the last
    go_on = [abs(em_step(path[i + 1], path[i]) / trans_eps - 1) for i in range(hi - lo + 1)]
    extra = float(np.max(np.abs(T_long - at[longer][1])))
    common = float(np.max(np.abs(at["a"][1] - at["b"][1])))
    out.update({"common_pass": lo, "max_T_diff_at_common_pass": common,
                "extra_pass_step": extra,
                "stop_margins": tuple(abs(em_step(at[x][1], at[x][0]) / trans_eps - 1)
                                      for x in ("a", "b")),
                "go_on_margins": go_on})
    # where it went on, em_step > trans_eps: its margin is em_step / trans_eps - 1
    tail = hi - lo == 1 or all(1.0 + m <= TAIL_STEP for m in go_on[:-1])
    out["ok"] = tail and common <= tol and out["max_T_diff"] <= tol + extra
    return out
