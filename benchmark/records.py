"""Helpers the metric readers share, over a traced run's records.

`run` holds, for the window's sessions, each session's JSONL records (as
the driver's MetricsLogger wrote them) and its PhaseTimer summary; the
profiled session's device operations and host spans; and the counted
session's host syncs.
"""

from __future__ import annotations


def frame_records(session: dict) -> list[dict]:
    """A session's per-frame records: run_slam tags them kind "odom"
    (beside its "pgo" records); run_odometry's are all per frame."""
    return [r for r in session["records"] if r.get("kind", "odom") == "odom"]


def phase_mean_ms(run: dict, phase: str):
    """A PhaseTimer phase's mean over the window's sessions, ms a call."""
    total = sum(s["timing"].get(phase, {}).get("total_s", 0.0) for s in run["sessions"])
    count = sum(s["timing"].get(phase, {}).get("count", 0) for s in run["sessions"])
    return 1e3 * total / count if count else None
