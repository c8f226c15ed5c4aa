"""EM passes a frame, as the driver logs them (run_odometry's "iterations",
run_slam's "iters"), over the window's frames."""

from benchmark.records import frame_records


def read(run):
    n = [r.get("iterations", r.get("iters")) for s in run["sessions"] for r in frame_records(s)]
    n = [v for v in n if v is not None]
    return sum(n) / len(n) if n else None
