"""95th percentile (linear) of the gaps between consecutive per-frame
records of a session (MetricsLogger's t_wall), over the window's sessions:
the tail of a frame's time as the driver logs it, ms."""

import numpy as np

from benchmark.records import frame_records


def read(run):
    gaps = []
    for s in run["sessions"]:
        t = [r["t_wall"] for r in frame_records(s)]
        gaps.extend(np.diff(t).tolist())
    return 1e3 * float(np.percentile(gaps, 95)) if gaps else None
