"""Share of the profiled session's wall time in which no kernel, copy or
set ran on the device, %."""

from benchmark.trace import busy


def read(run):
    p = run.get("profile")
    if not p or not p["device_ops"] or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - busy(p["device_ops"]) / p["window_s"])
