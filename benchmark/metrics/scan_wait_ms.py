"""The driver's span "scan_wait" (the main thread's wait for the next scan:
the prefetch queue in run_odometry, the load itself in run_slam) over the
window's frames, host clock, ms a frame."""


def read(run):
    s = [x for x in run["sessions"] if "scan_wait" in x["timing"]]
    frames = sum(x["frames"] for x in s)
    return 1e3 * sum(x["timing"]["scan_wait"]["total_s"] for x in s) / frames if frames else None
