"""The counter "align.retry" (a health check's re-solve from identity) over
the window's frames."""


def read(run):
    s = [x for x in run["sessions"] if "align.retry" in x["timing"]]
    frames = sum(x["frames"] for x in s)
    return sum(x["timing"]["align.retry"]["count"] for x in s) / frames if frames else None
