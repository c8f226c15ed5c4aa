"""The span "em.wait" (the host blocked on the device in the EM loop: each
pass's convergence flag and each result's copy) over the window's frames,
host clock, ms a frame."""


def read(run):
    s = [x for x in run["sessions"] if "em.wait" in x["timing"]]
    frames = sum(x["frames"] for x in s)
    return 1e3 * sum(x["timing"]["em.wait"]["total_s"] for x in s) / frames if frames else None
