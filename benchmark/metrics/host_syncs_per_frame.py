"""Synchronising host calls a frame, over one session under CUDA's sync
debug mode ("warn"), as chip_smoke.host_syncs counts them."""


def read(run):
    s = run.get("syncs")
    return s["count"] / s["frames"] if s and s["frames"] else None
