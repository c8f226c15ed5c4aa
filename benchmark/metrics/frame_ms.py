"""The window's wall time over the frames its sessions completed (each
session's start and flush included), host clock, ms a frame."""


def read(run):
    w = run["window"]
    return 1e3 * w["seconds"] / w["frames"] if w["frames"] else None
