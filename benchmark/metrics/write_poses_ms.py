"""The driver's span "write_poses" (run_odometry rewrites poses.txt after
every frame, run_slam writes it once) over the window's frames, host
clock, ms a frame."""


def read(run):
    s = [x for x in run["sessions"] if "write_poses" in x["timing"]]
    frames = sum(x["frames"] for x in s)
    return 1e3 * sum(x["timing"]["write_poses"]["total_s"] for x in s) / frames if frames else None
