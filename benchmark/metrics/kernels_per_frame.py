"""Device kernels (copies and sets apart) a frame in the profiled session."""

from benchmark.trace import is_kernel


def read(run):
    p = run.get("profile")
    if not p or not p["frames"]:
        return None
    n = sum(1 for name, _, _ in p["device_ops"] if is_kernel(name))
    return n / p["frames"] if n else None
