"""Peaks of the card and the bound of a kernel stage.

A stage (stages/<stage>/*.json) is a set of kernel-name patterns and the
contract of one call: the bytes its inputs and outputs take once, per point
of the cloud (n_pad points), and the flops its inputs need. Its bound is the
larger of flops / peak and bytes / bandwidth, summed over the calls the
trace shows; its share is bound / the device time of its kernels. The
arithmetic is `chip_smoke.kernel_entry`'s, restated per stage.

Published H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W): 67 TFLOP/s
in float32 outside the tensor cores, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def matches(name: str, entry: dict) -> bool:
    return any(k in name for k in entry["kernels"])


def stage_of(name: str, stages: dict) -> str:
    """The stage whose patterns match a kernel name, or "other"."""
    for st, entries in stages.items():
        if any(matches(name, e) for e in entries):
            return st
    return "other"


def stage_bound_s(entries: list, counts: dict, n_points: int) -> float:
    """Seconds the stage's calls take at the card's peaks. counts: device
    launches by kernel name (as the trace names them)."""
    total = 0.0
    for e in entries:
        for term in e["terms"]:
            calls = sum(n for name, n in counts.items() if term["per"] in name)
            flops = calls * n_points * term["flops_per_point"]
            nbytes = calls * n_points * term["bytes_per_point"]
            total += max(flops / PEAK_F32, nbytes / PEAK_BYTES)
    return total


def stage_share(run: dict, stage: str):
    """100 x bound / device time of the stage's kernels over the traced
    slice, or None where the slice ran none of them."""
    prof = run.get("profile")
    entries = run["stages"].get(stage)
    if not prof or not entries:
        return None
    busy = sum(d for name, _, d in prof["device_ops"] if any(matches(name, e) for e in entries))
    if busy <= 0.0:
        return None
    counts: dict = {}
    for name, _, _ in prof["device_ops"]:
        counts[name] = counts.get(name, 0) + 1
    return 100.0 * stage_bound_s(entries, counts, run["n_points"]) / busy
