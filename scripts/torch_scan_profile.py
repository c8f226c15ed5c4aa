#!/usr/bin/env python3
"""Count and time the device work of one steady bench scan of a semicp_torch checkout.

    python3 scripts/torch_scan_profile.py [ROOT] [--dist]

ROOT (default: the checkout that holds this script) must hold
`semicp_torch/` and a `chip_smoke.py` with `bench_pair`, so two checkouts,
such as a commit and its parent, can be compared on one card: run this
script once per checkout, in turns. The scan is `chip_smoke.py`'s phase 4
scan: preprocess the 120k-point, 20-class bench source, then align it to
the preprocessed target. Needs a CUDA device. Prints one JSON line: the
card's name and power limit; host-clock ms per scan, per preprocess and
per align (5 steady repeats each, ending in a synchronise); and, for one
more scan under torch.profiler, its device kernels (memory copies and sets
left out), the device time of all its device events against its wall
time (the busy share), and the kernels with the most device time.

With --dist (ROOT's `chip_smoke.py` must have `slam` and `SLAM_LOOP`):
`run_slam --dist` on chip_smoke's SLAM loop (an NCCL group of one), its
ATE and ms a frame; every scan-to-map pair that run aligned, aligned
again by the distributed align, by `make_align_fn` and, where ROOT's
chip_smoke has `g1d_align_fn`, by make_align_fn with G1d's M-step: how
many pairs' EM trip counts differ and how far apart the poses land. On
the last pair: host-clock ms per align and per EM pass of the
distributed align and of make_align_fn; the distributed EM pass's host
ms by part (the time spent inside each function the align calls, the
flag's MIN all-reduce, and the rest); and one distributed align under
torch.profiler, with the host ops that took the most CPU time of their
own (per EM pass) beside its device kernels.
"""

from __future__ import annotations

import collections
import json
import sys
import tempfile
import time
from pathlib import Path


def steady_ms(fn):
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / 5


def profiled(fn):
    """fn()'s result, its wall ms, and the torch.profiler run of one call."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    return res, wall_ms, prof


def device_summary(prof, wall_ms) -> dict:
    import torch

    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in dev_events if not e.name.startswith(("Memcpy", "Memset"))]
    device_ms = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name[:60]] += e.time_range.elapsed_us() / 1e3
    return {"device_kernels": len(kernels), "profiled_wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms, "top_kernels_ms": by_name.most_common(8)}


def bench_scan(root, chip_smoke, semicp_torch, dev) -> dict:
    cfg = semicp_torch.Config().override({"cloud.n_pad": chip_smoke.N_PAD,
                                          "cloud.num_classes": chip_smoke.N_CLASSES,
                                          "em.max_iters": 20})
    s_pts, s_lab, t_pts, t_lab, _ = chip_smoke.bench_pair(chip_smoke.N_POINTS, 40.0,
                                                          chip_smoke.N_CLASSES)
    raw_src = semicp_torch.make_cloud(s_pts, s_lab, n_pad=chip_smoke.N_PAD, device=dev)
    tgt = semicp_torch.preprocess_cloud(
        semicp_torch.make_cloud(t_pts, t_lab, n_pad=chip_smoke.N_PAD, device=dev), cfg)
    align_fn = semicp_torch.make_align_fn(cfg)

    def scan():
        return align_fn(semicp_torch.preprocess_cloud(raw_src, cfg), tgt)

    src = semicp_torch.preprocess_cloud(raw_src, cfg)
    ms = {"scan": steady_ms(scan), "preprocess": steady_ms(
        lambda: semicp_torch.preprocess_cloud(raw_src, cfg)), "align": steady_ms(
        lambda: align_fn(src, tgt))}
    res, wall_ms, prof = profiled(scan)
    out = {"root": str(root), "card": chip_smoke.card_line(), "ms_per": ms,
           "em_iterations": int(res.iterations)}
    summary = device_summary(prof, wall_ms)
    summary["device_kernels_per_scan"] = summary.pop("device_kernels")
    return {**out, **summary}


def trip_counts(calls, dist_align, aligns) -> dict:
    """Each recorded pair through the distributed align and through each of
    aligns (name -> align fn): the pairs whose EM trip count differs from
    the distributed align's, and the largest |T| difference over all pairs
    and over those."""
    import torch

    out = {"pairs": len(calls)}
    for name, align in aligns.items():
        differ, dT, dT_differ = 0, 0.0, 0.0
        for src, tgt, T0 in calls:
            rd, r = dist_align(src, tgt, T0), align(src, tgt, T0)
            d = float(torch.max(torch.abs(rd.T - r.T)))
            dT = max(dT, d)
            if int(rd.iterations) != int(r.iterations):
                differ += 1
                dT_differ = max(dT_differ, d)
        out[name] = {"trip_counts_differ": differ, "max_T_diff": dT,
                     "max_T_diff_where_differ": dT_differ}
    return out


def pass_split(align, iters: int) -> dict:
    """Where a distributed align's host time goes, per EM pass: the host ms
    spent inside each function the align calls (`_block_nn`, the ring
    step's K2 call, is inside `ring_sweep`; the M-step's all-reduces are
    inside `em_tail_dist`), the flag's MIN all-reduce, and the rest (the
    flag's read, which waits for the device, and the loop)."""
    import torch

    from semicp_torch.dist import align_dist, ring_corr
    from semicp_torch.dist.mesh import Mesh

    targets = [(align_dist, "prepare_ring_block"), (align_dist, "_log_sem"),
               (align_dist, "move_source"), (align_dist, "ring_sweep"), (ring_corr, "_block_nn"),
               (align_dist, "estep_reduce"), (align_dist, "em_tail_dist"),
               (Mesh, "all_reduce")]
    spent = collections.Counter()
    saved = [(owner, name, getattr(owner, name)) for owner, name in targets]

    def timed(fn, name):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                op = k.get("op", a[2] if len(a) > 2 else None)
                key = name if name != "all_reduce" else f"all_reduce {getattr(op, 'name', 'SUM')}"
                spent[key] += 1e3 * (time.perf_counter() - t0)
        return wrapped

    for owner, name, fn in saved:
        setattr(owner, name, timed(fn, name))
    try:
        align()
        torch.cuda.synchronize()
        spent.clear()
        t0 = time.perf_counter()
        align()
        torch.cuda.synchronize()
        total = 1e3 * (time.perf_counter() - t0)
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    top = ("prepare_ring_block", "_log_sem", "move_source", "ring_sweep", "estep_reduce",
           "em_tail_dist", "all_reduce MIN")
    split = {k: v / iters for k, v in spent.items()}
    split["rest (flag read, loop)"] = (total - sum(spent[k] for k in top)) / iters
    split["total"] = total / iters
    return split


def dist_pair(root, chip_smoke, semicp_torch, dev) -> dict:
    import torch.distributed as tdist

    from semicp_torch.config import parse_overrides
    from semicp_torch.dist import align_dist
    from semicp_torch.dist.mesh import make_mesh

    calls = []
    orig = align_dist.make_dist_align_fn

    def recording(mesh, cfg, engine=None):
        align = orig(mesh, cfg, engine)

        def fn(src, tgt, T0=None):
            calls.append((src, tgt, T0))
            return align(src, tgt, T0)

        return fn

    align_dist.make_dist_align_fn = recording
    try:
        with tempfile.TemporaryDirectory() as tmp:
            run, _, recs = chip_smoke.slam(Path(tmp), "dist", chip_smoke.SLAM_LOOP + ["--dist"],
                                           device=str(dev))
    finally:
        align_dist.make_dist_align_fn = orig
    cfg = semicp_torch.Config().override(parse_overrides(chip_smoke.SLAM_LOOP))
    mesh = make_mesh(dev)
    dist_align = orig(mesh, cfg)
    single = semicp_torch.make_align_fn(cfg)
    others = {"make_align_fn": single}
    if hasattr(chip_smoke, "g1d_align_fn"):
        others["make_align_fn with G1d"] = chip_smoke.g1d_align_fn(cfg, mesh)
    survey = trip_counts(calls, dist_align, others)
    src, tgt, T0 = calls[-1]
    it_d = int(dist_align(src, tgt, T0).iterations)
    it_s = int(single(src, tgt, T0).iterations)
    ms = {"dist_align": steady_ms(lambda: dist_align(src, tgt, T0)),
          "align": steady_ms(lambda: single(src, tgt, T0))}
    split = pass_split(lambda: dist_align(src, tgt, T0), it_d)
    _, wall_ms, prof = profiled(lambda: dist_align(src, tgt, T0))
    host = sorted(prof.key_averages(), key=lambda a: a.self_cpu_time_total, reverse=True)
    out = {"root": str(root), "card": chip_smoke.card_line(),
           "slam": {"ate_m": run["ate_rmse_m"], "ms_per_frame": chip_smoke.frame_ms(recs)},
           "trip_counts": survey, "ms_per": ms,
           "em_iterations": {"dist_align": it_d, "align": it_s},
           "ms_per_em_pass": {"dist_align": ms["dist_align"] / it_d, "align": ms["align"] / it_s},
           "host_ms_per_em_pass": split,
           "top_host_ops_ms_per_em_pass": [(a.key[:60], a.self_cpu_time_total / 1e3 / it_d,
                                            a.count / it_d) for a in host[:12]]}
    out.update(device_summary(prof, wall_ms))
    tdist.destroy_process_group()
    return out


def main() -> None:
    args = [a for a in sys.argv[1:] if a != "--dist"]
    root = Path(args[0] if args else Path(__file__).parent.parent).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_scan_profile: no CUDA device")
    import chip_smoke
    import semicp_torch

    dev = torch.device("cuda", 0)
    run = dist_pair if "--dist" in sys.argv[1:] else bench_scan
    print(json.dumps(run(root, chip_smoke, semicp_torch, dev)))


if __name__ == "__main__":
    main()
