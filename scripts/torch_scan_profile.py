#!/usr/bin/env python3
"""Count and time the device work of one steady bench scan of a semicp_torch checkout.

    python3 scripts/torch_scan_profile.py [ROOT]

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
"""

from __future__ import annotations

import collections
import json
import sys
import time
from pathlib import Path


def main() -> None:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).parent.parent).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_scan_profile: no CUDA device")
    import chip_smoke
    import semicp_torch

    dev = torch.device("cuda", 0)
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

    def steady_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / 5

    src = semicp_torch.preprocess_cloud(raw_src, cfg)
    ms = {"scan": steady_ms(scan), "preprocess": steady_ms(
        lambda: semicp_torch.preprocess_cloud(raw_src, cfg)), "align": steady_ms(
        lambda: align_fn(src, tgt))}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = scan()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in dev_events if not e.name.startswith(("Memcpy", "Memset"))]
    device_ms = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name[:60]] += e.time_range.elapsed_us() / 1e3
    print(json.dumps({"root": str(root), "card": chip_smoke.card_line(), "ms_per": ms,
                      "em_iterations": int(res.iterations), "device_kernels_per_scan": len(kernels),
                      "profiled_wall_ms": wall_ms, "device_ms": device_ms,
                      "busy_share": device_ms / wall_ms, "top_kernels_ms": by_name.most_common(8)}))


if __name__ == "__main__":
    main()
