"""The port's tracer (semicp_torch/utils/metrics.py) on the CPU: spans and
counters of a PhaseTimer, its profiler spans, and what the drivers'
sessions record with it."""

import pytest
import torch

from semicp_torch.cli.run_odometry import main as odometry_main
from semicp_torch.cli.run_slam import main as slam_main
from semicp_torch.utils import PhaseTimer, count, elapsed, installed, metrics, span

CPU_ACT = [torch.profiler.ProfilerActivity.CPU]


def user_spans(prof):
    """(name, start ns, end ns) of the profile's user annotations, read from
    the raw results: `prof.events()` builds an event tree, minutes for a
    SLAM session's millions of operations on the CPU."""
    return [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()]


def union_us(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def test_spans_nest_and_accumulate_and_counters_count():
    timer = PhaseTimer()
    with installed(timer):
        for _ in range(3):
            with span("outer"):
                with span("outer.inner"):
                    sum(range(1000))
                count("hits")
        count("hits", 4)
        count("never", 0)
        elapsed("waits", 0.0)
    s = timer.summary()
    assert s["outer"]["count"] == s["outer.inner"]["count"] == 3
    assert s["outer"]["total_s"] >= s["outer.inner"]["total_s"] > 0.0
    assert s["hits"] == {"total_s": 0.0, "count": 7, "mean_ms": 0.0}
    assert s["never"] == {"total_s": 0.0, "count": 0, "mean_ms": 0.0}
    assert s["waits"]["count"] == 1 and s["waits"]["total_s"] > 0.0
    table = timer.table().splitlines()
    assert any(line.startswith("  outer.inner") for line in table)
    # installed for the block only: outside it nothing is recorded
    assert metrics._CURRENT is None
    with span("outer"):
        count("hits")
    assert timer.summary()["outer"]["count"] == 3 and timer.summary()["hits"]["count"] == 7


def test_installed_restores_the_previous_timer():
    a, b = PhaseTimer(), PhaseTimer()
    with installed(a):
        with installed(b):
            count("x")
        count("y")
    assert set(a.summary()) == {"y"} and set(b.summary()) == {"x"}


def test_phase_is_a_profiler_span_only_under_a_profiler(monkeypatch):
    timer = PhaseTimer()
    with torch.profiler.profile(activities=CPU_ACT) as prof:
        with timer.phase("traced_phase"):
            torch.ones(3).add_(1)
        with installed(timer), span("traced_span"):
            torch.ones(3).add_(1)
        with span("bare_span"):       # no timer installed: the profiler's span alone
            torch.ones(3).add_(1)
    names = [n for n, _, _ in user_spans(prof)]
    assert names.count("traced_phase") == names.count("traced_span") == 1
    assert names.count("bare_span") == 1

    def refuse(*a, **kw):
        raise AssertionError("record_function opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with timer.phase("untraced"):
        pass
    with installed(timer), span("untraced"):
        pass
    with span("untraced"):
        pass
    assert timer.summary()["untraced"]["count"] == 2


def test_every_warm_started_frame_counts_a_retry(tmp_path):
    """At em.retry_overlap_frac 1.0 no align is healthy (n_corr never
    reaches every point): each warm-started frame re-solves once. The
    first align has no warm start."""
    out = odometry_main(["--synthetic", "5", "--n-points", "800", "--cloud.n_pad=1024",
                         "--cloud.num_classes=8", "--em.max_iters=10",
                         "--em.retry_overlap_frac=1.0", "--device", "cpu",
                         "--out", str(tmp_path / "p.txt")])
    assert out["frames"] == 5
    assert out["timing"]["align.retry"]["count"] == 3
    assert out["timing"]["em.wait"]["count"] > 4 + 3


def test_slam_spans_cover_the_session(tmp_path):
    """Under the CPU profiler, the union of run_slam's spans covers at
    least 95% of the session's host wall time, final PGO included."""
    argv = ["--synthetic", "48", "--loop", "--n-points", "1000", "--drift", "0.01",
            "--cloud.n_pad=1024", "--cloud.num_classes=8", "--em.max_iters=12",
            "--slam.keyframe_trans=1.5", "--slam.lc_min_gap=14", "--slam.lc_max_dist=5.0",
            "--device", "cpu", "--out", str(tmp_path / "p.txt")]
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with torch.profiler.profile(activities=CPU_ACT) as prof:
            with torch.profiler.record_function("test_session"):
                out = slam_main(argv)
    finally:
        torch.set_num_threads(n)
    assert out["loop_edges"] >= 1
    timing = out["timing"]
    assert {"session_setup", "scan_wait", "keyframe", "loop_verify", "pgo", "pgo_final",
            "pgo.upload", "pgo.readback", "write_poses", "session_finish"} <= set(timing)
    spans = user_spans(prof)
    (_, t0, t1), = [s for s in spans if s[0] == "test_session"]
    covered = union_us([(max(s, t0), min(e, t1)) for name, s, e in spans
                        if name in timing and e > t0 and s < t1])
    assert covered >= 0.95 * (t1 - t0), covered / (t1 - t0)


def test_upload_span_holds_no_unsorted_cloud(monkeypatch):
    """The span around the upload keeps no reference to the unsorted cloud:
    preprocess_cloud frees it once sorted, before the covariances' working
    memory is taken (the card's peak memory depends on it)."""
    import weakref

    import semicp_torch
    from semicp_torch.cli.common import to_device_cloud
    from semicp_torch.cli.run_odometry import synthetic_frames
    from semicp_torch.cloud import covariance

    cfg = semicp_torch.Config().override({"cloud.n_pad": 1024, "cloud.num_classes": 8})
    (pts, lab), _ = next(synthetic_frames(1, 800))
    seen = {}
    sort, estimate = covariance.sort_cloud_cm, covariance.estimate_covariances

    def sort_seen(cloud, *a):
        seen["raw"] = weakref.ref(cloud.xyz)
        return sort(cloud, *a)

    def estimate_seen(*a, **kw):
        seen["alive"] = seen["raw"]() is not None
        return estimate(*a, **kw)

    monkeypatch.setattr(covariance, "sort_cloud_cm", sort_seen)
    monkeypatch.setattr(covariance, "estimate_covariances", estimate_seen)
    with installed(PhaseTimer()):
        to_device_cloud(pts, lab, cfg, "cpu")
    assert seen == {"raw": seen["raw"], "alive": False}
