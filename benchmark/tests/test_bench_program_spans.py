"""The readers of the program's own spans and counters, and of the idle time
no span names, give known values on a hand-made record, and nothing where
the program has no such span (a checkout that predates them)."""

from __future__ import annotations

import pytest

from benchmark import spec


def run_record():
    sessions = [
        {"records": [], "frames": 4,
         "timing": {"scan_wait": {"total_s": 0.008, "count": 5},
                    "preprocess.upload": {"total_s": 0.012, "count": 4},
                    "em.wait": {"total_s": 0.02, "count": 30},
                    "align.retry": {"total_s": 0.0, "count": 1},
                    "write_poses": {"total_s": 0.004, "count": 3},
                    "pgo.capture": {"total_s": 0.06, "count": 2}}},
        {"records": [], "frames": 6,
         "timing": {"scan_wait": {"total_s": 0.002, "count": 7},
                    "preprocess.upload": {"total_s": 0.018, "count": 6},
                    "em.wait": {"total_s": 0.03, "count": 40},
                    "align.retry": {"total_s": 0.0, "count": 0},
                    "write_poses": {"total_s": 0.006, "count": 5}}},
    ]
    # device busy [0, 1.5], [2, 4], [5, 6] ms: gaps [1.5, 2] and [4, 5];
    # user spans cover [1.5, 1.8] of the first and [4.2, 4.8] of the
    # second (two spans that overlap); an op outside any span is no span
    ops = [("k1", 0.0, 0.001), ("Memcpy HtoD (Pageable -> Device)", 0.0005, 0.001),
           ("k2", 0.002, 0.001), ("k3", 0.003, 0.001), ("g1", 0.005, 0.001)]
    host = [("preprocess", 0.0, 0.0018, True), ("aten::empty", 0.0015, 0.0035, False),
            ("em.wait", 0.0042, 0.0005, True), ("align", 0.0044, 0.0004, True)]
    return {"sessions": sessions,
            "profile": {"device_ops": ops, "host": host, "window_s": 0.010, "frames": 2}}


EXPECTED = {
    # 10 ms over 10 frames
    "scan_wait_ms": 1.0,
    # 30 ms over 10 uploads
    "upload_host_ms": 3.0,
    "em_wait_ms": 5.0,
    "align_retries_per_frame": 0.1,
    "write_poses_ms": 1.0,
    "pgo_capture_ms": 30.0,
    # 1.5 ms idle, 0.9 ms of it in a span
    "idle_unattributed": 100.0 * 0.6 / 1.5,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_values(name):
    assert spec.metric_reader(name)(run_record()) == pytest.approx(EXPECTED[name], rel=1e-9)


def test_every_new_metric_is_declared():
    bench = {m["name"]: m for m in spec.load_benchmark()["per_layer"]}
    assert set(EXPECTED) <= set(bench)
    assert bench["pgo_capture_ms"]["workloads"] == ["slam.loop-f2f"]


@pytest.mark.parametrize("name", sorted(set(EXPECTED) - {"idle_unattributed"}))
def test_no_span_in_the_program_reads_nothing(name):
    rec = run_record()
    for s in rec["sessions"]:
        s["timing"] = {"preprocess": {"total_s": 0.01, "count": 1}}
    assert spec.metric_reader(name)(rec) is None


def test_idle_in_no_span_is_all_unattributed():
    rec = run_record()
    rec["profile"]["host"] = [h for h in rec["profile"]["host"] if not h[3]]
    assert spec.metric_reader("idle_unattributed")(rec) == pytest.approx(100.0)


def test_a_span_over_several_gaps_covers_each():
    rec = run_record()
    rec["profile"]["host"] = [("session", -1.0, 2.0, True)]
    assert spec.metric_reader("idle_unattributed")(rec) == 0.0


def test_no_device_ops_no_idle_share():
    rec = run_record()
    rec["profile"]["device_ops"] = []
    assert spec.metric_reader("idle_unattributed")(rec) is None
    del rec["profile"]
    assert spec.metric_reader("idle_unattributed")(rec) is None
