"""Each metric's reader gives known values on a hand-made record, and a
per-layer reader nothing where there is nothing to read."""

from __future__ import annotations

import pytest

from benchmark import roofline, spec

K1 = "(anonymous namespace)::moments_walk_kernel(float4 const*)"
K2 = "(anonymous namespace)::nn_walk_kernel(float4 const*, int const*)"
K3 = "(anonymous namespace)::estep_reduce_kernel(float const*)"
G1 = "void (anonymous namespace)::gn_em_kernel<true>(GNArgs)"
N = 131072


def run_record():
    sessions = [
        {"records": [{"frame": 1, "t_wall": 10.0, "iterations": 3},
                     {"frame": 2, "t_wall": 10.02, "iterations": 5},
                     {"frame": 3, "t_wall": 10.05, "iterations": 4}],
         "timing": {"preprocess": {"total_s": 0.03, "count": 3},
                    "pgo": {"total_s": 0.1, "count": 2}}, "frames": 4},
        {"records": [{"frame": 1, "kind": "odom", "t_wall": 20.0, "iters": 6},
                     {"frame": 1, "kind": "pgo", "t_wall": 20.001, "edges": 3},
                     {"frame": 2, "kind": "odom", "t_wall": 20.01, "iters": 2}],
         "timing": {"preprocess": {"total_s": 0.01, "count": 1},
                    "pgo": {"total_s": 0.0, "count": 0}}, "frames": 3},
    ]
    # device ops (name, start s, seconds): 1 ms each of K1, K2, K3, G1, a
    # copy overlapping the K1 launch, over a 10 ms slice of 2 frames
    ops = [(K1, 0.000, 0.001), ("Memcpy HtoD (Pageable -> Device)", 0.0005, 0.001),
           (K2, 0.002, 0.001), (K3, 0.003, 0.001), (G1, 0.005, 0.001)]
    return {"window": {"setup_s": 12.5, "seconds": 2.0, "frames": 100, "peak_bytes": 3 * 2 ** 29},
            "sessions": sessions, "stages": spec.stages(), "n_points": N,
            "profile": {"device_ops": ops, "host": [], "window_s": 0.010, "frames": 2},
            "syncs": {"frames": 4, "count": 10}}


E2E = {
    "setup_s": 12.5,
    # 2 s over 100 frames
    "frame_ms": 20.0,
    "peak_mem_gib": 1.5,
}
EXPECTED = {
    # gaps 20, 30 and 10 ms: the linear 95th percentile is 29 ms
    "frame_ms_p95": 29.0,
    "preprocess_host_ms": 10.0,
    "pgo_ms": 50.0,
    "em_passes_per_frame": 4.0,
    "host_syncs_per_frame": 2.5,
    # busy: [0, 1.5 ms] + [2, 4 ms] + [5, 6 ms] = 4.5 of 10 ms
    "device_idle": 55.0,
    "kernels_per_frame": 2.0,
    # one call each; bound / stage time (ms), x 100
    "roofline.moments": 100.0 * (N * 57 / roofline.PEAK_BYTES) / 0.001,
    "roofline.estep": 100.0 * (N * 125 / roofline.PEAK_BYTES) / 0.002,
    "roofline.mstep": 100.0 * (N * (72 + 44) / roofline.PEAK_BYTES) / 0.001,
}


@pytest.mark.parametrize("name", sorted(EXPECTED) + sorted(E2E))
def test_reader_values(name):
    want = {**EXPECTED, **E2E}[name]
    assert spec.metric_reader(name)(run_record()) == pytest.approx(want, rel=1e-9)


def test_every_per_layer_metric_has_a_known_value():
    bench = spec.load_benchmark()
    assert {m["name"] for m in bench["per_layer"]} <= set(EXPECTED)
    assert {m["name"] for m in bench["end_to_end"]} <= set(E2E)


def test_no_frames_no_frame_time():
    rec = {"window": {"setup_s": 1.0, "seconds": 2.0, "frames": 0, "peak_bytes": 0}}
    assert spec.metric_reader("frame_ms")(rec) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_finds_nothing(name):
    empty = {"sessions": [{"records": [], "timing": {}, "frames": 0}], "stages": spec.stages(),
             "n_points": N}
    assert spec.metric_reader(name)(empty) is None


def test_unclaimed_kernels_are_other():
    assert roofline.stage_of("void at::native::vectorized_elementwise_kernel", spec.stages()) \
        == "other"
    assert roofline.stage_of(K2, spec.stages()) == "estep"
