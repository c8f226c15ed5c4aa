"""The dense-LiDAR cell (odom.dense): its E-step counters' reader, K6's
kernels in the E-step stage, a whole run of the cell cut to a CPU size on
the E-step the cell's own size takes (K6's plain path), sound and with two
faults of the timed path (test_bench_faults.py's `state_unchanged` and
`answer_altered`, restated here), and the control at that size."""

from __future__ import annotations

import dataclasses

import pytest

from benchmark import roofline, spec

CELL = "odom.dense"
K2 = "(anonymous namespace)::nn_walk_kernel(float4 const*, int const*)"
K6 = "(anonymous namespace)::estep_keys_kernel(unsigned long long const*, float const*)"
N = 524288


def sessions():
    return [
        {"records": [{"frame": 1, "iterations": 3}, {"frame": 2, "iterations": 5}],
         "timing": {"estep": {"total_s": 0.0, "count": 9},
                    "estep.fused": {"total_s": 0.0, "count": 9}}, "frames": 3},
        {"records": [{"frame": 1, "iterations": 4}],
         "timing": {"estep": {"total_s": 0.0, "count": 4},
                    "estep.fused": {"total_s": 0.0, "count": 1}}, "frames": 2},
    ]


def test_estep_fused_share_reads_the_counters():
    # 10 of 13 E-steps fused (the first session's aligns one retried: 9 of 8)
    run = {"sessions": sessions()}
    assert spec.metric_reader("estep_fused_share")(run) == pytest.approx(1000 / 13, rel=1e-12)
    run["sessions"][1]["timing"]["estep.fused"]["count"] = 4
    assert spec.metric_reader("estep_fused_share")(run) == 100.0


@pytest.mark.parametrize("timing", [{}, {"estep": {"total_s": 0.0, "count": 0},
                                         "estep.fused": {"total_s": 0.0, "count": 0}}])
def test_estep_fused_share_finds_nothing(timing):
    # a program without the counters (the parent of the counters), or no E-step
    empty = {"sessions": [{"records": [], "timing": timing, "frames": 0}]}
    assert spec.metric_reader("estep_fused_share")(empty) is None


def test_k6_kernels_are_the_estep_stage():
    stages = spec.stages()
    assert roofline.stage_of("(anonymous namespace)::estep_keys_kernel(...)", stages) == "estep"
    assert roofline.stage_of(K6, stages) == "estep"
    # K6's walk and its keys kernel, 1 ms each: the stage's 125 B a point,
    # counted per walk, over both
    run = {"stages": stages, "n_points": N,
           "profile": {"device_ops": [(K2, 0.0, 0.001), (K6, 0.001, 0.001)], "frames": 1}}
    want = 100.0 * (N * 125 / roofline.PEAK_BYTES) / 0.002
    assert spec.metric_reader("roofline.estep")(run) == pytest.approx(want, rel=1e-12)


def test_cell_is_declared():
    cell = spec.load_cell(CELL)
    assert cell.chips == 1 and cell.config["overrides"]["cloud.n_pad"] == 128 * 2048 * 2
    assert cell.config["reduced"] == ["frames"] and cell.config["precision"] == "float32"
    names = {m["name"] for m in cell.per_layer}
    assert {"estep_fused_share", "write_poses_ms", "align_retries_per_frame", "upload_host_ms",
            "scan_wait_ms", "em_wait_ms", "idle_unattributed"} <= names


def state_unchanged(monkeypatch):
    import torch
    from semicp_torch.register import em_icp

    orig = em_icp.em_tail

    def em_tail(T_in, *a, **kw):
        out = orig(T_in, *a, **kw)
        return out._replace(T=T_in, em_step=torch.zeros_like(out.em_step))
    monkeypatch.setattr(em_icp, "em_tail", em_tail)


def answer_altered(monkeypatch):
    from semicp_torch.register import em_icp

    orig = em_icp._align

    def _align(*a, **kw):
        res = orig(*a, **kw)
        T = res.T.clone()
        T[0, 3] += 0.005
        return dataclasses.replace(res, T=T)
    monkeypatch.setattr(em_icp, "_align", _align)


FAULTS = {"state_unchanged": state_unchanged, "answer_altered": answer_altered}


def fused(cell):
    """The tiny cell on the E-step the cell's own size takes: the sparse
    engine's fused branch (its plain path on the CPU)."""
    cell.config["overrides"].update({"corr.engine": "sparse", "em.fused_estep": "true"})
    return cell


def failed(res):
    return [k for k, c in res["checks"].items() if c["value"] is None or c["value"] > c["limit"]]


def test_tiny_dense_cell_is_correct(tiny_cell, bench_run):
    import torch

    torch.set_num_threads(2)
    res = bench_run.run(fused(tiny_cell(CELL)), 2**31 + 41, 0.1, True, "cpu")
    assert res["correct"] and not failed(res), res["checks"]
    assert res["metrics"]["estep_fused_share"]["value"] == 100.0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_makes_the_dense_run_incorrect(fault, monkeypatch, tiny_cell, bench_run):
    import torch

    torch.set_num_threads(2)
    FAULTS[fault](monkeypatch)
    res = bench_run.run(fused(tiny_cell(CELL)), 2**31 + 41, 0.1, False, "cpu")
    assert not res["correct"] and failed(res), res["checks"]


def test_control_fails_at_a_tiny_size(tiny_cell):
    """The bfloat16 control in the system's place reads `correct: false`
    against the cell's limits (test_bench_control.py's test, for this cell)."""
    import torch

    from benchmark import control, judge, scenes

    torch.set_num_threads(2)
    c = tiny_cell(CELL)
    seq = scenes.make_sequence(c.config["sequence"], 1, "cpu")
    out = control.aligns(c.config, seq, 1, 3, "cpu", torch.bfloat16)
    assert not judge.passed(control.judged(out, c.config["correct"])), out
