"""A whole run of each cell, cut to a CPU size, with the timed path broken
underneath: `correct` has to come out false for each fault the cell can
have, and true for the sound program. The same faults at the cell's own
size on a card (marked `card`).

* state unchanged: the M-step returns the pose it was given (and reports
  a zero step, so that the align claims convergence);
* answer altered: every align's pose moved by 5 mm where it is produced;
* half left out: the driver writes the poses of half of a session's frames;
* half of the points left out: every E-step's planes of every other
  source point are zeroed, so that the M-step sums over the rest;
* session fails: every session of the window raises (its answers never
  come), and the run still reports.
One chip exchanges nothing, so the fault of a dropped exchange does not
apply.
"""

from __future__ import annotations

import dataclasses

import pytest

CELLS = ["odom.seq-replay", "slam.loop-f2f"]
DRIVERS = {"odom.seq-replay": "semicp_torch.cli.run_odometry",
           "slam.loop-f2f": "semicp_torch.cli.run_slam"}


def state_unchanged(monkeypatch, cell):
    import torch
    from semicp_torch.register import em_icp

    orig = em_icp.em_tail

    def em_tail(T_in, *a, **kw):
        out = orig(T_in, *a, **kw)
        return out._replace(T=T_in, em_step=torch.zeros_like(out.em_step))
    monkeypatch.setattr(em_icp, "em_tail", em_tail)


def answer_altered(monkeypatch, cell):
    from semicp_torch.register import em_icp

    orig = em_icp._align

    def _align(*a, **kw):
        res = orig(*a, **kw)
        T = res.T.clone()
        T[0, 3] += 0.005
        return dataclasses.replace(res, T=T)
    monkeypatch.setattr(em_icp, "_align", _align)


def half_left_out(monkeypatch, cell):
    import importlib

    mod = importlib.import_module(DRIVERS[cell])
    orig = mod.save_kitti_poses
    monkeypatch.setattr(mod, "save_kitti_poses",
                        lambda path, poses: orig(path, poses[: (len(poses) + 1) // 2]))


def half_points_left_out(monkeypatch, cell):
    from semicp_torch.register import em_icp

    orig = em_icp._estep

    def _estep(*a, **kw):
        planes = [x.clone() for x in orig(*a, **kw)]
        for x in planes:
            x[..., 1::2] = 0.0
        return tuple(planes)
    monkeypatch.setattr(em_icp, "_estep", _estep)


def session_fails(monkeypatch, cell):
    import importlib

    mod = importlib.import_module(DRIVERS[cell])
    orig = mod.main

    def main(argv):
        if any("/w0" in a for a in argv):
            raise RuntimeError("planted failure")
        return orig(argv)
    monkeypatch.setattr(mod, "main", main)


FAULTS = {"sound": None, "session_fails": session_fails, "state_unchanged": state_unchanged,
          "answer_altered": answer_altered, "half_left_out": half_left_out,
          "half_points_left_out": half_points_left_out}
# the faults of the timed path itself, read once more at the cell's size
CARD_FAULTS = ["state_unchanged", "answer_altered", "half_points_left_out"]


def failed(res):
    return [k for k, c in res["checks"].items() if c["value"] is None or c["value"] > c["limit"]]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_makes_the_run_incorrect(cell, fault, monkeypatch, tiny_cell, bench_run):
    import torch

    torch.set_num_threads(2)
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch, cell)
    res = bench_run.run(tiny_cell(cell), 11, 0.1, False, "cpu")
    if fault == "sound":
        assert res["correct"] and not failed(res), res["checks"]
    else:
        assert not res["correct"] and failed(res), res["checks"]


@pytest.mark.card
@pytest.mark.parametrize("fault", CARD_FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_makes_the_run_incorrect_at_the_cell_size(cell, fault, monkeypatch, card,
                                                        bench_run):
    """One window of one session (0.1 s) at the cell's own size on the card."""
    from benchmark import spec

    FAULTS[fault](monkeypatch, cell)
    res = bench_run.run(spec.load_cell(cell), 20240612, 0.1, False, "cuda")
    print(cell, fault, {k: c["value"] for k, c in res["checks"].items()})
    assert not res["correct"] and failed(res), res["checks"]
