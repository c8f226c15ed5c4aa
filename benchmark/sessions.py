"""Sessions of the system's drivers, back to back: the benchmark's load.

A session is one call of the configuration's driver (`driver`, a module
with `main(argv)`, such as `semicp_torch.cli.run_odometry`) over the whole
sequence, into fresh output paths. It is a closed loop with one stream: a
user replaying a recorded sequence. The window runs sessions back to back
and ends at the end of the session in flight once its seconds have passed,
so it holds whole sessions only. Nothing of the harness runs per frame:
the outputs (the poses file and the JSONL records the driver writes) are
read after the window.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import sys
import time
import traceback
from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class Session:
    index: int
    dir: Path
    result: dict          # the driver's own result (its PhaseTimer summary under "timing")
    wall: float           # seconds the session took
    captured: dict | None = None   # what the recorder kept of the session's answers

    def poses(self) -> np.ndarray:
        """(F, 4, 4) float64 from the KITTI poses file the driver wrote."""
        path = self.dir / "poses.txt"
        if not path.exists():
            return np.zeros((0, 4, 4))
        flat = np.loadtxt(path, ndmin=2).reshape(-1, 3, 4)
        out = np.tile(np.eye(4), (len(flat), 1, 1))
        out[:, :3] = flat
        return out

    def records(self) -> list[dict]:
        path = self.dir / "metrics.jsonl"
        if not path.exists():
            return []
        return [json.loads(s) for s in path.read_text().splitlines() if s.strip()]


class Driver:
    """The cell's driver over the sequence in `seq_dir`, writing its sessions
    under `work`."""

    def __init__(self, config: dict, traffic: dict, seq_dir: Path, work: Path, device: str,
                 overrides: dict | None = None, recorder=None):
        self.main = importlib.import_module(config["driver"]).main
        self.recorder = recorder
        ov = dict(config.get("overrides", {}), **(overrides or {}))
        self.argv = (["--seq", str(seq_dir)] + list(config.get("driver_args", []))
                     + list(traffic.get("driver_args", [])) + ["--device", device]
                     + [f"--{k}={v}" for k, v in ov.items()])
        self.work = Path(work)
        self.count = 0
        self.frames = int(config["sequence"]["frames"])

    def session(self, tag: str = "s") -> Session:
        d = self.work / f"{tag}{self.count:05d}"
        self.count += 1
        d.mkdir(parents=True)
        argv = self.argv + ["--out", str(d / "poses.txt"), "--jsonl", str(d / "metrics.jsonl")]
        sink = io.StringIO()
        captured = self.recorder.begin() if self.recorder is not None else None
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(sink), contextlib.redirect_stderr(sink):
                result = self.main(argv)
        except Exception:
            # a session that fails owes its frames still: the checks count
            # what it did not write, and the run goes on to report them
            if tag == "warm":
                raise
            print(f"session {self.count - 1} failed:\n{traceback.format_exc()}", file=sys.stderr)
            result = {}
        return Session(index=self.count - 1, dir=d, result=result,
                       wall=time.perf_counter() - t0, captured=captured)

    def frames_of(self, s: Session) -> int:
        return int(s.result.get("frames", 0))


def window(driver: Driver, seconds: float, sync=None):
    """Sessions back to back until `seconds` have passed; returns (sessions,
    wall seconds). `sync()` is called once at the end, before the clock."""
    sessions = []
    t0 = time.perf_counter()
    while True:
        sessions.append(driver.session("w"))
        if time.perf_counter() - t0 >= seconds:
            break
    if sync is not None:
        sync()
    return sessions, time.perf_counter() - t0
