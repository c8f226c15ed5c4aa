"""Structured metrics and phase timing.

Port of `semicp/utils/metrics.py`: JSONL per-frame records and a
per-phase wall-clock table. `drain` is how a phase timer measures device
work and not its enqueue: it waits for the device of every CUDA tensor
in its argument (the JAX package's `drain` waits on the first leaf only).
`card_line` names the card and its power limit beside a measurement.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

import torch


def card_line() -> str:
    """The first card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _cuda_devices(out, found: set) -> None:
    if torch.is_tensor(out):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _cuda_devices(v, found)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            _cuda_devices(getattr(out, f.name), found)


def drain(out):
    """Wait until the work queued on every device that holds a CUDA tensor
    of `out` (a tensor, or tensors nested in tuples, lists, dicts and
    dataclasses such as Cloud and AlignResult) is done; returns `out`.
    Does nothing for CPU tensors. Phase timers call it inside the phase."""
    found: set = set()
    _cuda_devices(out, found)
    for dev in found:
        torch.cuda.synchronize(dev)
    return out


class MetricsLogger:
    """Append-only JSONL writer for per-frame records."""

    def __init__(self, path: str | Path | None):
        self.path = Path(path) if path else None
        self._fh = open(self.path, "a") if self.path else None
        self.records: list[dict] = []

    def log(self, **record):
        record.setdefault("t_wall", time.time())
        self.records.append(record)
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PhaseTimer:
    """Accumulating wall-clock timer keyed by phase name.

    The host clock: a phase measures device work only where the caller
    waits for it inside the phase (`drain`, or a host read of a result).
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict[str, dict]:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k],
                "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1)}
            for k in self.totals
        }

    def table(self) -> str:
        lines = [f"{'phase':<24}{'count':>8}{'total s':>12}{'mean ms':>12}"]
        for k, v in sorted(self.summary().items()):
            lines.append(f"{k:<24}{v['count']:>8}{v['total_s']:>12.3f}{v['mean_ms']:>12.2f}")
        return "\n".join(lines)
