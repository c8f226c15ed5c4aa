"""Structured metrics and the port's one tracer.

Port of `semicp/utils/metrics.py`: JSONL per-frame records and a
per-span wall-clock table (`PhaseTimer`). `drain` is how a phase timer
measures device work and not its enqueue: it waits for the device of
every CUDA tensor in its argument (the JAX package's `drain` waits on the
first leaf only). `card_line` names the card and its power limit beside a
measurement.

Library code reaches the session's timer through `span`, `count` and
`elapsed`; a driver installs its timer for the length of its run
(`installed`). With no timer installed they record nothing. Spans are
opened on the main thread only: a profile keeps no thread ids, and a
worker thread's span would cover the main thread's gaps.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
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

    def log(self, **record):
        record.setdefault("t_wall", time.time())
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


class _Span:
    """One span of a PhaseTimer: its host-clock time is added to the
    timer's total on exit; while a torch profiler records, it is also a
    `record_function` of its name, on the clock of the device's
    operations."""

    __slots__ = ("timer", "name", "t0", "rf")

    def __init__(self, timer: "PhaseTimer", name: str):
        self.timer, self.name = timer, name

    def __enter__(self):
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.timer.add(self.name, time.perf_counter() - self.t0)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class PhaseTimer:
    """Accumulating wall-clock timer keyed by span name.

    The host clock: a phase measures device work only where the caller
    waits for it inside the phase (`drain`, or a host read of a result).
    A dotted name is a child of the span its prefix names (`pgo.capture`
    runs inside `pgo`). A counter (`count`) is an entry of no duration.
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    def phase(self, name: str):
        """A span of `name`, as a context manager."""
        return _Span(self, name)

    def add(self, name: str, seconds: float):
        """One call of `name` that took `seconds`, timed by the caller."""
        self.totals[name] += seconds
        self.counts[name] += 1

    def count(self, name: str, n: int = 1):
        """Count `n` events of `name` (n = 0 makes the entry, so that a
        counter that never fires reads 0 and not missing)."""
        self.totals[name] += 0.0
        self.counts[name] += n

    def summary(self) -> dict[str, dict]:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k],
                "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1)}
            for k in self.totals
        }

    def table(self) -> str:
        lines = [f"{'phase':<24}{'count':>8}{'total s':>12}{'mean ms':>12}"]
        summary = self.summary()
        for k, v in sorted(summary.items()):
            # a child is indented under each of its parents that ran
            parts = k.split(".")
            depth = sum(".".join(parts[:i]) in summary for i in range(1, len(parts)))
            name = "  " * depth + k
            lines.append(f"{name:<24}{v['count']:>8}{v['total_s']:>12.3f}{v['mean_ms']:>12.2f}")
        return "\n".join(lines)


_CURRENT: PhaseTimer | None = None
_NO_SPAN = nullcontext()


@contextmanager
def installed(timer: PhaseTimer):
    """Make `timer` the one that `span`, `count` and `elapsed` reach while
    the block runs (the previous one after it)."""
    global _CURRENT
    prev, _CURRENT = _CURRENT, timer
    try:
        yield timer
    finally:
        _CURRENT = prev


def span(name: str):
    """A span of the installed timer; with none, a bare `record_function`
    while a torch profiler records, and nothing otherwise."""
    timer = _CURRENT
    if timer is not None:
        return timer.phase(name)
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def count(name: str, n: int = 1):
    """Count `n` events of `name` on the installed timer, if any."""
    if _CURRENT is not None:
        _CURRENT.count(name, n)


def elapsed(name: str, t0: float):
    """One call of `name` on the installed timer, if any, from t0 (a
    `time.perf_counter()` reading) to now: a span for code that runs too
    often for a context manager, and never a profiler span."""
    if _CURRENT is not None:
        _CURRENT.add(name, time.perf_counter() - t0)
