"""The traced run's readings: a profiled session and a counted one.

* `profiled` runs one session under torch.profiler (CPU and CUDA), with a
  span (`record_function`) around each call the configuration names
  (`spans`), and returns the device operations, the host spans and ops, and
  the slice's wall time. The profiler has been seen to drop events of a
  window and never to add any (`chip_smoke.device_events`): of two
  sessions the one with the most device events is kept.
* `host_syncs` counts the synchronising calls of one session with CUDA's
  sync debug mode, as `chip_smoke.host_syncs` does.
* `busy`, `gaps` and `breakdown` reduce a profile: the union of the device
  intervals, the idle gaps between them named by what the host was doing,
  and the busiest device operations by stage.
"""

from __future__ import annotations

import contextlib
import time
import warnings

import torch

from benchmark.recorders import swapped
from benchmark.roofline import stage_of

PROFILED_SESSIONS = 2


def _wrap_call(fn, name):
    def wrapped(*a, **kw):
        with torch.profiler.record_function(name):
            return fn(*a, **kw)
    return wrapped


def _wrap_phase(fn):
    @contextlib.contextmanager
    def phase(self, name, *a, **kw):
        with torch.profiler.record_function(name), fn(self, name, *a, **kw):
            yield
    return phase


def spans(specs: list):
    """Wrap each named callable in a profiler span while the block runs.
    A spec is {"module", "attr" ("Class.method" or a function), "span"}:
    with a span name, calls are spans of that name; without, the call is a
    context manager whose first argument names the span (a phase timer)."""
    return swapped(specs, lambda s, orig: _wrap_call(orig, s["span"]) if "span" in s
                   else _wrap_phase(orig))


def profiled(session, span_specs: list, tries: int = PROFILED_SESSIONS) -> dict:
    """Profile `session()` (returns its frame count) `tries` times; keep the
    try with the most device events."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    best = None
    for _ in range(tries):
        torch.cuda.synchronize()
        with spans(span_specs), torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            frames = session()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.events()
        cuda = torch.autograd.DeviceType.CUDA
        spans_seen = {e.name for e in events if e.device_type != cuda and e.is_user_annotation}
        dev, host = [], []
        for e in events:
            tr = e.time_range
            item = (e.name, tr.start * 1e-6, (tr.end - tr.start) * 1e-6)
            user = bool(e.is_user_annotation) or e.name in spans_seen
            if e.device_type != cuda:
                host.append(item + (user,))
            elif not user:     # a span's copy on the device's timeline is no operation
                dev.append(item)
        if best is None or len(dev) > len(best["device_ops"]):
            best = {"device_ops": dev, "host": host, "window_s": wall, "frames": frames}
    return best


def host_syncs(session):
    """(frames, synchronising calls) of one session."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            frames = session()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return frames, sum(1 for w in caught if "synchroniz" in str(w.message))


def intervals(device_ops):
    """The union of the device operations' intervals, sorted."""
    out = []
    for _, s, d in sorted(device_ops, key=lambda x: x[1]):
        e = s + d
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy(device_ops) -> float:
    return sum(e - s for s, e in intervals(device_ops))


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def _host_at(host, t):
    """'span/op' of what the host ran at time t: the innermost user span
    and the innermost op inside it, or 'python' where no op ran."""
    span, op = None, None
    for name, s, d, user in host:
        if s <= t <= s + d:
            if user:
                if span is None or d < span[1]:
                    span = (name, d)
            elif op is None or d < op[1]:
                op = (name, d)
    return f"{span[0] if span else 'driver'}/{op[0] if op else 'python'}"


def gaps(prof: dict, top: int = 10):
    """The longest idle gaps of the device within the slice, as
    [name, seconds], named by what the host was doing at their middle."""
    iv = intervals(prof["device_ops"])
    found = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(iv, iv[1:])), reverse=True)[:top]
    return [[_host_at(prof["host"], (s + e) / 2), g] for g, s, e in found]


def breakdown(prof: dict, stages: dict, top: int = 10) -> dict:
    """The busiest device operations, 'stage:name' ('other' for a kernel no
    stage claims), and the longest idle gaps."""
    by: dict = {}
    for name, _, d in prof["device_ops"]:
        key = f"{stage_of(name, stages)}:{name[:96]}"
        by[key] = by.get(key, 0.0) + d
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": gaps(prof, top)}
