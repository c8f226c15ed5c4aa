#!/usr/bin/env python3
"""Run one cell of the semicp_torch benchmark once, on the machine it starts on.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up writes the cell's sequence (drawn from --seed) into the run's
temporary directory and runs one warm session of the cell's own shapes.
The window then runs the configuration's driver in whole sessions, back to
back, for --seconds (it ends with the session in flight). With --trace 0
the result carries the cell's end-to-end metrics, with --trace 1 its
per-layer metrics, read after the window from the sessions' own records,
one profiled session and one session under CUDA's sync debug mode. Every
metric is read from the run's record by metrics/<name>.py. Either way the
window's outputs are then judged against the plain reference by the
configuration's check (checks/<check>.py), and the numbers compared are
printed with their limits as the last lines of standard error and under
"checks", last, in the result line, which is the last line of standard
output.

The configuration's `environment` (its host settings, such as the CPU
thread pools' sizes) is set before torch is imported.

Exits non-zero with no result where there is no CUDA device, fewer than
the cell asks for, no system under test beside the benchmark, or where
JAX, flax or the JAX package were loaded.
"""

from __future__ import annotations

import time

_T_IMPORT = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the package is imported as `benchmark` from the checkout's root; its own
# directory leaves sys.path so that its modules shadow nothing
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "semicp")


def process_start() -> float:
    """Wall-clock time at which this process started, from /proc (Linux);
    the time this module began to run where /proc's clocks disagree (in a
    container whose uptime is not the host's) or are missing."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        start = time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _T_IMPORT
    return start if 0.0 <= _T_IMPORT - start < 60.0 else _T_IMPORT


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, or that come from the repository's tests/."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    found = sorted(tops & set(FORBIDDEN))
    tests = sys.modules.get("tests")
    if tests is not None and str(ROOT / "tests") in str(getattr(tests, "__file__", "") or ""):
        found.append("tests")
    return found


def card_line() -> str:
    """The card's name, power limit, SM clock and power draw (nvidia-smi)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not available"


def cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout. The system builds
    its CUDA kernels and scan loader into semicp_torch/_build/ itself."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        path = ROOT / ".bench_cache" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def run(cell, seed: int, seconds: float, trace_on: bool, device: str = "cuda",
        t_start: float | None = None, marks: str = "") -> dict:
    """One run of `cell` (a spec.Cell): set-up, window, readings, checks.
    Returns the result line's object."""
    import torch

    from benchmark import judge, recorders, scenes, sessions, spec, trace

    t_start = _T_IMPORT if t_start is None else t_start
    cuda = device == "cuda"
    cfg, traffic = cell.config, cell.traffic
    seq_spec = cfg["sequence"]

    def sync():
        if cuda:
            torch.cuda.synchronize()

    recorder = recorders.Recorder(cfg.get("record", []))
    with tempfile.TemporaryDirectory(prefix="semicp-bench-") as tmp, recorder.active():
        tmp = Path(tmp)
        t0, started = time.perf_counter(), time.time() - t_start
        seq = scenes.make_sequence(seq_spec, seed, device)
        t1 = time.perf_counter()
        seq_dir = scenes.write_sequence(seq, tmp / "seq", seq_spec["classes"] + 1)
        t2 = time.perf_counter()
        drv = sessions.Driver(cfg, traffic, seq_dir, tmp / "out", device, recorder=recorder)
        drv.session("warm")
        sync()
        print(f"setup: {marks}run started {started:.3f} s after the process, sequence drawn in "
              f"{t1 - t0:.3f} s, written in {t2 - t1:.3f} s, warm session "
              f"{time.perf_counter() - t2:.3f} s", file=sys.stderr)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.time() - t_start

        done, window_s = sessions.window(drv, seconds, sync)

        peak = torch.cuda.max_memory_allocated() if cuda else 0
        frames = sum(drv.frames_of(s) for s in done)
        result = {"correct": False, "attempted": len(done) * drv.frames, "failed": 0}
        dev_info = {"platform": "gpu" if cuda else "cpu",
                    "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                    "count": cell.chips, "memory_peak_bytes": int(peak)}
        passes = [r.get("iterations", r.get("iters", 0)) for s in done for r in s.records()
                  if r.get("kind", "odom") == "odom"]
        print(f"window: {len(done)} sessions, {frames} frames in {window_s:.3f} s; session "
              f"walls {[round(s.wall, 3) for s in done]}; EM passes a frame "
              f"{sum(passes) / max(len(passes), 1):.4f}", file=sys.stderr)
        breakdown = None
        t3 = time.perf_counter()
        rec = {"window": {"setup_s": setup_s, "seconds": window_s, "frames": frames,
                          "peak_bytes": int(peak)}}
        if trace_on:
            rec.update(n_points=int(cfg["overrides"]["cloud.n_pad"]), stages=spec.stages(),
                       sessions=[{"records": s.records(), "timing": s.result.get("timing", {}),
                                  "frames": drv.frames_of(s)} for s in done])
            if cuda:
                rec["profile"] = trace.profiled(lambda: drv.frames_of(drv.session("p")),
                                                cfg.get("spans", []))
                n_frames, n_syncs = trace.host_syncs(lambda: drv.frames_of(drv.session("y")))
                rec["syncs"] = {"frames": n_frames, "count": n_syncs}
                dev_info["busy_s"] = trace.busy(rec["profile"]["device_ops"])
                dev_info["window_s"] = rec["profile"]["window_s"]
                breakdown = trace.breakdown(rec["profile"], rec["stages"])
        metrics = {}
        for m in cell.per_layer if trace_on else cell.end_to_end:
            v = spec.metric_reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        del rec
        if trace_on:
            print(f"trace: read in {time.perf_counter() - t3:.3f} s", file=sys.stderr)
        if cuda:
            print(f"card: {card_line()}", file=sys.stderr)
        del drv
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t4 = time.perf_counter()
        checks = judge.printable(spec.check_reader(cfg["check"])(cfg, traffic, seq, done, seed,
                                                                 device))
        print(f"checks: judged in {time.perf_counter() - t4:.3f} s", file=sys.stderr)

    result.update(correct=judge.passed(checks), failed=int(checks["frames_missing"]["value"]),
                  metrics=metrics, device=dev_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import spec

    cell = spec.load_cell(args.workload)
    for var, value in cell.config.get("environment", {}).items():
        os.environ[var] = str(value)
    import torch

    t_torch = time.time() - t_start
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    try:
        import semicp_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the system under test is missing beside the benchmark ({e})",
              file=sys.stderr)
        return 3
    cache_dirs()
    marks = (f"torch imported {t_torch:.3f} s, the system {time.time() - t_start:.3f} s after "
             "the process; ")
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start, marks)
    found = forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
