"""Pairwise alignment driver.

Port of `semicp/cli/run_pair.py`: load two labeled scans (or make a
synthetic pair), align, print the transform and timing as one JSON line.

Usage:
  python -m semicp_torch.cli.run_pair --src scan0.bin --tgt scan1.bin \
      [--src-labels s0.label --tgt-labels s1.label] [--voxel 0.25] \
      [--synthetic N] [--t-init "..."] [--profile DIR] [--device cuda|cpu] \
      [--em.max_iters=40 ...config overrides] [--jsonl out.jsonl]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from semicp_torch.cli.common import (
    device_name,
    load_scan_np,
    print_result,
    setup_device,
    to_device_cloud,
)
from semicp_torch.config import Config, parse_overrides
from semicp_torch.convert import align_result_to_numpy
from semicp_torch.register import make_align_fn
from semicp_torch.utils import MetricsLogger, PhaseTimer, drain


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--src")
    ap.add_argument("--tgt")
    ap.add_argument("--src-labels")
    ap.add_argument("--tgt-labels")
    ap.add_argument("--voxel", type=float, default=0.0)
    ap.add_argument("--synthetic", type=int, default=0,
                    help="generate a synthetic pair with N points instead of loading files")
    ap.add_argument("--jsonl", default=None)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of one steady-state "
                         "align to DIR/trace.json")
    ap.add_argument("--t-init", default=None, metavar="T",
                    help="initial guess: 16 (4x4 row-major) or 12 (3x4 KITTI row) "
                         "whitespace/comma-separated floats")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; raises without a card)")
    return ap


def parse_t_init(text: str) -> np.ndarray:
    vals = np.array([float(v) for v in text.replace(",", " ").split()], np.float32)
    if vals.size == 12:
        vals = np.concatenate([vals, np.array([0, 0, 0, 1], np.float32)])
    if vals.size != 16:
        raise ValueError(f"--t-init needs 12 or 16 floats, got {vals.size}")
    return vals.reshape(4, 4)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    ap = build_parser()
    args, extra = ap.parse_known_args(argv)
    overrides = parse_overrides(extra)
    cfg = Config().override(overrides)
    dev = setup_device(args.device)

    timer = PhaseTimer()
    if args.synthetic:
        from semicp_torch.data import make_pair, make_scene

        rng = np.random.default_rng(0)
        tgt_pts, tgt_lab = make_scene(rng, n_points=args.synthetic)
        tgt_lab = tgt_lab - 1
        delta = np.array([0.4, -0.2, 0.05, 0.02, -0.01, 0.05])
        src_pts, src_lab, T_gt = make_pair(rng, tgt_pts, tgt_lab, delta, n_classes=6)
        if "cloud.num_classes" not in overrides:   # never clobber the user's
            cfg = cfg.override({"cloud.num_classes": 8})
    else:
        if not (args.src and args.tgt):
            ap.error("--src/--tgt or --synthetic required")
        with timer.phase("load"):
            src_pts, src_lab = load_scan_np(args.src, args.src_labels, args.voxel)
            tgt_pts, tgt_lab = load_scan_np(args.tgt, args.tgt_labels, args.voxel)
        T_gt = None

    with timer.phase("preprocess"):
        src = to_device_cloud(src_pts, src_lab, cfg, dev)
        tgt = to_device_cloud(tgt_pts, tgt_lab, cfg, dev)
        drain((src.cov6, tgt.cov6))

    T0 = torch.from_numpy(parse_t_init(args.t_init)).to(dev) if args.t_init else None
    align_fn = make_align_fn(cfg)
    # the JAX driver's key; here the first align pays CUDA's lazy start-up
    # (the kernels were built by setup_device)
    with timer.phase("compile+first_align"):
        res = align_fn(src, tgt, T0)
        drain(res.T)
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            res = align_fn(src, tgt, T0)
            drain(res.T)
        out_dir = Path(args.profile)
        out_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out_dir / "trace.json"))
        print(f"profile written to {out_dir / 'trace.json'}", file=sys.stderr)
    for _ in range(args.repeat - 1):
        with timer.phase("align"):
            res = align_fn(src, tgt, T0)
            drain(res.T)

    r = align_result_to_numpy(res)
    T = r["T"].astype(np.float64)
    out = {
        "T": T.reshape(-1).tolist(),
        "iterations": int(r["iterations"]),
        "converged": bool(r["converged"]),
        "cost": float(r["cost"]),
        "n_corr": float(r["n_corr"]),
        "n_src": int(len(src_pts)),
        "n_tgt": int(len(tgt_pts)),
        "device": device_name(dev),
        "timing": timer.summary(),
    }
    if T_gt is not None:
        err = T @ np.linalg.inv(np.asarray(T_gt, np.float64))
        out["trans_err_m"] = float(np.linalg.norm(err[:3, 3]))
        out["rot_err_rad"] = float(np.arccos(np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)))
    with MetricsLogger(args.jsonl) as ml:
        ml.log(**out)
    print_result("run_pair", out)
    print(timer.table(), file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
