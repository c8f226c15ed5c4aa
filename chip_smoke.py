#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
1. require a CUDA device; print the card's name and power limit;
2. build the hand-written CUDA kernels from semicp_torch/csrc;
3. each kernel against its plain PyTorch version on the card, at the
   main path's shapes (the bench scene: 131072-point clouds, 20 classes);
4. the main path at full size: a 120k-point, 20-class scan pair through
   make_cloud -> preprocess_cloud -> make_align_fn(cfg)(src, tgt), with
   the kernel launch counts of that run, the ground-truth error, the
   steady-state time per scan (preprocess of the source plus align) and
   the host syncs of one scan (only the EM convergence flag may sync);
5. the same slice at n_pad=4096, on the card against the CPU.

It prints one JSON line of the kernels' results, the card's name and
power limit, and last the line {"ok": true, "device": {...}}.
Imports torch, numpy and semicp_torch only.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import time
import warnings

import numpy as np
import torch

import semicp_torch
from semicp_torch import kernels
from semicp_torch.cloud.covariance import estimate_radius
from semicp_torch.cloud.moments import moments_plain, neighborhood_moments_sparse
from semicp_torch.corr.nn_sparse import (
    class_nn_attrs_plain,
    class_nn_attrs_sparse,
    prepare_sparse,
)
from semicp_torch.data import make_pair, make_scene
from semicp_torch.register.em_icp import _log_sem
from semicp_torch.register.estep import estep_reduce, estep_reduce_plain

N_POINTS, N_CLASSES, N_PAD = 120000, 20, 131072
DELTA = np.array([0.5, -0.2, 0.05, 0.01, -0.02, 0.04])
REPEATS = 5


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def host_syncs(fn):
    """Run fn() with CUDA sync debugging on. Returns its result and a
    count of the synchronizing calls it made, by source line."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sites = collections.Counter(f"{os.path.relpath(w.filename)}:{w.lineno}"
                                for w in caught if "synchroniz" in str(w.message))
    return out, sites


def pose_errors(T, T_ref):
    err = np.asarray(T, np.float64) @ np.linalg.inv(np.asarray(T_ref, np.float64))
    terr = float(np.linalg.norm(err[:3, 3]))
    rerr = float(np.arccos(np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)))
    return terr, rerr


def cov_from_moments(m):
    """Covariance planes (6, N) through covariance.py's epilogue, float64."""
    m = m.double()
    n = torch.clamp(m[0], min=1.0)
    mx, my, mz = m[1] / n, m[2] / n, m[3] / n
    return torch.stack([m[4] / n - mx * mx, m[5] / n - my * my, m[6] / n - mz * mz,
                        m[7] / n - mx * my, m[8] / n - mx * mz, m[9] / n - my * mz])


def bench_pair(n_points, extent, n_classes):
    rng = np.random.default_rng(0)
    xyz, lab = make_scene(rng, n_points=n_points, extent=extent, n_classes=n_classes)
    lab = lab - 1
    src, slab, T_gt = make_pair(rng, xyz, lab, DELTA, noise=0.02, dropout=0.1,
                                n_classes=n_classes)
    return src, slab, xyz, lab, T_gt


def check_k1(tgt, cfg, results):
    """K1 against moments_plain at the covariance level, all points."""
    label = torch.clamp(tgt.label, min=0)
    r = estimate_radius(tgt.xyz, label, tgt.valid, k=cfg.cov.k)
    K = cfg.cloud.num_classes
    m_k = neighborhood_moments_sparse(tgt.xyz, label, tgt.valid, r, K)
    # reference: the plain version in float64 (exact up to the radius
    # test); the f32 plain is what is timed
    m_ref = moments_plain(tgt.xyz.double(), label, tgt.valid, r.double())
    cnt_k, cnt_r = m_k[0], m_ref[0]
    n_cnt_diff = int(torch.sum(cnt_k != cnt_r.float()))
    max_cnt_diff = float(torch.max(torch.abs(cnt_k.double() - cnt_r)))
    sel = tgt.valid & (cnt_r >= 3) & (cnt_k.double() == cnt_r)
    ck, cr = cov_from_moments(m_k)[:, sel], cov_from_moments(m_ref)[:, sel]
    err = torch.abs(ck - cr)
    atol, rtol = 1e-5, 1e-3
    worst = float(torch.max(err / (atol + rtol * torch.abs(cr))))
    max_abs = float(torch.max(err))
    ms = cuda_ms(lambda: neighborhood_moments_sparse(tgt.xyz, label, tgt.valid, r, K), 20)
    plain_ms = cuda_ms(lambda: moments_plain(tgt.xyz, label, tgt.valid, r), 2)
    print(f"K1 moments_sparse: radius {float(r):.4f} m, cov max_abs_err {max_abs:.3e} "
          f"(tol atol {atol} + rtol {rtol}; worst ratio {worst:.3f}); counts differ at "
          f"{n_cnt_diff} of {int(tgt.count)} points (max |diff| {max_cnt_diff:.0f}, tol <= 1 "
          f"at <= 1e-4 of the points); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    assert worst <= 1.0, "K1 covariances disagree with the plain version"
    assert max_cnt_diff <= 1.0 and n_cnt_diff <= 1e-4 * int(tgt.count), "K1 counts disagree"
    results.append({"name": "moments_sparse", "route": "cuda",
                    "source": "semicp_torch/csrc/moments.cu",
                    "replaces": "semicp/cloud/pallas_cov.py:210",
                    "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms})


def check_k2_k3(src, tgt, cfg, results):
    """K2 against class_nn_attrs_plain within the gate, then K3 against
    estep_reduce_plain, both on all points of the first E-step (T = I)."""
    K = cfg.cloud.num_classes
    gate = cfg.corr.max_dist
    prep = prepare_sparse(tgt, K, cfg.corr.cell)
    q, qv = src.xyz, src.valid
    tv = prep["label_s"] < K

    def plain():
        return class_nn_attrs_plain(prep["xyz_s"], prep["label_s"], tv,
                                    prep["attrs16"][3:9], q, K)

    d2_k, at_k = class_nn_attrs_sparse(prep, q, qv, K, gate)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d2_p, at_p = plain()
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    ms = cuda_ms(lambda: class_nn_attrs_sparse(prep, q, qv, K, gate), 20)

    inside = (d2_p <= gate * gate * (1.0 - 1e-5)) & qv[None, :]
    rtol, atol = 1e-4, 1e-3
    d_err = torch.abs(d2_k - d2_p)[inside]
    max_abs = float(torch.max(d_err))
    ok_d2 = bool(torch.all(d_err <= atol + rtol * torch.abs(d2_p[inside])))
    same = torch.all(at_k == at_p, dim=1) & inside               # (K, Q)
    ties = inside & ~same
    # where the winners differ (a near-tie), the kernel's winner must lie
    # within the d2 tolerance of the plain minimum
    wd = at_k[:, 0:3, :] - q[None]
    wd2 = torch.sum(wd * wd, dim=1)
    tie_err = torch.abs(wd2 - d2_p)[ties]
    ok_ties = bool(torch.all(tie_err <= atol + rtol * torch.abs(d2_p[ties])))
    ok_found = bool(torch.all(at_k[:, 9, :][inside] == 1.0)) and bool(torch.all(at_k[:, 10:] == 0))
    outside = ~inside & qv[None, :]
    ok_out = bool(torch.all(d2_k[outside] >= d2_p[outside] * (1 - rtol) - atol))
    print(f"K2 nn_sparse: {int(inside.sum())} (query, class) pairs within the {gate} m gate; "
          f"d2 max_abs_err {max_abs:.3e} (tol rtol {rtol}, atol {atol}); attrs equal at "
          f"{int(same.sum())}, near-ties {int(ties.sum())} (all within tol: {ok_ties}); "
          f"beyond-gate never closer: {ok_out}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    assert ok_d2 and ok_ties and ok_found and ok_out, "K2 disagrees with the plain version"
    results.append({"name": "nn_sparse", "route": "cuda",
                    "source": "semicp_torch/csrc/nn_sparse.cu",
                    "replaces": "semicp/corr/pallas_nn2.py:545",
                    "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms})

    log_sem = _log_sem(src, cfg)
    gate2 = torch.tensor(gate * gate, device=q.device)
    args = (d2_k, at_k, src.cov6, q.contiguous(), log_sem, qv, gate2)
    out_k = estep_reduce(*args)
    out_p = estep_reduce_plain(*args)
    names = ("a6", "b3", "c", "wsum")
    tols = {"a6": (3e-3, 2e-3), "b3": (3e-3, 5e-3), "c": (3e-3, 5e-3), "wsum": (0.0, 1e-5)}
    worst = {}
    for name, k, p in zip(names, out_k, out_p):
        rt, at = tols[name]
        worst[name] = float(torch.max(torch.abs(k - p) / (at + rt * torch.abs(p))))
    max_abs = float(torch.max(torch.abs(out_k[0] - out_p[0])))
    ms = cuda_ms(lambda: estep_reduce(*args), 50)
    plain_ms = cuda_ms(lambda: estep_reduce_plain(*args), 5)
    print(f"K3 estep_reduce: worst |err|/(atol+rtol|ref|) per output {worst} with (rtol, atol) "
          f"{tols}; a6 max_abs_err {max_abs:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    assert all(v <= 1.0 for v in worst.values()), "K3 disagrees with the plain version"
    results.append({"name": "estep_reduce", "route": "cuda",
                    "source": "semicp_torch/csrc/estep.cu",
                    "replaces": "semicp/register/pallas_estep.py:135",
                    "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms})


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    kernels.library()
    print(f"phase 2: built the CUDA kernels in {time.perf_counter() - t0:.1f} s")

    cfg = semicp_torch.Config().override({"cloud.n_pad": N_PAD, "cloud.num_classes": N_CLASSES,
                                          "em.max_iters": 20})
    src_pts, src_lab, tgt_pts, tgt_lab, T_gt = bench_pair(N_POINTS, 40.0, N_CLASSES)

    t0 = time.perf_counter()
    results = []
    src = semicp_torch.preprocess_cloud(
        semicp_torch.make_cloud(src_pts, src_lab, n_pad=N_PAD, device=dev), cfg)
    tgt = semicp_torch.preprocess_cloud(
        semicp_torch.make_cloud(tgt_pts, tgt_lab, n_pad=N_PAD, device=dev), cfg)
    check_k1(tgt, cfg, results)
    check_k2_k3(src, tgt, cfg, results)
    print(f"phase 3: kernels against plain in {time.perf_counter() - t0:.1f} s")

    # phase 4: the main path, counted
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    raw_src = semicp_torch.make_cloud(src_pts, src_lab, n_pad=N_PAD, device=dev)
    raw_tgt = semicp_torch.make_cloud(tgt_pts, tgt_lab, n_pad=N_PAD, device=dev)
    src = semicp_torch.preprocess_cloud(raw_src, cfg)
    tgt = semicp_torch.preprocess_cloud(raw_tgt, cfg)
    align_fn = semicp_torch.make_align_fn(cfg)
    res = align_fn(src, tgt)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    T = res.T.cpu().numpy()
    terr, rerr = pose_errors(T, T_gt)
    iters, conv = int(res.iterations), bool(res.converged)
    print(f"phase 4: main path (first run {first_s:.2f} s): converged={conv} in {iters} EM "
          f"iterations, trans_err {terr:.3e} m, rot_err {rerr:.3e} rad, "
          f"n_corr {float(res.n_corr):.0f}; kernel launches {launches}")
    assert conv, "main path did not converge"
    assert terr < 0.02 and rerr < 0.005, (terr, rerr)
    assert np.isfinite(T).all()
    missing = [k for k, v in launches.items() if v == 0]
    assert not missing, f"kernels not launched on the main path: {missing}"
    for r in results:
        r["launches"] = launches[r["name"]]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPEATS):
        src = semicp_torch.preprocess_cloud(raw_src, cfg)
        res = align_fn(src, tgt)
    torch.cuda.synchronize()
    ms_scan = 1e3 * (time.perf_counter() - t0) / REPEATS
    print(f"phase 4: steady state {ms_scan:.2f} ms per scan (preprocess source + align, "
          f"{REPEATS} repeats, {int(res.iterations)} EM iterations) on {card}")
    res, sites = host_syncs(lambda: align_fn(semicp_torch.preprocess_cloud(raw_src, cfg), tgt))
    n_sync, iters = sum(sites.values()), int(res.iterations)
    print(f"phase 4: host syncs in one scan: {n_sync} ({dict(sites)}), "
          f"{iters} EM iterations (one convergence-flag read each)")
    assert n_sync == iters, "a host sync crept into the scan beyond the EM flag"

    # phase 5: n_pad=4096, card against CPU
    small = semicp_torch.Config().override({"cloud.n_pad": 4096, "cloud.num_classes": N_CLASSES,
                                            "em.max_iters": 20})
    s_pts, s_lab, t_pts, t_lab, T_gt_s = bench_pair(3800, 20.0, N_CLASSES)
    Ts = {}
    for d in (dev, torch.device("cpu")):
        s = semicp_torch.preprocess_cloud(semicp_torch.make_cloud(s_pts, s_lab, 4096, d), small)
        t = semicp_torch.preprocess_cloud(semicp_torch.make_cloud(t_pts, t_lab, 4096, d), small)
        Ts[d.type] = semicp_torch.make_align_fn(small)(s, t).T.cpu().numpy()
    diff = float(np.max(np.abs(Ts["cuda"] - Ts["cpu"])))
    terr_s, _ = pose_errors(Ts["cuda"], T_gt_s)
    print(f"phase 5: n_pad=4096 T card vs CPU max |diff| {diff:.3e} (tol 1e-4); "
          f"card trans_err {terr_s:.3e} m")
    assert diff <= 1e-4, diff

    print(json.dumps({"kernels": results}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
