"""Multi-process runs of the port's distributed paths over gloo, for the tests.

`spawn(task, world, directory, deadline_s)` starts `world` processes with
torch.multiprocessing (spawn), each of which joins a gloo group over
tcp://127.0.0.1:<free port> with a 60 s group timeout, reads its inputs
from `directory/in.npz`, runs `task` over the mesh and writes
`directory/out<rank>.npz`. The parent joins them with a hard deadline and
kills them on overrun. The workers import torch, numpy and semicp_torch
only (this module imports nothing else), so that the JAX package never
runs in them; the tests compute the JAX references in the parent.
"""

from __future__ import annotations

import socket
import time
from pathlib import Path

import numpy as np
import torch

GROUP_TIMEOUT_S = 60.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(task: str, world: int, directory, deadline_s: float = 150.0) -> list[dict]:
    """Run task on `world` gloo ranks; returns each rank's outputs."""
    import torch.multiprocessing as mp

    ctx = mp.spawn(_main, args=(world, _free_port(), task, str(directory)), nprocs=world,
                   join=False)
    end = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=max(0.5, end - time.monotonic())):
            if time.monotonic() >= end:
                raise AssertionError(f"gloo task {task!r} over {world} ranks overran its "
                                     f"{deadline_s} s deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [dict(np.load(Path(directory) / f"out{r}.npz")) for r in range(world)]


def _main(rank: int, world: int, port: int, task: str, directory: str) -> None:
    import torch.distributed as dist

    from semicp_torch.dist.mesh import init_distributed, make_mesh

    torch.set_num_threads(1)
    init_distributed("gloo", f"tcp://127.0.0.1:{port}", rank, world, GROUP_TIMEOUT_S)
    try:
        d = Path(directory)
        inp = dict(np.load(d / "in.npz"))
        out = TASKS[task](make_mesh("cpu"), inp)
        np.savez(d / f"out{rank}.npz", **{k: np.asarray(v) for k, v in out.items()})
    finally:
        dist.destroy_process_group()


def _config(inp):
    from semicp_torch.config import Config, parse_overrides

    return Config().override(parse_overrides([str(a) for a in inp["overrides"]]))


def _cloud(inp, tag):
    from semicp_torch.convert import cloud_from_numpy

    return cloud_from_numpy(*(inp[f"{tag}_{f}"] for f in ("xyz", "label", "cov6", "valid",
                                                        "count")), device="cpu")


def _cols(a, mesh):
    """This rank's contiguous columns of a (..., N) array, as a tensor."""
    n = a.shape[-1] // mesh.world
    return torch.from_numpy(np.ascontiguousarray(a[..., mesh.rank * n:(mesh.rank + 1) * n]))


def task_dist(mesh, inp) -> dict:
    """The ring NN (three engines), the distributed align (two engines, and
    the trajectories of the spread pairs), the distributed GN and its tail,
    G1d's moment M-step, and a batch of pairs over the mesh."""
    from semicp_torch.cloud import make_cloud, preprocess_cloud
    from semicp_torch.config import GNConfig
    from semicp_torch.dist import align_dist
    from semicp_torch.dist.align_dist import make_dist_align_fn
    from semicp_torch.dist.batch import batched_align
    from semicp_torch.dist.ring_corr import make_ring_nn
    from semicp_torch.register.gauss_newton import (
        em_tail_dist,
        em_tail_dist_moments_plain,
        gn_moments_plain,
        gn_solve_dist_plain,
        gn_solve_moments_plain,
    )

    out = {}
    K, gate = int(inp["ring_k"]), float(inp["ring_gate"])
    q = _cols(inp["ring_q"], mesh)
    blk = [_cols(inp[f"ring_{f}"], mesh) for f in ("xyz", "lab", "val", "cov6")]
    for eng in ("xla", "sparse", "dense"):
        out[f"ring_d2_{eng}"], out[f"ring_at_{eng}"] = make_ring_nn(mesh, K, eng, gate)(q, *blk)

    cfg = _config(inp)
    src, tgt = _cloud(inp, "src"), _cloud(inp, "tgt")
    for eng in ("xla", "sparse"):
        res = make_dist_align_fn(mesh, cfg, engine=eng)(src, tgt)
        out[f"align_T_{eng}"], out[f"align_it_{eng}"] = res.T, res.iterations
        out[f"align_n_corr_{eng}"] = res.n_corr
    # each spread pair's trajectory: the initial pose, then the pose
    # after each EM pass (em_tail_dist's T)
    traj = []
    orig = align_dist.em_tail_dist

    def recording(*a, **k):
        tail = orig(*a, **k)
        traj.append(tail.T)
        return tail

    align_dist.em_tail_dist = recording
    try:
        for i in range(int(inp["spread_pairs"])):
            traj[:] = [torch.eye(4)]
            make_dist_align_fn(mesh, cfg)(_cloud(inp, f"spread{i}_src"),
                                          _cloud(inp, f"spread{i}_tgt"))
            out[f"spread_traj{i}"] = torch.stack(traj)
    finally:
        align_dist.em_tail_dist = orig

    gcfg = GNConfig(**{k: float(v) if k != "max_iters" else int(v)
                       for k, v in zip(inp["gn_keys"], inp["gn_vals"])})
    z, cov6, a6, b3, c, wsum = (_cols(inp[f"gn_{f}"], mesh)
                                for f in ("z", "cov6", "a6", "b3", "c", "wsum"))
    T0 = torch.from_numpy(inp["gn_T0"])
    out["gn_T"], out["gn_cost"], out["gn_step"], out["gn_H"] = gn_solve_dist_plain(
        T0, z, a6, b3, c, gcfg, mesh)
    tail = em_tail_dist(T0, z, cov6, a6, b3, c, wsum, gcfg, mesh)
    ref = em_tail_dist_moments_plain(T0, z, cov6, a6, b3, c, wsum, gcfg, mesh)
    out["tail_equal"] = all(bool(torch.equal(a, b)) for a, b in zip(tail, ref))
    out["tail_n_corr"], out["tail_em_step"] = tail.n_corr, tail.em_step
    out["tail_T"] = tail.T
    # G1d's M-step on its float64 mirror: this rank's moment row,
    # all-reduced, then every GN pass from the row
    row = mesh.all_reduce(gn_moments_plain(z, a6, b3, c, wsum))
    out["mom_row"] = row
    out["mom_T"], _, _, _, out["mom_passes"] = gn_solve_moments_plain(T0, row, gcfg)

    # a batch of pairs over the mesh (the shares differ where the world
    # does not divide the batch)
    n_pairs = int(inp["batch_pairs"])
    pcfg = cfg.override({"cloud.n_pad": int(inp["batch_n_pad"])})
    clouds = [[preprocess_cloud(make_cloud(inp[f"batch_{w}{i}"], inp[f"batch_{w}lab{i}"],
                                           n_pad=pcfg.cloud.n_pad, device="cpu"), pcfg.cov)
               for i in range(n_pairs)] for w in ("src", "tgt")]
    res = batched_align(pcfg, mesh)(clouds[0], clouds[1], np.tile(np.eye(4, dtype=np.float32),
                                                                  (n_pairs, 1, 1)))
    out["batch_T"], out["batch_it"] = res.T, res.iterations
    return {k: v.numpy() if torch.is_tensor(v) else v for k, v in out.items()}


def task_schur(mesh, inp) -> dict:
    """The Schur BA over the mesh on this rank's landmarks and their
    observations (already grouped by shard, ids local); refine_keyframes
    over the mesh on a keyframe store."""
    from semicp_torch.cloud import make_cloud
    from semicp_torch.slam.keyframes import KeyframeStore
    from semicp_torch.slam.map_ba import refine_keyframes
    from semicp_torch.slam.schur import make_ba_solver

    r = mesh.rank
    t = torch.from_numpy
    solve = make_ba_solver(mesh, m=inp["ba_p0"].shape[0], iters=int(inp["ba_iters"]))
    per = inp["ba_l0"].shape[0] // mesh.world
    poses, lms = solve(t(inp["ba_p0"]), t(inp["ba_l0"][r * per:(r + 1) * per]),
                       t(inp["ba_OP"][r]), t(inp["ba_OL"][r]), t(inp["ba_OZ"][r]),
                       t(inp["ba_OW"][r]))
    store = KeyframeStore()
    for i in range(inp["kf_xyz"].shape[0]):
        n = int(inp["kf_n"][i])
        store.add(i, inp["kf_gt"][i], make_cloud(inp["kf_xyz"][i][:n], inp["kf_lab"][i][:n],
                                                 n_pad=int(inp["kf_n_pad"]), device="cpu"),
                  np.zeros(1))
    refined, stats = refine_keyframes(store, inp["kf_noisy"].copy(), _config(inp), mesh=mesh)
    return {"ba_poses": poses.numpy(), "ba_lms": lms.numpy(), "refined": refined,
            "observations": stats["observations"], "landmarks": stats["landmarks"]}


def task_run_batch(mesh, inp) -> dict:
    """run_batch (plain) over the mesh, on the CPU."""
    from semicp_torch.cli.run_batch import build_parser, run_batch
    from semicp_torch.config import Config, parse_overrides

    args, extra = build_parser().parse_known_args([str(a) for a in inp["argv"]])
    out, poses, _ = run_batch(args, Config().override(parse_overrides(extra)))
    return {"poses": np.stack([np.stack(p) for p in poses]), "ate": np.asarray(out["ate_rmse_m"]),
            "aligns_total": out["aligns_total"], "devices": out["devices"]}


TASKS = {"dist": task_dist, "schur": task_schur, "run_batch": task_run_batch}
