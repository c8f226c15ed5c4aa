"""Weak scaling of the port's batched alignment over the process group.

The counterpart of scripts/scaling_bench.py in semicp_torch: each rank
aligns `pairs_per_dev` pairs of one scene pair (n_points points, 8
classes, em.max_iters 12, preprocessed with the bare CovConfig) through
`dist/batch.batched_align`, so the batch grows with the world. The JAX
script sweeps the device counts of one process's mesh; here the world is
the process group's (torchrun's, or a group of one), so one run measures
one world size: aligns/s over 3 timed batches after a warm-up, the
backend and the world.

    python scripts/torch_scaling_bench.py [pairs_per_dev] [n_points]
        [--device cpu] [--out PATH]
    torchrun --nproc-per-node N scripts/torch_scaling_bench.py ...

Defaults: 2 pairs a rank, 1000 points. Runs on the card unless given
--device cpu (gloo ranks); rank 0 writes the JSON to --out (default
scaling_torch.json), with the card's name and power limit when it ran on
one. `efficiency` is null: see NOTE.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

REPS = 3
NOTE = ("efficiency is null: one run measures one world size, and ranks that timeshare one "
        "host or one card cannot scale per-rank throughput, so this run only pins that the "
        "sharded harness works; real efficiency must be measured across cards, one rank each")


def run(pairs_per_dev=2, n_points=1000, device="cuda") -> dict:
    from semicp_torch.cloud import make_cloud, preprocess_cloud
    from semicp_torch.config import Config
    from semicp_torch.data import make_pair, make_scene
    from semicp_torch.dist import batched_align
    from semicp_torch.dist.mesh import make_mesh
    from semicp_torch.utils.metrics import card_line

    n_pad = 1 << int(np.ceil(np.log2(n_points * 2)))
    cfg = Config().override({"cloud.n_pad": n_pad, "cloud.num_classes": 8,
                             "em.max_iters": 12})
    rng = np.random.default_rng(0)
    xyz, lab = make_scene(rng, n_points=n_points, extent=15.0)
    lab = lab - 1
    delta = np.array([0.3, -0.1, 0.05, 0.01, -0.01, 0.03])
    src, slab, _ = make_pair(rng, xyz, lab, delta, n_classes=8)
    mesh = make_mesh(torch.device(device))
    src_c, tgt_c = (preprocess_cloud(make_cloud(p, lb, n_pad=n_pad, device=mesh.device), cfg.cov)
                    for p, lb in ((src, slab), (xyz, lab)))
    b = mesh.world * pairs_per_dev
    T0 = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    fn = batched_align(cfg, mesh)

    def batch():
        res = fn([src_c] * b, [tgt_c] * b, T0)
        res.T.cpu()    # the result on the host: every rank's aligns done
        return res

    res = batch()
    t0 = time.perf_counter()
    for _ in range(REPS):
        res = batch()
    dt = (time.perf_counter() - t0) / REPS
    fps = b / dt
    print(f"world={mesh.world:3d}  batch={b:3d}  {fps:8.2f} aligns/s", file=sys.stderr)
    return {"platform": "gpu" if mesh.device.type == "cuda" else "cpu",
            "backend": mesh.backend, "world": mesh.world,
            "card": card_line() if mesh.device.type == "cuda" else None,
            "pairs_per_dev": pairs_per_dev, "n_points": n_points, "n_pad": n_pad, "note": NOTE,
            "em_iterations": [int(i) for i in res.iterations.cpu()],
            "rows": [{"devices": mesh.world, "batch": b, "aligns_per_s": fps,
                      "efficiency": None}]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("pairs_per_dev", nargs="?", type=int, default=2)
    ap.add_argument("n_points", nargs="?", type=int, default=1000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="scaling_torch.json")
    args = ap.parse_args(argv)
    result = run(args.pairs_per_dev, args.n_points, args.device)
    if torch.distributed.get_rank() == 0:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
        print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
