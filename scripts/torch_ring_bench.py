"""One ring sweep of the port at map-block scale: K4 against K2.

The counterpart of scripts/ring_bench.py in semicp_torch. It times one
full ring sweep (`dist/ring_corr.make_ring_nn` over the process group's
mesh) of Morton-sorted queries over a map, with the dense class-sorted
engine (kernel K4 on the card) and with the block-sparse one (K2), and
holds the two to each other within the gate on the first 8192 queries
(of rank 0's shard).
At a world of one the ring is one step: the cost of one step of a ring
that rotates over several cards. The map is a structured scene of 0.9 x
map_points points with random covariances (they do not enter the NN's
cost).

    python scripts/torch_ring_bench.py [map_points] [query_points] [classes]
        [--device cpu] [--out PATH]

Defaults: 2^19 map points, 2^17 queries, 20 classes. Runs on the card
unless given --device cpu (under torchrun, one rank a card); rank 0
writes the JSON to --out (default ring_torch.json), with the card's name
and power limit when it ran on one.
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

AGREE_QUERIES = 8192
# the within-gate d2 agreement of two NN engines: chip_smoke.py
# compare_nn's (rtol, atol), plus the float32 rounding of the dense
# engine's expanded form |q|^2 + |t|^2 - 2 q.t (K4's, as the reference's
# dense kernel forms it), which grows with |q|^2: 8 float32 ulps of it
# (K4 against K2 measured 3.9e-3 m^2 on the H100 at the map's +-60 m,
# above atol; ROADMAP, expected differences)
D2_RTOL, D2_ATOL, D2_EXPANDED = 1e-4, 1e-3, 2.0 ** -20


def steady(fn, dev, reps=5):
    """Mean host ms of fn over reps calls after one warm-up, ending in a
    device sync."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps * 1e3


def run(n_map=1 << 19, n_q=1 << 17, K=20, device="cuda", reps=5) -> dict:
    from semicp_torch.cloud import make_cloud
    from semicp_torch.config import Config
    from semicp_torch.corr.morton import morton_order
    from semicp_torch.data import make_scene
    from semicp_torch.dist.mesh import make_mesh
    from semicp_torch.dist.ring_corr import make_ring_nn
    from semicp_torch.utils.metrics import card_line

    dev = torch.device(device)
    cfg = Config().override({"cloud.n_pad": n_map, "cloud.num_classes": K})
    rng = np.random.default_rng(0)
    # a map fused from preprocessed keyframe clouds arrives with its
    # covariances; their values do not change the NN's cost
    pts, lab = make_scene(rng, n_points=int(n_map * 0.9), extent=120.0, n_classes=K)
    lab = lab - 1
    mesh = make_mesh(dev)
    cloud = make_cloud(pts, lab, n_pad=n_map, device=mesh.device)
    cloud = cloud.replace(cov6=torch.from_numpy(
        rng.normal(size=(6, n_map)).astype(np.float32) * 0.01).to(mesh.device))
    qsel = rng.choice(int(n_map * 0.9), size=n_q, replace=False)
    q = torch.from_numpy(np.ascontiguousarray(pts[qsel].T.astype(np.float32))).to(mesh.device)
    # query clouds arrive class-major Morton sorted; unsorted, the query
    # tiles' boxes span the map and the sparse engine prunes nothing
    q = q[:, morton_order(q, torch.ones(n_q, dtype=torch.bool, device=mesh.device),
                          cfg.corr.cell)].contiguous()
    # this rank's block of the map and shard of the queries (the world
    # divides both, as the mesh's blocks require)
    lo_m, hi_m = mesh.rank * n_map // mesh.world, (mesh.rank + 1) * n_map // mesh.world
    lo_q, hi_q = mesh.rank * n_q // mesh.world, (mesh.rank + 1) * n_q // mesh.world
    blk = [t[..., lo_m:hi_m].contiguous() for t in (cloud.xyz, cloud.label, cloud.valid,
                                                    cloud.cov6)]
    q = q[:, lo_q:hi_q].contiguous()
    gate = cfg.corr.max_dist
    print(f"map={n_map} queries={n_q} K={K} world={mesh.world} backend={mesh.backend} "
          f"gate={gate}", file=sys.stderr)
    ms, out = {}, {}
    for engine in ("dense", "sparse"):
        ring = make_ring_nn(mesh, num_classes=K, engine=engine, gate=gate)

        def fn(ring=ring):
            return ring(q, *blk)

        ms[engine] = steady(fn, mesh.device, reps)
        out[engine] = fn()
        print(f"  ring step [{engine:6s}]: {ms[engine]:9.2f} ms", file=sys.stderr)
    d2_d = out["dense"][0][:, :AGREE_QUERIES].cpu()
    d2_s = out["sparse"][0][:, :AGREE_QUERIES].cpu()
    q2 = torch.sum(q[:, :AGREE_QUERIES].cpu() ** 2, dim=0).expand_as(d2_d)
    inside = d2_d <= gate * gate * (1 - 1e-5)
    diff = torch.abs(d2_s - d2_d)[inside]
    err = float(diff.max()) if inside.any() else 0.0
    tol = D2_ATOL + D2_RTOL * torch.abs(d2_d[inside]) + D2_EXPANDED * q2[inside]
    agree = bool(torch.all(diff <= tol))
    print(f"  within-gate agreement: max |d2 diff| = {err:.2e} "
          f"({float(inside.float().mean()) * 100:.1f}% of (K,Q) within gate)", file=sys.stderr)
    return {"map_points": n_map, "queries": n_q, "classes": K, "gate_m": gate,
            "world": mesh.world, "backend": mesh.backend, "device": mesh.device.type,
            "card": card_line() if mesh.device.type == "cuda" else None,
            "ms_per_ring_step": {"dense": ms["dense"], "sparse": ms["sparse"]},
            "agreement_queries": int(d2_d.shape[1]),
            "within_gate_share": float(inside.float().mean()),
            "max_abs_d2_diff_within_gate": err,
            "d2_tolerance": {"rtol": D2_RTOL, "atol": D2_ATOL, "of_q2": D2_EXPANDED},
            "agree_within_tolerance": agree}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("map_points", nargs="?", type=int, default=1 << 19)
    ap.add_argument("query_points", nargs="?", type=int, default=1 << 17)
    ap.add_argument("classes", nargs="?", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="ring_torch.json")
    args = ap.parse_args(argv)
    result = run(args.map_points, args.query_points, args.classes, args.device)
    if not torch.distributed.is_initialized() or torch.distributed.get_rank() == 0:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
        print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
