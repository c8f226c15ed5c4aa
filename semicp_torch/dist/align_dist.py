"""One scan-to-map EM alignment spread over the mesh: the fourth configuration's core.

Port of `semicp/dist/align_dist.py`. The source scan's points are
sharded over the mesh's ranks (dist/mesh.py) and the target map (a fused
submap, slam/submap.py) lives as one block on each rank. Each EM pass:

  E-step  the ring NN sweep of this rank's moved source points over every
          block (dist/ring_corr.py: K2 at map-block scale, K4 below it,
          on CUDA), then the weight/class reduction of the local points
          (K3, register/estep.py)
  M-step  Gauss-Newton/LM from one all-reduce an EM pass: each rank's
          float64 moment row of its points, summed over the group, fixes
          every GN pass's 6x6 system (G1's distributed mode, G1d on CUDA,
          its plain version on the CPU: register/gauss_newton.py
          `em_tail_dist`); then the all-reduced n_corr, and this rank's
          moved source and rotated covariances at the new pose

as the JAX package runs it inside one shard_map while_loop, where the
f32 system is all-reduced in every GN pass instead: the moments evaluate
the same system more exactly, and an em_step within rounding of
em.trans_eps can stop the two one pass apart. Every rank derives its
pose from the same all-reduced row, so the result is the same on every
rank. The host reads one flag an EM pass, as the
single-device align does; the flag is all-reduced (MIN of "go on") before
it is read, so that every rank takes the same number of passes and meets
the same collectives.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from semicp_torch.cloud.cloud import Cloud
from semicp_torch.config import Config
from semicp_torch.dist.ring_corr import prepare_ring_block, resolve_ring_engine, ring_sweep
from semicp_torch.register.em_icp import AlignResult, _log_sem
from semicp_torch.register.estep import estep_reduce
from semicp_torch.register.gauss_newton import em_tail_dist, move_source, tail_outputs


def _shard(cloud: Cloud, mesh) -> Cloud:
    """This rank's contiguous columns of a cloud whose n_pad the world divides."""
    n = cloud.n_pad
    if n % mesh.world:
        raise ValueError(f"make_dist_align_fn: n_pad={n} is not a multiple of the "
                         f"{mesh.world} ranks")
    lo, hi = mesh.rank * (n // mesh.world), (mesh.rank + 1) * (n // mesh.world)
    return cloud.replace(xyz=cloud.xyz[:, lo:hi].contiguous(), label=cloud.label[lo:hi],
                         cov6=cloud.cov6[:, lo:hi].contiguous(), valid=cloud.valid[lo:hi])


def make_dist_align_fn(mesh, cfg: Config, engine: str | None = None):
    """Return align(src, tgt, T0=None) -> AlignResult over the mesh.

    Every rank passes the whole source scan and the whole map, as clouds on
    its device (both n_pad a multiple of the world); each aligns with its
    own columns of both. The result is the same on every rank and drop-in
    for `make_align_fn`'s. engine: as `dist/ring_corr.py` resolves "auto"
    (the default) from a block's size.
    """

    def align(src: Cloud, tgt: Cloud, T0=None) -> AlignResult:
        dev = mesh.device
        if src.device != dev or tgt.device != dev:
            raise ValueError(f"make_dist_align_fn: clouds on {src.device} and {tgt.device}, "
                             f"the mesh computes on {dev}")
        K = cfg.cloud.num_classes
        eng = resolve_ring_engine(engine or "auto", tgt.n_pad // mesh.world, dev,
                                  cfg.corr.sparse_min_n)
        s, b = _shard(src, mesh), _shard(tgt, mesh)
        blk0 = prepare_ring_block(b.xyz, b.label, b.valid, b.cov6, K, eng, cfg.corr.cell)
        log_sem = _log_sem(s, cfg)
        gate = torch.full((), cfg.corr.max_dist, dtype=torch.float32, device=dev)
        gate2 = gate * gate
        T = (torch.eye(4, dtype=torch.float32, device=dev) if T0 is None
             else torch.as_tensor(T0, dtype=torch.float32, device=dev).contiguous())
        step = torch.full((), float("inf"), dtype=torch.float32, device=dev)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        cost, n_corr, H = zero, zero, torch.zeros((6, 6), dtype=torch.float32, device=dev)
        # G1's outputs, kept for the align (two states, alternating by pass)
        out = tail_outputs(s.n_pad, dev, 2) if dev.type == "cuda" else [None, None]
        moved, rc = move_source(T, s.xyz, s.cov6, out[0])
        it = 0
        while it < cfg.em.max_iters:
            nn_d2, attrs = ring_sweep(moved, blk0, K, mesh, eng, gate, s.valid)
            a6, b3, c, wsum = estep_reduce(nn_d2, attrs, rc, moved, log_sem, s.valid, gate2)
            T, cost, _, H, step, n_corr, moved, rc = em_tail_dist(
                T, s.xyz, s.cov6, a6, b3, c, wsum, cfg.gn, mesh, out[it % 2])
            it += 1
            # step is the same on every rank; the MIN makes the trip count so
            go = mesh.all_reduce((step > cfg.em.trans_eps).to(torch.float32).reshape(1),
                                 dist.ReduceOp.MIN)
            if not bool(go[0] > 0.5):   # the one sync per EM pass
                break
        return AlignResult(T=T, iterations=torch.full((), it, dtype=torch.int32, device=dev),
                           converged=step <= cfg.em.trans_eps, cost=cost, n_corr=n_corr, H=H)

    return align
