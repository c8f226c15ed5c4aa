"""Ring correspondence: per-class NN of sharded queries over sharded map blocks.

Port of `semicp/dist/ring_corr.py`. The map lives as one block on each
rank of the mesh (dist/mesh.py), each rank holds a shard of the query
(source) points, and the blocks rotate around the ring so that every
query shard meets every block: after `world` steps each rank holds its
queries' per-class nearest neighbour over the whole map. The running
result is min-merged step by step, so a rank holds its query shard, one
block and the block arriving next, never the map.

Each rank prepares its block once (`prepare_ring_block`, loop-invariant
across an align's EM passes); the prepared tensors are what rotate. Their
shapes depend only on the block's size, which is the same on every rank,
so a receive needs no sizes. Engines, as in the JAX package:

  sparse  the block sorted class-major Morton (corr/layout.py) and
          prepared as the sparse engine's target (corr/nn_sparse.py
          `prepare_sparse`): each ring step runs kernel K2 on CUDA.
          Beyond the gate a d2 may come back INF (the E-step gates there).
  dense   the block sorted by class with its class segments
          (corr/nn_dense.py): kernel K4 on CUDA.
  xla     the raw block through the plain NN (`class_nn_attrs_plain`), for
          CPU tensors.

On CPU tensors "sparse" and "dense" run their kernels' plain versions.
The rotation is `batch_isend_irecv` to rank + 1 and from rank - 1 into
a second buffer. At a world of one there is nothing to send, and the
sweep is one step with no communication.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from semicp_torch.cloud.cloud import Cloud
from semicp_torch.config import CorrConfig
from semicp_torch.corr.bruteforce import INF
from semicp_torch.corr.layout import sort_cloud_cm
from semicp_torch.corr.nn_dense import class_nn_attrs_dense, sort_cloud_by_class
from semicp_torch.corr.nn_sparse import (
    NATTR,
    class_nn_attrs_plain,
    class_nn_attrs_sparse,
    prepare_sparse,
)

# the prepared block's tensors that rotate, per engine (K2's, K4's, plain's)
ROTATING = {"sparse": ("pts4", "label_s", "attrs16", "tile_box", "chunk_box"),
            "dense": ("xyz_s", "label_s", "attrs16", "seg"),
            "xla": ("xyz", "label", "valid", "cov6")}


def prepare_ring_block(blk_xyz, blk_label, blk_valid, blk_cov6, num_classes: int,
                       engine: str, cell: float = CorrConfig.cell) -> dict:
    """This rank's block, prepared once for `engine`: a dict of the
    tensors `ring_sweep` rotates (ROTATING[engine])."""
    if engine == "sparse":
        count = torch.sum(blk_valid.to(torch.int32))
        cloud = sort_cloud_cm(Cloud(xyz=blk_xyz, label=blk_label, cov6=blk_cov6,
                                    valid=blk_valid, count=count), num_classes, cell)
        prep = prepare_sparse(cloud, num_classes, cell)
    elif engine == "dense":
        xyz_s, label_s, attrs16, seg = sort_cloud_by_class(blk_xyz, blk_label, blk_cov6,
                                                           blk_valid, num_classes)
        prep = {"xyz_s": xyz_s, "label_s": label_s, "attrs16": attrs16, "seg": seg}
    elif engine == "xla":
        prep = {"xyz": blk_xyz, "label": blk_label, "valid": blk_valid, "cov6": blk_cov6}
    else:
        raise ValueError(f"ring engine {engine!r}: expected sparse, dense or xla")
    return {k: prep[k].contiguous() for k in ROTATING[engine]}


def _block_nn(blk: dict, q_xyz, q_valid, num_classes: int, engine: str, gate):
    """(d2 (K,Q), attrs (K,16,Q)) of the queries over one prepared block."""
    if engine == "sparse":
        prep = {**blk, "xyz_s": blk["attrs16"][:3]}
        return class_nn_attrs_sparse(prep, q_xyz, q_valid, num_classes, gate)
    if engine == "dense":
        return class_nn_attrs_dense(blk["xyz_s"], blk["label_s"], blk["attrs16"], blk["seg"],
                                    q_xyz, num_classes)
    return class_nn_attrs_plain(blk["xyz"], blk["label"], blk["valid"], blk["cov6"], q_xyz,
                                num_classes)


def _rotate(blk: dict, buf: dict, mesh) -> None:
    """Send blk to rank + 1 and receive rank - 1's block into buf."""
    nxt, prv = (mesh.rank + 1) % mesh.world, (mesh.rank - 1) % mesh.world
    ops = []
    for k in blk:
        ops.append(dist.P2POp(dist.isend, blk[k], nxt))
        ops.append(dist.P2POp(dist.irecv, buf[k], prv))
    for req in dist.batch_isend_irecv(ops):
        req.wait()


def ring_sweep(q_xyz, blk0: dict, num_classes: int, mesh, engine: str, gate=2.0,
               q_valid=None):
    """One full ring: this rank's queries (3, Qs) against every rank's
    block. blk0 comes from `prepare_ring_block` and is left as it was.
    Returns the per-class NN over the whole map, (d2 (K, Qs), attrs
    (K, 16, Qs)). A tie between blocks keeps the block met first (from
    this rank's own backwards), as the JAX package's merge does.

    gate and q_valid serve the sparse engine (its gate pruning); the dense
    and plain engines are exact everywhere.
    """
    k, qs = num_classes, q_xyz.shape[1]
    if q_valid is None:
        q_valid = torch.ones(qs, dtype=torch.bool, device=q_xyz.device)
    best_d2 = torch.full((k, qs), INF, dtype=torch.float32, device=q_xyz.device)
    best_at = torch.zeros((k, NATTR, qs), dtype=torch.float32, device=q_xyz.device)
    bufs = [{n: torch.empty_like(t) for n, t in blk0.items()}
            for _ in range(min(mesh.world - 1, 2))]
    blk = blk0
    for step in range(mesh.world):
        d2, at = _block_nn(blk, q_xyz, q_valid, num_classes, engine, gate)
        take = d2 < best_d2
        best_d2 = torch.where(take, d2, best_d2)
        best_at = torch.where(take[:, None, :], at, best_at)
        if step < mesh.world - 1:
            # the next block arrives in the buffer this step does not read
            nxt = bufs[step % 2]
            _rotate(blk, nxt, mesh)
            blk = nxt
    return best_d2, best_at


def resolve_ring_engine(engine: str, n_blk: int, device,
                        sparse_min_n: int = CorrConfig.sparse_min_n) -> str:
    """The JAX package's rule for "auto": the plain engine for CPU tensors;
    on CUDA K2's at a block of sparse_min_n points and more, K4's below."""
    cuda = torch.device(device).type == "cuda"
    if engine == "auto":
        return ("sparse" if n_blk >= sparse_min_n else "dense") if cuda else "xla"
    if engine == "xla" and cuda:
        raise NotImplementedError("ring engine 'xla' is the plain NN, for CPU tensors only; "
                                  "on CUDA use 'sparse' (K2), 'dense' (K4) or 'auto'")
    return engine


def make_ring_nn(mesh, num_classes: int, engine: str = "auto", gate: float = 2.0,
                 cell: float = CorrConfig.cell):
    """Return ring(q_xyz, blk_xyz, blk_label, blk_valid, blk_cov6) -> (d2, attrs):
    this rank's query shard (3, Qs) against the map whose block (3, Nb) on
    this rank is given, over the mesh. Every rank calls it with its own
    shards (Nb the same on every rank); each gets its queries' result.
    `gate` bounds the sparse engine's pruning: use the EM gate."""

    def ring(q_xyz, blk_xyz, blk_label, blk_valid, blk_cov6):
        eng = resolve_ring_engine(engine, blk_xyz.shape[1], q_xyz.device)
        blk0 = prepare_ring_block(blk_xyz, blk_label, blk_valid, blk_cov6, num_classes, eng,
                                  cell)
        return ring_sweep(q_xyz, blk0, num_classes, mesh, eng, gate)

    return ring
