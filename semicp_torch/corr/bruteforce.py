"""Exact nearest neighbours, dense and chunked over queries.

Port of `semicp.corr.bruteforce`: `class_nn`, the per-class nearest
neighbour, is the plain version behind the sparse nearest-neighbour
kernel (corr/nn_sparse.py) and the whole correspondence engine on the
CPU; `knn_self`, the k nearest neighbours within a cloud, serves the kNN
covariances on every device. Distances use the expanded form

    d2 = |q|^2 + |t|^2 - 2 q . t

as the JAX package and the kernels do, so d2 compares like for like
(the expansion loses ~|x|^2 * 2^-23 to cancellation, ~1e-3 m^2 at
+-80 m). The q.t product runs in full f32 (TF32 is off package-wide).
"""

from __future__ import annotations

import torch

INF = 3.0e37

QB = 512      # query chunk
BLOCK = 1 << 27  # class_nn's chunk: K x chunk x N stays below this many elements


def class_nn(tgt_xyz, tgt_label, tgt_valid, q_xyz, num_classes: int, qb: int = QB):
    """Exact per-class nearest neighbour for every query point.

    tgt_xyz (3, N) planes; tgt_label (N,) int32; tgt_valid (N,) bool;
    q_xyz (3, Q) planes. Returns (idx (K, Q) int64, d2 (K, Q) f32) — d2 ==
    INF (idx 0) where a class has no valid target. Exact ties take the
    lowest target index. Each chunk of queries computes its (chunk, N)
    distances once and takes each class's minimum over that class's
    columns only (found once, in index order).
    """
    t2 = torch.sum(tgt_xyz * tgt_xyz, dim=0)
    q2 = torch.sum(q_xyz * q_xyz, dim=0)
    dev, nq = tgt_xyz.device, q_xyz.shape[1]
    cols = [torch.nonzero(tgt_valid & (tgt_label == k)).flatten() for k in range(num_classes)]
    qb = max(1, min(qb, BLOCK // max(num_classes * tgt_xyz.shape[1], 1)))
    idx = torch.zeros((num_classes, nq), dtype=torch.int64, device=dev)
    d2_out = torch.full((num_classes, nq), INF, dtype=q2.dtype, device=dev)
    for s in range(0, nq, qb):
        q = q_xyz[:, s:s + qb]
        d2 = q2[s:s + qb, None] + t2[None, :] - 2.0 * (q.T @ tgt_xyz)   # (qb, N)
        for k, c in enumerate(cols):
            if c.numel():
                # the first minimum of the columns in index order: the lowest index
                m, a = torch.min(d2[:, c], dim=1)
                d2_out[k, s:s + qb] = m
                idx[k, s:s + qb] = c[a]
    return idx, d2_out


def _order_key(d2):
    """int64 keys whose order is that of (d2, column): the float32 d2's
    order-preserving bits (-0 taken as +0) above the column index."""
    bits = (d2 + 0.0).view(torch.int32)
    bits = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    col = torch.arange(d2.shape[1], dtype=torch.int64, device=d2.device)
    return (bits.to(torch.int64) << 32) | col


def knn_self(xyz, label, valid, k: int, class_aware: bool = True):
    """k nearest neighbours of every point within its own cloud (and, when
    class_aware, its own class): the covariance neighbourhood. Port of
    `semicp.corr.bruteforce.knn_self`, self-inclusive.

    xyz (3, N) planes; label (N,) int32; valid (N,) bool. Returns
    (idx (N, k) int32, d2 (N, k) f32, nvalid (N, k) bool), ascending by
    d2; d2 == INF where fewer than k neighbours exist. Exact ties take the
    lowest index, as `lax.top_k` does: the top-k runs on int64 keys of
    (d2, index), because `torch.topk` does not order ties. Queries go in
    chunks whose (chunk, N) int64 key block stays within BLOCK * 4 bytes
    (512 MiB), with its f32 distances beside it.
    """
    n = xyz.shape[1]
    t2 = torch.sum(xyz * xyz, dim=0)
    qb = max(1, min(n, BLOCK // (2 * max(n, 1))))
    idx_out, d2_out = [], []
    for s in range(0, n, qb):
        q = xyz[:, s:s + qb]
        d2 = t2[s:s + qb, None] + t2[None, :] - 2.0 * (q.T @ xyz)        # (qb, N)
        ok = valid[None, :]
        if class_aware:
            ok = ok & (label[None, :] == label[s:s + qb, None])
        d2 = torch.where(ok, d2, INF)
        key = torch.topk(_order_key(d2), k, dim=1, largest=False, sorted=True).values
        del d2
        bits = (key >> 32).to(torch.int32)
        d2_out.append((bits ^ ((bits >> 31) & 0x7FFFFFFF)).view(torch.float32))
        idx_out.append((key & 0xFFFFFFFF).to(torch.int32))
    d2 = torch.cat(d2_out)
    return torch.cat(idx_out), d2, d2 < INF
