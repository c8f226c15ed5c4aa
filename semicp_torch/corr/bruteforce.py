"""Exact per-class nearest neighbour, dense and chunked over queries.

Port of `semicp.corr.bruteforce.class_nn`. It is the plain version
behind the sparse nearest-neighbour kernel (corr/nn_sparse.py) and the
whole correspondence engine on the CPU. Distances use the expanded form

    d2 = |q|^2 + |t|^2 - 2 q . t

as the JAX package and the kernels do, so d2 compares like for like
(the expansion loses ~|x|^2 * 2^-23 to cancellation, ~1e-3 m^2 at
+-80 m). The q.t product runs in full f32 (TF32 is off package-wide).
"""

from __future__ import annotations

import torch

INF = 3.0e37

QB = 512      # query chunk
BLOCK = 1 << 27  # bound on the (K, chunk, N) masked-distance block, in elements


def class_nn(tgt_xyz, tgt_label, tgt_valid, q_xyz, num_classes: int, qb: int = QB):
    """Exact per-class nearest neighbour for every query point.

    tgt_xyz (3, N) planes; tgt_label (N,) int32; tgt_valid (N,) bool;
    q_xyz (3, Q) planes. Returns (idx (K, Q) int64, d2 (K, Q) f32) —
    d2 == INF (idx 0) where a class has no valid target. Exact ties
    take the lowest target index.
    """
    t2 = torch.sum(tgt_xyz * tgt_xyz, dim=0)
    q2 = torch.sum(q_xyz * q_xyz, dim=0)
    # (K, N) membership: target is valid and of class k
    classes = torch.arange(num_classes, device=tgt_xyz.device)
    member = (tgt_label[None, :] == classes[:, None]) & tgt_valid[None, :]
    qb = max(1, min(qb, BLOCK // max(num_classes * tgt_xyz.shape[1], 1)))
    idx_out, d2_out = [], []
    for s in range(0, q_xyz.shape[1], qb):
        q = q_xyz[:, s:s + qb]
        d2 = q2[s:s + qb, None] + t2[None, :] - 2.0 * (q.T @ tgt_xyz)   # (qb, N)
        dk = torch.where(member[:, None, :], d2[None], INF)             # (K, qb, N)
        m, a = torch.min(dk, dim=2)
        idx_out.append(a)
        d2_out.append(m)
    return torch.cat(idx_out, dim=1), torch.cat(d2_out, dim=1)
