"""Per-class nearest neighbour with winner attributes: plain and kernel K2.

Port of the parts of `semicp/corr/pallas_nn2.py` on the main path.

* `prepare_sparse` packs a class-major Morton sorted target into the
  (16, N) attribute slab (x, y, z | cov6 | 1 | |t|^2 | label | 4 spare)
  with per-tile AABBs and class ranges, once per align.
* `class_nn_attrs_plain` is the dense contract (the JAX package's
  `class_nn_attrs_xla`): exact per-class NN over all targets, then a
  gather of the winner's rows. It is the CPU path and K2's reference.
* `class_nn_attrs_sparse` launches K2 (csrc/nn_sparse.cu) over each
  query tile's gate-pruned candidate tiles.

Contract of both, per query and class k: d2 (K, Q), INF where the class
has no candidate, and attrs (K, 16, Q) with the winner's x, y, z, cov6,
found = 1.0 in row 9 and zeros in rows 10-15. Within the gate the two
agree; beyond it the kernel may report INF (the E-step gates there).
Exact ties take the lowest target index in both.
"""

from __future__ import annotations

import torch

from semicp_torch import kernels
from semicp_torch.corr.bruteforce import INF, class_nn
from semicp_torch.corr.layout import LAYOUT_CM, sort_cloud_cm, tile_candidates, tile_meta
from semicp_torch.corr.morton import tile_aabbs

QB = 256     # query tile of the kernel (csrc/common.cuh kQB)
TB = 1024    # target tile
NATTR = 16   # attribute rows (csrc/nn_sparse.cu reads |t|^2 from row 10, the label from 11)


def prepare_sparse(cloud, num_classes: int, cell: float) -> dict:
    """Loop-invariant prep of a target cloud (sorted to cm layout if raw)."""
    if cloud.layout != LAYOUT_CM:
        cloud = sort_cloud_cm(cloud, num_classes, cell)
    n = cloud.n_pad
    tb = min(TB, n)
    if n % tb:
        raise ValueError(f"prepare_sparse: N={n} must be a multiple of the target "
                         f"tile tb={tb} (pad the cloud to a power of two >= {tb})")
    label_s = torch.where(cloud.valid, torch.clamp(cloud.label, min=0),
                          torch.full_like(cloud.label, num_classes)).to(torch.int32)
    ones = torch.ones((1, n), dtype=torch.float32, device=cloud.device)
    t2 = torch.sum(cloud.xyz * cloud.xyz, dim=0, keepdim=True)
    pad = torch.zeros((NATTR - 12, n), dtype=torch.float32, device=cloud.device)
    attrs16 = torch.cat([cloud.xyz, cloud.cov6, ones, t2,
                         label_s[None].to(torch.float32), pad], dim=0).contiguous()
    meta = tile_meta(cloud.xyz, cloud.label, cloud.valid, num_classes, tb)
    return {"xyz_s": cloud.xyz, "label_s": label_s, "attrs16": attrs16, **meta}


def class_nn_attrs_plain(tgt_xyz, tgt_label, tgt_valid, tgt_cov6, q_xyz, num_classes: int):
    """Dense per-class NN + winner attribute gather (the plain contract)."""
    idx, d2 = class_nn(tgt_xyz, torch.clamp(tgt_label, min=0), tgt_valid, q_xyz, num_classes)
    n = tgt_xyz.shape[1]
    rows = torch.cat([tgt_xyz, tgt_cov6,
                      torch.ones((1, n), dtype=tgt_xyz.dtype, device=tgt_xyz.device)])
    win = rows[:, idx].movedim(0, 1)                           # (K, 10, Q)
    win = torch.where((d2 < INF)[:, None, :], win, torch.zeros_like(win))
    spare = torch.zeros((num_classes, NATTR - 10, q_xyz.shape[1]),
                        dtype=win.dtype, device=win.device)
    return d2, torch.cat([win, spare], dim=1)


def query_candidates(prep: dict, q_xyz, q_valid, gate, who: str):
    """Candidate target tiles of each 256-query tile within `gate` (the
    walk of K2 and K6). Returns (cand, count, tb) after checking shapes."""
    n = prep["xyz_s"].shape[1]
    q = q_xyz.shape[1]
    tb = n // prep["lo"].shape[0]
    if q % QB:
        raise ValueError(f"{who}: Q={q} must be a multiple of the query tile {QB} "
                         f"(pad queries to a power of two >= {QB})")
    if tb % QB or n % tb:
        raise ValueError(f"{who}: target tile tb={tb} must be a multiple of {QB} "
                         f"and divide N={n}")
    qlo, qhi = tile_aabbs(q_xyz, q_valid, QB)
    cand, count = tile_candidates(qlo, qhi, prep["lo"], prep["hi"], gate)
    kernels.check(prep["attrs16"], "attrs16", torch.float32, (NATTR, n))
    kernels.check(cand, "cand", torch.int32, (q // QB, n // tb))
    kernels.check(count, "count", torch.int32, (q // QB,))
    return cand, count, tb


def class_nn_attrs_sparse(prep: dict, q_xyz, q_valid, num_classes: int, gate):
    """Block-sparse per-class NN over a prepared target (K2 on CUDA).

    A CPU tensor takes `class_nn_attrs_plain` on the prepared target;
    a CUDA tensor launches K2. `gate` may be a float or a 0-dim tensor.
    Queries should be cm-sorted so query tiles are compact (that is what
    makes the pruning bite); exactness does not depend on it.
    """
    if not q_xyz.is_cuda:
        label_s = prep["label_s"]
        return class_nn_attrs_plain(prep["xyz_s"], label_s, label_s < num_classes,
                                    prep["attrs16"][3:9], q_xyz, num_classes)
    n = prep["xyz_s"].shape[1]
    q = q_xyz.shape[1]
    cand, count, tb = query_candidates(prep, q_xyz, q_valid, gate, "class_nn_attrs_sparse")
    q_xyz = q_xyz.contiguous()
    kernels.check(q_xyz, "q_xyz", torch.float32, (3, q))
    out_d2 = torch.empty((num_classes, q), dtype=torch.float32, device=q_xyz.device)
    out_attr = torch.empty((num_classes, NATTR, q), dtype=torch.float32, device=q_xyz.device)
    kernels.launch("semicp_nn_sparse", "nn_sparse", q_xyz.device,
                   prep["attrs16"].data_ptr(), cand.data_ptr(), count.data_ptr(),
                   q_xyz.data_ptr(), n, q, cand.shape[1], tb, num_classes,
                   out_d2.data_ptr(), out_attr.data_ptr())
    return out_d2, out_attr
