"""Per-class nearest neighbour over a class-sorted target: kernel K4.

Port of the dense half of `semicp/corr/pallas_nn2.py`, the correspondence
engine of small clouds (`corr.engine="dense"`, which "auto" picks below
`corr.sparse_min_n`).

* `sort_cloud_by_class` sorts a target by class, invalid last, packs
  its attribute rows (x, y, z | cov6 | 1 | 6 zero rows) and finds each
  class's segment of the sorted target, once per align.
* `class_nn_attrs_dense` has K2's contract (corr/nn_sparse.py) over every
  target: `class_nn_attrs_plain` over the sorted target on a CPU tensor,
  kernel K4 (csrc/nn_dense.cu) on CUDA. Exact ties take the lowest index
  in class-sorted order in both.
"""

from __future__ import annotations

import torch

from semicp_torch import kernels
from semicp_torch.corr.nn_sparse import NATTR, class_nn_attrs_plain


def sort_cloud_by_class(xyz, label, cov6, valid, num_classes: int):
    """Sort target planes by class (invalid last). Returns (xyz_s (3,N),
    label_s (N,) int32 with invalid = num_classes, attrs16 (16,N), seg
    (K+1,) int32): class k holds the sorted points [seg[k], seg[k+1]).

    The sort is stable, as `jnp.argsort` is: the order within a class,
    and so the winner of an exact tie, is the JAX package's. The segments
    are found on the device, with no host sync.
    """
    key = torch.where(valid, torch.clamp(label, min=0), torch.full_like(label, num_classes))
    order = torch.argsort(key, stable=True)
    xyz_s = xyz[:, order]
    n = xyz.shape[1]
    ones = torch.ones((1, n), dtype=torch.float32, device=xyz.device)
    pad = torch.zeros((NATTR - 10, n), dtype=torch.float32, device=xyz.device)
    attrs16 = torch.cat([xyz_s, cov6[:, order], ones, pad], dim=0).contiguous()
    label_s = key[order].to(torch.int32).contiguous()
    classes = torch.arange(num_classes + 1, dtype=torch.int32, device=xyz.device)
    seg = torch.searchsorted(label_s, classes, out_int32=True)
    return xyz_s.contiguous(), label_s, attrs16, seg


def class_nn_attrs_dense(xyz_s, label_s, attrs16, seg, q_xyz, num_classes: int):
    """Per-class NN of every query over a class-sorted target (K4 on CUDA).

    Inputs as `sort_cloud_by_class` returns them; q_xyz (3, Q). Returns
    (d2 (K, Q), INF where a class has no target; attrs (K, 16, Q)).
    """
    if not q_xyz.is_cuda:
        return class_nn_attrs_plain(xyz_s, label_s, label_s < num_classes, attrs16[3:9],
                                    q_xyz, num_classes)
    n, q = xyz_s.shape[1], q_xyz.shape[1]
    q_xyz = q_xyz.contiguous()
    kernels.check(xyz_s, "xyz_s", torch.float32, (3, n))
    kernels.check(attrs16, "attrs16", torch.float32, (NATTR, n))
    kernels.check(seg, "seg", torch.int32, (num_classes + 1,))
    kernels.check(q_xyz, "q_xyz", torch.float32, (3, q))
    out_d2 = torch.empty((num_classes, q), dtype=torch.float32, device=q_xyz.device)
    out_attr = torch.empty((num_classes, NATTR, q), dtype=torch.float32, device=q_xyz.device)
    kernels.launch("semicp_nn_dense", "nn_dense", q_xyz.device,
                   xyz_s.data_ptr(), seg.data_ptr(), attrs16.data_ptr(), q_xyz.data_ptr(),
                   n, q, num_classes, out_d2.data_ptr(), out_attr.data_ptr())
    return out_d2, out_attr
