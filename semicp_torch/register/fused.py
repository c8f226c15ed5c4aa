"""The one-kernel sparse E-step: the plain version and kernel K6.

Port of `semicp/register/pallas_fused.py`. Per-class nearest neighbour of
every moved source point over a prepared target's gate-pruned candidate
tiles, then the E-step softmax and class reduction, in one pass. It
returns the GN planes (a6, b3, c, wsum) of `register/estep.py` without the
(K, 16, Q) winner intermediate that the split path writes to device memory
and reads back (0.67 GB at 524288 queries, K = 20). `em_icp.use_fused_estep`
picks it at map scale.

* `estep_fused_plain` is the composed contract: `class_nn_attrs_plain`
  over the prepared target, then `estep_reduce_plain`. It is the CPU path
  and K6's reference.
* `estep_sparse_fused` launches K6 (csrc/estep_fused.cu) on a CUDA tensor:
  K2's candidate walk and K3's per-class update, from the same device
  functions.

The port's contract is K2 followed by K3, with exact ties to the lowest
target index. The TPU kernel averages the rows of exact ties instead.
"""

from __future__ import annotations

import torch

from semicp_torch import kernels
from semicp_torch.corr.nn_sparse import class_nn_attrs_plain, query_candidates
from semicp_torch.register.estep import estep_reduce_plain


def estep_fused_plain(prep: dict, q_xyz, q_valid, rc6, log_sem, num_classes: int, gate):
    """Exact per-class NN over the prepared target, then the reduce."""
    label_s = prep["label_s"]
    nn_d2, attrs = class_nn_attrs_plain(prep["xyz_s"], label_s, label_s < num_classes,
                                        prep["attrs16"][3:9], q_xyz, num_classes)
    return estep_reduce_plain(nn_d2, attrs, rc6, q_xyz, log_sem, q_valid, gate * gate)


def estep_sparse_fused(prep: dict, q_xyz, q_valid, rc6, log_sem, num_classes: int, gate):
    """One-kernel sparse E-step (K6 on CUDA).

    prep: corr/nn_sparse.py `prepare_sparse` of the target; q_xyz (3, Q)
    moved source points (cm-sorted, so query tiles are compact); q_valid
    (Q,); rc6 (6, Q) rotated source covariances; log_sem (K, Q); gate a
    float or a 0-dim tensor. Returns (a6 (6,Q), b3 (3,Q), c (Q,), wsum (Q,)).
    """
    if not q_xyz.is_cuda:
        return estep_fused_plain(prep, q_xyz, q_valid, rc6, log_sem, num_classes, gate)
    dev = q_xyz.device
    n, q = prep["xyz_s"].shape[1], q_xyz.shape[1]
    cand, count, tb = query_candidates(prep, q_xyz, q_valid, gate, "estep_sparse_fused")
    q_xyz = q_xyz.contiguous()
    args = {"q_xyz": (q_xyz, torch.float32, (3, q)),
            "q_valid": (q_valid, torch.bool, (q,)),
            "rc6": (rc6, torch.float32, (6, q)),
            "log_sem": (log_sem, torch.float32, (num_classes, q))}
    for name, (t, dtype, shape) in args.items():
        kernels.check(t, name, dtype, shape)
    g = kernels.device_scalar(gate, torch.float32, dev)
    g2 = g * g
    a6 = torch.empty((6, q), dtype=torch.float32, device=dev)
    b3 = torch.empty((3, q), dtype=torch.float32, device=dev)
    c = torch.empty((q,), dtype=torch.float32, device=dev)
    wsum = torch.empty((q,), dtype=torch.float32, device=dev)
    kernels.launch("semicp_estep_fused", "estep_fused", dev,
                   prep["attrs16"].data_ptr(), cand.data_ptr(), count.data_ptr(),
                   q_xyz.data_ptr(), q_valid.data_ptr(), rc6.data_ptr(), log_sem.data_ptr(),
                   g2.data_ptr(), n, q, cand.shape[1], tb, num_classes,
                   a6.data_ptr(), b3.data_ptr(), c.data_ptr(), wsum.data_ptr())
    return a6, b3, c, wsum
