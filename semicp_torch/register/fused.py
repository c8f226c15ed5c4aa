"""The one-kernel sparse E-step: the plain version and kernel K6.

Port of `semicp/register/pallas_fused.py`. Per-class nearest neighbour of
every moved source point over a prepared target within the gate, then
the E-step softmax and class reduction, in one C entry. It returns the GN
planes (a6, b3, c, wsum) of `register/estep.py` without the (K, 16, Q)
winner intermediate that the split path writes to device memory and
reads back (64 K Q bytes). `em_icp.use_fused_estep` picks it at map
scale.

* `estep_fused_plain` is the composed contract: `class_nn_attrs_plain`
  over the prepared target, then `estep_reduce_plain`. It is the CPU path
  and K6's reference.
* `estep_sparse_fused` launches K6 (csrc/estep_fused.cu) on a CUDA tensor:
  K2's walk (csrc/nn_walk.cuh) into (K, Q) keys, then K3's per-class
  update with each winner's row read from the target slab.

The port's contract is K2 followed by K3, with exact ties to the lowest
target index. The TPU kernel averages the rows of exact ties instead.
"""

from __future__ import annotations

import torch

from semicp_torch import kernels
from semicp_torch.corr.nn_sparse import class_nn_attrs_plain, walk_args
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
    moved source points (cm-sorted, so query warps are compact); q_valid
    (Q,); rc6 (6, Q) rotated source covariances; log_sem (K, Q); gate a
    float or a 0-dim tensor. Returns (a6 (6,Q), b3 (3,Q), c (Q,), wsum (Q,)).
    """
    if not q_xyz.is_cuda:
        return estep_fused_plain(prep, q_xyz, q_valid, rc6, log_sem, num_classes, gate)
    dev = q_xyz.device
    n, q = prep["xyz_s"].shape[1], q_xyz.shape[1]
    args, tb = walk_args(prep, q_xyz, q_valid, num_classes, gate, "estep_sparse_fused")
    kernels.check(rc6, "rc6", torch.float32, (6, q))
    kernels.check(log_sem, "log_sem", torch.float32, (num_classes, q))
    out = [torch.empty(shape, dtype=torch.float32, device=dev)
           for shape in ((6, q), (3, q), (q,), (q,))]
    p = {k: v.data_ptr() for k, v in args.items()}
    # one entry: the item list, the walk into keys, and the reduce from them
    kernels.launch("semicp_estep_fused", "estep_fused", dev,
                   p["pts4"], p["label_s"], p["attrs16"], p["tile_box"], p["chunk_box"],
                   p["q_xyz"], p["q_valid"], rc6.data_ptr(), log_sem.data_ptr(), p["gate"],
                   n, q, tb, num_classes, p["keys"], p["items"], p["wbox"], p["counters"],
                   *(o.data_ptr() for o in out))
    kernels.WALKED["estep_fused"] = args["counters"][2:]
    return tuple(out)
