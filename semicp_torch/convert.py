"""Carry state between the JAX package and this one, as numpy arrays.

`cloud_from_numpy` builds a Cloud from the fields of a JAX-side cloud
(for instance one preprocessed by `semicp.preprocess_cloud`), so both
packages can align the very same clouds; `pose_graph_from_numpy` builds
the port's PoseGraph from the eight fields of a JAX-side one;
`align_result_to_numpy` turns an AlignResult into host arrays. None
imports the JAX package. run_slam's checkpoint state has the JAX
package's layout (cli/run_slam.py `_restore_state` takes either).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from semicp_torch.cloud.cloud import Cloud
from semicp_torch.slam.pose_graph import PoseGraph


def cloud_from_numpy(xyz, label, cov6, valid, count, layout: str = "raw",
                     device="cuda") -> Cloud:
    """Cloud from planar host arrays: xyz (3,N), label (N,), cov6 (6,N),
    valid (N,), count (), on the card unless `device` says otherwise."""

    def t(a, dtype):
        return torch.tensor(np.asarray(a, dtype), device=device)

    return Cloud(xyz=t(xyz, np.float32), label=t(label, np.int32),
                 cov6=t(cov6, np.float32), valid=t(valid, np.bool_),
                 count=t(count, np.int32), layout=layout)


def pose_graph_from_numpy(poses, n_poses, edge_i, edge_j, edge_z, edge_info, edge_W,
                          n_edges) -> PoseGraph:
    """PoseGraph from the fields of a JAX-side one as host arrays: poses
    (M_pad,4,4), edge_i and edge_j (E_pad,), edge_z (E_pad,4,4), edge_info
    (E_pad,), edge_W (E_pad,6,6), and the two counts."""

    def a(x, dtype):
        return np.array(x, dtype)

    return PoseGraph(poses=a(poses, np.float32), n_poses=int(n_poses),
                     edge_i=a(edge_i, np.int32), edge_j=a(edge_j, np.int32),
                     edge_z=a(edge_z, np.float32), edge_info=a(edge_info, np.float32),
                     edge_W=a(edge_W, np.float32), n_edges=int(n_edges))


def align_result_to_numpy(res) -> dict:
    """AlignResult -> {field: numpy array} on the host."""
    return {f.name: getattr(res, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(res)}
