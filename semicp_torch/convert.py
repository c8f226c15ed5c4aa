"""Carry state between the JAX package and this one, as numpy arrays.

`cloud_from_numpy` builds a Cloud from the fields of a JAX-side cloud
(for instance one preprocessed by `semicp.preprocess_cloud`), so both
packages can align the very same clouds; `align_result_to_numpy` turns
an AlignResult into host arrays. Neither imports the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from semicp_torch.cloud.cloud import Cloud


def cloud_from_numpy(xyz, label, cov6, valid, count, layout: str = "raw",
                     device="cuda") -> Cloud:
    """Cloud from planar host arrays: xyz (3,N), label (N,), cov6 (6,N),
    valid (N,), count (), on the card unless `device` says otherwise."""

    def t(a, dtype):
        return torch.tensor(np.asarray(a, dtype), device=device)

    return Cloud(xyz=t(xyz, np.float32), label=t(label, np.int32),
                 cov6=t(cov6, np.float32), valid=t(valid, np.bool_),
                 count=t(count, np.int32), layout=layout)


def align_result_to_numpy(res) -> dict:
    """AlignResult -> {field: numpy array} on the host."""
    return {f.name: getattr(res, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(res)}
