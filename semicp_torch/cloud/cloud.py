"""Padded planar semantic point cloud — the port's counterpart of `Cloud`.

Port of `semicp/cloud/cloud.py` with the same layout, so that arrays
compare one to one with the JAX package's:

    xyz:   (3, N_pad) float32 — coordinate planes; padded cols = FAR
    label: (N_pad,)   int32   — semantic class ids; padded = -1
    cov6:  (6, N_pad) float32 — GICP-regularized covariance planes
           (sym3 order xx,yy,zz,xy,xz,yz); identity until preprocessed
    valid: (N_pad,)   bool
    count: ()         int32

`layout` is "raw" or "cm" (class-major + Morton-within-class, invalid
last — see corr/layout.py). All tensors of a cloud live on one device,
chosen at `make_cloud` (the card unless the caller asks for the CPU);
everything downstream follows it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

# Padded points are parked far outside any plausible scan so they can
# never be a nearest neighbour even without masking.
FAR = 1.0e6


@dataclass(frozen=True)
class Cloud:
    xyz: torch.Tensor
    label: torch.Tensor
    cov6: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor
    layout: str = "raw"

    @property
    def n_pad(self) -> int:
        return self.xyz.shape[1]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    def replace(self, **kw) -> "Cloud":
        return dataclasses.replace(self, **kw)


def pad_to(arr: np.ndarray, n_pad: int, fill) -> np.ndarray:
    n = arr.shape[0]
    if n > n_pad:
        raise ValueError(f"cloud has {n} points > capacity {n_pad}")
    out = np.full((n_pad,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[:n] = arr
    return out


def make_cloud(xyz: np.ndarray, label: np.ndarray | None = None,
               n_pad: int | None = None, device="cuda") -> Cloud:
    """Build a padded Cloud on `device` from host (N,3)/(N,) numpy arrays.

    The card is the default: pass device="cpu" to build a cloud on the CPU
    (without a card the default raises; nothing falls back)."""
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    if label is None:
        label = np.zeros((n,), np.int32)
    label = np.asarray(label, np.int32)
    if n_pad is None:
        n_pad = max(8, 1 << int(np.ceil(np.log2(max(n, 1)))))
    xyz_p = pad_to(xyz, n_pad, FAR).T.copy()           # (3, N_pad)
    lab_p = pad_to(label, n_pad, -1)
    valid = np.zeros((n_pad,), bool)
    valid[:n] = True
    cov6 = np.zeros((6, n_pad), np.float32)
    cov6[:3] = 1.0                                     # identity components
    return Cloud(
        xyz=torch.from_numpy(xyz_p).to(device),
        label=torch.from_numpy(lab_p).to(device),
        cov6=torch.from_numpy(cov6).to(device),
        valid=torch.from_numpy(valid).to(device),
        count=torch.tensor(n, dtype=torch.int32, device=device),
    )


def cloud_from_tensors(xyz: torch.Tensor, label: torch.Tensor, n_pad: int) -> Cloud:
    """`make_cloud` of device tensors, on their device: xyz (3, n) float32
    and label (n,) int32 padded to n_pad as `make_cloud` pads them, with
    no host copy (the count is filled in on the device)."""
    n, dev = xyz.shape[1], xyz.device
    if n > n_pad:
        raise ValueError(f"cloud has {n} points > capacity {n_pad}")
    xyz_p = torch.full((3, n_pad), FAR, dtype=torch.float32, device=dev)
    xyz_p[:, :n] = xyz
    lab_p = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
    lab_p[:n] = label
    valid = torch.arange(n_pad, device=dev) < n
    cov6 = torch.zeros((6, n_pad), dtype=torch.float32, device=dev)
    cov6[:3] = 1.0
    return Cloud(xyz=xyz_p, label=lab_p, cov6=cov6, valid=valid,
                 count=torch.full((), n, dtype=torch.int32, device=dev))
