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

from semicp_torch.utils.metrics import count

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


def make_cloud(xyz: np.ndarray, label: np.ndarray | None = None,
               n_pad: int | None = None, device="cuda") -> Cloud:
    """Build a padded Cloud on `device` from host (N,3)/(N,) numpy arrays.

    The scan goes to the device in one copy of a host buffer that holds
    its xyz rows, then its labels: pinned on the card, where the copy is
    asynchronous (no host wait; counted as `upload.pinned`). It lands in
    the new cloud's cov6 planes and is padded from there as
    `cloud_from_tensors` pads, before cov6 is set, so the upload takes no
    device memory beyond the cloud's own. The card is the default: pass
    device="cpu" to build a cloud on the CPU (without a card the default
    raises; nothing falls back)."""
    dev = torch.device(device)
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    if n_pad is None:
        n_pad = max(8, 1 << int(np.ceil(np.log2(max(n, 1)))))
    pinned = dev.type == "cuda"
    host = torch.empty((4 * n,), dtype=torch.float32, pin_memory=pinned)
    packed = host.numpy()
    packed[:3 * n] = xyz.reshape(-1)
    packed[3 * n:].view(np.int32)[:] = 0 if label is None else np.asarray(label, np.int32)

    def staged(cov6):
        # 4n floats fit in cov6's 6 n_pad, as n <= n_pad; torch's host
        # allocator keeps the pinned block until the copy lands
        into = cov6.view(-1)[:4 * n].copy_(host, non_blocking=True)
        return into[:3 * n].view(n, 3).T, into[3 * n:].view(torch.int32)

    count("upload.pinned", int(pinned))
    return _padded(n, n_pad, dev, staged)


def cloud_from_tensors(xyz: torch.Tensor, label: torch.Tensor, n_pad: int) -> Cloud:
    """`make_cloud` of device tensors, on their device: xyz (3, n) float32
    and label (n,) int32 padded to n_pad as `make_cloud` pads them, with
    no host copy (the count is filled in on the device)."""
    return _padded(xyz.shape[1], n_pad, xyz.device, lambda cov6: (xyz, label))


def _padded(n: int, n_pad: int, dev: torch.device, points) -> Cloud:
    """A Cloud of n points padded to n_pad on dev: xyz FAR, label -1 and
    identity cov6. `points(cov6)` gives the points on dev as xyz (3, n)
    and label (n,); they may lie in cov6's memory, which is set once they
    are copied."""
    if n > n_pad:
        raise ValueError(f"cloud has {n} points > capacity {n_pad}")
    xyz_p = torch.full((3, n_pad), FAR, dtype=torch.float32, device=dev)
    lab_p = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
    cov6 = torch.empty((6, n_pad), dtype=torch.float32, device=dev)
    xyz, label = points(cov6)
    xyz_p[:, :n] = xyz
    lab_p[:n] = label
    cov6[:3] = 1.0
    cov6[3:] = 0.0
    valid = torch.zeros((n_pad,), dtype=torch.bool, device=dev)
    valid[:n] = True
    return Cloud(xyz=xyz_p, label=lab_p, cov6=cov6, valid=valid,
                 count=torch.full((), n, dtype=torch.int32, device=dev))
