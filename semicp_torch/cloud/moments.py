"""Masked neighbourhood moments: the plain version and kernel K1.

Port of `semicp/cloud/pallas_cov.py`. For every point, the ten moments
n, Sx, Sy, Sz, Sxx, Syy, Szz, Sxy, Sxz, Syz of its neighbourhood
(same class, d^2 < r^2, valid; self-inclusive), from which the
covariance follows in cloud/covariance.py's epilogue.

* `moments_plain` is the dense masked version (the JAX package's
  `neighborhood_moments_xla`), chunked over queries: raw, uncentred
  moments. It is the CPU path and the kernel's reference.
* `neighborhood_moments_sparse` launches K1 (csrc/moments.cu) over a
  class-major Morton sorted cloud, walking each query tile's same-class
  candidate tiles within the radius. Its moments are centred on each
  query point: equal covariances through the epilogue, not equal raw
  moments.
* `neighborhood_moments_dense` is the raw-layout path (a bare CovConfig,
  or class_aware=False): plain on the CPU, kernel K5 (csrc/moments_dense.cu)
  over all pairs on CUDA. Like K1's, its moments are centred on each
  query point.
"""

from __future__ import annotations

import torch

from semicp_torch import kernels
from semicp_torch.corr.layout import tile_candidates, tile_meta

NMOM = 10
QB = 256   # query tile of the kernel (csrc/common.cuh kQB)
TB = 512   # target tile


def moments_plain(xyz, label, valid, radius, qb: int = 512):
    """(10, N) raw masked neighbourhood moments, dense over all pairs."""
    n = xyz.shape[1]
    tx, ty, tz = xyz[0], xyz[1], xyz[2]
    t2 = tx * tx + ty * ty + tz * tz
    lab = torch.where(valid, label, torch.full_like(label, -1))
    # invalid queries get -2 so they never match anything
    qlab = torch.where(valid, label, torch.full_like(label, -2))
    r2 = kernels.device_scalar(radius, xyz.dtype, xyz.device)[0] ** 2
    feats = torch.stack([torch.ones_like(tx), tx, ty, tz, tx * tx, ty * ty, tz * tz,
                         tx * ty, tx * tz, ty * tz])              # (10, N)
    out = torch.empty((NMOM, n), dtype=xyz.dtype, device=xyz.device)
    for s in range(0, n, qb):
        e = min(s + qb, n)
        d2 = (t2[s:e, None] + t2[None, :]
              - 2.0 * (tx[s:e, None] * tx[None, :] + ty[s:e, None] * ty[None, :]
                       + tz[s:e, None] * tz[None, :]))
        w = ((d2 < r2) & (qlab[s:e, None] == lab[None, :])).to(xyz.dtype)
        out[:, s:e] = feats @ w.T
    return out


def neighborhood_moments_sparse(xyz, label, valid, radius, num_classes: int):
    """(10, N) query-centred masked moments over a cm-sorted cloud (K1).

    A CPU tensor takes `moments_plain`; a CUDA tensor launches K1.
    `radius` may be a float or a 0-dim tensor (it stays on the device).
    """
    if not xyz.is_cuda:
        return moments_plain(xyz, label, valid, radius)
    n = xyz.shape[1]
    tb = min(TB, n)
    if n % QB or n % tb or tb % QB:
        raise ValueError(f"moments_sparse: N={n} must be a multiple of the query "
                         f"tile {QB} and of the target tile tb={tb} (itself a multiple of {QB})")
    label = label.to(torch.int32)
    qmeta = tile_meta(xyz, label, valid, num_classes, QB)
    tmeta = tile_meta(xyz, label, valid, num_classes, tb)
    rad = kernels.device_scalar(radius, torch.float32, xyz.device)
    cand, count = tile_candidates(qmeta["lo"], qmeta["hi"], tmeta["lo"], tmeta["hi"], rad[0],
                                  q_range=(qmeta["cmin"], qmeta["cmax"]),
                                  t_range=(tmeta["cmin"], tmeta["cmax"]))
    tlab = torch.where(valid, label, torch.full_like(label, -1)).contiguous()
    qlab = torch.where(valid, label, torch.full_like(label, -2)).contiguous()
    xyz = xyz.contiguous()
    kernels.check(xyz, "xyz", torch.float32, (3, n))
    kernels.check(cand, "cand", torch.int32, (n // QB, n // tb))
    kernels.check(count, "count", torch.int32, (n // QB,))
    out = torch.empty((NMOM, n), dtype=torch.float32, device=xyz.device)
    kernels.launch("semicp_moments_sparse", "moments_sparse", xyz.device,
                   xyz.data_ptr(), tlab.data_ptr(), qlab.data_ptr(), cand.data_ptr(),
                   count.data_ptr(), rad.data_ptr(), n, cand.shape[1], tb, out.data_ptr())
    return out


def neighborhood_moments_dense(xyz, label, valid, radius):
    """(10, N) masked moments over all pairs of a cloud in any layout (K5).

    A CPU tensor takes `moments_plain` (raw moments); a CUDA tensor
    launches K5 (query-centred moments, equal covariances through the
    epilogue). `radius` may be a float or a 0-dim tensor (it stays on the
    device).
    """
    if not xyz.is_cuda:
        return moments_plain(xyz, label, valid, radius)
    n = xyz.shape[1]
    label = label.to(torch.int32)
    tlab = torch.where(valid, label, torch.full_like(label, -1)).contiguous()
    qlab = torch.where(valid, label, torch.full_like(label, -2)).contiguous()
    xyz = xyz.contiguous()
    kernels.check(xyz, "xyz", torch.float32, (3, n))
    kernels.check(tlab, "label", torch.int32, (n,))
    rad = kernels.device_scalar(radius, torch.float32, xyz.device)
    out = torch.empty((NMOM, n), dtype=torch.float32, device=xyz.device)
    kernels.launch("semicp_moments_dense", "moments_dense", xyz.device,
                   xyz.data_ptr(), tlab.data_ptr(), qlab.data_ptr(), rad.data_ptr(), n,
                   out.data_ptr())
    return out


def neighborhood_moments_auto(xyz, label, valid, radius, num_classes=None,
                              layout: str = "raw"):
    """Dispatch on the layout: the sparse walk (K1) for a cm-sorted cloud,
    the dense moments (K5) otherwise. Each picks its CPU or CUDA path."""
    if layout == "cm" and num_classes is not None:
        return neighborhood_moments_sparse(xyz, label, valid, radius, num_classes)
    return neighborhood_moments_dense(xyz, label, valid, radius)
