"""GICP plane-to-plane per-point covariances.

Port of `semicp/cloud/covariance.py`, both methods:

* "radius" (the default): the radius is density-adaptive unless set, the
  median k-th-nearest-neighbour distance over a strided sample of points
  times 1.3. The neighbourhood moments come from cloud/moments.py (on
  CUDA, kernel K1 over a class-major cloud and K5 over a raw-layout one),
  then the epilogue C = S2/n - mean mean^T.
* "knn": the reference's k nearest neighbours (corr/bruteforce.py
  `knn_self`, plain torch on the cloud's device; the JAX package has no
  Pallas kernel for it), gathered and centred per point.

Both end in the rank-1 GICP clamp C -> I - (1-eps) n n^T, with the
identity where a point has fewer than 3 neighbours.
"""

from __future__ import annotations

import torch

from semicp_torch.cloud.cloud import Cloud
from semicp_torch.cloud.moments import neighborhood_moments_auto
from semicp_torch.config import CovConfig
from semicp_torch.corr.bruteforce import knn_self
from semicp_torch.corr.layout import LAYOUT_CM, sort_cloud_cm
from semicp_torch.geom import sym3
from semicp_torch.utils.metrics import span


def _nanmedian(x):
    """Median of the non-NaN entries, averaging the two middle values
    (numpy's and JAX's convention; `torch.nanmedian` takes the lower).
    NaN when every entry is NaN. No host sync: the middle positions stay
    on the device and are gathered, never used as Python indices."""
    s = torch.sort(x).values                         # NaNs sort last
    cnt = torch.sum(~torch.isnan(x))
    mid = torch.clamp(torch.stack([(cnt - 1) // 2, cnt // 2]), min=0)
    med = 0.5 * torch.sum(torch.gather(s, 0, mid))
    return torch.where(cnt > 0, med, torch.full_like(med, float("nan")))


def estimate_radius(xyz, label, valid, k: int = 20, class_aware: bool = True,
                    n_samples: int = 256, scale: float = 1.3):
    """Density-adaptive neighbourhood radius (a 0-dim tensor, no host sync).

    k-th-NN distance on a strided sample of the VALID prefix (make_cloud
    packs points at the front, so the sample — and the radius — do not
    depend on the padding capacity), same-class when `class_aware`;
    returns `scale` times its median. The k-th distance is an exact
    top-k, which the JAX package's `approx_min_k` equals on a CPU.
    """
    n = xyz.shape[1]
    s = min(n_samples, n)
    cnt = torch.clamp(torch.sum(valid.to(torch.int64)), min=1)
    idx = (torch.arange(s, device=xyz.device) * cnt) // s
    q = xyz[:, idx]                                              # (3, S)
    qlab, qval = label[idx], valid[idx]
    d2 = (torch.sum(q * q, 0)[:, None] + torch.sum(xyz * xyz, 0)[None, :]
          - 2.0 * (q.T @ xyz))                                   # (S, N)
    mask = valid[None, :]
    if class_aware:
        mask = mask & (qlab[:, None] == label[None, :])
    d2 = torch.where(mask, torch.clamp(d2, min=0.0), torch.full_like(d2, float("inf")))
    kk = min(k + 1, n)                                           # +1: self-match
    kth = torch.topk(d2, kk, dim=1, largest=False, sorted=True).values[:, -1]
    kth = torch.where(qval & torch.isfinite(kth), kth, torch.full_like(kth, float("nan")))
    r = torch.sqrt(_nanmedian(kth))
    return scale * torch.where(torch.isnan(r), torch.ones_like(r), r)


def _estimate_radius(cloud: Cloud, cfg: CovConfig, class_aware: bool,
                     num_classes: int | None = None):
    label = torch.clamp(cloud.label, min=0) if class_aware else torch.zeros_like(cloud.label)
    if cfg.radius > 0:
        radius = cfg.radius
    else:
        radius = estimate_radius(cloud.xyz, label, cloud.valid, k=cfg.k,
                                 class_aware=class_aware)
    mom = neighborhood_moments_auto(cloud.xyz, label, cloud.valid, radius,
                                    num_classes=num_classes,
                                    layout=cloud.layout if class_aware else "raw")
    cnt = mom[0]
    safe = torch.clamp(cnt, min=1.0)
    mx, my, mz = mom[1] / safe, mom[2] / safe, mom[3] / safe
    cov = (mom[4] / safe - mx * mx, mom[5] / safe - my * my, mom[6] / safe - mz * mz,
           mom[7] / safe - mx * my, mom[8] / safe - mx * mz, mom[9] / safe - my * mz)
    reg = sym3.regularize_gicp(cov, cfg.eps)
    enough = (cnt >= 3.0) & cloud.valid
    eye = sym3.identity_like(cov[0])
    return sym3.pack(tuple(torch.where(enough, r, e) for r, e in zip(reg, eye)))


def _estimate_knn(cloud: Cloud, cfg: CovConfig, class_aware: bool):
    idx, _d2, nvalid = knn_self(cloud.xyz, torch.clamp(cloud.label, min=0), cloud.valid,
                                k=cfg.k, class_aware=class_aware)
    w = nvalid.to(torch.float32)                     # (N, k)
    cnt = torch.sum(w, -1)
    safe = torch.clamp(cnt, min=1.0)
    # planar neighbour gathers: (N, k) per coordinate
    nx, ny, nz = cloud.xyz[0][idx], cloud.xyz[1][idx], cloud.xyz[2][idx]
    mx = torch.sum(nx * w, -1) / safe
    my = torch.sum(ny * w, -1) / safe
    mz = torch.sum(nz * w, -1) / safe
    cx = (nx - mx[:, None]) * w
    cy = (ny - my[:, None]) * w
    cz = (nz - mz[:, None]) * w
    # empirical covariance; w in {0, 1} so w^2 == w
    cov = (torch.sum(cx * cx, -1) / safe, torch.sum(cy * cy, -1) / safe,
           torch.sum(cz * cz, -1) / safe, torch.sum(cx * cy, -1) / safe,
           torch.sum(cx * cz, -1) / safe, torch.sum(cy * cz, -1) / safe)
    reg = sym3.regularize_gicp(cov, cfg.eps)
    enough = (cnt >= 3.0) & cloud.valid
    eye = sym3.identity_like(cov[0])
    return sym3.pack(tuple(torch.where(enough, r, e) for r, e in zip(reg, eye)))


def estimate_covariances(cloud: Cloud, cfg: CovConfig, class_aware: bool = True,
                         num_classes: int | None = None):
    """(6, N_pad) regularized covariance planes; identity where a point
    has fewer than 3 neighbours or is padding. `cfg.method` picks the
    neighbourhood: "radius" (the moments kernels) or "knn" (knn_self)."""
    if cfg.method == "radius":
        return _estimate_radius(cloud, cfg, class_aware, num_classes)
    return _estimate_knn(cloud, cfg, class_aware)


def preprocess_cloud(cloud: Cloud, cfg, class_aware: bool = True) -> Cloud:
    """Fill `cloud.cov6` with GICP-regularized covariances.

    With a full `Config`, the cloud is first put in canonical class-major
    Morton layout (one sort shared by the moments kernel here and the
    nearest-neighbour kernel inside align). With a bare `CovConfig`,
    the layout is left as it is and the dense moments run over all pairs
    (kernel K5 on CUDA), as they do for `class_aware=False`. The sort and
    the covariances are the spans `preprocess.sort` and
    `preprocess.moments`.
    """
    num_classes = None
    if hasattr(cfg, "cov"):                  # full Config
        if cloud.layout != LAYOUT_CM:
            with span("preprocess.sort"):
                cloud = sort_cloud_cm(cloud, cfg.cloud.num_classes, cfg.corr.cell)
        num_classes = cfg.cloud.num_classes
        cfg = cfg.cov
    with span("preprocess.moments"):
        cov6 = estimate_covariances(cloud, cfg, class_aware, num_classes=num_classes)
    return cloud.replace(cov6=cov6)
