"""NDT baseline — voxel-Gaussian registration on the EM core.

Port of `semicp/register/ndt.py`. Like the GICP ablation this is a
configuration of the EM/GN core, not a second engine:

  1. The target is compressed into voxel Gaussians: points are sorted by
     Morton voxel code (and class, when semantic), segment-reduced into
     per-voxel (count, mean, covariance) with `index_add_`, and each
     covariance keeps its shape with Magnusson's eigenvalue floor
     (lambda_i >= ratio * lambda_max) but is rescaled to lambda_max = 1,
     the unit scale of the GICP covariances the EM weights expect.
  2. Source covariances collapse to ~0 (point-to-distribution), or stay
     GICP-estimated for the distribution-to-distribution variant (d2d).
  3. `align()` runs as usual: each moved source point associates to its
     nearest voxel Gaussian within the gate (K2/K4 on CUDA), and the
     M-step minimizes the weighted Mahalanobis cost.

Classic NDT ignores labels (every class collapses to 0, uniform
semantics); `semantic=True` keeps (class, voxel) as the aggregation key
and the confusion-model weights.

The voxel Gaussians keep the cloud's capacity with `valid` scattered
(segment i is slot i), not packed at the front. Against the JAX package:
one stable sort on the int64 key (class << 31) | code replaces its two
stable argsorts (the same permutation), a stable sort of the codes
replaces its unstable one (the same segments), and the segment sums
differ from its `segment_sum` only by f32 rounding.
"""

from __future__ import annotations

import dataclasses

import torch

from semicp_torch.cloud.cloud import FAR, Cloud
from semicp_torch.config import Config
from semicp_torch.corr.morton import morton_codes
from semicp_torch.geom import sym3
from semicp_torch.geom.eig3 import eigh3x3
from semicp_torch.register.em_icp import AlignResult, align


def _voxel_segments(xyz, label, valid, voxel: float, semantic: bool):
    """Sort by (class?, voxel code); return (order, segment start mask,
    sorted labels, sorted valid)."""
    code = morton_codes(xyz, valid, voxel)
    lab0 = torch.clamp(label, min=0)
    if semantic:
        cls = torch.where(valid, lab0, torch.full_like(lab0, 1 << 30))
        order = torch.sort((cls.to(torch.int64) << 31) | code.to(torch.int64), stable=True).indices
    else:
        order = torch.sort(code, stable=True).indices
    code_s, lab_s, val_s = code[order], lab0[order], valid[order]
    start = torch.ones_like(val_s)
    start[1:] = code_s[1:] != code_s[:-1]
    if semantic:
        start[1:] |= lab_s[1:] != lab_s[:-1]
    return order, start, lab_s, val_s


def _build_ndt_arrays(xyz, label, valid, voxel: float, min_points: int, eig_ratio: float,
                      semantic: bool):
    n = xyz.shape[1]
    order, start, lab_s, val_s = _voxel_segments(xyz, label, valid, voxel, semantic)
    x, y, z = xyz[:, order]
    seg = torch.cumsum(start.to(torch.int64), 0) - 1               # (N,)
    w = val_s.to(torch.float32)
    mom = torch.stack([w, w * x, w * y, w * z, w * x * x, w * y * y, w * z * z,
                       w * x * y, w * x * z, w * y * z])           # (10, N)
    table = torch.zeros_like(mom).index_add_(1, seg, mom)
    cnt = table[0]
    safe = torch.clamp(cnt, min=1.0)
    mean = table[1:4] / safe[None, :]                              # (3, V)
    cov6 = (table[4] / safe - mean[0] * mean[0], table[5] / safe - mean[1] * mean[1],
            table[6] / safe - mean[2] * mean[2], table[7] / safe - mean[0] * mean[1],
            table[8] / safe - mean[0] * mean[2], table[9] / safe - mean[1] * mean[2])
    wv, V = eigh3x3(sym3.to_matrix(cov6))                          # (V,3), (V,3,3)
    lmax = torch.clamp(wv[..., :1], min=1e-9)
    wc = torch.clamp(wv / lmax, eig_ratio, 1.0)
    creg = torch.einsum("vik,vk,vjk->vij", V, wc, V)
    cov6_r = sym3.pack(sym3.from_matrix(creg))                     # (6, V)
    # a semantic segment is single-label; a plain one may mix labels and
    # collapses to 0
    vox_lab = torch.zeros(n, dtype=torch.int32, device=xyz.device)
    if semantic:
        vox_lab = vox_lab.scatter_reduce(0, seg, torch.where(val_s, lab_s, 0).to(torch.int32),
                                         "amax", include_self=False)
    vox_valid = cnt >= min_points
    vox_xyz = torch.where(vox_valid[None, :], mean, torch.full_like(mean, FAR))
    return vox_xyz, vox_lab, cov6_r, vox_valid, torch.sum(vox_valid.to(torch.int32))


def build_ndt_cloud(tgt: Cloud, voxel: float = 1.0, min_points: int = 5,
                    eig_ratio: float = 0.01, semantic: bool = False) -> Cloud:
    """Compress a cloud into voxel Gaussians (same padded capacity)."""
    xyz, lab, cov6, valid, count = _build_ndt_arrays(
        tgt.xyz, tgt.label, tgt.valid, voxel, min_points, eig_ratio, semantic)
    return Cloud(xyz=xyz, label=torch.where(valid, lab, torch.full_like(lab, -1)),
                 cov6=cov6, valid=valid, count=count)


def align_ndt(src: Cloud, tgt: Cloud, cfg: Config | None = None, T_init=None,
              voxel: float = 1.0, semantic: bool = False, d2d: bool = False) -> AlignResult:
    """NDT registration: src points against tgt's voxel Gaussians.

    src may be raw (point-to-distribution ignores its covariances) unless
    d2d=True, where its preprocessed GICP covariances are kept. The
    correspondence gate should exceed the voxel diagonal; the default
    gate (2 m) covers voxel <= 1.15 m.
    """
    cfg = cfg or Config()
    cfg = dataclasses.replace(cfg, em=dataclasses.replace(cfg.em, uniform_semantics=not semantic))
    tgt_ndt = build_ndt_cloud(tgt, voxel=voxel, semantic=semantic)
    src_nd = src
    if not d2d:
        # point-to-distribution: the combined covariance is the voxel's
        src_nd = src.replace(cov6=sym3.pack(sym3.identity_like(src.xyz[0], scale=1e-6)))
    if not semantic:
        src_nd = src_nd.replace(label=torch.where(src_nd.valid, torch.zeros_like(src_nd.label),
                                                  torch.full_like(src_nd.label, -1)))
    return align(src_nd, tgt_ndt, cfg, T_init)
