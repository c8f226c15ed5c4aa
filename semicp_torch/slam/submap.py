"""Submaps: fused keyframe clouds for scan-to-map alignment.

Port of `semicp/slam/submap.py`. A submap concatenates the last
`submap_keyframes` keyframe clouds in the newest keyframe's frame,
voxel-downsamples them, subsamples to the cloud capacity with a fixed
seed, and preprocesses the result once with the full Config (kernel K1
on the card).

The points never leave their device (`submap_points`). The host composes
the keyframes' 4x4 transforms in float64 and uploads them in one copy,
reads the count the voxel grid keeps (the rebuild's one host read,
`data/kitti.py voxel_keep`), and uploads the seeded permutation, which
depends only on that count. `submap_points_plain` is the JAX package's
numpy fusion, kept as the plain version that chip_smoke.py holds the
device rebuild to; nothing on a run path calls it.
"""

from __future__ import annotations

import numpy as np
import torch

from semicp_torch.cloud import Cloud, cloud_from_tensors, preprocess_cloud
from semicp_torch.config import Config
from semicp_torch.data.kitti import voxel_downsample, voxel_keep


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on dev; to the card from pinned memory without a host
    wait (the work that reads it queues behind the copy)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t


def _subsample(count: int, n_pad: int):
    """The seeded subsample of `count` fused points to n_pad, or None where
    they fit: the JAX package's `default_rng(0).permutation`."""
    return np.random.default_rng(0).permutation(count)[:n_pad] if count > n_pad else None


def submap_points(keyframes, poses: np.ndarray, anchor_idx: int, voxel: float, n_pad: int):
    """The fused points of `keyframes` in the anchor keyframe's frame, on
    their clouds' device: (xyz (3, n) float32, label (n,) int32), n <= n_pad.
    Each keyframe's valid prefix (a preprocessed cloud keeps its valid
    points first) is moved by T_anchor^-1 T_kf in float64 and cast to
    float32, as the JAX package does on the host."""
    keyframes = list(keyframes)
    dev = keyframes[0].cloud.device
    T_anchor_inv = np.linalg.inv(poses[anchor_idx].astype(np.float64))
    T = _upload(np.stack([T_anchor_inv @ poses[kf.index].astype(np.float64)
                          for kf in keyframes]), dev)
    xyz, lab, valid = [], [], []
    for i, kf in enumerate(keyframes):
        c = kf.cloud
        xyz.append((T[i, :3, :3] @ c.xyz.to(torch.float64) + T[i, :3, 3:]).to(torch.float32))
        lab.append(c.label)
        valid.append(torch.arange(c.n_pad, device=dev) < c.count)
    xyz, lab = torch.cat(xyz, dim=1), torch.cat(lab)
    keep = voxel_keep(xyz, torch.cat(valid), voxel)
    sel = _subsample(keep.shape[0], n_pad)
    if sel is not None:
        keep = keep[_upload(sel, dev)]
    return xyz[:, keep], lab[keep]


def submap_points_plain(keyframes, poses: np.ndarray, anchor_idx: int, voxel: float,
                        n_pad: int):
    """`submap_points` as the JAX package computes it, in numpy: each
    keyframe's points read to the host, moved in float64, voxel-downsampled
    by `voxel_downsample`, subsampled. Returns (pts (n, 3) float32, labels
    (n,) int32)."""
    T_anchor_inv = np.linalg.inv(poses[anchor_idx].astype(np.float64))
    pts_all, lab_all = [], []
    for kf in keyframes:
        T = T_anchor_inv @ poses[kf.index].astype(np.float64)
        n = int(kf.cloud.count)
        pts = kf.cloud.xyz.cpu().numpy().T[:n].astype(np.float64)
        pts_all.append(pts @ T[:3, :3].T + T[:3, 3])
        lab_all.append(kf.cloud.label.cpu().numpy()[:n])
    pts = np.concatenate(pts_all).astype(np.float32)
    lab = np.concatenate(lab_all).astype(np.int32)
    if voxel > 0:
        pts, lab = voxel_downsample(pts, lab, voxel)
    sel = _subsample(len(pts), n_pad)
    return (pts, lab) if sel is None else (pts[sel], lab[sel])


def build_submap(keyframes, poses: np.ndarray, anchor_idx: int, cfg: Config,
                 voxel: float = 0.3, n_pad: int | None = None) -> Cloud:
    """Fuse keyframe clouds into the anchor keyframe's sensor frame.

    keyframes: a sequence of Keyframe, whose clouds share one device (the
    submap's); poses: (M,4,4) current keyframe poses; anchor_idx: the
    keyframe id whose frame the submap lives in.
    """
    n_pad = n_pad or cfg.cloud.n_pad
    xyz, lab = submap_points(keyframes, poses, anchor_idx, voxel, n_pad)
    # full Config: the class-major layout once per rebuild, so every align
    # against this submap skips its own sort
    return preprocess_cloud(cloud_from_tensors(xyz, lab, n_pad), cfg)
