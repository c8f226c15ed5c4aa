"""Submaps: fused keyframe clouds for scan-to-map alignment.

Port of `semicp/slam/submap.py`. A submap concatenates the last
`submap_keyframes` keyframe clouds in the newest keyframe's frame,
voxel-downsamples them on the host, subsamples to the cloud capacity
with a fixed seed, and preprocesses the result once with the full
Config (kernel K1 on the card). Each rebuild reads the keyframes' points
to the host in one device-to-host copy.
"""

from __future__ import annotations

import numpy as np
import torch

from semicp_torch.cloud import Cloud, make_cloud, preprocess_cloud
from semicp_torch.config import Config
from semicp_torch.data.kitti import voxel_downsample


def build_submap(keyframes, poses: np.ndarray, anchor_idx: int, cfg: Config,
                 voxel: float = 0.3, n_pad: int | None = None) -> Cloud:
    """Fuse keyframe clouds into the anchor keyframe's sensor frame.

    keyframes: a sequence of Keyframe, whose clouds share one device (the
    submap's); poses: (M,4,4) current keyframe poses; anchor_idx: the
    keyframe id whose frame the submap lives in.
    """
    keyframes = list(keyframes)
    dev = keyframes[0].cloud.device
    # per keyframe: xyz (3, n_pad), labels and the count, as f32 (exact
    # for labels and counts below 2^24), all in one copy
    flat = torch.cat([torch.cat([kf.cloud.xyz.reshape(-1), kf.cloud.label.to(torch.float32),
                                 kf.cloud.count.to(torch.float32).reshape(1)])
                      for kf in keyframes]).cpu().numpy()
    T_anchor_inv = np.linalg.inv(poses[anchor_idx].astype(np.float64))
    pts_all, lab_all, at = [], [], 0
    for kf in keyframes:
        m = kf.cloud.n_pad
        xyz = flat[at:at + 3 * m].reshape(3, m)
        lab = flat[at + 3 * m:at + 4 * m].astype(np.int32)
        n = int(flat[at + 4 * m])
        at += 4 * m + 1
        T = T_anchor_inv @ poses[kf.index].astype(np.float64)
        # a preprocessed cloud keeps its valid points first
        pts = xyz.T[:n].astype(np.float64)
        pts_all.append(pts @ T[:3, :3].T + T[:3, 3])
        lab_all.append(lab[:n])
    pts = np.concatenate(pts_all).astype(np.float32)
    lab = np.concatenate(lab_all).astype(np.int32)
    if voxel > 0:
        pts, lab = voxel_downsample(pts, lab, voxel)
    n_pad = n_pad or cfg.cloud.n_pad
    if len(pts) > n_pad:
        sel = np.random.default_rng(0).permutation(len(pts))[:n_pad]
        pts, lab = pts[sel], lab[sel]
    # full Config: the class-major layout once per rebuild, so every align
    # against this submap skips its own sort
    return preprocess_cloud(make_cloud(pts, lab, n_pad=n_pad, device=dev), cfg)
