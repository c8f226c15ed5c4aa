"""Synthetic labelled scenes, registration pairs and scan sequences, in numpy.

Port of `semicp/data/synthetic.py`. From the same `np.random.Generator`
(or seed) every function draws the same numbers in the same order as the
JAX package, so scenes are equal to the bit; what passes through an
SE(3) exponential (T_gt of `make_pair`, the poses of `make_trajectory`
and the scans rendered from them) uses this package's f32 `se3_exp`,
equal to the JAX one to f32 rounding. `corridor_scene` is the corridor
of the JAX package's tests (tests/test_register.py) and ablation script.
"""

from __future__ import annotations

import numpy as np
import torch

from semicp_torch.geom.se3 import se3_exp


def _plane(rng, n, center, extent, normal_axis, label, thickness=0.02):
    pts = rng.uniform(-1.0, 1.0, size=(n, 3)) * extent + center
    pts[:, normal_axis] = center[normal_axis] + rng.normal(size=n) * thickness
    return pts, np.full(n, label, np.int32)


def _cluster(rng, n, center, scale, label):
    pts = rng.normal(size=(n, 3)) * scale + center
    return pts, np.full(n, label, np.int32)


def make_scene(rng, n_points: int = 4096, extent: float = 20.0, n_classes: int = 6):
    """Structured labelled scene: ground plane, two walls, clusters.

    Returns (xyz (N,3) float32, labels (N,) int32) with labels in
    [1, n_classes] (0 is reserved for unlabelled, as in SemanticKITTI).
    """
    parts = []
    n_ground = n_points // 3
    parts.append(_plane(rng, n_ground, np.array([0.0, 0.0, 0.0]),
                        np.array([extent, extent, 1.0]), 2, 1))
    n_wall = n_points // 4
    parts.append(_plane(rng, n_wall, np.array([extent * 0.7, 0.0, 2.0]),
                        np.array([1.0, extent, 2.0]), 0, 2))
    parts.append(_plane(rng, n_wall, np.array([0.0, extent * 0.7, 2.0]),
                        np.array([extent, 1.0, 2.0]), 1, 3))
    remaining = n_points - n_ground - 2 * n_wall
    n_clusters = max(1, n_classes - 3)
    per = max(1, remaining // n_clusters)
    for c in range(n_clusters):
        center = rng.uniform(-extent * 0.6, extent * 0.6, size=3)
        center[2] = abs(center[2]) * 0.2 + 1.0
        n_c = per if c < n_clusters - 1 else remaining - per * (n_clusters - 1)
        parts.append(_cluster(rng, max(n_c, 1), center, 0.8, 4 + (c % max(1, n_classes - 3))))
    xyz = np.concatenate([p[0] for p in parts]).astype(np.float32)
    lab = np.concatenate([p[1] for p in parts])
    perm = rng.permutation(len(xyz))[:n_points]
    return xyz[perm], lab[perm]


def corridor_scene(rng, n: int):
    """Ground and two walls, all parallel to x: translation-invariant along
    x, so the only x information is the label boundary at x = 0. Labels
    encode the surface and its side of x = 0 (6 classes). 2n points."""
    g = np.stack([rng.uniform(-10, 10, n), rng.uniform(-4, 4, n),
                  rng.normal(n) * 0 + rng.normal(size=n) * 0.01], -1)
    w1 = np.stack([rng.uniform(-10, 10, n // 2), np.full(n // 2, -4.0)
                   + rng.normal(size=n // 2) * 0.01, rng.uniform(0, 3, n // 2)], -1)
    w2 = np.stack([rng.uniform(-10, 10, n // 2), np.full(n // 2, 4.0)
                   + rng.normal(size=n // 2) * 0.01, rng.uniform(0, 3, n // 2)], -1)
    xyz = np.concatenate([g, w1, w2]).astype(np.float32)
    surf = np.concatenate([np.zeros(n), np.ones(n // 2), np.full(n // 2, 2)])
    lab = (surf * 2 + (xyz[:, 0] > 0)).astype(np.int32)
    return xyz, lab


def make_pair(rng, scene_xyz: np.ndarray, scene_lab: np.ndarray, delta: np.ndarray,
              noise: float = 0.02, label_flip: float = 0.0, dropout: float = 0.1,
              n_classes: int = 6):
    """Build a (source, source labels, T_gt) registration pair from a scene.

    Target = the scene. Source = a random subset of it moved by T_gt^-1
    (aligning source onto target recovers T_gt), plus sensor noise and
    optional label corruption (labels drawn from [0, n_classes)).
    """
    T_gt = se3_exp(torch.as_tensor(np.asarray(delta), dtype=torch.float32)).numpy().astype(np.float64)
    keep = rng.uniform(size=len(scene_xyz)) > dropout
    src = scene_xyz[keep].astype(np.float64)
    lab = scene_lab[keep].copy()
    Tinv = np.linalg.inv(T_gt)
    src = src @ Tinv[:3, :3].T + Tinv[:3, 3]
    src = src + rng.normal(size=src.shape) * noise
    if label_flip > 0:
        flip = rng.uniform(size=len(lab)) < label_flip
        lab[flip] = rng.integers(0, n_classes, size=flip.sum())
    return src.astype(np.float32), lab.astype(np.int32), T_gt.astype(np.float32)


def make_trajectory(n_frames: int, step: float = 1.0, turn: float = 0.02, seed: int = 0):
    """Smooth SE(3) trajectory (N,4,4) float32: forward motion with gentle
    yaw, the odometry tests' ground truth."""
    rng = np.random.default_rng(seed)
    poses = [np.eye(4, dtype=np.float32)]
    for i in range(1, n_frames):
        yaw = turn * np.sin(i * 0.1) + rng.normal() * turn * 0.1
        d = np.array([step, rng.normal() * 0.01, rng.normal() * 0.005,
                      rng.normal() * 0.002, rng.normal() * 0.002, yaw], np.float32)
        rel = se3_exp(torch.from_numpy(d)).numpy()
        poses.append(poses[-1] @ rel)
    return np.stack(poses)


def render_scan(rng, scene_xyz: np.ndarray, scene_lab: np.ndarray, pose: np.ndarray,
                max_range: float = 25.0, noise: float = 0.02, max_points: int | None = None):
    """Simulate a scan of the scene from a world pose: points in the
    sensor frame, range-gated, at most `max_points`, with additive noise."""
    Tinv = np.linalg.inv(pose.astype(np.float64))
    local = scene_xyz @ Tinv[:3, :3].T + Tinv[:3, 3]
    r = np.linalg.norm(local, axis=-1)
    keep = r < max_range
    local, lab = local[keep], scene_lab[keep]
    if max_points is not None and len(local) > max_points:
        sel = rng.permutation(len(local))[:max_points]
        local, lab = local[sel], lab[sel]
    local = local + rng.normal(size=local.shape) * noise
    return local.astype(np.float32), lab.astype(np.int32)
