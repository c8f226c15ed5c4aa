"""Keyframe selection, storage, and semantic descriptors.

Port of `semicp/slam/keyframes.py`. The host owns this control plane:
keyframe decisions and store bookkeeping are numpy and Python; each
keyframe keeps its preprocessed cloud where it was made (the card, or the
CPU when asked).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from semicp_torch.cloud.cloud import Cloud
from semicp_torch.config import SLAMConfig
from semicp_torch.geom.se3 import se3_log


def keyframe_due(T_last_kf: np.ndarray, T_now: np.ndarray, cfg: SLAMConfig) -> bool:
    """Spawn a keyframe after enough motion since the last one: the motion
    composed in float64, its log taken in float32 on the CPU, as the JAX
    package takes it."""
    rel = np.linalg.inv(T_last_kf.astype(np.float64)) @ T_now.astype(np.float64)
    v = se3_log(torch.from_numpy(rel.astype(np.float32))).numpy()
    return bool(np.linalg.norm(v[:3]) > cfg.keyframe_trans
                or np.linalg.norm(v[3:]) > cfg.keyframe_rot)


def semantic_descriptor(labels: np.ndarray, num_classes: int,
                        xyz: np.ndarray | None = None) -> np.ndarray:
    """Loop-closure gating descriptor: normalized class histogram,
    optionally augmented with a coarse height histogram (4 bins)."""
    h = np.bincount(np.clip(labels, 0, num_classes - 1), minlength=num_classes
                    ).astype(np.float64)
    h /= max(h.sum(), 1.0)
    if xyz is not None:
        z = xyz[:, 2]
        zh, _ = np.histogram(z, bins=4, range=(-3.0, 9.0))
        zh = zh.astype(np.float64) / max(zh.sum(), 1.0)
        h = np.concatenate([h, 0.5 * zh])
    return h


@dataclass
class Keyframe:
    index: int               # keyframe id (pose-graph node id)
    frame: int               # source frame number
    pose: np.ndarray         # (4,4) world pose at creation (pre-PGO)
    cloud: Cloud             # preprocessed cloud (sensor frame)
    descriptor: np.ndarray


@dataclass
class KeyframeStore:
    keyframes: list[Keyframe] = field(default_factory=list)

    def add(self, frame: int, pose: np.ndarray, cloud: Cloud, desc: np.ndarray) -> Keyframe:
        kf = Keyframe(len(self.keyframes), frame, pose.copy(), cloud, desc)
        self.keyframes.append(kf)
        return kf

    def __len__(self):
        return len(self.keyframes)

    def __getitem__(self, i):
        return self.keyframes[i]
