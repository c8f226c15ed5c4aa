"""KITTI / SemanticKITTI ingestion — direct binary parsing, no PCD step.

Port of `semicp/data/kitti.py`, host-side numpy and unchanged, so both
packages read a sequence into the same arrays to the bit. `voxel_keep`
is `voxel_downsample`'s selection on device tensors (the submap rebuild,
slam/submap.py).

Formats:
  velodyne .bin : float32 little-endian, N x (x, y, z, reflectance)
  .label        : uint32 little-endian per point; low 16 bits = semantic
                  class id, high 16 bits = instance id
  poses.txt     : one line per frame, 12 floats = row-major 3x4 [R|t]
  calib.txt     : "Tr: r11 r12 ... t3" velodyne->camera extrinsic
"""

from __future__ import annotations

import numpy as np
import torch

# SemanticKITTI raw label id -> train id (0 = unlabeled/ignored, 1..19 =
# the standard 19 train classes; moving classes fold onto their static
# counterparts). This is the community-standard remap from the
# semantic-kitti-api config.
SEMANTICKITTI_REMAP: dict[int, int] = {
    0: 0, 1: 0,
    10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5,
    30: 6, 31: 7, 32: 8,
    40: 9, 44: 10, 48: 11, 49: 12,
    50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17,
    80: 18, 81: 19, 99: 0,
    252: 1, 253: 7, 254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}

_REMAP_LUT = np.zeros(1 << 16, dtype=np.int32)
for _raw, _train in SEMANTICKITTI_REMAP.items():
    _REMAP_LUT[_raw] = _train


def load_velodyne_bin(path) -> np.ndarray:
    """Load a KITTI velodyne scan: (N, 4) float32 [x, y, z, reflectance]."""
    raw = np.fromfile(path, dtype=np.float32)
    if raw.size % 4 != 0:
        raise ValueError(f"{path}: size {raw.size} not divisible by 4")
    return raw.reshape(-1, 4)


def load_semantickitti_labels(path) -> tuple[np.ndarray, np.ndarray]:
    """Load a .label file -> (semantic (N,) int32 raw ids, instance (N,) int32)."""
    raw = np.fromfile(path, dtype=np.uint32)
    sem = (raw & 0xFFFF).astype(np.int32)
    inst = (raw >> 16).astype(np.int32)
    return sem, inst


def remap_semantickitti(raw_labels: np.ndarray) -> np.ndarray:
    """Raw SemanticKITTI ids -> train ids 0..19 (0 = ignore)."""
    return _REMAP_LUT[np.clip(raw_labels, 0, (1 << 16) - 1)]


def load_kitti_poses(path) -> np.ndarray:
    """poses.txt -> (N, 4, 4) float64 homogeneous transforms."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    n = rows.shape[0]
    out = np.tile(np.eye(4), (n, 1, 1))
    out[:, :3, :] = rows
    return out


def save_kitti_poses(path, poses: np.ndarray) -> None:
    """(N, 4, 4) -> KITTI 3x4 row-major text, one line per frame.

    Matches the reference odometry driver's output format (SURVEY.md
    §2.1 row "Sequence odometry driver") so external eval tools work.
    """
    flat = np.asarray(poses)[:, :3, :].reshape(len(poses), 12)
    np.savetxt(path, flat, fmt="%.9e")


def load_kitti_calib(path) -> np.ndarray:
    """Parse calib.txt; return the 4x4 'Tr' velodyne->camera transform.

    Falls back to identity when no Tr line is present (pure-velodyne
    evaluation).
    """
    tr = np.eye(4)
    with open(path) as f:
        for line in f:
            if line.startswith("Tr"):
                vals = np.fromstring(line.split(":", 1)[1], sep=" ")
                tr[:3, :] = vals.reshape(3, 4)
                break
    return tr


def voxel_downsample(
    xyz: np.ndarray, labels: np.ndarray | None, voxel: float
) -> tuple[np.ndarray, np.ndarray | None]:
    """Host-side voxel-grid downsample keeping one (first) point per cell.

    Keeping a representative point (not the centroid) preserves label
    integrity; the reference pipeline achieves density control the same
    way before registration [C:med].
    """
    if voxel <= 0:
        return xyz, labels
    cells = np.floor(xyz / voxel).astype(np.int64)
    # Unique by composite key, keep first occurrence
    key = (cells[:, 0] * 73856093) ^ (cells[:, 1] * 19349663) ^ (cells[:, 2] * 83492791)
    _, keep = np.unique(key, return_index=True)
    keep.sort()
    return xyz[keep], (labels[keep] if labels is not None else None)


def voxel_keep(xyz: torch.Tensor, valid: torch.Tensor, voxel: float) -> torch.Tensor:
    """`voxel_downsample`'s selection on the device: the columns of xyz
    (3, N) float32 that it keeps of the valid ones, ascending. That is the
    first valid column of each cell, by the same key (floor(xyz / voxel)
    in float32, the XOR of the cells' products), or every valid column
    where voxel <= 0. A stable sort by key, then by validity, puts each
    cell's first valid column at the head of its run, as numpy's
    `unique(return_index=True)` (a stable sort) does; the heads, sorted,
    are `keep.sort()`. One host read: the count kept."""
    n, dev = xyz.shape[1], xyz.device
    if voxel > 0:
        # true division by a float32 on the device, as numpy divides: by a
        # host scalar the card multiplies by its reciprocal
        cells = torch.floor(xyz / torch.full((), voxel, dtype=torch.float32, device=dev))
        cells = cells.to(torch.int64)
        key = (cells[0] * 73856093) ^ (cells[1] * 19349663) ^ (cells[2] * 83492791)
        order = torch.sort(key, stable=True).indices
        order = order[torch.sort((~valid[order]).to(torch.uint8), stable=True).indices]
        ks = key[order]
        head = valid[order]
        head[1:] &= ks[1:] != ks[:-1]
    else:
        order, head = torch.arange(n, device=dev), valid
    kept = torch.sort(torch.where(head, order, n)).values
    return kept[:int(torch.sum(head))]
