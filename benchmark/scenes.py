"""Seeded KITTI-layout sequences: the benchmark's traffic generator.

A copy of the system's synthetic scene (`make_scene`: a ground plane, two
walls and clusters, labelled 1..n_classes), its odometry drive
(`make_trajectory`), its closed square loop (`run_slam.synthetic_loop_frames`)
and its range-gated scan (`render_scan`), as `chip_smoke.write_sequence`
writes them: `velodyne/*.bin` (N, 4) float32 with zero reflectance and
`labels/*.label` uint32 raw SemanticKITTI ids that the standard remap sends
back to the train ids. Three changes from the originals:

* everything is drawn from the run's seed;
* the scans are rendered in bulk with torch on the given device (a
  generator on that device), so set-up stays short;
* a drive longer than one scene tiles the plane with scene blocks around its
  path, so that every scan of a long session sees a full block around it
  (one block of the original is 60 m wide; a 100-frame drive is about 60 m);
* a scene may place its clusters on a grid (`"clusters": "grid"`): one
  cluster in each cell of a square grid over the original's area, jittered
  within its cell, the seed choosing which cluster goes to which cell. The
  original draws each centre anywhere in that area, so the number of clusters
  near a stretch of the drive, and with it how well a scan that sees walls of
  one direction only is held along them, changes from seed to seed; on the
  grid every seed draws the same structure near every scan.

Every scan has exactly `points_per_scan` points: a generator that cannot
fill one raises, so every seed runs the same sizes.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from benchmark import geom

# SemanticKITTI raw id -> train id (semantic-kitti-api's remap), as the
# system's loader applies it
SEMANTICKITTI_REMAP = {
    0: 0, 1: 0,
    10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5,
    30: 6, 31: 7, 32: 8,
    40: 9, 44: 10, 48: 11, 49: 12,
    50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17,
    80: 18, 81: 19, 99: 0,
    252: 1, 253: 7, 254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}


def raw_label_lut(n_train: int) -> np.ndarray:
    """(n_train,) uint32: the smallest raw id of each train id."""
    raw_of = {}
    for raw, train in sorted(SEMANTICKITTI_REMAP.items(), reverse=True):
        raw_of[train] = raw
    return np.array([raw_of[k] for k in range(n_train)], np.uint32)


@dataclass
class Sequence:
    points: np.ndarray   # (F, M, 3) float32, sensor frame
    labels: np.ndarray   # (F, M) int32 train ids
    poses: np.ndarray    # (F, 4, 4) float64 world-from-sensor ground truth


def _uniform(gen, shape, device, lo=-1.0, hi=1.0):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device, dtype=torch.float64)


def _normal(gen, shape, device):
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float64)


def _grid_centres(gen, n: int, extent: float, device):
    """(n, 2) cluster centres (x, y): one in each cell of a g x g grid
    (g = ceil(sqrt(n))) over [-0.6 extent, 0.6 extent]^2, jittered by up to a
    quarter cell, the cells dealt to the clusters in an order drawn from gen."""
    g = math.ceil(math.sqrt(n))
    cell = 1.2 * extent / g
    ij = torch.stack(torch.meshgrid(torch.arange(g, device=device), torch.arange(g, device=device),
                                    indexing="ij"), -1).reshape(-1, 2).to(torch.float64)
    ij = ij[torch.randperm(g * g, generator=gen, device=device)[:n]]
    return -0.6 * extent + cell * (ij + 0.5) + _uniform(gen, (n, 2), device) * (cell / 4)


def make_scene(gen, n_points: int, extent: float, n_classes: int, device, centre=(0.0, 0.0),
               clusters: str = "random"):
    """The system's `make_scene`, centred at `centre` (x, y): (n, 3) float64
    points and (n,) int64 labels in [1, n_classes]. `clusters` is "random"
    (the original's centres) or "grid" (`_grid_centres`)."""
    if clusters not in ("random", "grid"):
        raise ValueError(f"unknown cluster layout {clusters!r}")
    cx, cy = centre
    parts = []

    def plane(n, c, ext, axis, label):
        p = _uniform(gen, (n, 3), device) * torch.tensor(ext, dtype=torch.float64, device=device)
        p = p + torch.tensor(c, dtype=torch.float64, device=device)
        p[:, axis] = c[axis] + _normal(gen, (n,), device) * 0.02
        parts.append((p, torch.full((n,), label, dtype=torch.int64, device=device)))

    n_ground = n_points // 3
    plane(n_ground, (cx, cy, 0.0), (extent, extent, 1.0), 2, 1)
    n_wall = n_points // 4
    plane(n_wall, (cx + extent * 0.7, cy, 2.0), (1.0, extent, 2.0), 0, 2)
    plane(n_wall, (cx, cy + extent * 0.7, 2.0), (extent, 1.0, 2.0), 1, 3)
    remaining = n_points - n_ground - 2 * n_wall
    n_clusters = max(1, n_classes - 3)
    per = max(1, remaining // n_clusters)
    grid = _grid_centres(gen, n_clusters, extent, device) if clusters == "grid" else None
    for c in range(n_clusters):
        centre_c = _uniform(gen, (3,), device, -extent * 0.6, extent * 0.6)
        if grid is not None:
            centre_c[:2] = grid[c]
        centre_c[2] = centre_c[2].abs() * 0.2 + 1.0
        centre_c[0] += cx
        centre_c[1] += cy
        n_c = per if c < n_clusters - 1 else remaining - per * (n_clusters - 1)
        p = _normal(gen, (max(n_c, 1), 3), device) * 0.8 + centre_c
        parts.append((p, torch.full((len(p),), 4 + c % max(1, n_classes - 3),
                                    dtype=torch.int64, device=device)))
    xyz = torch.cat([p for p, _ in parts])
    lab = torch.cat([lbl for _, lbl in parts])
    perm = torch.randperm(len(xyz), generator=gen, device=device)[:n_points]
    return xyz[perm], lab[perm]


def drive_trajectory(rng: np.random.Generator, n_frames: int, step: float, turn: float):
    """The system's `make_trajectory`: forward motion with a gently swinging
    yaw and small noise, (F, 4, 4) float64."""
    poses = [torch.eye(4, dtype=torch.float64)]
    for i in range(1, n_frames):
        yaw = turn * math.sin(i * 0.1) + rng.normal() * turn * 0.1
        d = torch.tensor([step, rng.normal() * 0.01, rng.normal() * 0.005,
                          rng.normal() * 0.002, rng.normal() * 0.002, yaw], dtype=torch.float64)
        poses.append(poses[-1] @ geom.exp(d))
    return torch.stack(poses).numpy()


def loop_trajectory(n_frames: int, step: float):
    """`run_slam.synthetic_loop_frames`' closed square: four sides of
    n_frames // 4 frames, each 90-degree corner spread over its last
    max(3, side // 3) frames, (F, 4, 4) float64."""
    side = n_frames // 4
    turn_frames = max(3, side // 3)
    poses = [torch.eye(4, dtype=torch.float64)]
    for i in range(1, n_frames):
        turn = (math.pi / 2) / turn_frames if (i % side) >= side - turn_frames else 0.0
        d = torch.tensor([step, 0, 0, 0, 0, turn], dtype=torch.float64)
        poses.append(poses[-1] @ geom.exp(d))
    return torch.stack(poses).numpy()


def _block_centres(poses: np.ndarray, extent: float, reach: float):
    """Centres of the scene blocks (pitch 2 extent, one at the origin) that
    come within `reach` of the path."""
    xy = poses[:, :2, 3]
    lo, hi = xy.min(0) - reach, xy.max(0) + reach
    pitch = 2.0 * extent
    ix = range(int(math.floor((lo[0] + extent) / pitch)), int(math.floor((hi[0] + extent) / pitch)) + 1)
    iy = range(int(math.floor((lo[1] + extent) / pitch)), int(math.floor((hi[1] + extent) / pitch)) + 1)
    return [(i * pitch, j * pitch) for i in ix for j in iy]


def render(gen, scene, labels, poses: np.ndarray, max_range: float, n_points: int,
           noise: float, chunk: int = 8):
    """Scans of the scene from each pose: points in the sensor frame within
    max_range, a uniform draw of exactly n_points of them, plus noise.
    Returns (F, n_points, 3) float32 and (F, n_points) int64, on the device."""
    dev = scene.device
    T = torch.from_numpy(poses).to(dev)
    out_p, out_l = [], []
    for s in range(0, len(poses), chunk):
        R, t = T[s:s + chunk, :3, :3], T[s:s + chunk, :3, 3]
        local = torch.einsum("sk,fkj->fsj", scene, R) - torch.einsum("fk,fkj->fj", t, R)[:, None]
        inside = torch.linalg.vector_norm(local, dim=-1) < max_range
        keys = torch.rand(inside.shape, generator=gen, device=dev, dtype=torch.float64)
        keys = torch.where(inside, keys, torch.full_like(keys, 2.0))
        kept, idx = torch.topk(keys, min(n_points, keys.shape[1]), dim=1, largest=False)
        if idx.shape[1] < n_points or bool((kept >= 1.0).any()):
            short = int(inside.sum(1).min())
            raise ValueError(f"a scan holds {short} points within {max_range} m, fewer than "
                             f"the {n_points} the configuration asks for")
        pts = torch.gather(local, 1, idx[..., None].expand(-1, -1, 3))
        pts = pts + _normal(gen, pts.shape, dev) * noise
        out_p.append(pts.to(torch.float32))
        out_l.append(labels[idx])
    return torch.cat(out_p), torch.cat(out_l)


def make_sequence(spec: dict, seed: int, device="cpu") -> Sequence:
    """The sequence that the configuration's `sequence` section describes,
    from `seed`."""
    seed = int(seed)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    traj = spec["trajectory"]
    if traj["kind"] == "drive":
        poses = drive_trajectory(rng, spec["frames"], traj["step"], traj["turn"])
    elif traj["kind"] == "loop":
        poses = loop_trajectory(spec["frames"], traj["step"])
    else:
        raise ValueError(f"unknown trajectory kind {traj['kind']!r}")
    sc = spec["scene"]
    centres = _block_centres(poses, sc["extent"], spec["max_range"]) if sc["tiled"] else [(0.0, 0.0)]
    blocks = [make_scene(gen, sc["points"], sc["extent"], spec["classes"], device, c,
                         sc.get("clusters", "random"))
              for c in centres]
    scene = torch.cat([b[0] for b in blocks])
    labels = torch.cat([b[1] for b in blocks])
    pts, lab = render(gen, scene, labels, poses, spec["max_range"], spec["points_per_scan"],
                      spec["noise"])
    return Sequence(points=pts.cpu().numpy(), labels=lab.to(torch.int32).cpu().numpy(),
                    poses=poses)


def _write(path: Path, data: np.ndarray) -> None:
    with open(path, "wb") as fh:
        data.tofile(fh)
        fh.flush()
        os.fsync(fh.fileno())


def write_sequence(seq: Sequence, root: Path, n_train: int) -> Path:
    """KITTI layout under root: velodyne/%06d.bin and labels/%06d.label.
    Every file is on disk when this returns (fsync), so that the kernel's
    write-back of the sequence does not fall into the measured window."""
    root = Path(root)
    (root / "velodyne").mkdir(parents=True, exist_ok=True)
    (root / "labels").mkdir(exist_ok=True)
    lut = raw_label_lut(n_train)
    arr = np.zeros(seq.points.shape[1:2] + (4,), np.float32)
    for i in range(len(seq.points)):
        arr[:, :3] = seq.points[i]
        _write(root / "velodyne" / f"{i:06d}.bin", arr)
        _write(root / "labels" / f"{i:06d}.label", lut[seq.labels[i]])
    for d in (root / "velodyne", root / "labels", root):
        fd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    return root
