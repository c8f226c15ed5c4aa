"""Shared CLI plumbing: the device, scan loading (KITTI, PCD), run dirs.

Port of `semicp/cli/common.py`. `setup_device` takes the place of
`setup_jax`: the drivers run where `--device` says and nowhere else. On
CUDA it builds (or loads) the kernel library before the first timed
phase, so the nvcc build is never timed as an align.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from semicp_torch import kernels
from semicp_torch.cloud import Cloud, make_cloud, preprocess_cloud
from semicp_torch.config import Config
from semicp_torch.data import (
    load_semantickitti_labels,
    load_velodyne_bin,
    remap_semantickitti,
)
from semicp_torch.data.kitti import voxel_downsample
from semicp_torch.utils.metrics import span


def setup_device(name: str) -> torch.device:
    """The torch device a driver runs on; raises for CUDA without a card.

    Nothing falls back to the CPU: pass `--device cpu` to run there.
    """
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {name}: no CUDA device (torch.cuda.is_available() "
                               "is false); pass --device cpu to run on the CPU")
        kernels.library()
    return dev


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def load_scan_np(bin_path, label_path=None, voxel: float = 0.0):
    """Load one scan (+ optional SemanticKITTI labels) as numpy.

    Dispatches on extension: `.pcd` files (optionally with an embedded
    XYZL label field) go through data/pcd.py; KITTI `.bin` scans use the
    native C++ loader (data/native) when it builds, the numpy loaders of
    data/kitti.py otherwise. Host code only.
    """
    from semicp_torch.data import native
    from semicp_torch.data.kitti import _REMAP_LUT

    if Path(bin_path).suffix.lower() == ".pcd":
        from semicp_torch.data.pcd import load_pcd

        pts, lab = load_pcd(bin_path)
        if label_path is not None:
            raw, _ = load_semantickitti_labels(label_path)
            lab = remap_semantickitti(raw)
            if len(lab) != len(pts):
                raise ValueError(f"scan/label length mismatch: {len(pts)} vs {len(lab)}")
        elif lab is None:
            lab = np.zeros(len(pts), np.int32)
        if voxel > 0:
            pts, lab = voxel_downsample(pts, lab, voxel)
        return pts.astype(np.float32), lab.astype(np.int32)

    if native.native_available():
        xyz, _ = native.load_bin_planar(bin_path)
        n = xyz.shape[1]
        if label_path is not None:
            lab = native.load_labels_remapped(label_path, _REMAP_LUT, n)
            if len(lab) != n:
                raise ValueError(f"scan/label length mismatch: {n} vs {len(lab)}")
        else:
            lab = np.zeros(n, np.int32)
        if voxel > 0:
            xyz, lab = native.voxel_downsample_planar(xyz, lab, voxel)
        return xyz.T.copy(), lab

    pts = load_velodyne_bin(bin_path)[:, :3]
    if label_path is not None:
        raw, _ = load_semantickitti_labels(label_path)
        lab = remap_semantickitti(raw)
        if len(lab) != len(pts):
            raise ValueError(f"scan/label length mismatch: {len(pts)} vs {len(lab)}")
    else:
        lab = np.zeros(len(pts), np.int32)
    if voxel > 0:
        pts, lab = voxel_downsample(pts, lab, voxel)
    return pts.astype(np.float32), lab.astype(np.int32)


def to_device_cloud(pts, lab, cfg: Config, device) -> Cloud:
    """Pad, upload to `device` and preprocess a scan with the FULL config.

    The full config puts the cloud in canonical class-major Morton layout,
    which selects the sparse moments (K1 on CUDA) here and lets align skip
    its own sort. Labels are checked against cfg.cloud.num_classes on the
    host first: `.pcd` XYZL files carry arbitrary uint32 labels, and an
    out-of-range label would corrupt the per-tile class ranges. The
    upload is the span `preprocess.upload`.
    """
    lab = np.asarray(lab)
    if lab.size and int(lab.max()) >= cfg.cloud.num_classes:
        raise ValueError(
            f"label {int(lab.max())} >= cloud.num_classes={cfg.cloud.num_classes}; "
            "remap labels into [0, K) first (raw un-remapped SemanticKITTI ids in a "
            ".pcd file?)")
    # handed on, not held here: preprocess_cloud frees the unsorted cloud
    # once it has sorted it
    return preprocess_cloud(_upload(pts, lab, cfg, device), cfg)


def _upload(pts, lab, cfg: Config, device) -> Cloud:
    with span("preprocess.upload"):
        return make_cloud(pts, lab, n_pad=cfg.cloud.n_pad, device=device)


def sequence_frames(seq_dir: str | Path):
    """List (bin, label|None) pairs for a KITTI sequence directory layout:
    <seq>/velodyne/*.bin and optional <seq>/labels/*.label."""
    seq = Path(seq_dir)
    bins = sorted((seq / "velodyne").glob("*.bin"))
    labels_dir = seq / "labels"
    out = []
    for b in bins:
        lbl = labels_dir / (b.stem + ".label")
        out.append((b, lbl if lbl.exists() else None))
    return out


def init_run_dir(path: str | Path | None, cfg: Config):
    """Create a run directory with the serialized config (reproducibility)."""
    if path is None:
        return None
    run = Path(path)
    run.mkdir(parents=True, exist_ok=True)
    (run / "config.json").write_text(cfg.to_json())
    return run


def pose_to_json(T) -> list:
    return np.asarray(T, np.float64).reshape(-1).tolist()


def print_result(tag: str, result_dict: dict):
    print(json.dumps({"tag": tag, **result_dict}))
