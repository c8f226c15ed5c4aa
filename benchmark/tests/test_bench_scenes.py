"""The traffic generator: the same seed gives the same files, another seed
others; every scan has the configured size; labels are raw SemanticKITTI
ids that the standard remap sends back to the scene's train ids."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest

from benchmark import scenes

SPECS = {
    "drive": {"frames": 5, "points_per_scan": 1500, "classes": 19, "max_range": 8.0,
              "noise": 0.02, "scene": {"points": 8000, "extent": 10.0, "tiled": True},
              "trajectory": {"kind": "drive", "step": 0.6, "turn": 0.05}},
    "drive-grid": {"frames": 5, "points_per_scan": 1500, "classes": 19, "max_range": 8.0,
                   "noise": 0.02,
                   "scene": {"points": 8000, "extent": 10.0, "tiled": True, "clusters": "grid"},
                   "trajectory": {"kind": "drive", "step": 0.6, "turn": 0.05}},
    "loop": {"frames": 8, "points_per_scan": 1500, "classes": 19, "max_range": 8.0,
             "noise": 0.02, "scene": {"points": 8000, "extent": 10.0, "tiled": False},
             "trajectory": {"kind": "loop", "step": 0.4}},
}


def digest(spec, seed, tmp_path, tag):
    seq = scenes.make_sequence(spec, seed, "cpu")
    root = scenes.write_sequence(seq, tmp_path / tag, spec["classes"] + 1)
    h = hashlib.sha256()
    for p in sorted(root.rglob("*")):
        if p.is_file():
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest(), seq, root


@pytest.mark.parametrize("kind", sorted(SPECS))
def test_same_seed_same_files(kind, tmp_path):
    a, _, _ = digest(SPECS[kind], 2**31 + 17, tmp_path, "a")
    b, _, _ = digest(SPECS[kind], 2**31 + 17, tmp_path, "b")
    assert a == b


@pytest.mark.parametrize("kind", sorted(SPECS))
def test_other_seed_other_files(kind, tmp_path):
    a, _, _ = digest(SPECS[kind], 5, tmp_path, "a")
    b, _, _ = digest(SPECS[kind], 6, tmp_path, "b")
    assert a != b


@pytest.mark.parametrize("kind", sorted(SPECS))
def test_scan_layout(kind, tmp_path):
    spec = SPECS[kind]
    _, seq, root = digest(spec, 9, tmp_path, "a")
    lut = np.zeros(1 << 16, np.int64)
    for raw, train in scenes.SEMANTICKITTI_REMAP.items():
        lut[raw] = train
    bins = sorted((root / "velodyne").glob("*.bin"))
    assert len(bins) == spec["frames"]
    for i, b in enumerate(bins):
        pts = np.fromfile(b, np.float32).reshape(-1, 4)
        raw = np.fromfile(root / "labels" / f"{b.stem}.label", np.uint32)
        assert pts.shape == (spec["points_per_scan"], 4) and not pts[:, 3].any()
        assert np.array_equal(pts[:, :3], seq.points[i])
        train = lut[raw]
        assert np.array_equal(train, seq.labels[i])
        assert train.min() >= 1 and train.max() <= spec["classes"]
        assert np.linalg.norm(pts[:, :3], axis=1).max() < spec["max_range"] + 0.2


def test_too_few_points_raises():
    spec = dict(SPECS["loop"], points_per_scan=100000)
    with pytest.raises(ValueError, match="fewer than"):
        scenes.make_sequence(spec, 1, "cpu")


@pytest.mark.parametrize("n", [16, 13])
def test_grid_clusters_one_a_cell(n):
    import torch
    gen = torch.Generator()
    gen.manual_seed(2**31 + 5)
    xy = scenes._grid_centres(gen, n, 30.0, "cpu").numpy()
    g = int(np.ceil(np.sqrt(n)))
    cell = 1.2 * 30.0 / g
    ij = np.floor((xy + 18.0) / cell).astype(int)
    assert ((ij >= 0) & (ij < g)).all()
    assert len({tuple(c) for c in ij}) == n
    off = (xy + 18.0) - cell * (ij + 0.5)
    assert np.abs(off).max() <= cell / 4 + 1e-9


def test_unknown_cluster_layout_raises():
    spec = dict(SPECS["drive"], scene=dict(SPECS["drive"]["scene"], clusters="ring"))
    with pytest.raises(ValueError, match="cluster layout"):
        scenes.make_sequence(spec, 1, "cpu")
