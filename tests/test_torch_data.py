"""semicp_torch's scan ingestion against semicp's, on the same files.

Tolerances: the KITTI and PCD readers are the same numpy code, so every
array is equal to the bit; the native loader equals the numpy path to
the bit for scans and labels, and its voxel downsample keeps one point
per cell as the numpy one does (its hash differs, so the kept count may
differ by 2%, the JAX package's own bound). The synthetic trajectory
and scans go through each package's f32 se3_exp, so they agree to f32
rounding: poses to 1e-5 and rendered points to 1e-4 m at 25 m range.
The device voxel selection (`voxel_keep`) keeps the columns the numpy
voxel_downsample keeps, exactly.
"""

import numpy as np
import pytest
import torch

from semicp.data import kitti as j_kitti
from semicp.data import make_scene as j_make_scene
from semicp.data import make_trajectory as j_make_trajectory
from semicp.data import render_scan as j_render_scan
from semicp.data.pcd import load_pcd as j_load_pcd
from semicp_torch.cli.common import load_scan_np
from semicp_torch.data import kitti as t_kitti
from semicp_torch.data import make_trajectory as t_make_trajectory
from semicp_torch.data import native
from semicp_torch.data import render_scan as t_render_scan
from semicp_torch.data.pcd import _lzf_decompress, load_pcd, save_pcd


def test_kitti_bin_labels_and_remap_equal_jax(tmp_path, rng):
    pts = rng.normal(size=(300, 4)).astype(np.float32)
    pts.tofile(tmp_path / "000000.bin")
    np.testing.assert_array_equal(t_kitti.load_velodyne_bin(tmp_path / "000000.bin"),
                                  j_kitti.load_velodyne_bin(tmp_path / "000000.bin"))
    raw = rng.choice(sorted(j_kitti.SEMANTICKITTI_REMAP) + [7, 300, 65535], size=300)
    inst = rng.integers(0, 9, size=300)
    ((inst.astype(np.uint32) << 16) | raw.astype(np.uint32)).tofile(tmp_path / "000000.label")
    sem_t, inst_t = t_kitti.load_semantickitti_labels(tmp_path / "000000.label")
    sem_j, inst_j = j_kitti.load_semantickitti_labels(tmp_path / "000000.label")
    np.testing.assert_array_equal(sem_t, sem_j)
    np.testing.assert_array_equal(inst_t, inst_j)
    np.testing.assert_array_equal(t_kitti.remap_semantickitti(sem_t),
                                  j_kitti.remap_semantickitti(sem_j))
    assert t_kitti.SEMANTICKITTI_REMAP == j_kitti.SEMANTICKITTI_REMAP
    np.testing.assert_array_equal(t_kitti._REMAP_LUT, j_kitti._REMAP_LUT)


def test_kitti_poses_calib_and_voxel_equal_jax(tmp_path, rng):
    poses = np.tile(np.eye(4), (5, 1, 1))
    poses[:, :3, 3] = rng.normal(size=(5, 3))
    t_kitti.save_kitti_poses(tmp_path / "t.txt", poses)
    j_kitti.save_kitti_poses(tmp_path / "j.txt", poses)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    np.testing.assert_array_equal(t_kitti.load_kitti_poses(tmp_path / "j.txt"),
                                  j_kitti.load_kitti_poses(tmp_path / "j.txt"))
    tr = rng.normal(size=12)
    (tmp_path / "calib.txt").write_text("P0: " + " ".join(["0"] * 12) + "\nTr: "
                                        + " ".join(map(str, tr)) + "\n")
    np.testing.assert_array_equal(t_kitti.load_kitti_calib(tmp_path / "calib.txt"),
                                  j_kitti.load_kitti_calib(tmp_path / "calib.txt"))
    xyz = rng.uniform(0, 10, size=(5000, 3))
    lab = rng.integers(0, 5, size=5000).astype(np.int32)
    for a, b in zip(t_kitti.voxel_downsample(xyz, lab, 0.7),
                    j_kitti.voxel_downsample(xyz, lab, 0.7)):
        np.testing.assert_array_equal(a, b)


def lzf_stream(raw: bytes) -> bytes:
    """A valid LZF stream with a back-reference: bytes 0-3 as a literal,
    bytes 4-7 (equal to them) copied from 4 back, the rest as literals."""
    assert raw[4:8] == raw[:4]
    out = bytearray([3]) + raw[:4] + bytes([(4 - 2) << 5, 3])
    for i in range(8, len(raw), 32):
        chunk = raw[i:i + 32]
        out += bytes([len(chunk) - 1]) + chunk
    return bytes(out)


@pytest.mark.parametrize("encoding", ["binary", "ascii", "binary_compressed"])
def test_pcd_encodings_equal_jax(tmp_path, encoding):
    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(37, 3)).astype(np.float32)
    xyz[1] = xyz[0]                                  # a repeat for the back-reference
    lab = rng.integers(0, 6, size=37).astype(np.uint32)
    p = tmp_path / "c.pcd"
    if encoding == "binary_compressed":
        # field-major (SoA), as PCL writes it
        raw = xyz[:, 0].tobytes() + xyz[:, 1].tobytes() + xyz[:, 2].tobytes() + lab.tobytes()
        comp = lzf_stream(raw)
        header = ("VERSION 0.7\nFIELDS x y z label\nSIZE 4 4 4 4\nTYPE F F F U\n"
                  "COUNT 1 1 1 1\nWIDTH 37\nHEIGHT 1\nPOINTS 37\nDATA binary_compressed\n")
        p.write_bytes(header.encode() + np.asarray([len(comp), len(raw)], np.uint32).tobytes()
                      + comp)
    else:
        save_pcd(p, xyz, lab, binary=encoding == "binary")
    (xt, lt), (xj, lj) = load_pcd(p), j_load_pcd(p)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_array_equal(lt, lab.astype(np.int32))
    np.testing.assert_allclose(xt, xyz, atol=0 if encoding != "ascii" else 1e-5)


@pytest.mark.parametrize("stream", [
    bytes([2]) + b"abc" + bytes([(4 - 2) << 5]),          # cut before the offset byte
    bytes([2]) + b"abc" + bytes([7 << 5]),                # cut before the length extension
    bytes([2]) + b"abc" + bytes([7 << 5, 1]),             # cut before the offset byte
])
def test_lzf_truncated_back_reference_raises_value_error(stream):
    assert _lzf_decompress(bytes([2]) + b"abc" + bytes([(4 - 2) << 5, 2]), 7) == b"abcabca"
    with pytest.raises(ValueError, match="truncated"):
        _lzf_decompress(stream, 16)


def write_scan(tmp_path, rng, n=1000):
    pts = (rng.normal(size=(n, 4)) * 5).astype(np.float32)
    pts.tofile(tmp_path / "000000.bin")
    raw = rng.choice([0, 10, 40, 50, 252, 81], size=n).astype(np.uint32)
    ((rng.integers(0, 5, size=n).astype(np.uint32) << 16) | raw).tofile(
        tmp_path / "000000.label")
    return pts, raw


def test_native_loader_equals_numpy_path(tmp_path, rng, monkeypatch):
    assert native.native_available(), "g++ is present, so the native loader must build"
    pts, raw = write_scan(tmp_path, rng)
    xyz, inten = native.load_bin_planar(tmp_path / "000000.bin")
    np.testing.assert_array_equal(xyz.T, pts[:, :3])
    np.testing.assert_array_equal(inten, pts[:, 3])
    got = native.load_labels_remapped(tmp_path / "000000.label", t_kitti._REMAP_LUT, len(pts))
    np.testing.assert_array_equal(got, j_kitti.remap_semantickitti(raw.astype(np.int32)))
    b, lbl = tmp_path / "000000.bin", tmp_path / "000000.label"
    nat = [load_scan_np(b, lbl, v) for v in (0.0, 0.5)]
    monkeypatch.setattr(native, "native_available", lambda: False)
    ref = [load_scan_np(b, lbl, v) for v in (0.0, 0.5)]
    for a, r in zip(nat[0], ref[0]):
        np.testing.assert_array_equal(a, r)
    # voxel: one point per occupied cell on both paths, counts within 2%
    oxyz, olab = nat[1]
    assert len({tuple(c) for c in np.floor(oxyz / 0.5).astype(np.int64)}) == len(oxyz)
    assert abs(len(oxyz) - len(ref[1][0])) <= max(4, len(ref[1][0]) // 50)
    assert set(np.unique(olab)) <= {0, 1, 9, 13, 19}


def test_trajectory_and_render_match_jax():
    traj_t = t_make_trajectory(12, step=0.6, turn=0.05, seed=4)
    traj_j = j_make_trajectory(12, step=0.6, turn=0.05, seed=4)
    assert traj_t.dtype == traj_j.dtype == np.float32
    np.testing.assert_allclose(traj_t, traj_j, atol=1e-5)
    scene, lab = j_make_scene(np.random.default_rng(1), n_points=6000, extent=30.0)
    rt, rj = np.random.default_rng(2), np.random.default_rng(2)
    for pt, pj in zip(traj_t[::4], traj_j[::4]):
        (xt, lt), (xj, lj) = (t_render_scan(rt, scene, lab, pt, max_range=25.0, max_points=900),
                              j_render_scan(rj, scene, lab, pj, max_range=25.0, max_points=900))
        np.testing.assert_array_equal(lt, lj)
        np.testing.assert_allclose(xt, xj, atol=1e-4)
    assert rt.uniform() == rj.uniform()          # the same draws, in the same order


def kept_by_jax(xyz, valid, voxel):
    """The columns JAX's voxel_downsample keeps of the valid ones: run on
    the valid points with their column indices as the labels."""
    idx = np.flatnonzero(valid)
    return j_kitti.voxel_downsample(xyz[idx], idx, voxel)[1]


def test_voxel_keep_matches_jax_seeded():
    """The device selection (here on CPU tensors) keeps the columns JAX's
    voxel_downsample keeps, in order: seeded clouds with invalid columns,
    at three voxel sizes and at voxel 0 (every valid column)."""
    rng = np.random.default_rng(7)
    for trial in range(4):
        xyz = (rng.normal(size=(4000, 3)) * 4).astype(np.float32)
        valid = rng.uniform(size=4000) > 0.15
        for voxel in (0.1, 0.3, 1.0, 0.0):
            got = t_kitti.voxel_keep(torch.from_numpy(xyz.T.copy()), torch.from_numpy(valid),
                                     voxel).numpy()
            ref = kept_by_jax(xyz, valid, voxel) if voxel > 0 else np.flatnonzero(valid)
            np.testing.assert_array_equal(got, ref)


def test_voxel_keep_matches_jax_hand_built():
    """Points on cell boundaries (exact multiples of the voxel, and one
    float32 ulp either side), negative coordinates (floor, not truncation),
    duplicate cells whose first point is invalid, and a key shared only by
    invalid columns."""
    v = np.float32(0.25)
    edge = [0.0, 0.25, -0.25, 0.5, -0.5, 1.0]
    pts = [[e, 0.1, -0.1] for e in edge]
    pts += [[np.nextafter(np.float32(e), np.float32(-1)), 0.1, -0.1] for e in edge]
    pts += [[np.nextafter(np.float32(e), np.float32(1)), 0.1, -0.1] for e in edge]
    pts += [[-0.01, -0.01, -0.01], [-0.24, -0.24, -0.24], [-0.26, 0.0, 0.0],
            [3.1, 3.1, 3.1], [3.2, 3.15, 3.05], [3.1, 3.1, 3.1], [-7.0, 2.0, 1.0]]
    xyz = np.asarray(pts, np.float32)
    valid = np.ones(len(xyz), bool)
    valid[len(edge) * 3 + 3] = False       # the first of three points in one cell
    valid[-1] = False                      # a cell that only an invalid point holds
    got = t_kitti.voxel_keep(torch.from_numpy(xyz.T.copy()), torch.from_numpy(valid),
                             float(v)).numpy()
    ref = kept_by_jax(xyz, valid, float(v))
    np.testing.assert_array_equal(got, ref)
    assert len(ref) < valid.sum()          # some cells held more than one point
