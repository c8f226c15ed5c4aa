"""Global map refinement: keyframe poses and map landmarks by Schur BA.

Port of `semicp/slam/map_ba.py`, the host assembly around
slam/schur.py's solver:

  1. landmarks     the keyframe clouds fused in the WORLD frame at the
                   current poses, voxel-downsampled and capped; padded to
                   a multiple of the mesh's world with FAR rows that match
                   nothing (the blocks each rank owns);
  2. observations  every keyframe point matched to its same-class nearest
                   landmark within a gate (corr/bruteforce.class_nn, the
                   plain NN, as the JAX package matches with its own
                   class_nn); the measurement is the point's
                   keyframe-LOCAL coordinates;
  3. solve         slam/schur.make_ba_solver over the mesh (landmarks and
                   their observations on their rank, the pose system
                   all-reduced), or schur.ba_solve_single without one.

The refined keyframe poses feed run_slam --dist's trajectory. Every rank
builds the same landmarks and observations (host numpy, as in the JAX
package's program on every process); a rank solves over its share.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from semicp_torch.corr.bruteforce import class_nn
from semicp_torch.data.kitti import voxel_downsample
from semicp_torch.slam.schur import ba_solve_single, make_ba_solver

FAR = 1.0e6


def _host_cloud(cloud):
    """(points (n,3) float64 of the valid prefix, labels (n,)) of a
    preprocessed cloud, in one device-to-host copy."""
    n_pad = cloud.n_pad
    flat = torch.cat([cloud.xyz.reshape(-1), cloud.label.to(torch.float32),
                      cloud.count.to(torch.float32).reshape(1)]).cpu().numpy()
    n = int(flat[-1])
    xyz = flat[:3 * n_pad].reshape(3, n_pad)
    return xyz.T[:n].astype(np.float64), flat[3 * n_pad:4 * n_pad][:n].astype(np.int32)


def build_landmarks(store, poses: np.ndarray, voxel: float, max_landmarks: int,
                    n_shards: int, seed: int = 0):
    """Fuse keyframe clouds into world-frame landmarks.

    Returns (lms (L,3) f32, lab (L,) i32, valid (L,) bool) with L padded to
    a multiple of n_shards; padded rows sit at FAR so no point matches them.
    """
    pts_all, lab_all = [], []
    for kf in store.keyframes:
        T = poses[kf.index].astype(np.float64)
        pts, lab = _host_cloud(kf.cloud)
        pts_all.append(pts @ T[:3, :3].T + T[:3, 3])
        lab_all.append(lab)
    pts = np.concatenate(pts_all).astype(np.float32)
    lab = np.concatenate(lab_all).astype(np.int32)
    if voxel > 0:
        pts, lab = voxel_downsample(pts, lab, voxel)
    if len(pts) > max_landmarks:
        sel = np.random.default_rng(seed).permutation(len(pts))[:max_landmarks]
        pts, lab = pts[sel], lab[sel]
    L = len(pts)
    L_pad = int(np.ceil(L / n_shards)) * n_shards
    lms = np.full((L_pad, 3), FAR, np.float32)
    labs = np.full((L_pad,), -1, np.int32)
    valid = np.zeros((L_pad,), bool)
    lms[:L], labs[:L], valid[:L] = pts, lab, True
    return lms, labs, valid


def collect_observations(store, poses: np.ndarray, lms, lab, lm_valid, gate: float,
                         num_classes: int, max_obs_per_kf: int, seed: int = 0, device="cuda"):
    """Match every keyframe point to its same-class nearest landmark within
    the gate, on `device`.

    Returns (obs_pose (O,), obs_lm (O,) GLOBAL landmark ids, obs_z (O,3)
    keyframe-local measurements, obs_w (O,)).
    """
    rng = np.random.default_rng(seed)
    lms_pl = torch.from_numpy(np.ascontiguousarray(lms.T)).to(device)          # (3, L)
    lab_t = torch.from_numpy(np.maximum(lab, 0)).to(device)
    val_t = torch.from_numpy(lm_valid).to(device)
    op, ol, oz = [], [], []
    for kf in store.keyframes:
        T = poses[kf.index].astype(np.float64)
        local, klab = _host_cloud(kf.cloud)
        n = len(local)
        world = (local @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
        # queries keep the cloud's padded capacity; pad rows sit at FAR
        qpl = np.full((3, kf.cloud.n_pad), FAR, np.float32)
        qpl[:, :n] = world.T
        idx, d2 = class_nn(lms_pl, lab_t, val_t, torch.from_numpy(qpl).to(device), num_classes)
        rows = torch.from_numpy(np.maximum(klab, 0).astype(np.int64)).to(device)
        cols = torch.arange(n, device=device)
        got = torch.stack([idx[rows, cols].to(torch.float64), d2[rows, cols].to(torch.float64)])
        my_idx, my_d2 = got.cpu().numpy()
        ok = (my_d2.astype(np.float32) <= np.float32(gate * gate)) & (klab >= 0)
        sel = np.nonzero(ok)[0]
        if len(sel) > max_obs_per_kf:
            sel = rng.permutation(sel)[:max_obs_per_kf]
        op.append(np.full(len(sel), kf.index, np.int32))
        ol.append(my_idx[sel].astype(np.int32))
        oz.append(local[sel].astype(np.float32))
    obs_pose = np.concatenate(op) if op else np.zeros(0, np.int32)
    obs_lm = np.concatenate(ol) if ol else np.zeros(0, np.int32)
    obs_z = np.concatenate(oz) if oz else np.zeros((0, 3), np.float32)
    return obs_pose, obs_lm, obs_z, np.ones(len(obs_pose), np.float32)


def shard_observations(obs_pose, obs_lm, obs_z, obs_w, L: int, n_shards: int):
    """Group observations by landmark shard (landmark l lives on rank
    l // (L / n_shards)), pad each group to the largest, and make the
    landmark ids local. Returns (OP (S,omax), OL, OZ (S,omax,3), OW): row
    d is rank d's observations."""
    per = L // n_shards
    dev = obs_lm // per
    groups = [np.nonzero(dev == d)[0] for d in range(n_shards)]
    omax = max([len(g) for g in groups] + [1])
    OP = np.zeros((n_shards, omax), np.int32)
    OL = np.zeros((n_shards, omax), np.int32)
    OZ = np.zeros((n_shards, omax, 3), np.float32)
    OW = np.zeros((n_shards, omax), np.float32)
    for d, g in enumerate(groups):
        n = len(g)
        OP[d, :n] = obs_pose[g]
        OL[d, :n] = obs_lm[g] - d * per
        OZ[d, :n] = obs_z[g]
        OW[d, :n] = obs_w[g]
    return OP, OL, OZ, OW


def refine_keyframes(store, poses: np.ndarray, cfg, mesh=None, voxel: float = 0.3):
    """One global BA refinement pass. Returns ((M,4,4) refined keyframe
    poses, stats); rows beyond the keyframes are unchanged. mesh=None
    solves on the keyframes' clouds' device; a mesh solves over its ranks
    on its device. The stats give the landmark and observation counts and
    the seconds spent matching and solving."""
    M = len(store.keyframes)
    if M < 2:
        return poses, {"landmarks": 0, "observations": 0}
    dev = mesh.device if mesh is not None else store.keyframes[0].cloud.device
    n_shards = mesh.world if mesh is not None else 1
    s = cfg.slam
    t0 = time.perf_counter()
    lms, lab, lm_valid = build_landmarks(store, poses, voxel, s.ba_max_landmarks, n_shards)
    obs_pose, obs_lm, obs_z, obs_w = collect_observations(
        store, poses, lms, lab, lm_valid, s.ba_gate, cfg.cloud.num_classes, s.ba_obs_per_kf,
        device=dev)
    t1 = time.perf_counter()
    stats = {"landmarks": int(lm_valid.sum()), "observations": len(obs_pose)}
    if len(obs_pose) < 6 * M:
        return poses, stats
    kf_ids = np.asarray([kf.index for kf in store.keyframes], np.int32)
    p0 = poses[kf_ids].astype(np.float32)
    # BA pose indices are keyframe-store positions (0..M-1)
    remap = np.zeros(int(kf_ids.max()) + 1, np.int32)
    remap[kf_ids] = np.arange(M, dtype=np.int32)
    obs_pose = remap[obs_pose]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if mesh is not None:
        OP, OL, OZ, OW = shard_observations(obs_pose, obs_lm, obs_z, obs_w, len(lms), n_shards)
        per, r = len(lms) // n_shards, mesh.rank
        solver = make_ba_solver(mesh, m=M, iters=s.ba_iters)
        new_p, _ = solver(t(p0), t(lms[r * per:(r + 1) * per]), t(OP[r]), t(OL[r]), t(OZ[r]),
                          t(OW[r]))
    else:
        new_p, _ = ba_solve_single(t(p0), t(lms), t(obs_pose), t(obs_lm), t(obs_z), t(obs_w),
                                   iters=s.ba_iters)
    out = poses.copy()
    out[kf_ids] = new_p.cpu().numpy().astype(poses.dtype)
    stats.update(match_s=t1 - t0, solve_s=time.perf_counter() - t1)
    return out, stats
