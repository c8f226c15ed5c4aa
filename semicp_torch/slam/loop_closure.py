"""Loop-closure proposal and verification.

Port of `semicp/slam/loop_closure.py`. Per new keyframe:
  1. propose (host): older keyframes within cfg.lc_max_dist of the
     current (PGO-corrected) pose, at least cfg.lc_min_gap keyframes back,
     whose semantic descriptors differ by at most cfg.lc_desc_thresh (L1);
  2. verify (device): a semantic EM alignment of the two keyframe clouds
     at the wide gate lc_max_dist / 2 with max_iters 40, from the current
     relative pose estimate; accepted on convergence with more than a
     quarter of the source's points in effective correspondences.
"""

from __future__ import annotations

import numpy as np
import torch

from semicp_torch.config import Config
from semicp_torch.dist.batch import batched_align
from semicp_torch.slam.keyframes import Keyframe, KeyframeStore

VERIFY_MAX_ITERS = 40


def propose_loop_closures(store: KeyframeStore, kf: Keyframe, poses: np.ndarray,
                          cfg: Config) -> list[int]:
    """Indices of older keyframes worth verifying against `kf`.

    `poses` are the CURRENT (post-PGO) keyframe poses, (M,4,4)."""
    out = []
    c = cfg.slam
    p_now = poses[kf.index][:3, 3]
    for other in store.keyframes:
        if kf.index - other.index < c.lc_min_gap:
            continue
        d = np.linalg.norm(poses[other.index][:3, 3] - p_now)
        if d > c.lc_max_dist:
            continue
        desc_d = float(np.abs(other.descriptor - kf.descriptor).sum())
        if desc_d > c.lc_desc_thresh:
            continue
        out.append(other.index)
    return out


class LoopVerifier:
    """Loop-closure verification, every candidate of a keyframe in one
    batch (dist/batch.py `batched_align` on the keyframes' device).

    `verify` reads all its candidates' results, and the source's point
    count, in one device-to-host copy. `last` keeps that copy's fields for
    the last call: converged, n_corr and n_min (the acceptance bound).
    """

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.align_b = batched_align(cfg)
        self.last = None

    def verify(self, store: KeyframeStore, cands: list[int], j: int, poses: np.ndarray):
        """Verify keyframe j against each candidate keyframe.

        Returns [(c, accepted, Z, info, H)] in candidate order: Z (4,4)
        with x_c = Z x_j (the pose-graph edge measurement), the scalar
        information and the align's 6x6 GN Hessian, as float64 arrays.
        """
        if not cands:
            return []
        cfg = self.cfg
        src = store[j].cloud
        T0 = np.stack([np.linalg.inv(poses[c].astype(np.float64)) @ poses[j].astype(np.float64)
                       for c in cands]).astype(np.float32)
        res = self.align_b([src] * len(cands), [store[c].cloud for c in cands], T0,
                           gate=cfg.slam.lc_max_dist / 2.0, max_iters=VERIFY_MAX_ITERS)
        b = len(cands)
        flat = torch.cat([res.T.reshape(b, 16), res.H.reshape(b, 36),
                          res.converged.to(torch.float32)[:, None], res.n_corr[:, None],
                          src.count.to(torch.float32).expand(b, 1)], dim=1)
        host = flat.cpu().numpy().astype(np.float64)
        conv, n_corr = host[:, 52] > 0.5, host[:, 53]
        n_min = 0.25 * host[0, 54]
        self.last = {"converged": conv, "n_corr": n_corr, "n_min": n_min}
        out = []
        for r, c in enumerate(cands):
            ok = bool(conv[r]) and float(n_corr[r]) > n_min
            H = host[r, 16:52].reshape(6, 6)
            out.append((c, ok, host[r, :16].reshape(4, 4), edge_info_from_hessian(H), H))
        return out


def verify_loop_closures_batched(store: KeyframeStore, cands: list[int], j: int,
                                 poses: np.ndarray, cfg: Config,
                                 verifier: LoopVerifier | None = None):
    """Build (or reuse) a LoopVerifier and verify. Loops build ONE
    LoopVerifier per run and call `.verify(...)` directly (run_slam does)."""
    if not cands:
        return []
    return (verifier or LoopVerifier(cfg)).verify(store, cands, j, poses)


def edge_info_from_hessian(H) -> float:
    """Scalar pose-graph edge information from the align's 6x6 GN Hessian:
    its mean diagonal, which weights an edge by both its correspondence
    count and its geometric conditioning. optimize_pose_graph normalizes
    the edge informations per solve, so only relative magnitudes matter."""
    return float(np.mean(np.diagonal(np.asarray(H, np.float64))))
