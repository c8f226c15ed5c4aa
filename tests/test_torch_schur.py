"""semicp_torch.slam.schur and slam.map_ba against semicp's, on one device
and over 2 gloo ranks (tests/torch_gloo_workers.py) against the JAX
package's 2-device CPU mesh.

Tolerances:
- Schur BA: the same LM on the same problem in f32 (index_add_ assembly
  where the JAX package multiplies one-hots, sums in other orders):
  poses within 1e-4, landmarks within 1e-3 (their steps are the pose
  steps back-substituted through 3x3 inverses); the mesh solve within
  1e-4 of the single one on each side.
- refine_keyframes: the landmarks and the observations are host numpy on
  the same inputs and equal exactly; the refined poses within 1e-4.
  These parity cases cap the landmarks at 2560, a multiple of 512: the
  JAX package's class_nn never reads the targets past the last whole
  512-column tile (semicp/corr/bruteforce.py:73, n // tb), so at other
  counts it misses up to 511 landmarks. The port reads every landmark
  (held to a float64 brute force at 2875 landmarks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import semicp
import semicp_torch
import torch
import torch_gloo_workers as workers
from semicp.data import make_scene as j_make_scene
from semicp.dist import make_mesh as j_make_mesh
from semicp.geom.se3 import se3_exp as j_se3_exp
from semicp.slam import map_ba as j_map_ba
from semicp.slam import schur as j_schur
from semicp.slam.keyframes import KeyframeStore as JStore
from semicp_torch.slam import map_ba as t_map_ba
from semicp_torch.slam import schur as t_schur
from semicp_torch.slam.keyframes import KeyframeStore as TStore

ITERS = 6
REFINE = ["--cloud.num_classes=5", "--slam.ba_iters=6", "--slam.ba_gate=0.6",
          "--slam.ba_max_landmarks=2560"]


def exp(v):
    return np.asarray(j_se3_exp(jnp.asarray(np.asarray(v, np.float32))), np.float64)


def make_ba_problem(rng, M=6, L=512, obs_per_lm=3):
    """tests/test_dist_ring_schur.py's synthetic BA: noisy poses and
    landmarks, observations of the ground truth."""
    gt_poses = [np.eye(4)]
    for _ in range(1, M):
        gt_poses.append(gt_poses[-1] @ exp([1.0, 0.1, 0, 0.01, 0, 0.05]))
    gt_poses = np.stack(gt_poses)
    gt_lms = rng.uniform(-5, 15, size=(L, 3))
    obs_pose, obs_lm, obs_z = [], [], []
    for lm in range(L):
        for i in rng.choice(M, size=obs_per_lm, replace=False):
            Ti = np.linalg.inv(gt_poses[i])
            obs_pose.append(i)
            obs_lm.append(lm)
            obs_z.append(Ti[:3, :3] @ gt_lms[lm] + Ti[:3, 3] + rng.normal(size=3) * 0.01)
    init = gt_poses.copy()
    for i in range(1, M):
        init[i] = init[i] @ exp(rng.normal(size=6) * np.array([0.1, 0.1, 0.05, 0.01, 0.01, 0.02]))
    init_lms = gt_lms + rng.normal(size=(L, 3)) * 0.1
    return (gt_poses, gt_lms, init.astype(np.float32), init_lms.astype(np.float32),
            np.asarray(obs_pose, np.int32), np.asarray(obs_lm, np.int32),
            np.asarray(obs_z, np.float32), np.ones(len(obs_pose), np.float32))


def make_stores(rng, M=4, n_points=1500, K=5, n_pad=2048, pose_noise=0.05):
    """tests/test_map_ba.py's keyframes, in both packages' stores, with the
    ground truth and the noisy poses BA starts from."""
    scene, labels = j_make_scene(rng, n_points=6000, extent=20.0, n_classes=K)
    labels = labels - 1
    gt = [np.eye(4)]
    for _ in range(1, M):
        gt.append(gt[-1] @ exp([1.5, 0.2, 0.0, 0.0, 0.0, 0.05]))
    gt = np.stack(gt)
    js, ts, raw = JStore(), TStore(), []
    for i in range(M):
        Ti = np.linalg.inv(gt[i])
        local = scene @ Ti[:3, :3].T + Ti[:3, 3]
        sel = np.argsort(np.linalg.norm(local, axis=1))[:n_points]
        pts, lab = local[sel].astype(np.float32), labels[sel]
        raw.append((pts, lab))
        js.add(i, gt[i].astype(np.float32), semicp.make_cloud(pts, lab, n_pad=n_pad),
               np.zeros(K))
        ts.add(i, gt[i].astype(np.float32),
               semicp_torch.make_cloud(pts, lab, n_pad=n_pad, device="cpu"), np.zeros(K))
    noisy = gt.copy()
    for i in range(1, M):
        noisy[i] = noisy[i] @ exp(rng.normal(size=6) * pose_noise * np.array([1, 1, 1, .2, .2, .2]))
    return js, ts, raw, gt, noisy.astype(np.float32)


def shard(ol, per, world, *obs):
    """Observations grouped by landmark shard, padded, landmark ids local
    (tests/test_dist_ring_schur.py `test_schur_ba_mesh_matches_single`)."""
    groups = [np.nonzero((ol // per) == d)[0] for d in range(world)]
    omax = max(len(g) for g in groups)
    out = [np.zeros((world, omax) + a.shape[1:], a.dtype) for a in obs]
    for d, g in enumerate(groups):
        for o, a in zip(out, obs):
            o[d, :len(g)] = a[g]
        out[1][d, :len(g)] -= d * per
    return out


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_schur_ba_single_matches_jax(rng):
    """ba_solve_single of both packages on the same problem; the port's
    converges as tests/test_dist_ring_schur.py asks of the JAX one."""
    gt_p, gt_l, p0, l0, oi, ol, oz, ow = make_ba_problem(rng)
    pj, lj = j_schur.ba_solve_single(*(jnp.asarray(a) for a in (p0, l0, oi, ol, oz, ow)),
                                     iters=ITERS)
    pt, lt = t_schur.ba_solve_single(*(t(a) for a in (p0, l0, oi, ol, oz, ow)), iters=ITERS)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-4)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-3)
    err_t = np.linalg.norm(pt.numpy()[:, :3, 3] - gt_p[:, :3, 3], axis=1)
    assert err_t.max() < 0.02, err_t
    assert np.median(np.linalg.norm(lt.numpy() - gt_l, axis=1)) < 0.02


@pytest.mark.parametrize("lam", [1e-4, 10.0])
def test_schur_step_matches_jax(rng, lam):
    """One linearisation and Schur reduction (index_add_ assembly) against
    the JAX package's one-hot form: the pose and landmark steps."""
    _, _, p0, l0, oi, ol, oz, ow = make_ba_problem(rng, M=5, L=200)
    dpj, dlj = j_schur._schur_local(*(jnp.asarray(a) for a in (p0, l0, oi, ol, oz, ow)),
                                    m=5, axis=None, lam=jnp.float32(lam))
    dpt, dlt = t_schur._schur_local(t(p0), t(l0), t(oi).long(), t(ol).long(), t(oz), t(ow),
                                    5, None, torch.tensor(lam, dtype=torch.float32))
    scale = np.abs(np.asarray(dpj)).max()
    np.testing.assert_allclose(dpt.numpy(), np.asarray(dpj), atol=1e-4 * scale + 1e-7)
    np.testing.assert_allclose(dlt.numpy(), np.asarray(dlj), atol=1e-3 * np.abs(dlj).max())


@pytest.fixture(scope="module")
def schur_run(tmp_path_factory):
    """One spawn of 2 gloo ranks: the BA over the mesh and refine_keyframes
    over the mesh; and the inputs they ran on."""
    rng = np.random.default_rng(0)
    prob = make_ba_problem(rng)
    _, _, p0, l0, oi, ol, oz, ow = prob
    per = l0.shape[0] // 2
    OP, OL, OZ, OW = shard(ol, per, 2, oi, ol, oz, ow)
    js, ts, raw, gt, noisy = make_stores(rng)
    n_pad = 2048
    inp = {"ba_p0": p0, "ba_l0": l0, "ba_OP": OP, "ba_OL": OL, "ba_OZ": OZ, "ba_OW": OW,
           "ba_iters": ITERS, "kf_n_pad": n_pad, "kf_gt": gt.astype(np.float32),
           "kf_noisy": noisy, "overrides": np.asarray(REFINE),
           "kf_n": np.asarray([len(p) for p, _ in raw]),
           "kf_xyz": np.stack([np.pad(p, ((0, n_pad - len(p)), (0, 0))) for p, _ in raw]),
           "kf_lab": np.stack([np.pad(lab, (0, n_pad - len(lab))) for _, lab in raw])}
    d = tmp_path_factory.mktemp("schur")
    np.savez(d / "in.npz", **inp)
    return prob, (OP, OL, OZ, OW), (js, ts, gt, noisy), workers.spawn("schur", 2, d)


def test_schur_ba_mesh_matches_jax(schur_run):
    """The BA over 2 ranks (landmarks and their observations sharded, S and
    g_s all-reduced) against JAX's make_ba_solver on a 2-device mesh and
    against the single-device solve."""
    (_, _, p0, l0, oi, ol, oz, ow), (OP, OL, OZ, OW), _, outs = schur_run
    mesh = j_make_mesh({"blocks": 2}, devices=jax.devices()[:2])
    pj, lj = j_schur.make_ba_solver(mesh, m=p0.shape[0], iters=ITERS)(
        *(jnp.asarray(a) for a in (p0, l0, OP.reshape(-1), OL.reshape(-1), OZ.reshape(-1, 3),
                                   OW.reshape(-1))))
    ps, ls = t_schur.ba_solve_single(*(t(a) for a in (p0, l0, oi, ol, oz, ow)), iters=ITERS)
    np.testing.assert_array_equal(outs[0]["ba_poses"], outs[1]["ba_poses"])
    lms = np.concatenate([o["ba_lms"] for o in outs])
    for p_ref, l_ref in ((np.asarray(pj), np.asarray(lj)), (ps.numpy(), ls.numpy())):
        np.testing.assert_allclose(outs[0]["ba_poses"], p_ref, atol=1e-4)
        np.testing.assert_allclose(lms, l_ref, atol=1e-3)


def test_landmarks_and_observations_match_jax(schur_run):
    """build_landmarks, collect_observations and shard_observations on the
    same store and poses give the JAX package's arrays exactly."""
    _, _, (js, ts, gt, noisy), _ = schur_run
    for shards in (1, 2, 3):
        lj = j_map_ba.build_landmarks(js, noisy, 0.3, 2560, shards)
        lt = t_map_ba.build_landmarks(ts, noisy, 0.3, 2560, shards)
        for a, b in zip(lt, lj):
            np.testing.assert_array_equal(a, np.asarray(b))
    oj = j_map_ba.collect_observations(js, noisy, *lj, 0.6, 5, 2048)
    ot = t_map_ba.collect_observations(ts, noisy, *lt, 0.6, 5, 2048, device="cpu")
    for a, b in zip(ot, oj):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t_map_ba.shard_observations(*ot, len(lt[0]), 3),
                    j_map_ba.shard_observations(*oj, len(lj[0]), 3)):
        np.testing.assert_array_equal(a.reshape(b.shape), b)


def test_refine_keyframes_matches_jax(schur_run):
    """refine_keyframes without a mesh and over 2 ranks against the JAX
    package's, alone and over its 2-device mesh; both move the poses
    towards the truth."""
    _, _, (js, ts, gt, noisy), outs = schur_run
    jcfg = semicp.Config().override(semicp.config.parse_overrides(REFINE))
    tcfg = semicp_torch.Config().override(semicp_torch.config.parse_overrides(REFINE))
    rj, sj = j_map_ba.refine_keyframes(js, noisy.copy(), jcfg, mesh=None)
    rt, st = t_map_ba.refine_keyframes(ts, noisy.copy(), tcfg, mesh=None)
    mesh = j_make_mesh({"blocks": 2}, devices=jax.devices()[:2])
    rjm, sjm = j_map_ba.refine_keyframes(js, noisy.copy(), jcfg, mesh=mesh)
    assert st["observations"] == sj["observations"] >= 6 * len(ts)
    assert st["landmarks"] == sj["landmarks"]
    assert int(outs[0]["observations"]) == sjm["observations"]
    np.testing.assert_allclose(rt, rj, atol=1e-4)
    for o in outs:
        np.testing.assert_allclose(o["refined"], rjm, atol=1e-4)
        np.testing.assert_allclose(o["refined"], rt, atol=1e-4)
    before = np.linalg.norm(noisy[:, :3, 3] - gt[:, :3, 3], axis=1).max()
    after = np.linalg.norm(rt[:, :3, 3].astype(np.float64) - gt[:, :3, 3], axis=1).max()
    assert after < before


def test_observations_reach_every_landmark(schur_run):
    """Uncapped (2875 landmarks, not a multiple of 512): a point is observed
    exactly when its nearest same-class landmark lies within the gate, and
    then at that landmark (float64 brute force; a point within 1e-3 of the
    gate, or a landmark within 1e-3 m^2 of the nearest, may go either way
    in f32)."""
    _, _, (_, ts, _, noisy), _ = schur_run
    g2 = 0.6 * 0.6
    lms, lab, val = t_map_ba.build_landmarks(ts, noisy, 0.3, 8192, 1)
    assert val.sum() % 512 and val.sum() > 2560
    op, ol, oz, _ = t_map_ba.collect_observations(ts, noisy, lms, lab, val, 0.6, 5, 2048,
                                                  device="cpu")
    for kf in ts.keyframes:
        pts, klab = t_map_ba._host_cloud(kf.cloud)
        T = noisy[kf.index].astype(np.float64)
        world = pts @ T[:3, :3].T + T[:3, 3]
        d2 = ((world[:, None, :] - lms[None].astype(np.float64)) ** 2).sum(-1)
        d2 = np.where((lab[None] == klab[:, None]) & val[None], d2, np.inf)
        best = d2.min(1)
        mine = op == kf.index
        at = {tuple(r): i for i, r in enumerate(pts.astype(np.float32))}
        got = {at[tuple(r)]: int(j) for r, j in zip(oz[mine], ol[mine])}
        assert len(got) == int(mine.sum())
        for i in range(len(pts)):
            if abs(best[i] - g2) < 1e-3 * g2:
                continue
            assert (i in got) == bool(best[i] < g2), i
            if i in got:
                assert d2[i, got[i]] <= best[i] + 1e-3, i
