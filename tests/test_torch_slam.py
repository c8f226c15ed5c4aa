"""semicp_torch.slam, dist.batched_align, utils.checkpoint and run_slam
against semicp's, on the CPU.

Tolerances:
- PGO: the same LM in f32 (dense LU solves, sums in other orders) lands
  within 1e-4 of the JAX poses; each test's own properties are those of
  tests/test_slam.py.
- Loop verification: each candidate is one EM align, so Z agrees to 1e-4
  as an align's T does (tests/test_torch_register.py); the accept flags
  are equal.
- The submap's points and labels: the float64 transform (one BLAS product
  each, on the submap's device), the voxel key and a stable sort, the
  seeded subsample and the class-major sort, equal to the bit; its
  covariances as in tests/test_torch_covariance.py. The device fusion
  (`submap_points`) equals its numpy plain version to the bit.
- The whole of run_slam: every relative pose agrees to 1e-4, so positions
  chained over 16 frames to 1e-3 m; keyframes and edges are equal.
- Where the port runs against itself (batched against serial aligns, a
  checkpoint's round trip, a restored state) the results are equal to
  the bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import semicp
import semicp_torch
from semicp.cli.run_slam import _capture_state as j_capture_state
from semicp.cli.run_slam import main as j_slam_main
from semicp.data import make_pair, make_scene
from semicp.geom.se3 import se3_exp as j_se3_exp
from semicp.slam import LoopVerifier as JLoopVerifier
from semicp.slam import keyframes as jkf
from semicp.slam import pose_graph as jpg
from semicp.slam.loop_closure import propose_loop_closures as j_propose
from semicp.slam.submap import build_submap as j_build_submap
from semicp_torch.cli.run_slam import _capture_state, _restore_state
from semicp_torch.cli.run_slam import main as t_slam_main
from semicp_torch.convert import cloud_from_numpy, pose_graph_from_numpy
from semicp_torch.dist import batched_align
from semicp_torch.slam import LoopVerifier, keyframes as tkf, pose_graph as tpg
from semicp_torch.slam.loop_closure import propose_loop_closures
from semicp_torch.slam.submap import build_submap, submap_points, submap_points_plain
from semicp_torch.utils.checkpoint import latest_checkpoint, save_checkpoint

GRAPH_FIELDS = ("poses", "n_poses", "edge_i", "edge_j", "edge_z", "edge_info", "edge_W",
                "n_edges")


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """The SLAM runs' tensors are small: two intra-op threads run them no
    slower than eight, and leave the suite's other workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def T_of(v):
    return np.asarray(j_se3_exp(jnp.asarray(np.asarray(v, np.float32))))


def to_port(g) -> tpg.PoseGraph:
    return pose_graph_from_numpy(**{f: np.asarray(getattr(g, f)) for f in GRAPH_FIELDS})


def square_loop(m):
    """tests/test_slam.py's square: drifted odometry and one loop edge."""
    edge_T = T_of([2, 0, 0, 0, 0, np.pi / 2])
    drift = T_of([0.1, 0.05, 0, 0, 0, 0.02])
    g = m.PoseGraph.empty(8, 16)
    T = np.eye(4, dtype=np.float32)
    g = m.add_pose(g, T)
    for i in range(4):
        T = (T @ edge_T @ drift).astype(np.float32)
        g = m.add_pose(g, T)
        g = m.add_edge(g, i, i + 1, (edge_T @ drift).astype(np.float32), 1.0)
    return m.add_edge(g, 0, 4, np.eye(4, dtype=np.float32), 1.0)


def consistent_chain(m):
    edge_T = T_of([1, 0.2, 0, 0, 0, 0.1])
    g = m.PoseGraph.empty(8, 16)
    T = np.eye(4, dtype=np.float32)
    g = m.add_pose(g, T)
    for i in range(5):
        T = (T @ edge_T).astype(np.float32)
        g = m.add_pose(g, T)
        g = m.add_edge(g, i, i + 1, edge_T, 1.0)
    return g


ANISO_H = np.diag([100.0, 0.01, 1.0, 1.0, 1.0, 1.0])


def anisotropic(use_H):
    """tests/test_slam.py's two conflicting 0->1 edges: isotropic
    odometry biased in x, and a corridor-style closure accurate in x only."""
    zA = T_of([1.2, 1.0, 0, 0, 0, 0]).astype(np.float32)
    zB = T_of([1.0, 1.4, 0, 0, 0, 0]).astype(np.float32)

    def build(m):
        g = m.PoseGraph.empty(4, 8)
        g = m.add_pose(g, np.eye(4, dtype=np.float32))
        g = m.add_pose(g, zA)
        g = m.add_edge(g, 0, 1, zA, 1.0)
        return m.add_edge(g, 0, 1, zB, float(np.trace(ANISO_H)) / 6.0,
                          H=ANISO_H if use_H else None)

    return build


CASES = {"square": (square_loop, 30, 1.0), "chain": (consistent_chain, 10, 1.0),
         "aniso_full": (anisotropic(True), 40, 100.0),
         "aniso_scalar": (anisotropic(False), 40, 100.0)}


@pytest.mark.parametrize("case", list(CASES))
def test_pgo_matches_jax(case):
    build, iters, huber = CASES[case]
    gj = build(jpg)
    gt = to_port(gj)
    for f in GRAPH_FIELDS:      # the port's own add_pose / add_edge build the same graph
        np.testing.assert_array_equal(np.asarray(getattr(build(tpg), f)), getattr(gt, f))
    oj = jpg.optimize_pose_graph(gj, semicp.config.SLAMConfig(pgo_iters=iters, pgo_huber=huber))
    ot = tpg.optimize_pose_graph(gt, semicp_torch.config.SLAMConfig(pgo_iters=iters,
                                                                     pgo_huber=huber),
                                 device="cpu")
    P = ot.poses
    np.testing.assert_allclose(P, np.asarray(oj.poses), atol=1e-4)
    np.testing.assert_array_equal(ot.edge_info, gt.edge_info)   # raw scale kept
    if case == "square":
        before, after = tpg.graph_cost(gt, "cpu"), tpg.graph_cost(ot, "cpu")
        np.testing.assert_allclose(after, float(jpg.graph_cost(oj)), rtol=1e-3)
        assert after < before * 0.2, (before, after)
        assert np.linalg.norm(P[4][:3, 3]) < 0.5 * np.linalg.norm(gt.poses[4][:3, 3])
        np.testing.assert_allclose(P[0], np.eye(4), atol=1e-3)     # the gauge
    elif case == "chain":
        np.testing.assert_allclose(P[:6], gt.poses[:6], atol=2e-3)
    elif case == "aniso_full":
        assert abs(P[1][0, 3] - 1.0) < 0.05 and abs(P[1][1, 3] - 1.0) < 0.1, P[1]
    else:
        assert abs(P[1][1, 3] - 1.0) > 0.2, P[1]


def test_pose_graph_capacity_overflow_raises():
    graph = tpg.PoseGraph.empty(2, 1)
    graph = tpg.add_pose(graph, np.eye(4, dtype=np.float32))
    graph = tpg.add_pose(graph, np.eye(4, dtype=np.float32))
    with pytest.raises(ValueError, match="keyframe capacity"):
        tpg.add_pose(graph, np.eye(4, dtype=np.float32))
    graph = tpg.add_edge(graph, 0, 1, np.eye(4, dtype=np.float32), 1.0)
    with pytest.raises(ValueError, match="edge capacity"):
        tpg.add_edge(graph, 0, 1, np.eye(4, dtype=np.float32), 1.0)
    assert graph.n_poses == 2 and graph.n_edges == 1


def test_descriptor_and_keyframe_due_match_jax(rng):
    lab = rng.integers(0, 9, size=1000).astype(np.int32)
    xyz = rng.normal(size=(1000, 3)).astype(np.float32) * 4
    for args in ((lab, 8), (lab, 8, xyz)):
        np.testing.assert_array_equal(tkf.semantic_descriptor(*args),
                                      jkf.semantic_descriptor(*args))
    cfg = semicp.Config().slam
    T0 = T_of([0.3, -1.0, 0.2, 0.1, 0.0, 0.4]).astype(np.float64)
    for v in ([0.5, 0, 0, 0, 0, 0], [cfg.keyframe_trans * 1.5, 0, 0, 0, 0, 0],
              [0, 0, 0, 0, 0, cfg.keyframe_rot * 1.5], [1.9, 0.3, 0, 0, 0, 0.1],
              [0, 0, 0, 0.1, 0, 0.13]):
        T = T0 @ T_of(v)
        assert tkf.keyframe_due(T0, T, cfg) == bool(jkf.keyframe_due(T0, T, cfg)), v


def keyframe_stores(rng, n_kf, n_pad=512, K=4, cov=True):
    """The same keyframes in both packages: JAX-preprocessed clouds (bare
    CovConfig, as tests/test_slam.py's verifier test makes them) and their
    port copies on the CPU, at poses 0.05 m apart along x."""
    cfg = semicp.Config().override({"cloud.n_pad": n_pad, "cloud.num_classes": K})
    xyz, lab = make_scene(rng, n_points=300, extent=6.0, n_classes=K)
    lab = lab - 1
    poses = np.tile(np.eye(4), (n_kf, 1, 1))
    js, ts = jkf.KeyframeStore(), tkf.KeyframeStore()
    for i in range(n_kf):
        src, slab, _ = make_pair(rng, xyz, lab, np.array([0.05 * i, 0, 0, 0, 0, 0]), n_classes=K)
        c = semicp.make_cloud(src, slab, n_pad=n_pad)
        if cov:
            c = semicp.preprocess_cloud(c, cfg.cov)
        desc = jkf.semantic_descriptor(slab, K, src)
        js.add(i, poses[i], c, desc)
        ts.add(i, poses[i], cloud_from_numpy(c.xyz, c.label, c.cov6, c.valid, c.count,
                                             layout=c.layout, device="cpu"), desc)
    return js, ts, poses


def test_loop_verifier_matches_jax(rng):
    """tests/test_slam.py's verifier size (n_pad 512, 4 classes): the
    same accept flags and Z within 1e-4, on the very same clouds."""
    over = {"cloud.n_pad": 512, "cloud.num_classes": 4, "em.max_iters": 4, "gn.max_iters": 3}
    js, ts, poses = keyframe_stores(rng, 4)
    oj = JLoopVerifier(semicp.Config().override(over)).verify(js, [0, 1, 2], 3, poses)
    v = LoopVerifier(semicp_torch.Config().override(over))
    ot = v.verify(ts, [0, 1, 2], 3, poses)
    assert [c for c, *_ in ot] == [c for c, *_ in oj] == [0, 1, 2]
    assert [ok for _, ok, *_ in ot] == [bool(ok) for _, ok, *_ in oj]
    assert all(ok for _, ok, *_ in ot)
    assert np.all(v.last["n_corr"] > 1.1 * v.last["n_min"])      # not near the bound
    for (_, _, Zt, it, Ht), (_, _, Zj, ij, Hj) in zip(ot, oj):
        np.testing.assert_allclose(Zt, Zj, atol=1e-4)
        np.testing.assert_allclose(it, ij, rtol=1e-3)
        np.testing.assert_allclose(Ht, Hj, rtol=1e-3, atol=1e-3 * np.abs(Hj).max())
    assert v.verify(ts, [], 3, poses) == []


def test_batched_align_equals_serial_aligns(rng):
    """One batch of pairs equals serial make_align_fn calls to the bit."""
    cfg = semicp_torch.Config().override({"cloud.n_pad": 512, "cloud.num_classes": 4,
                                          "em.max_iters": 6})
    _, ts, _ = keyframe_stores(rng, 3)
    T0 = np.stack([np.eye(4), T_of([0.1, 0, 0, 0, 0, 0.02]), T_of([0, 0.2, 0, 0, 0, 0])])
    src, tgt = [ts[2].cloud, ts[1].cloud, ts[2].cloud], [ts[0].cloud, ts[0].cloud, ts[1].cloud]
    res = batched_align(cfg)(src, tgt, T0.astype(np.float32), gate=2.5, max_iters=8)
    align = semicp_torch.make_align_fn(cfg)
    for b in range(3):
        r = align(src[b], tgt[b], torch.from_numpy(T0[b].astype(np.float32)), gate=2.5,
                  max_iters=8)
        for f in dataclasses.fields(r):
            assert torch.equal(getattr(res, f.name)[b], getattr(r, f.name)), f.name
    with pytest.raises(ValueError):
        batched_align(cfg)(src, tgt[:2], T0)


def test_propose_loop_closures_matches_jax(rng):
    js, ts, _ = keyframe_stores(rng, 6, cov=False)
    poses = np.stack([T_of([1.5 * i * (i < 4) + 1.5 * (7 - i) * (i >= 4), 0.3 * i, 0, 0, 0, 0])
                      for i in range(6)]).astype(np.float64)
    for over in ({"slam.lc_min_gap": 2, "slam.lc_max_dist": 4.0},
                 {"slam.lc_min_gap": 1, "slam.lc_max_dist": 10.0, "slam.lc_desc_thresh": 0.05}):
        cj, ct = semicp.Config().override(over), semicp_torch.Config().override(over)
        for k in range(6):
            assert propose_loop_closures(ts, ts[k], poses, ct) == j_propose(js, js[k], poses, cj)


def test_build_submap_matches_jax(rng):
    """Points and labels equal to the bit (fusion, voxel, the seeded
    subsample and the class-major sort); covariances to the tolerance of
    tests/test_torch_covariance.py's full-Config case."""
    over = {"cloud.n_pad": 1024, "cloud.num_classes": 4}
    cj, ct = semicp.Config().override(over), semicp_torch.Config().override(over)
    js, ts, _ = keyframe_stores(rng, 4, n_pad=1024)
    poses = np.stack([T_of([0.4 * i, 0.1 * i, 0, 0, 0, 0.05 * i]) for i in range(4)])
    # 900 points, about 790 after the voxel grid, subsampled to 512
    sj = j_build_submap(js.keyframes[1:], poses, 3, cj, voxel=0.1, n_pad=512)
    st = build_submap(ts.keyframes[1:], poses, 3, ct, voxel=0.1, n_pad=512)
    assert st.layout == sj.layout == "cm" and int(st.count) == int(sj.count) == 512
    np.testing.assert_array_equal(st.xyz.numpy(), np.asarray(sj.xyz))
    np.testing.assert_array_equal(st.label.numpy(), np.asarray(sj.label))
    np.testing.assert_array_equal(st.valid.numpy(), np.asarray(sj.valid))
    c_t, c_j = st.cov6.numpy(), np.asarray(sj.cov6)
    np.testing.assert_allclose(c_t, c_j, rtol=2e-3, atol=0.2)
    assert np.isclose(c_t, c_j, rtol=2e-3, atol=2e-3).mean() > 0.995


@pytest.mark.parametrize("voxel,n_pad", [(0.1, 512), (0.1, 1024), (0.0, 1024), (0.3, 256)])
def test_submap_points_match_plain(rng, voxel, n_pad):
    """The fusion of build_submap on tensors (here CPU ones) against its
    numpy plain version: the same points and labels in the same order, to
    the bit, where the voxel grid's count exceeds the capacity (the seeded
    subsample) and where it fits, and with no voxel grid."""
    _, ts, _ = keyframe_stores(rng, 4, n_pad=1024)
    poses = np.stack([T_of([0.4 * i, 0.1 * i, 0, 0, 0, 0.05 * i]) for i in range(4)])
    xyz, lab = submap_points(ts.keyframes[1:], poses, 3, voxel, n_pad)
    pts, lab_p = submap_points_plain(ts.keyframes[1:], poses, 3, voxel, n_pad)
    assert xyz.shape[1] == len(pts) <= n_pad
    np.testing.assert_array_equal(xyz.numpy().T, pts)
    np.testing.assert_array_equal(lab.numpy(), lab_p)


def jax_state(rng):
    """A SLAM state the JAX package's `_capture_state` makes from JAX
    objects: three keyframes, two edges (one with a Hessian)."""
    js, _, poses = keyframe_stores(rng, 3)
    g = jpg.PoseGraph.empty(8, 16)
    for i in range(3):
        g = jpg.add_pose(g, poses[i].astype(np.float32))
    g = jpg.add_edge(g, 0, 1, T_of([0.05, 0, 0, 0, 0, 0]), 3.0)
    g = jpg.add_edge(g, 1, 2, T_of([0.05, 0, 0, 0, 0, 0]), 2.0, H=ANISO_H)
    anchors = [(0, np.eye(4)), (0, T_of([0.02, 0, 0, 0, 0, 0]).astype(np.float64)),
               (1, np.eye(4)), (2, np.eye(4))]
    state = j_capture_state(g, js, anchors, np.eye(4) * 1.0, np.eye(4, dtype=np.float32),
                            js[2].cloud, 4)
    return state, g, js


def test_restore_state_from_jax_capture(rng):
    """A state captured from the JAX package's objects, as numpy, restores
    in the port: the same graph, keyframes, anchors and clouds."""
    state, gj, js = jax_state(rng)
    graph, store, anchors, T_now, T_rel_prev, prev, frame = _restore_state(
        state, semicp_torch.Config(), "cpu")
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(graph, f)), np.asarray(getattr(gj, f)))
    assert isinstance(graph.n_poses, int) and isinstance(graph.n_edges, int)
    assert len(store) == 3 and [k.frame for k in store.keyframes] == [0, 1, 2]
    for kt, kj in zip(store.keyframes, js.keyframes):
        np.testing.assert_array_equal(kt.cloud.cov6.numpy(), np.asarray(kj.cloud.cov6))
        np.testing.assert_array_equal(kt.descriptor, kj.descriptor)
        assert int(kt.cloud.count) == int(kj.cloud.count)
    assert [a for a, _ in anchors] == [0, 0, 1, 2] and frame == 4
    np.testing.assert_array_equal(prev.xyz.numpy(), np.asarray(js[2].cloud.xyz))
    # and the port's capture of what it restored is the JAX capture again
    again = _capture_state(graph, store, anchors, T_now, T_rel_prev, prev, frame)
    flat_j = {k: np.asarray(v) for k, v in _flatten(state).items()}
    flat_t = _flatten(again)
    assert set(flat_t) == set(flat_j)
    for k in flat_j:
        np.testing.assert_array_equal(flat_t[k], flat_j[k], err_msg=k)


def _flatten(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_checkpoint_round_trip(rng, tmp_path):
    state, _, _ = jax_state(rng)
    state = {k: (np.asarray(v) if not isinstance(v, dict) else v) for k, v in state.items()}
    assert latest_checkpoint(tmp_path / "none") == (None, None)
    save_checkpoint(tmp_path, state, step=2)
    save_checkpoint(tmp_path, {**state, "frame": np.asarray(9, np.int32)}, step=10)
    step, back = latest_checkpoint(tmp_path)
    assert step == 10 and int(back["frame"]) == 9
    flat_a, flat_b = _flatten(state), _flatten(back)
    assert set(flat_a) == set(flat_b)
    for k in flat_a:
        if k != "frame":
            assert flat_b[k].dtype == flat_a[k].dtype, k
            np.testing.assert_array_equal(flat_b[k], flat_a[k], err_msg=k)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_10.pt", "step_2.pt"]


SLAM = ["--synthetic", "16", "--n-points", "600", "--cloud.n_pad=1024",
        "--cloud.num_classes=8", "--em.max_iters=10"]


def test_run_slam_matches_jax(tmp_path):
    """All of run_slam, loop-free: the same keyframes and edges, and
    every position within 1e-3 m of semicp.cli.run_slam's."""
    oj = j_slam_main(SLAM + ["--out", str(tmp_path / "j.txt")])
    ot = t_slam_main(SLAM + ["--out", str(tmp_path / "t.txt"), "--device", "cpu"])
    for k in ("frames", "keyframes", "edges", "loop_edges"):
        assert ot[k] == oj[k], k
    assert ot["frames"] == 16 and ot["keyframes"] >= 4 and ot["device"] == "cpu"
    assert set(ot) == set(oj) | {"device"}
    a = np.loadtxt(tmp_path / "j.txt").reshape(-1, 3, 4)
    b = np.loadtxt(tmp_path / "t.txt").reshape(-1, 3, 4)
    np.testing.assert_allclose(b[:, :, 3], a[:, :, 3], atol=1e-3)
    assert abs(ot["ate_rmse_m"] - oj["ate_rmse_m"]) < 1e-3


def test_run_slam_raises_for_dist_and_missing_card(tmp_path):
    """--dist runs where --device says (on the CPU a gloo group of one; two
    frames make one keyframe, so no map BA); without a card the default
    device raises, with --dist or not: nothing falls back to the CPU."""
    args = SLAM[:1] + ["2"] + SLAM[2:] + ["--out", str(tmp_path / "p.txt")]
    out = t_slam_main(args + ["--dist", "--device", "cpu"])
    assert out["frames"] == 2 and out["device"] == "cpu" and "map_ba" not in out
    if not torch.cuda.is_available():
        for extra in ([], ["--dist"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                t_slam_main(args + extra)
