"""semicp_torch.dist over 2 and 4 ranks against semicp.dist on its CPU mesh.

The port's ranks are gloo processes on the CPU (tests/torch_gloo_workers.py,
each spawn with its own deadline); the JAX references run here on the
8-device CPU mesh of tests/conftest.py, cut to W devices.

Tolerances:
- Ring NN: within the gate (the sparse engine prunes beyond it), d2 within
  rtol 1e-4 and the winner's rows within 1e-5, as
  tests/test_dist_ring_schur.py holds the JAX ring to the single-device NN.
- Distributed align: T within 1e-4 of JAX's and of the port's single-device
  align, with the same EM iterations (tests/test_map_ba.py's pair). On the
  CPU its M-step is G1d's float64 moment arithmetic, where JAX all-reduces
  f32 sums in every GN pass; over SPREAD_PAIRS more pairs both are held to
  one EM trajectory by `semicp_torch.eval.pairs.trip_parity` (equal trip
  counts: T within 1e-4; counts one apart: T within 1e-4 at the smaller
  count, and the final T's within 1e-4 plus the extra pass's step), as
  JAX's distributed align is held to its own single-device align.
- Distributed GN: T within 1e-5, H within 1e-4 of its largest entry, as
  tests/test_torch_register.py holds the one-device M-step; G1d's moment
  M-step (its float64 mirror over the ranks) T within 1e-5, its
  all-reduced row within 1e-12 relative of the whole planes' (float64
  sums in another order).
- A batch over the mesh equals serial aligns to the bit (the gather adds
  zeros), and within 1e-4 the JAX package's aligns.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import semicp
import semicp_torch
import torch_gloo_workers as workers
from semicp.cli.run_slam import main as j_slam_main
from semicp.corr.pallas_nn2 import class_nn_attrs_xla
from semicp.data import make_pair as j_make_pair
from semicp.data import make_scene as j_make_scene
from semicp.dist import make_mesh as j_make_mesh
from semicp.dist.align_dist import make_dist_align_fn as j_make_dist_align_fn
from semicp.dist.ring_corr import make_ring_nn as j_make_ring_nn
from semicp.register.gauss_newton import gn_solve as j_gn_solve
from semicp_torch.cli.run_slam import main as t_slam_main
from semicp_torch.convert import cloud_from_numpy
from semicp_torch.dist import shard_batch
from semicp_torch.dist.mesh import Mesh, shard_bounds
from semicp_torch.eval.pairs import trip_parity
from semicp_torch.register.gauss_newton import gn_moments_plain

K_RING, N_RING, Q_RING, GATE = 4, 2048, 1024, 2.0
ALIGN = ["--cloud.n_pad=2048", "--cloud.num_classes=5", "--em.max_iters=12"]
BATCH_PAIRS, BATCH_PAD = 3, 512
GN_N = 4096
SPREAD_PAIRS = 12
FIELDS = ("xyz", "label", "cov6", "valid", "count")


def jmesh(w):
    return j_make_mesh({"blocks": w}, devices=jax.devices()[:w])


def ring_inputs(rng):
    """tests/test_dist_ring_schur.py's sparse case: 2048 map points, 1024
    queries, 4 classes."""
    return {"ring_xyz": rng.normal(size=(3, N_RING)).astype(np.float32) * 8,
            "ring_lab": rng.integers(0, K_RING, size=N_RING).astype(np.int32),
            "ring_val": rng.uniform(size=N_RING) > 0.1,
            "ring_cov6": rng.normal(size=(6, N_RING)).astype(np.float32),
            "ring_q": rng.normal(size=(3, Q_RING)).astype(np.float32) * 8,
            "ring_k": K_RING, "ring_gate": GATE}


def align_inputs(rng):
    """tests/test_map_ba.py's pair, preprocessed by the JAX package."""
    cfg = semicp.Config().override(semicp.config.parse_overrides(ALIGN))
    tgt_pts, tgt_lab = j_make_scene(rng, n_points=1900, extent=15.0, n_classes=5)
    tgt_lab = tgt_lab - 1
    delta = np.array([0.25, -0.1, 0.04, 0.008, -0.015, 0.02])
    src_pts, src_lab, T_gt = j_make_pair(rng, tgt_pts, tgt_lab, delta, noise=0.01, dropout=0.05,
                                         n_classes=5)
    out = {"overrides": np.asarray(ALIGN), "T_gt": T_gt}
    for tag, (p, lab) in (("src", (src_pts, src_lab)), ("tgt", (tgt_pts, tgt_lab))):
        c = semicp.preprocess_cloud(semicp.make_cloud(p, lab, n_pad=2048), cfg.cov)
        out.update({f"{tag}_{f}": np.asarray(getattr(c, f)) for f in FIELDS})
    return out, cfg


def spread_inputs():
    """SPREAD_PAIRS pairs like align_inputs', each from its own seed, with
    growing offsets, 2 cm noise and 30% dropout, preprocessed by the JAX
    package: fields spread<i>_<src|tgt>_<field>."""
    cfg = semicp.Config().override(semicp.config.parse_overrides(ALIGN))
    out = {"spread_pairs": SPREAD_PAIRS}
    for i in range(SPREAD_PAIRS):
        rng = np.random.default_rng(i)
        tgt_pts, tgt_lab = j_make_scene(rng, n_points=1900, extent=15.0, n_classes=5)
        tgt_lab = tgt_lab - 1
        delta = np.array([0.25, -0.1, 0.04, 0.008, -0.015, 0.02]) * (1 + 0.25 * i)
        src_pts, src_lab, _ = j_make_pair(rng, tgt_pts, tgt_lab, delta, noise=0.02, dropout=0.3,
                                          n_classes=5)
        for tag, (p, lab) in (("src", (src_pts, src_lab)), ("tgt", (tgt_pts, tgt_lab))):
            c = semicp.preprocess_cloud(semicp.make_cloud(p, lab, n_pad=2048), cfg.cov)
            out.update({f"spread{i}_{tag}_{f}": np.asarray(getattr(c, f)) for f in FIELDS})
    return out


def jax_clouds(inp, prefix):
    """The (source, target) JAX clouds of inp's fields prefix<src|tgt>_<field>."""
    return tuple(semicp.cloud.Cloud(**{f: jnp.asarray(inp[f"{prefix}{t}_{f}"]) for f in FIELDS})
                 for t in ("src", "tgt"))


def jax_runs(make_fn, cfg, fn=None):
    """run(src, tgt, max_iters) -> (T, iterations) of make_fn(cfg with
    em.max_iters = max_iters; the config's own where None), one function
    kept a count (fn, where given, is the config's own)."""
    fns = {} if fn is None else {None: fn}

    def run(src, tgt, mi):
        if mi not in fns:
            fns[mi] = make_fn(cfg if mi is None else cfg.override({"em.max_iters": mi}))
        res = fns[mi](src, tgt)
        return np.asarray(res.T), int(res.iterations)

    return run


def gn_inputs(rng):
    """Planes shaped like the E-step's, their minimum a small known motion
    (tests/test_torch_register.py `test_gn_solve_matches_jax`)."""
    M = rng.normal(size=(GN_N, 3, 3))
    A = M @ np.swapaxes(M, -1, -2) + np.eye(3) * 0.1
    a6 = np.stack([A[:, 0, 0], A[:, 1, 1], A[:, 2, 2], A[:, 0, 1], A[:, 0, 2], A[:, 1, 2]])
    z = rng.normal(size=(3, GN_N)) * 5
    T_star = np.asarray(semicp.geom.se3_exp(jnp.asarray([0.1, -0.05, 0.02, 0.01, 0.02, -0.03],
                                                         jnp.float32)), np.float64)
    x = T_star[:3, :3] @ z + T_star[:3, 3:]
    b3 = np.einsum("nij,jn->in", A, x)
    c = np.einsum("in,in->n", x, b3)
    gcfg = semicp.Config().gn
    keys = ("max_iters", "lm_lambda0", "lm_up", "lm_down", "step_eps")
    return {"gn_z": z.astype(np.float32), "gn_a6": a6.astype(np.float32),
            "gn_b3": b3.astype(np.float32), "gn_c": c.astype(np.float32),
            "gn_cov6": rng.normal(size=(6, GN_N)).astype(np.float32),
            "gn_wsum": rng.uniform(size=GN_N).astype(np.float32),
            "gn_T0": np.eye(4, dtype=np.float32), "gn_keys": np.asarray(keys),
            "gn_vals": np.asarray([getattr(gcfg, k) for k in keys], np.float64)}


def batch_inputs(rng):
    """tests/test_multihost.py's pairs (400 points, 4 classes), three of them."""
    out = {"batch_pairs": BATCH_PAIRS, "batch_n_pad": BATCH_PAD}
    for s in range(BATCH_PAIRS):
        xyz, lab = j_make_scene(rng, n_points=400, extent=8.0, n_classes=4)
        lab = lab - 1
        delta = np.array([0.2, -0.1, 0.03, 0.01, -0.01, 0.02]) * (1 + 0.2 * s)
        src, slab, _ = j_make_pair(rng, xyz, lab, delta, n_classes=4)
        out.update({f"batch_src{s}": src, f"batch_srclab{s}": slab,
                    f"batch_tgt{s}": xyz, f"batch_tgtlab{s}": lab})
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"W{w}")
def dist_run(request, tmp_path_factory):
    """One spawn of W gloo ranks running every check of the `dist` task,
    and the JAX package's results on the same inputs over W devices."""
    w = request.param
    rng = np.random.default_rng(0)
    inp = ring_inputs(rng)
    al, cfg = align_inputs(rng)
    inp.update(al)
    inp.update(gn_inputs(rng))
    inp.update(batch_inputs(rng))
    inp.update(spread_inputs())
    inp["overrides"] = np.asarray(ALIGN + ["--gn.max_iters=4"])
    cfg = cfg.override({"gn.max_iters": 4})
    d = tmp_path_factory.mktemp(f"dist{w}")
    np.savez(d / "in.npz", **inp)
    outs = workers.spawn("dist", w, d)

    mesh = jmesh(w)
    ref = {}
    ring_args = [jnp.asarray(inp[f"ring_{f}"]) for f in ("q", "xyz", "lab", "val", "cov6")]
    ref["ring"] = [np.asarray(a) for a in j_make_ring_nn(mesh, K_RING, engine="xla")(*ring_args)]
    ref["ring_single"] = [np.asarray(a) for a in class_nn_attrs_xla(*ring_args[1:], ring_args[0],
                                                                     K_RING)]
    src, tgt = (semicp.cloud.Cloud(**{f: jnp.asarray(inp[f"{t}_{f}"]) for f in FIELDS})
                for t in ("src", "tgt"))
    jdist = j_make_dist_align_fn(mesh, cfg)
    res = jdist(src, tgt)
    ref["align"] = (np.asarray(res.T), int(res.iterations))
    ref["dist_run"] = jax_runs(lambda c: j_make_dist_align_fn(mesh, c), cfg, jdist)
    tcfg = semicp_torch.Config().override(
        semicp_torch.config.parse_overrides(list(inp["overrides"])))
    ts, tt = (cloud_from_numpy(*(inp[f"{t}_{f}"] for f in FIELDS), device="cpu")
              for t in ("src", "tgt"))
    res = semicp_torch.make_align_fn(tcfg)(ts, tt)
    ref["align_single"] = (res.T.numpy(), int(res.iterations))

    def gn(T0, z, a6, b3, c):
        return j_gn_solve(T0, tuple(z), tuple(a6), tuple(b3), c, cfg.gn, axis_name="blocks")

    pl = P(None, "blocks")
    fn = jax.jit(jax.shard_map(gn, mesh=mesh, in_specs=(P(), pl, pl, pl, P("blocks")),
                               out_specs=(P(), P(), P(), P()), check_vma=False))
    ref["gn"] = [np.asarray(a) for a in fn(jnp.eye(4), *(jnp.asarray(inp[f"gn_{f}"])
                                                        for f in ("z", "a6", "b3", "c")))]
    return w, inp, ref, outs, tcfg


@pytest.mark.parametrize("engine", ["xla", "sparse", "dense"])
def test_ring_nn_matches_jax(dist_run, engine):
    """Each rank's query shard against the whole map: JAX's ring (xla
    engine) and the single-device NN, within the gate; the port's sparse
    and dense engines run their kernels' plain versions here."""
    w, inp, ref, outs, _ = dist_run
    d2 = np.concatenate([o[f"ring_d2_{engine}"] for o in outs], axis=1)
    at = np.concatenate([o[f"ring_at_{engine}"] for o in outs], axis=2)
    for d2_ref, at_ref in (ref["ring"], ref["ring_single"]):
        inside = d2_ref <= GATE * GATE * (1.0 - 1e-5)
        assert inside.any()
        np.testing.assert_allclose(d2[inside], d2_ref[inside], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.moveaxis(at, 1, 0)[:, inside],
                                   np.moveaxis(at_ref, 1, 0)[:, inside], atol=1e-5)
        # beyond the gate the sparse engine may prune to INF, never fabricate
        assert (d2 >= d2_ref * (1 - 1e-4) - 1e-3).all()
        if engine != "sparse":
            found = d2_ref < 1e30
            assert (found == (d2 < 1e30)).all()


@pytest.mark.parametrize("engine", ["xla", "sparse"])
def test_dist_align_matches_jax_and_single(dist_run, engine):
    """One align spread over W ranks (ring NN, all-reduced GN, the flag's
    MIN) against JAX's make_dist_align_fn at D = W and the port's align on
    one device: T within 1e-4, the same iterations, the same on every rank."""
    w, inp, ref, outs, _ = dist_run
    T = outs[0][f"align_T_{engine}"]
    for o in outs[1:]:
        np.testing.assert_array_equal(o[f"align_T_{engine}"], T)
        assert int(o[f"align_it_{engine}"]) == int(outs[0][f"align_it_{engine}"])
    for T_ref, it_ref in (ref["align"], ref["align_single"]):
        np.testing.assert_allclose(T, T_ref, rtol=0, atol=1e-4)
        assert int(outs[0][f"align_it_{engine}"]) == it_ref
    err = T.astype(np.float64) @ np.linalg.inv(inp["T_gt"].astype(np.float64))
    assert np.linalg.norm(err[:3, 3]) < 0.02


def test_dist_align_pairs_hold_the_trip_rule(dist_run):
    """The distributed align through G1d's moment arithmetic (the CPU path)
    over W ranks against JAX's make_dist_align_fn at D = W, on every one of
    SPREAD_PAIRS pairs, by `trip_parity`: the port's pose after each pass
    is read from its run's trajectory, JAX's by a run at that
    em.max_iters. Every rank's trajectory is the same to the bit."""
    w, inp, ref, outs, tcfg = dist_run
    for i in range(SPREAD_PAIRS):
        traj = outs[0][f"spread_traj{i}"]
        for o in outs[1:]:
            np.testing.assert_array_equal(o[f"spread_traj{i}"], traj)
        n = len(traj) - 1
        src, tgt = jax_clouds(inp, f"spread{i}_")

        def port(mi, traj=traj, n=n):
            k = n if mi is None else min(mi, n)
            return traj[k], k

        r = trip_parity(port, lambda mi: ref["dist_run"](src, tgt, mi), tcfg.em.trans_eps)
        assert r["ok"], (i, r)


def test_jax_dist_align_spread_against_single():
    """The reference's own spread: JAX's make_dist_align_fn at W = 4 (f32
    sums all-reduced in every GN pass) against JAX's single-device align
    on the SPREAD_PAIRS pairs, held to one EM trajectory by `trip_parity`,
    as the port's distributed align is. Measured on the CPU mesh: trip
    counts 3 on one pair and 4 on eleven, equal on every pair; max |dT|
    1.2e-7 to 1.3e-6, and 3.4e-5 on pair 8. The reordered sums move T at
    rounding, as the moment arithmetic does; where such a move meets an
    em_step within rounding of em.trans_eps, the trip count moves by one."""
    inp = spread_inputs()
    cfg = semicp.Config().override(semicp.config.parse_overrides(ALIGN))
    dist = jax_runs(lambda c: j_make_dist_align_fn(jmesh(4), c), cfg)
    single = jax_runs(semicp.make_align_fn, cfg)
    for i in range(SPREAD_PAIRS):
        src, tgt = jax_clouds(inp, f"spread{i}_")
        r = trip_parity(lambda mi: dist(src, tgt, mi), lambda mi: single(src, tgt, mi),
                        cfg.em.trans_eps)
        assert r["ok"], (i, r)


def test_gn_solve_dist_plain_matches_jax(dist_run):
    """gn_solve_dist_plain over W ranks against JAX's gn_solve(axis_name=...)
    under shard_map; em_tail_dist on CPU tensors is G1d's plain version,
    em_tail_dist_moments_plain, to the bit."""
    w, inp, ref, outs, _ = dist_run
    Tj, cj, sj, Hj = ref["gn"]
    for o in outs:
        np.testing.assert_array_equal(o["gn_T"], outs[0]["gn_T"])
        np.testing.assert_allclose(o["gn_T"], Tj, atol=1e-5)
        np.testing.assert_allclose(o["gn_H"], Hj, rtol=1e-4, atol=1e-4 * np.abs(Hj).max())
        np.testing.assert_allclose(float(o["gn_step"]), float(sj), rtol=1e-3, atol=1e-6)
        assert bool(o["tail_equal"])
        np.testing.assert_allclose(float(o["tail_n_corr"]), inp["gn_wsum"].sum(dtype=np.float64),
                                   rtol=1e-5)


def test_gn_moments_dist_matches_jax(dist_run):
    """G1d's M-step on its float64 mirror over W ranks (each rank's moment
    row of its columns, all-reduced over gloo, then every GN pass from the
    row) against the per-pass all-reduced gn_solve_dist_plain and JAX's
    gn_solve(axis_name=...): T within 1e-5, the same row and T on every
    rank, and the row equal to the whole planes' within 1e-12 relative."""
    w, inp, ref, outs, _ = dist_run
    whole = gn_moments_plain(*(torch.from_numpy(inp[f"gn_{f}"]) for f in
                               ("z", "a6", "b3", "c", "wsum"))).numpy()
    for o in outs:
        np.testing.assert_array_equal(o["mom_row"], outs[0]["mom_row"])
        np.testing.assert_array_equal(o["mom_T"], outs[0]["mom_T"])
        assert int(o["mom_passes"]) == int(outs[0]["mom_passes"])
        np.testing.assert_allclose(o["mom_T"], o["gn_T"], atol=1e-5)
        np.testing.assert_allclose(o["mom_T"], ref["gn"][0], atol=1e-5)
        np.testing.assert_array_equal(o["tail_T"], o["mom_T"])
    np.testing.assert_allclose(outs[0]["mom_row"], whole, rtol=1e-12, atol=0)


def test_two_process_full_program(dist_run):
    """The counterpart of tests/test_multihost.py's two-process program: a
    batch of pairs aligned over the ranks (three pairs, so the shares are
    uneven at W = 2) equals the serial aligns to the bit and JAX's within
    1e-4, on every rank; the ring across the process boundary is
    test_ring_nn_matches_jax."""
    w, inp, ref, outs, tcfg = dist_run
    cfg = tcfg.override({"cloud.n_pad": BATCH_PAD})
    jcfg = semicp.Config().override({"cloud.n_pad": BATCH_PAD, "cloud.num_classes": 5,
                                     "em.max_iters": 12, "gn.max_iters": 4})
    align = semicp_torch.make_align_fn(cfg)
    for s in range(BATCH_PAIRS):
        pts = [(inp[f"batch_{t}{s}"], inp[f"batch_{t}lab{s}"]) for t in ("src", "tgt")]
        tc = [semicp_torch.preprocess_cloud(
            semicp_torch.make_cloud(p, lab, n_pad=BATCH_PAD, device="cpu"), cfg.cov)
            for p, lab in pts]
        jc = [semicp.preprocess_cloud(semicp.make_cloud(p, lab, n_pad=BATCH_PAD), jcfg.cov)
              for p, lab in pts]
        T_serial = align(*tc).T.numpy()
        T_jax = np.asarray(semicp.align(*jc, jcfg).T)
        for o in outs:
            np.testing.assert_array_equal(o["batch_T"][s], T_serial)
            np.testing.assert_allclose(o["batch_T"][s], T_jax, atol=1e-4)
        assert all(int(o["batch_it"][s]) == int(outs[0]["batch_it"][s]) for o in outs)


@pytest.mark.parametrize("n,world", [(3, 2), (8, 4), (2, 4), (7, 3)])
def test_shard_bounds_cover_in_order(n, world):
    """The shares of a batch are contiguous, in rank order, cover it once
    and differ by at most one; shard_batch hands each rank its share."""
    bounds = [shard_bounds(n, world, r) for r in range(world)]
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    sizes = [hi - lo for lo, hi in bounds]
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes, reverse=True)
    items = list(range(n))
    shares = [shard_batch(Mesh(rank=r, world=world, device=torch.device("cpu"), backend="gloo"),
                          items) for r in range(world)]
    assert sum(shares, []) == items


def test_run_slam_dist_matches_jax(tmp_path):
    """run_slam --dist on the CPU (a gloo group of one, the distributed
    align and the map BA) against the JAX driver on its 8-device mesh: the
    same keyframes and edges, the map BA's landmarks and observations
    within 2%, ATE within 1e-3 m (the BA's landmarks come from a voxel grid
    of the final poses, whose cells a point may change at 1e-6 m)."""
    args = ["--synthetic", "24", "--n-points", "700", "--cloud.n_pad=1024",
            "--cloud.num_classes=8", "--dist"]
    oj = j_slam_main(args + ["--out", str(tmp_path / "j.txt")])
    ot = t_slam_main(args + ["--out", str(tmp_path / "t.txt"), "--device", "cpu"])
    for k in ("frames", "keyframes", "edges", "loop_edges"):
        assert ot[k] == oj[k], k
    assert ot["keyframes"] >= 4 and set(ot["map_ba"]) >= set(oj["map_ba"])
    for k in ("landmarks", "observations"):
        assert abs(ot["map_ba"][k] - oj["map_ba"][k]) <= 0.02 * oj["map_ba"][k], k
    assert abs(ot["ate_rmse_m"] - oj["ate_rmse_m"]) < 1e-3
    assert ot["ate_rmse_m"] < 0.05
