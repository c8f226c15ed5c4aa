"""semicp_torch registration (normal equations, GN/LM, the whole EM
align) and its data, config and conversion helpers, against semicp on
the same numpy inputs, all on the CPU.

Tolerances: the whole slice runs the same algorithm in f32 with sums in
a different order, so T agrees to 1e-4 and the EM trip count to +-1 (the
early exits make it data dependent, as tests/test_register.py notes for
padding invariance); both must meet the ground-truth bounds of
test_align_recovers_gt.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import semicp
import semicp_torch
from semicp.data import make_pair as j_make_pair
from semicp.data import make_scene as j_make_scene
from semicp.geom.se3 import se3_inverse as j_se3_inverse
from semicp.geom.se3 import se3_log as j_se3_log
from semicp.register.gauss_newton import apply_T_planar as j_apply_T_planar
from semicp.register.gauss_newton import gn_solve as j_gn_solve
from semicp.oracle import OracleParams, estimate_covariances_np, semantic_icp_np
from semicp.register.residuals import normal_equations_collapsed as j_normal_eq
from semicp_torch.config import config_from_dict
from semicp_torch.convert import align_result_to_numpy, cloud_from_numpy
from semicp_torch.data import make_pair as t_make_pair
from semicp_torch.data import make_scene as t_make_scene
from semicp_torch.register.em_icp import resolve_engine
from semicp_torch.register.gauss_newton import em_tail, em_tail_plain, move_source
from semicp_torch.register.gauss_newton import gn_solve_plain as t_gn_solve_plain
from semicp_torch.register.residuals import normal_equations_collapsed as t_normal_eq

DELTA = np.array([0.3, -0.15, 0.05, 0.02, -0.01, 0.04])
OVER = {"cloud.num_classes": 6, "cloud.n_pad": 2048}


def pose_errors(T, T_ref):
    err = np.asarray(T, np.float64) @ np.linalg.inv(np.asarray(T_ref, np.float64))
    return (np.linalg.norm(err[:3, 3]),
            np.arccos(np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)))


@pytest.fixture
def pair(rng):
    """The pair of tests/test_register.py."""
    xyz, lab = j_make_scene(rng, n_points=1200)
    lab = lab - 1
    src, slab, T_gt = j_make_pair(rng, xyz, lab, DELTA, noise=0.01, dropout=0.2, n_classes=6)
    return src, slab, xyz, lab, T_gt


def collapsed_planes(rng, N=2048):
    """Per-point planes shaped like the E-step's output: A SPD."""
    M = rng.normal(size=(N, 3, 3))
    A = M @ np.swapaxes(M, -1, -2) + np.eye(3) * 0.1
    a6 = np.stack([A[:, 0, 0], A[:, 1, 1], A[:, 2, 2], A[:, 0, 1], A[:, 0, 2], A[:, 1, 2]])
    x = rng.normal(size=(3, N)) * 5
    b3 = np.einsum("nij,jn->in", A, x)
    c = np.einsum("in,in->n", x, b3) + rng.uniform(size=N)
    z = rng.normal(size=(3, N)) * 5
    return [a.astype(np.float32) for a in (a6, b3, c, z)]


def test_normal_equations_collapsed_matches_jax(rng):
    a6, b3, c, p = collapsed_planes(rng)
    Hj, gj, cj = j_normal_eq(tuple(jnp.asarray(a6)), tuple(jnp.asarray(b3)), jnp.asarray(c),
                             tuple(jnp.asarray(p)))
    Ht, gt, ct = t_normal_eq(torch.from_numpy(a6), torch.from_numpy(b3), torch.from_numpy(c),
                             tuple(torch.from_numpy(p)))
    # f32 sums of 2048 terms in different orders: relative to each block's scale
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=1e-4, atol=1e-4 * np.abs(Hj).max())
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-4, atol=1e-4 * np.abs(gj).max())
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-4)


def far_start_planes():
    """Eight points a few metres off the origin whose minimum is a large motion
    (5.5 m, 1.9 rad) from the identity: the first GN step overshoots, so the
    second pass's cost exceeds the first's and the LM schedule raises
    lambda."""
    rng = np.random.default_rng(10)
    M = rng.normal(size=(8, 3, 3))
    A = M @ np.swapaxes(M, -1, -2) + np.eye(3) * 0.1
    a6 = np.stack([A[:, 0, 0], A[:, 1, 1], A[:, 2, 2], A[:, 0, 1], A[:, 0, 2], A[:, 1, 2]])
    z = rng.normal(size=(3, 8)) * 3 + rng.normal(size=(3, 1)) * 5
    T_star = np.asarray(semicp.geom.se3_exp(jnp.asarray([2.0, 5.0, 1.0, -0.6, 1.5, 1.1],
                                                         jnp.float32)))
    x = T_star[:3, :3] @ z + T_star[:3, 3:]
    b3 = np.einsum("nij,jn->in", A, x)
    c = np.einsum("in,in->n", x, b3)
    return [a.astype(np.float32) for a in (a6, b3, c, z)], T_star


def gn_both(a6, b3, c, z, max_iters):
    """gn_solve of both packages from the identity: (JAX's, the port's),
    each as numpy (T, cost, step, H)."""
    cfg = semicp.Config().gn.__class__(max_iters=max_iters)
    tcfg = semicp_torch.Config().gn.__class__(max_iters=max_iters)
    rj = j_gn_solve(jnp.eye(4), tuple(jnp.asarray(z)), tuple(jnp.asarray(a6)),
                    tuple(jnp.asarray(b3)), jnp.asarray(c), cfg)
    rt = t_gn_solve_plain(torch.eye(4), tuple(torch.from_numpy(z)), torch.from_numpy(a6),
                          torch.from_numpy(b3), torch.from_numpy(c), tcfg)
    return [np.asarray(v) for v in rj], [v.numpy() for v in rt]


@pytest.mark.parametrize("case", [1, 8, "singular", "worse"])
def test_gn_solve_matches_jax(rng, case):
    """Same LM schedule, early exit and returned H; max_iters=1 also
    checks that the masked fixed loop stops where the while_loop does.
    "singular": all-zero planes make the damped system singular, so one
    pass leaves T and the step NaN and the cost 0, and the loop stops
    there. "worse": from a start far off, the second pass's cost exceeds
    the first's in both packages (lambda grows), compared after 3 passes."""
    a6, b3, c, z = collapsed_planes(rng)
    # make the minimum a small known motion of z: b = A T* z
    T_star = np.asarray(semicp.geom.se3_exp(jnp.asarray([0.1, -0.05, 0.02, 0.01, 0.02, -0.03],
                                                         jnp.float32)))
    A = np.asarray(semicp.geom.sym3.to_matrix(tuple(jnp.asarray(a6))))
    x = (T_star[:3, :3] @ z + T_star[:3, 3:]).astype(np.float32)
    b3 = np.einsum("nij,jn->in", A, x).astype(np.float32)
    c = np.einsum("in,in->n", x, b3).astype(np.float32)
    max_iters = case if isinstance(case, int) else {"singular": 8, "worse": 3}[case]
    if case == "singular":
        a6, b3, c = np.zeros_like(a6), np.zeros_like(b3), np.zeros_like(c)
    elif case == "worse":
        (a6, b3, c, z), T_star = far_start_planes()
        for costs in zip(*(gn_both(a6, b3, c, z, k) for k in (1, 2))):
            assert costs[1][1] > costs[0][1] > 0.0, costs
    (Tj, cj, sj, Hj), (Tt, ct, st, Ht) = gn_both(a6, b3, c, z, max_iters)
    np.testing.assert_allclose(Tt, Tj, atol=1e-5)
    np.testing.assert_allclose(Ht, Hj, rtol=1e-4, atol=1e-4 * np.abs(Hj).max())
    np.testing.assert_allclose(float(st), float(sj), rtol=1e-3, atol=1e-6)
    if case == 8:
        np.testing.assert_allclose(Tt, T_star, atol=1e-4)
    elif case == "singular":
        assert np.isnan(Tt[:3]).all() and np.isnan(st) and ct == cj == 0.0
        np.testing.assert_array_equal(Tt[3], [0.0, 0.0, 0.0, 1.0])
    elif case == "worse":
        np.testing.assert_allclose(float(ct), float(cj), rtol=1e-4)


@pytest.mark.parametrize("planes", ["tensor", "tuple"])
def test_gn_solve_dispatch(rng, planes):
    """On CPU tensors G1's wrappers take their plain versions to the bit:
    em_tail is em_tail_plain, whose M-step is gn_solve_plain, and
    move_source is em_tail's transform alone, with the source as the
    (3, N) planes em_icp passes or as three planes."""
    a6, b3, c, z = (torch.from_numpy(a) for a in collapsed_planes(rng))
    cov6 = torch.from_numpy(rng.normal(size=(6, z.shape[1])).astype(np.float32))
    wsum = torch.from_numpy(rng.uniform(size=z.shape[1]).astype(np.float32))
    cfg = semicp_torch.Config().gn
    src = z if planes == "tensor" else tuple(z)
    out = em_tail(torch.eye(4), src, cov6, a6, b3, c, wsum, cfg)
    ref = em_tail_plain(torch.eye(4), z, cov6, a6, b3, c, wsum, cfg)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    for a, b in zip(out, t_gn_solve_plain(torch.eye(4), tuple(z), a6, b3, c, cfg)):
        assert torch.equal(a, b)
    for a, b in zip(move_source(out.T, src, cov6), (out.moved, out.rc)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("angle", [1e-4, 3e-4, 1e-3, 0.05])
def test_em_tail_plain_matches_jax(rng, angle):
    """The plain EM-pass tail against the JAX package's lines that it
    replaces (semicp/register/em_icp.py `_estep` and the loop body), from
    a general pose T_in to the minimum a motion of `angle` rad (and about
    `angle` m) away, on the port's T_new: the moved source and rotated
    covariances to 4 ulp of their scale (f32 products and sums in one
    order; XLA may contract them), em_step to 2e-6 absolute and 1e-4
    relative (se3_log of T_new T_in^-1 in f32 on both sides; at 1e-4 to
    1e-3 rad the series' 1/theta^2 terms cancel in both, which moves only
    the W^2 term, of order theta^2), n_corr to 1e-5 relative (f32 sums of
    2048 terms in different orders), and T_new itself to JAX's gn_solve
    within 1e-5."""
    a6, _, _, z = collapsed_planes(rng)
    n = z.shape[1]
    cov6 = rng.normal(size=(6, n)).astype(np.float32)
    wsum = rng.uniform(size=n).astype(np.float32)
    T_in = np.asarray(semicp.geom.se3_exp(jnp.asarray([0.4, -1.2, 0.3, 0.2, -0.1, 0.5],
                                                      jnp.float32)))
    axis = np.array([0.3, -0.5, 0.8]) / np.linalg.norm([0.3, -0.5, 0.8])
    motion = (angle * np.concatenate([[0.6, -0.3, 0.4], axis])).astype(np.float32)
    T_star = np.asarray(semicp.geom.se3_exp(jnp.asarray(motion))) @ T_in
    A = np.asarray(semicp.geom.sym3.to_matrix(tuple(jnp.asarray(a6))))
    x = T_star[:3, :3] @ z + T_star[:3, 3:]
    b3 = np.einsum("nij,jn->in", A, x).astype(np.float32)
    c = np.einsum("in,in->n", x, b3).astype(np.float32)
    cfg = semicp_torch.Config().gn
    out = em_tail_plain(*(torch.from_numpy(np.array(v, np.float32))
                          for v in (T_in, z, cov6, a6, b3, c, wsum)), cfg)
    T_new = out.T.numpy()
    Tj = np.asarray(j_gn_solve(jnp.asarray(T_in), tuple(jnp.asarray(z)), tuple(jnp.asarray(a6)),
                               tuple(jnp.asarray(b3)), jnp.asarray(c), semicp.Config().gn)[0])
    np.testing.assert_allclose(T_new, Tj, atol=1e-5)
    Tn = jnp.asarray(T_new)
    moved_j = np.stack([np.asarray(p) for p in j_apply_T_planar(Tn, tuple(jnp.asarray(z)))])
    rc_j = np.stack([np.asarray(p) for p in semicp.geom.sym3.rotate(Tn[:3, :3],
                                                                    tuple(jnp.asarray(cov6)))])
    for name, got, ref in (("moved", out.moved.numpy(), moved_j), ("rc", out.rc.numpy(), rc_j)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=4 * np.spacing(np.abs(ref).max()),
                                   err_msg=name)
    step_j = float(jnp.linalg.norm(j_se3_log(Tn @ j_se3_inverse(jnp.asarray(T_in)))))
    np.testing.assert_allclose(float(out.em_step), step_j, rtol=1e-4, atol=2e-6)
    assert abs(float(out.em_step) - np.linalg.norm(motion)) < 1e-6 + 1e-3 * np.linalg.norm(motion)
    np.testing.assert_allclose(float(out.n_corr), float(jnp.sum(jnp.asarray(wsum))), rtol=1e-5)


def test_align_matches_jax_and_gt(pair):
    src, slab, tgt, tlab, T_gt = pair
    cj, ct = semicp.Config().override(OVER), semicp_torch.Config().override(OVER)
    rj = semicp.align(semicp.preprocess_cloud(semicp.make_cloud(src, slab, n_pad=2048), cj),
                      semicp.preprocess_cloud(semicp.make_cloud(tgt, tlab, n_pad=2048), cj), cj)
    rt = semicp_torch.align(
        semicp_torch.preprocess_cloud(semicp_torch.make_cloud(src, slab, n_pad=2048,
                                                              device="cpu"), ct),
        semicp_torch.preprocess_cloud(semicp_torch.make_cloud(tgt, tlab, n_pad=2048,
                                                              device="cpu"), ct), ct)
    np.testing.assert_allclose(rt.T.numpy(), np.asarray(rj.T), atol=1e-4)
    assert abs(int(rt.iterations) - int(rj.iterations)) <= 1
    assert bool(rt.converged) and bool(rj.converged)
    for T in (rt.T.numpy(), np.asarray(rj.T)):
        terr, rerr = pose_errors(T, T_gt)
        assert terr < 0.02 and rerr < 0.005, (terr, rerr)
    np.testing.assert_allclose(float(rt.n_corr), float(rj.n_corr), rtol=1e-3)


@pytest.mark.parametrize("start", ["identity", "offset"])
def test_align_keeps_jax_iterations(pair, start):
    """The CPU align, whose EM pass ends in the plain tail, takes as many
    EM iterations as semicp.align and lands within 1e-4 of it, from the
    identity and from a start 0.2 m / 0.05 rad off."""
    src, slab, tgt, tlab, T_gt = pair
    cj, ct = semicp.Config().override(OVER), semicp_torch.Config().override(OVER)
    T0 = np.eye(4, dtype=np.float32)
    if start == "offset":
        T0 = np.array(semicp.geom.se3_exp(jnp.asarray([0.2, 0.1, 0.0, 0.0, 0.0, 0.05],
                                                      jnp.float32)))
    rj = semicp.align(semicp.preprocess_cloud(semicp.make_cloud(src, slab, n_pad=2048), cj),
                      semicp.preprocess_cloud(semicp.make_cloud(tgt, tlab, n_pad=2048), cj), cj,
                      T_init=jnp.asarray(T0))
    rt = semicp_torch.align(
        semicp_torch.preprocess_cloud(semicp_torch.make_cloud(src, slab, n_pad=2048,
                                                              device="cpu"), ct),
        semicp_torch.preprocess_cloud(semicp_torch.make_cloud(tgt, tlab, n_pad=2048,
                                                              device="cpu"), ct), ct,
        T_init=torch.from_numpy(T0))
    np.testing.assert_allclose(rt.T.numpy(), np.asarray(rj.T), atol=1e-4)
    assert int(rt.iterations) == int(rj.iterations)
    assert bool(rt.converged) and bool(rj.converged)


def test_align_on_jax_preprocessed_clouds(pair):
    """Both packages align the very same preprocessed clouds."""
    src, slab, tgt, tlab, T_gt = pair
    cj = semicp.Config().override(OVER)
    cs = [semicp.preprocess_cloud(semicp.make_cloud(p, lab, n_pad=2048), cj)
          for p, lab in ((src, slab), (tgt, tlab))]
    rj = semicp.align(cs[0], cs[1], cj)
    tcfg = config_from_dict(dataclasses.asdict(cj))
    tc = [cloud_from_numpy(c.xyz, c.label, c.cov6, c.valid, c.count, layout=c.layout, device="cpu")
          for c in cs]
    for c, j in zip(tc, cs):
        np.testing.assert_array_equal(c.cov6.numpy(), np.asarray(j.cov6))
    out = align_result_to_numpy(semicp_torch.make_align_fn(tcfg)(tc[0], tc[1]))
    assert set(out) == {"T", "iterations", "converged", "cost", "n_corr", "H"}
    np.testing.assert_allclose(out["T"], np.asarray(rj.T), atol=1e-4)
    np.testing.assert_allclose(out["H"], np.asarray(rj.H), rtol=1e-3,
                               atol=1e-3 * np.abs(np.asarray(rj.H)).max())


def test_sparse_engine_on_cpu_sorts_raw_source(pair):
    """engine='sparse' on a CPU runs the plain versions over a prepared
    target; a raw source is sorted inside align as in the JAX package."""
    src, slab, tgt, tlab, T_gt = pair
    ct = semicp_torch.Config().override({**OVER, "corr.engine": "sparse"})
    s = semicp_torch.preprocess_cloud(semicp_torch.make_cloud(src, slab, n_pad=2048,
                                                              device="cpu"), ct.cov)
    t = semicp_torch.preprocess_cloud(semicp_torch.make_cloud(tgt, tlab, n_pad=2048,
                                                              device="cpu"), ct)
    assert s.layout == "raw"
    res = semicp_torch.make_align_fn(ct)(s, t)
    terr, rerr = pose_errors(res.T.numpy(), T_gt)
    assert bool(res.converged) and terr < 0.02 and rerr < 0.005, (terr, rerr)


def test_padding_invariance(pair):
    """Same data, different padding capacity => same answer (the bound of
    tests/test_register.py: GN/EM early exits may take one extra LM step
    near step_eps under a different reduction order)."""
    src, slab, tgt, tlab, T_gt = pair
    Ts = []
    for n_pad in (2048, 4096):
        cfg = semicp_torch.Config().override({**OVER, "cloud.n_pad": n_pad})
        s = semicp_torch.preprocess_cloud(semicp_torch.make_cloud(src, slab, n_pad=n_pad,
                                                                  device="cpu"), cfg)
        t = semicp_torch.preprocess_cloud(semicp_torch.make_cloud(tgt, tlab, n_pad=n_pad,
                                                                  device="cpu"), cfg)
        Ts.append(semicp_torch.align(s, t, cfg).T.numpy())
    terr, rerr = pose_errors(Ts[0], Ts[1])
    assert terr < 5e-5 and rerr < 5e-5, (terr, rerr)


def corridor_scene(rng, n):
    """Ground + two walls, all parallel to x (tests/test_register.py's
    scene): the only x information is the label boundary at x = 0."""
    g = np.stack([rng.uniform(-10, 10, n), rng.uniform(-4, 4, n),
                  rng.normal(size=n) * 0.01], -1)
    w1 = np.stack([rng.uniform(-10, 10, n // 2),
                   np.full(n // 2, -4.0) + rng.normal(size=n // 2) * 0.01,
                   rng.uniform(0, 3, n // 2)], -1)
    w2 = np.stack([rng.uniform(-10, 10, n // 2),
                   np.full(n // 2, 4.0) + rng.normal(size=n // 2) * 0.01,
                   rng.uniform(0, 3, n // 2)], -1)
    xyz = np.concatenate([g, w1, w2]).astype(np.float32)
    surf = np.concatenate([np.zeros(n), np.ones(n // 2), np.full(n // 2, 2)])
    return xyz, (surf * 2 + (xyz[:, 0] > 0)).astype(np.int32)


def test_semantics_disambiguate_corridor(rng):
    """The paper's core claim, as tests/test_register.py pins it for the
    JAX package: semantic EM-ICP recovers the corridor's x offset, and
    uniform class weights (em.uniform_semantics) cannot observe it."""
    tgt, tlab = corridor_scene(rng, 800)
    delta = np.array([0.6, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32)
    src, slab, T_gt = t_make_pair(rng, tgt, tlab, delta, noise=0.01, dropout=0.2, n_classes=6)
    over = {"cloud.num_classes": 6, "cloud.n_pad": 2048, "em.alpha": 0.95, "em.max_iters": 50}
    terr = {}
    for uniform in (False, True):
        cfg = semicp_torch.Config().override({**over, "em.uniform_semantics": uniform})
        s = semicp_torch.preprocess_cloud(semicp_torch.make_cloud(src, slab, n_pad=2048,
                                                                  device="cpu"), cfg)
        t = semicp_torch.preprocess_cloud(semicp_torch.make_cloud(tgt, tlab, n_pad=2048,
                                                                  device="cpu"), cfg)
        terr[uniform] = pose_errors(semicp_torch.align(s, t, cfg).T.numpy(), T_gt)[0]
    assert terr[False] < 0.15, terr
    assert terr[True] > 2 * terr[False], terr


def prep_cov(xyz, lab, cfg):
    """A CPU cloud preprocessed with the bare CovConfig (raw layout), as
    tests/test_register.py's `prep` does."""
    return semicp_torch.preprocess_cloud(
        semicp_torch.make_cloud(xyz, lab, n_pad=cfg.cloud.n_pad, device="cpu"), cfg.cov)


def test_align_parity_with_oracle_radius(pair):
    """tests/test_register.py's like-for-like radius parity with the numpy
    oracle, on the port: the same fixed radius on both sides, and the
    same bounds (5 mm, 2 mrad)."""
    src, slab, tgt, tlab, T_gt = pair
    radius = 0.6
    cfg = semicp_torch.Config().override({**OVER, "cov.radius": radius})
    res = semicp_torch.align(prep_cov(src, slab, cfg), prep_cov(tgt, tlab, cfg), cfg)
    p = OracleParams(cov_method="radius", cov_radius=radius)
    tgt_cov = estimate_covariances_np(tgt.astype(np.float64), tlab, p)
    assert np.abs(tgt_cov - np.eye(3)).max() > 0.3    # not the all-identity oracle
    T_o, info = semantic_icp_np(src, slab, tgt, tlab, p)
    assert info["converged"] and bool(res.converged)
    terr, rerr = pose_errors(res.T.numpy(), T_o)
    assert terr < 5e-3 and rerr < 2e-3, (terr, rerr)


def test_align_parity_with_oracle_knn(pair):
    """The reference-semantics anchor: kNN covariances (k = 20) on the
    port's side and the oracle's, within 5 mm and 2 mrad."""
    src, slab, tgt, tlab, T_gt = pair
    cfg = semicp_torch.Config().override({**OVER, "cov.method": "knn"})
    res = semicp_torch.align(prep_cov(src, slab, cfg), prep_cov(tgt, tlab, cfg), cfg)
    T_o, info = semantic_icp_np(src, slab, tgt, tlab,
                                OracleParams(cov_method="knn", cov_k=cfg.cov.k))
    assert info["converged"] and bool(res.converged)
    terr, rerr = pose_errors(res.T.numpy(), T_o)
    assert terr < 5e-3 and rerr < 2e-3, (terr, rerr)


def test_align_from_larger_offset(rng):
    """tests/test_register.py's larger offset (1 m, 0.15 rad), on the port:
    within 5 cm and 10 mrad of the truth."""
    xyz, lab = t_make_scene(rng, n_points=1500)
    lab = lab - 1
    delta = np.array([1.0, 0.5, 0.1, 0.05, 0.05, 0.15])
    src, slab, T_gt = t_make_pair(rng, xyz, lab, delta, noise=0.02, dropout=0.1, n_classes=6)
    cfg = semicp_torch.Config().override({**OVER, "em.max_iters": 40})
    res = semicp_torch.align(prep_cov(src, slab, cfg), prep_cov(xyz, lab, cfg), cfg)
    terr, rerr = pose_errors(res.T.numpy(), T_gt)
    assert terr < 0.05 and rerr < 0.01, (terr, rerr)


@pytest.fixture
def two_threads():
    """Two intra-op threads: this test's clouds are small, and the suite's
    other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("two_threads")
def test_semantic_robust_to_label_corruption(rng):
    """The other half of the paper's claim, as tests/test_register.py pins
    it: with 35% of the source labels flipped, semantic EM-ICP still
    recovers the corridor's x offset to 0.2 m and beats uniform weights
    by 2x, on that test's 2400-point corridor."""
    tgt, tlab = corridor_scene(rng, 1200)
    delta = np.array([0.6, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32)
    src, slab, T_gt = t_make_pair(rng, tgt, tlab, delta, noise=0.01, dropout=0.2, n_classes=6,
                                  label_flip=0.35)
    assert slab.min() >= 0 and slab.max() < 6
    over = {"cloud.num_classes": 6, "cloud.n_pad": 4096, "em.alpha": 0.9, "em.max_iters": 50}
    terr = {}
    for uniform in (False, True):
        cfg = semicp_torch.Config().override({**over, "em.uniform_semantics": uniform})
        res = semicp_torch.align(prep_cov(src, slab, cfg), prep_cov(tgt, tlab, cfg), cfg)
        terr[uniform] = pose_errors(res.T.numpy(), T_gt)[0]
    assert terr[False] < 0.2, terr
    assert terr[True] > 2 * terr[False], terr


def test_identity_pair_stays_identity(rng):
    xyz, lab = t_make_scene(rng, n_points=800)
    cfg = semicp_torch.Config().override({**OVER, "cloud.n_pad": 1024})
    c = prep_cov(xyz, lab - 1, cfg)
    res = semicp_torch.align(c, c, cfg)
    np.testing.assert_allclose(res.T.numpy(), np.eye(4), atol=5e-4)


def test_engine_dispatch_rules():
    cfg = semicp_torch.Config()
    # on a CPU "auto" is the plain path; a forced engine is kept (its
    # wrappers take their plain versions there)
    assert resolve_engine(cfg, "cpu") == "xla"
    for eng in ("dense", "sparse", "xla"):
        assert resolve_engine(cfg.override({"corr.engine": eng}), "cpu") == eng
    # on CUDA "auto" is the JAX package's rule: the sparse kernel (K2) at
    # n_pad >= corr.sparse_min_n, the dense kernel (K4) below it
    assert cfg.corr.sparse_min_n == 4096
    for n_pad, eng in ((1024, "dense"), (2048, "dense"), (4096, "sparse"),
                       (1 << 17, "sparse")):
        assert resolve_engine(cfg.override({"cloud.n_pad": n_pad}), "cuda") == eng
    for eng in ("dense", "sparse"):
        for n_pad in (1024, 1 << 17):
            over = {"corr.engine": eng, "cloud.n_pad": n_pad}
            assert resolve_engine(cfg.override(over), "cuda") == eng
    # the plain "xla" path is for CPU tensors only
    with pytest.raises(NotImplementedError, match="'dense'"):
        resolve_engine(cfg.override({"corr.engine": "xla"}), "cuda")
    with pytest.raises(ValueError):
        resolve_engine(cfg.override({"corr.engine": "kdtree"}), "cpu")


def test_synthetic_data_matches_jax():
    rj, rt = np.random.default_rng(3), np.random.default_rng(3)
    xj, lj = j_make_scene(rj, n_points=3000, extent=15.0, n_classes=8)
    xt, lt = t_make_scene(rt, n_points=3000, extent=15.0, n_classes=8)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(lt, lj)
    pj = j_make_pair(rj, xj, lj - 1, DELTA, noise=0.02, dropout=0.1, label_flip=0.2, n_classes=8)
    pt = t_make_pair(rt, xt, lt - 1, DELTA, noise=0.02, dropout=0.1, label_flip=0.2, n_classes=8)
    # T_gt from each package's f32 se3_exp: equal to f32 rounding, and the
    # source points through it to ~1e-6 relative
    np.testing.assert_allclose(pt[2], pj[2], atol=1e-6)
    np.testing.assert_allclose(pt[0], pj[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(pt[1], pj[1])
    # both generators consumed the same draws
    assert rt.uniform() == rj.uniform()


def test_config_round_trip_from_jax():
    cj = semicp.Config().override({"em.max_iters": 7, "corr.max_dist": 1.5,
                                   "cloud.num_classes": 12})
    ct = config_from_dict(dataclasses.asdict(cj))
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert config_from_dict(json.loads(ct.to_json())) == ct
    with pytest.raises(TypeError):
        config_from_dict({"em": {"no_such_field": 1}})


def test_import_pulls_in_neither_jax_nor_semicp():
    code = ("import sys, semicp_torch, semicp_torch.convert, semicp_torch.data, "
            "semicp_torch.kernels, semicp_torch.cli.run_odometry, semicp_torch.cli.run_pair, "
            "semicp_torch.register.ndt, semicp_torch.eval, semicp_torch.utils, "
            "semicp_torch.slam.pipeline, semicp_torch.data.native, semicp_torch.cli.run_slam, "
            "semicp_torch.slam, semicp_torch.dist, semicp_torch.utils.checkpoint, "
            "semicp_torch.cli.run_batch, semicp_torch.dist.ring_corr, "
            "semicp_torch.dist.align_dist, semicp_torch.slam.schur, semicp_torch.slam.map_ba; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'semicp')); "
            "print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=root, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
