"""semicp_torch's eig3, planar normal equations, GICP and NDT baselines
against semicp's on the same numpy inputs, on the CPU.

Tolerances: eig3 is the same closed-form f32 arithmetic, so values agree
to 1e-4 (the eigenvectors of the trigonometric method amplify rounding
by ~1/gap). The planar normal equations sum 200 f32 terms in another
order: 1e-4 relative to each block's scale. The NDT voxel Gaussians come
from segment sums in another order, with means at ~15 m: means to 1e-4 m
and the unit-scale covariances to 2e-3 (the E[x^2] - mean^2 cancellation
at that range). Every align, as in tests/test_torch_register.py: T to
1e-4, and the ground-truth bounds of tests/test_ndt.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import semicp
import semicp_torch
from semicp.geom import eig3 as j_eig3
from semicp.register.gicp import align_gicp as j_align_gicp
from semicp.register.ndt import align_ndt as j_align_ndt
from semicp.register.ndt import build_ndt_cloud as j_build_ndt
from semicp.register.residuals import normal_equations_planar as j_normal_planar
from semicp_torch.convert import cloud_from_numpy
from semicp_torch.data import make_pair, make_scene
from semicp_torch.geom import eig3 as t_eig3
from semicp_torch.register.gicp import align_gicp as t_align_gicp
from semicp_torch.register.ndt import align_ndt as t_align_ndt
from semicp_torch.register.ndt import build_ndt_cloud as t_build_ndt
from semicp_torch.register.residuals import normal_equations_planar as t_normal_planar

K, N_PAD = 6, 4096
DELTA = np.array([0.3, -0.15, 0.05, 0.01, -0.02, 0.03])
OVER = {"cloud.n_pad": N_PAD, "cloud.num_classes": K, "em.max_iters": 25}


def random_spd(rng, n):
    A = rng.normal(size=(n, 3, 3))
    return (A @ np.swapaxes(A, -1, -2) + np.eye(3)).astype(np.float32)


def jt(fn_j, fn_t, *args):
    """Run a JAX and a torch function on the same numpy arrays."""
    out_j = fn_j(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args))
    out_t = fn_t(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args))
    return out_j, out_t


def test_eig3_matches_jax(rng):
    S = random_spd(rng, 512)
    S[:4] = 0.0                                      # the NDT single-point voxel
    S[4:8] = np.diag([3.0, 1.0, 2.0]).astype(np.float32)
    wj, wt = jt(j_eig3.eigvals3x3, t_eig3.eigvals3x3, S)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-5, atol=1e-4)
    (wj, Vj), (wt, Vt) = jt(j_eig3.eigh3x3, t_eig3.eigh3x3, S)
    assert np.isfinite(wt.numpy()).all() and np.isfinite(Vt.numpy()).all()
    np.testing.assert_array_equal(wt.numpy()[:4], 0.0)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(Vt.numpy(), np.asarray(Vj), atol=1e-4)
    nj, nt = jt(j_eig3.smallest_eigvec, t_eig3.smallest_eigvec, S)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), atol=1e-4)
    cj, ct = jt(j_eig3.gicp_regularize, t_eig3.gicp_regularize, S, 1e-3)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-4)


def test_cholesky_and_solves_match_jax(rng):
    S = random_spd(rng, 256)
    b = rng.normal(size=(256, 3)).astype(np.float32)
    B = rng.normal(size=(256, 3, 3)).astype(np.float32)
    Lj, Lt = jt(j_eig3.cholesky3x3, t_eig3.cholesky3x3, S, 0.01)
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), rtol=1e-5, atol=1e-5)
    L = np.array(Lj)
    for name in ("tri_solve3x3", "tri_solve3x3_mat", "cho_solve3x3"):
        rhs = B if name.endswith("mat") else b
        xj, xt = jt(getattr(j_eig3, name), getattr(t_eig3, name), L, rhs)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5, atol=1e-5)


def test_normal_equations_planar_matches_jax(rng):
    m = 200
    S = random_spd(rng, m)
    w = rng.uniform(size=m).astype(np.float32)
    p = rng.normal(size=(3, m)).astype(np.float32)
    d = rng.normal(size=(3, m)).astype(np.float32)
    planes = [S[:, 0, 0], S[:, 1, 1], S[:, 2, 2], S[:, 0, 1], S[:, 0, 2], S[:, 1, 2]]
    Hj, gj, cj = j_normal_planar(jnp.asarray(w), tuple(jnp.asarray(s) for s in planes),
                                 tuple(jnp.asarray(p)), tuple(jnp.asarray(d)))
    Ht, gt, ct = t_normal_planar(torch.from_numpy(w), tuple(torch.from_numpy(s) for s in planes),
                                 tuple(torch.from_numpy(p)), tuple(torch.from_numpy(d)))
    for t, j in ((Ht, Hj), (gt, gj)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-4, atol=1e-4 * np.abs(j).max())
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-4)


@pytest.fixture(scope="module")
def ndt_pair():
    """tests/test_ndt.py's pair, as clouds of both packages from the same
    numpy arrays (the d2d source preprocessed once, by semicp)."""
    rng = np.random.default_rng(0)
    tgt_pts, tgt_lab = make_scene(rng, n_points=4000, extent=15.0, n_classes=K)
    tgt_lab = tgt_lab - 1
    src_pts, src_lab, T_gt = make_pair(rng, tgt_pts, tgt_lab, DELTA, noise=0.01, dropout=0.05,
                                       n_classes=K)
    cj = semicp.Config().override(OVER)
    jsrc, jtgt = (semicp.make_cloud(p, lab, n_pad=N_PAD)
                  for p, lab in ((src_pts, src_lab), (tgt_pts, tgt_lab)))
    jsrc_pre = jax.jit(lambda c: semicp.preprocess_cloud(c, cj.cov))(jsrc)

    def carry(c):
        return cloud_from_numpy(c.xyz, c.label, c.cov6, c.valid, c.count, layout=c.layout,
                                device="cpu")

    tcfg = semicp_torch.Config().override(OVER)
    return {"cj": cj, "ct": tcfg, "T_gt": T_gt,
            "j": (jsrc, jtgt, jsrc_pre), "t": tuple(carry(c) for c in (jsrc, jtgt, jsrc_pre))}


def check_T(Tt, Tj, T_gt):
    np.testing.assert_allclose(Tt, Tj, atol=1e-4)
    err = Tt.astype(np.float64) @ np.linalg.inv(T_gt.astype(np.float64))
    assert np.isfinite(Tt).all()
    assert np.linalg.norm(err[:3, 3]) < 0.10
    assert np.linalg.norm(err[:3, :3] - np.eye(3)) < 0.05


@pytest.mark.parametrize("semantic", [False, True])
def test_build_ndt_cloud_matches_jax(ndt_pair, semantic):
    nj = j_build_ndt(ndt_pair["j"][1], voxel=1.0, semantic=semantic)
    nt = t_build_ndt(ndt_pair["t"][1], voxel=1.0, semantic=semantic)
    valid = np.asarray(nj.valid)
    assert 0 < int(nt.count) == int(nj.count) < 4000
    np.testing.assert_array_equal(nt.valid.numpy(), valid)
    np.testing.assert_array_equal(nt.label.numpy(), np.asarray(nj.label))
    np.testing.assert_allclose(nt.xyz.numpy(), np.asarray(nj.xyz), atol=1e-4)
    np.testing.assert_allclose(nt.cov6.numpy()[:, valid], np.asarray(nj.cov6)[:, valid],
                               atol=2e-3)
    assert np.isfinite(nt.cov6.numpy()).all()
    assert nt.cov6.numpy()[:3, valid].max() <= 1.0 + 1e-4


@pytest.mark.parametrize("variant", ["plain", "semantic", "d2d"])
def test_align_ndt_matches_jax(ndt_pair, variant):
    jsrc, jtgt, jsrc_pre = ndt_pair["j"]
    tsrc, ttgt, tsrc_pre = ndt_pair["t"]
    kw = {"semantic": variant == "semantic", "d2d": variant == "d2d"}
    if variant == "d2d":
        jsrc, tsrc = jsrc_pre, tsrc_pre
    rj = j_align_ndt(jsrc, jtgt, ndt_pair["cj"], voxel=1.0, **kw)
    rt = t_align_ndt(tsrc, ttgt, ndt_pair["ct"], voxel=1.0, **kw)
    check_T(rt.T.numpy(), np.asarray(rj.T), ndt_pair["T_gt"])
    assert abs(int(rt.iterations) - int(rj.iterations)) <= 1


def test_align_gicp_matches_jax(ndt_pair):
    """The uniform-weight baseline on preprocessed clouds of the same pair."""
    cj, ct = ndt_pair["cj"], ndt_pair["ct"]
    jtgt = jax.jit(lambda c: semicp.preprocess_cloud(c, cj.cov))(ndt_pair["j"][1])
    jsrc = ndt_pair["j"][2]
    rj = j_align_gicp(jsrc, jtgt, cj)
    tsrc = ndt_pair["t"][2]
    ttgt = cloud_from_numpy(jtgt.xyz, jtgt.label, jtgt.cov6, jtgt.valid, jtgt.count, device="cpu")
    rt = t_align_gicp(tsrc, ttgt, ct)
    check_T(rt.T.numpy(), np.asarray(rj.T), ndt_pair["T_gt"])
    assert not dataclasses.asdict(ct)["em"]["uniform_semantics"]   # cfg not mutated
