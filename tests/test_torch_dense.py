"""semicp_torch's small-cloud engine (K4) and raw-layout moments (K5)
against semicp on the same numpy inputs, on the CPU.

The JAX Pallas kernels run in interpret mode, as tests/test_pallas.py and
tests/test_covariance.py run them. Tolerances:
- nearest neighbour (tests/test_pallas.py's dense check): found masks
  equal, d2 to rtol 1e-4 / atol 1e-3 (the expanded form rounds
  differently per library), winner rows equal;
- moments: equal counts, covariances after the epilogue to atol 1e-5 /
  rtol 1e-3 on a cloud within a few metres of the origin (both sides sum
  uncentred f32 moments, whose epilogue cancels);
- preprocessing and the slice: the bounds of tests/test_torch_covariance.py
  and tests/test_torch_register.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import semicp
import semicp_torch
from semicp.cloud.pallas_cov import neighborhood_moments_pallas
from semicp.corr.pallas_nn2 import class_nn_attrs_pallas
from semicp.corr.pallas_nn2 import sort_cloud_by_class as j_sort
from semicp.data import make_pair, make_scene
from semicp_torch.cloud import moments as t_moments
from semicp_torch.corr.nn_dense import class_nn_attrs_dense, sort_cloud_by_class
from semicp_torch.register import em_icp as t_em_icp

DELTA = np.array([0.3, -0.15, 0.05, 0.02, -0.01, 0.04])


def to_cov(m):
    cnt = np.maximum(m[0], 1.0)
    mx, my, mz = m[1] / cnt, m[2] / cnt, m[3] / cnt
    return np.stack([m[4] / cnt - mx * mx, m[5] / cnt - my * my, m[6] / cnt - mz * mz,
                     m[7] / cnt - mx * my, m[8] / cnt - mx * mz, m[9] / cnt - my * mz])


def nn_fixture(rng, N=1024, K=6):
    """The scene of tests/test_pallas.py."""
    xyz = rng.normal(size=(3, N)).astype(np.float32) * 10
    lab = rng.integers(0, K, size=N).astype(np.int32)
    val = rng.uniform(size=N) > 0.1
    cov6 = rng.normal(size=(6, N)).astype(np.float32)
    q = rng.normal(size=(3, N)).astype(np.float32) * 10
    return xyz, lab, val, cov6, q


def test_sort_cloud_by_class_matches_jax(rng):
    xyz, lab, val, cov6, _ = nn_fixture(rng)
    lab[rng.uniform(size=lab.shape) < 0.05] = -1                # unlabelled points
    out_j = j_sort(*map(jnp.asarray, (xyz, lab, cov6, val)), 6)
    out_t = sort_cloud_by_class(*map(torch.from_numpy, (xyz, lab, cov6, val)), 6)
    for name, t, j in zip(("xyz_s", "label_s", "attrs16"), out_t, out_j):
        assert t.dtype == (torch.int32 if name == "label_s" else torch.float32)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)


@pytest.mark.parametrize("case", ["mixed", "absent", "all_invalid"])
def test_sort_cloud_by_class_segments(rng, case):
    """The (K+1,) class segments K4 reads against a numpy count of the
    sorted labels: unlabelled, invalid and past-the-classes points
    outside every segment, classes absent from the target (empty
    segments, first and last ones included), and an all-invalid target
    (every segment empty)."""
    K = 6
    xyz, lab, val, cov6, _ = nn_fixture(rng, 1000, K)
    if case == "mixed":
        lab[rng.uniform(size=lab.shape) < 0.05] = -1
        lab[rng.uniform(size=lab.shape) < 0.03] = K + 1
    elif case == "absent":
        lab = np.where(np.isin(lab, (0, 2, 5)), 3, lab).astype(np.int32)
    else:
        val[:] = False
    _, label_s, _, seg = sort_cloud_by_class(*map(torch.from_numpy, (xyz, lab, cov6, val)), K)
    label_s, seg = label_s.numpy(), seg.numpy()
    assert seg.dtype == np.int32 and seg.shape == (K + 1,)
    counts = np.bincount(label_s[label_s < K], minlength=K)
    np.testing.assert_array_equal(seg, np.concatenate([[0], np.cumsum(counts)]))
    for k in range(K):
        assert (label_s[seg[k]:seg[k + 1]] == k).all()
    if case == "absent":
        assert (counts[[0, 2, 5]] == 0).all() and (counts[[1, 3, 4]] > 0).all()
    if case == "all_invalid":
        assert (seg == 0).all()


def test_class_nn_attrs_dense_matches_pallas_interpret(rng):
    N, K = 1024, 6
    xyz, lab, val, cov6, q = nn_fixture(rng, N, K)
    xyz_s, lab_s, attrs16 = j_sort(*map(jnp.asarray, (xyz, lab, cov6, val)), K)
    d2_p, at_p = class_nn_attrs_pallas(xyz_s, lab_s, attrs16, jnp.asarray(q), num_classes=K,
                                       qb=256, tb=256, interpret=True)
    d2_p, at_p = np.asarray(d2_p), np.asarray(at_p)
    d2_t, at_t = class_nn_attrs_dense(*sort_cloud_by_class(
        *map(torch.from_numpy, (xyz, lab, cov6, val)), K), torch.from_numpy(q), K)
    d2_t, at_t = d2_t.numpy(), at_t.numpy()
    f = d2_p < 1e30
    assert (f == (d2_t < 1e30)).all()
    np.testing.assert_allclose(d2_t[f], d2_p[f], rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(np.moveaxis(at_t, 1, 0)[:, f], np.moveaxis(at_p, 1, 0)[:, f])
    assert (at_t[:, 10:] == 0).all()


def test_class_nn_attrs_dense_class_missing(rng):
    """A class absent from the target gives d2 == INF and a zero row."""
    N, K = 512, 4
    xyz = rng.normal(size=(3, N)).astype(np.float32)
    lab = rng.integers(0, 2, size=N).astype(np.int32)          # only 0, 1
    cov6 = rng.normal(size=(6, N)).astype(np.float32)
    val = np.ones(N, bool)
    d2, at = class_nn_attrs_dense(*sort_cloud_by_class(
        *map(torch.from_numpy, (xyz, lab, cov6, val)), K), torch.from_numpy(xyz), K)
    assert (d2[2:] > 1e30).all() and (at[2:] == 0).all() and (d2[:2] < 1e30).all()
    assert (at[:2, 9] == 1.0).all()


def test_moments_dense_matches_pallas_interpret(rng):
    N, r = 1024, 1.0
    xyz = rng.normal(size=(3, N)).astype(np.float32) * 2
    lab = rng.integers(0, 4, size=N).astype(np.int32)
    val = rng.uniform(size=N) > 0.1
    m_p = np.asarray(neighborhood_moments_pallas(*map(jnp.asarray, (xyz, lab, val)), r,
                                                 interpret=True))
    m_t = t_moments.neighborhood_moments_dense(*map(torch.from_numpy, (xyz, lab, val)),
                                               r).numpy()
    np.testing.assert_array_equal(m_t[0], m_p[0])                # counts
    ok = val & (m_p[0] >= 3)
    assert ok.sum() > 0.5 * N, "fixture must have populated neighbourhoods"
    np.testing.assert_allclose(to_cov(m_t)[:, ok], to_cov(m_p)[:, ok], rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("cfg_kind,class_aware", [("cov", True), ("cov", False),
                                                  ("full", False)])
def test_preprocess_raw_layout_matches_jax(rng, cfg_kind, class_aware):
    """The raw-layout path: a bare CovConfig, or class_aware=False (which
    takes the dense moments even after the class-major sort)."""
    K = 5
    xyz, lab = make_scene(rng, n_points=1900, extent=10.0, n_classes=K)
    over = {"cloud.n_pad": 2048, "cloud.num_classes": K}
    cj, ct = semicp.Config().override(over), semicp_torch.Config().override(over)
    if cfg_kind == "cov":
        cj, ct = cj.cov, ct.cov
    out_j = semicp.preprocess_cloud(semicp.make_cloud(xyz, lab - 1, n_pad=2048), cj,
                                    class_aware=class_aware)
    out_t = semicp_torch.preprocess_cloud(semicp_torch.make_cloud(xyz, lab - 1, n_pad=2048,
                                                                  device="cpu"),
                                          ct, class_aware=class_aware)
    assert out_t.layout == out_j.layout == ("raw" if cfg_kind == "cov" else "cm")
    np.testing.assert_array_equal(out_t.xyz.numpy(), np.asarray(out_j.xyz))
    c_t, c_j = out_t.cov6.numpy(), np.asarray(out_j.cov6)
    np.testing.assert_allclose(c_t, c_j, rtol=2e-3, atol=0.2)
    assert np.isclose(c_t, c_j, rtol=2e-3, atol=2e-3).mean() > 0.995


def test_dense_engine_raw_layout_slice_matches_jax(rng, monkeypatch):
    """corr.engine="dense" over raw-layout clouds (dense moments, then the
    class-sorted NN), against semicp.align with the same engine."""
    xyz, lab = make_scene(rng, n_points=1200)
    lab = lab - 1
    src, slab, T_gt = make_pair(rng, xyz, lab, DELTA, noise=0.01, dropout=0.2, n_classes=6)
    over = {"cloud.num_classes": 6, "cloud.n_pad": 2048, "corr.engine": "dense"}
    cj, ct = semicp.Config().override(over), semicp_torch.Config().override(over)
    rj = semicp.align(*(semicp.preprocess_cloud(semicp.make_cloud(p, l, n_pad=2048), cj.cov)
                        for p, l in ((src, slab), (xyz, lab))), cj)

    calls = {"moments": 0, "nn": 0}

    def counted(key, fn):
        def wrapper(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(t_moments, "neighborhood_moments_dense",
                        counted("moments", t_moments.neighborhood_moments_dense))
    monkeypatch.setattr(t_em_icp, "class_nn_attrs_dense",
                        counted("nn", t_em_icp.class_nn_attrs_dense))
    s, t = (semicp_torch.preprocess_cloud(semicp_torch.make_cloud(p, l, n_pad=2048,
                                                                  device="cpu"), ct.cov)
            for p, l in ((src, slab), (xyz, lab)))
    assert s.layout == t.layout == "raw"
    rt = semicp_torch.align(s, t, ct)
    assert calls["moments"] == 2 and calls["nn"] == int(rt.iterations)
    np.testing.assert_allclose(rt.T.numpy(), np.asarray(rj.T), atol=1e-4)
    assert int(rt.iterations) == int(rj.iterations)
    assert bool(rt.converged) and bool(rj.converged)
    err = rt.T.numpy().astype(np.float64) @ np.linalg.inv(T_gt.astype(np.float64))
    assert np.linalg.norm(err[:3, 3]) < 0.02
