"""semicp_torch.corr.bruteforce.knn_self against semicp's, on the CPU.

Both compute d2 in the expanded form |q|^2 + |t|^2 - 2 q.t in f32 with
sums in different orders, so d2 agrees to 1e-5 plus 2^-20 (8 ulps) of
|q|^2 + |t|^2, the magnitude the expansion cancels. The neighbour sets
are the same wherever the k-th and the (k+1)-th distance lie further
apart than that; where exact ties occur both take the lowest index, so
there the indices are equal one for one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import semicp
import semicp_torch
from semicp.corr.bruteforce import knn_self as j_knn_self
from semicp.data import make_scene
from semicp_torch.corr.bruteforce import INF
from semicp_torch.corr.bruteforce import knn_self as t_knn_self

K = 20


def both(xyz, label, valid, k, class_aware):
    rj = [np.asarray(a) for a in j_knn_self(jnp.asarray(xyz), jnp.asarray(label),
                                            jnp.asarray(valid), k=k, class_aware=class_aware)]
    rt = [a.numpy() for a in t_knn_self(torch.from_numpy(xyz), torch.from_numpy(label),
                                        torch.from_numpy(valid), k, class_aware)]
    return rj, rt


def scene_with_rare_classes(rng):
    """A 1900-point scene in a 2048 capacity, whose classes 5 and 6 hold
    7 and 13 points: fewer than k, so their rows end in INF."""
    xyz, lab = make_scene(rng, n_points=1900, extent=10.0, n_classes=5)
    lab = lab - 1
    lab[100:107] = 5
    lab[500:513] = 6
    c = semicp.make_cloud(xyz, lab, n_pad=2048)
    return np.array(c.xyz), np.maximum(np.asarray(c.label), 0).astype(np.int32), \
        np.array(c.valid)


@pytest.mark.parametrize("class_aware", [True, False])
def test_knn_self_matches_jax(rng, class_aware):
    xyz, label, valid = scene_with_rare_classes(rng)
    (ij, dj, vj), (it, dt, vt) = both(xyz, label, valid, K, class_aware)
    assert it.dtype == np.int32 and dt.dtype == np.float32 and it.shape == (2048, K)
    np.testing.assert_array_equal(vt, vj)
    if class_aware:
        assert vt[100].sum() == 7 and vt[500].sum() == 13
    assert np.all(dt[~vt] == np.float32(INF)) and np.all(dj[~vj] == np.float32(INF))
    sq = np.sum(xyz * xyz, axis=0)
    tol = 1e-5 + 2.0 ** -20 * (sq[:, None] + sq[ij])
    rows = vj & valid[:, None]
    np.testing.assert_array_less(np.abs(dt - dj)[rows], tol[rows])
    # neighbour sets away from ties: the exact (k+1)-th distance, float64
    d64 = np.sum((xyz.T[:, None, :].astype(np.float64) - xyz.T[None]) ** 2, -1)
    ok = valid[None, :] & ((label[:, None] == label[None, :]) if class_aware else True)
    d64 = np.where(ok, d64, np.inf)
    kth = np.sort(d64, axis=1)[:, K - 1:K + 1]
    with np.errstate(invalid="ignore"):                  # inf - inf in short rows
        gap = kth[:, 1] - kth[:, 0] > 2 * tol.max(1)
    clear = valid & ((vj.sum(1) < K) | gap)
    n_cmp = 0
    for i in np.nonzero(clear)[0]:
        assert set(it[i][vt[i]]) == set(ij[i][vj[i]]), i
        n_cmp += 1
    assert n_cmp > 1800, n_cmp
    # where a row has fewer than k neighbours, its INF slots take the
    # lowest indices of the rest in both packages
    short = valid & (vj.sum(1) < K)
    assert short.any() == class_aware
    np.testing.assert_array_equal(it[short][~vt[short]], ij[short][~vj[short]])


def test_knn_self_ties_take_lowest_index(rng):
    """64 distinct points, each repeated 8 times at scattered indices:
    every distance ties 8 ways, and both packages order the ties by index."""
    base = rng.uniform(-5, 5, size=(3, 64)).astype(np.float32)
    perm = rng.permutation(512)
    xyz = base[:, perm % 64].copy()
    label = (perm % 64 % 3).astype(np.int32)
    valid = np.ones(512, bool)
    for class_aware in (True, False):
        (ij, dj, _), (it, dt, _) = both(xyz, label, valid, 12, class_aware)
        np.testing.assert_array_equal(it, ij)
        # the first eight are the point's own copies, at distance ~0
        for i in range(512):
            assert set(it[i, :8]) == set(np.nonzero(perm % 64 == perm[i] % 64)[0])


def test_knn_covariances_full_config_match_jax(rng):
    """cov.method="knn" with a full Config: the cloud is put in the
    class-major layout first (identical to the JAX one), then the kNN
    covariances agree to 1e-4 (sums of the same 20 neighbours' products in
    other orders)."""
    xyz, lab = make_scene(rng, n_points=1900, extent=10.0, n_classes=6)
    over = {"cloud.n_pad": 2048, "cloud.num_classes": 6, "cov.method": "knn"}
    cj = semicp.preprocess_cloud(semicp.make_cloud(xyz, lab - 1, n_pad=2048),
                                 semicp.Config().override(over))
    ct = semicp_torch.preprocess_cloud(
        semicp_torch.make_cloud(xyz, lab - 1, n_pad=2048, device="cpu"),
        semicp_torch.Config().override(over))
    assert ct.layout == cj.layout == "cm"
    np.testing.assert_array_equal(ct.xyz.numpy(), np.asarray(cj.xyz))
    np.testing.assert_allclose(ct.cov6.numpy(), np.asarray(cj.cov6), rtol=0, atol=1e-4)
