"""semicp_torch covariances against semicp on the same numpy inputs.

The JAX Pallas kernel runs in interpret mode, as tests/test_covariance.py
runs it. Tolerances are those of tests/test_covariance.py for the same
comparisons: covariance-level agreement because the sparse kernels centre
their moments (the raw moments differ by design), and the uncentred f32
epilogue's cancellation noise where raw moments are compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import semicp
import semicp_torch
from semicp.cloud.covariance import estimate_radius as j_estimate_radius
from semicp.cloud.pallas_cov import neighborhood_moments_sparse, neighborhood_moments_xla
from semicp.corr.layout import sort_cloud_cm as j_sort_cloud_cm
from semicp.config import CovConfig as JCovConfig
from semicp.data import make_scene
from semicp_torch.cloud.covariance import estimate_radius as t_estimate_radius
from semicp_torch.cloud.moments import moments_plain
from semicp_torch.config import CovConfig as TCovConfig


def to_cov(m):
    cnt = np.maximum(m[0], 1.0)
    mx, my, mz = m[1] / cnt, m[2] / cnt, m[3] / cnt
    return np.stack([m[4] / cnt - mx * mx, m[5] / cnt - my * my, m[6] / cnt - mz * mz,
                     m[7] / cnt - mx * my, m[8] / cnt - mx * mz, m[9] / cnt - my * mz])


def cm_scene(rng, K=5, n_points=900, n_pad=1024):
    xyz, lab = make_scene(rng, n_points=n_points, extent=8.0, n_classes=K)
    c = j_sort_cloud_cm(semicp.make_cloud(xyz, lab - 1, n_pad=n_pad), K, cell=1.0)
    return (np.array(c.xyz), np.maximum(np.asarray(c.label), 0).astype(np.int32),
            np.array(c.valid))


@pytest.mark.parametrize("class_aware", [True, False])
def test_estimate_radius_matches_jax(rng, class_aware):
    # 1500 valid points >= 256 samples, all with >= 21 same-class
    # neighbours: the valid-sample count is 256 (even), which pins the
    # two-middle-value median convention
    xyz, lab = make_scene(rng, n_points=1500, extent=10.0, n_classes=5)
    cj = semicp.make_cloud(xyz, lab - 1, n_pad=2048)
    args = (np.asarray(cj.xyz), np.maximum(np.asarray(cj.label), 0), np.asarray(cj.valid))
    rj = float(j_estimate_radius(*map(jnp.asarray, args), class_aware=class_aware))
    rt = float(t_estimate_radius(*map(torch.from_numpy, map(np.array, args)),
                                 class_aware=class_aware))
    np.testing.assert_allclose(rt, rj, rtol=1e-5)


def test_nanmedian_averages_middle_values():
    from semicp_torch.cloud.covariance import _nanmedian

    x = torch.tensor([4.0, float("nan"), 1.0, 3.0, 2.0])
    assert float(_nanmedian(x)) == 2.5           # torch.nanmedian gives 2.0
    assert float(_nanmedian(x[:4])) == 3.0       # odd count: 1, 3, 4
    assert torch.isnan(_nanmedian(torch.full((3,), float("nan"))))


def test_moments_plain_matches_sparse_kernel_interpret(rng):
    K, r = 5, 0.9
    xyz, label, valid = cm_scene(rng, K)
    m_s = np.asarray(neighborhood_moments_sparse(
        jnp.asarray(xyz), jnp.asarray(label), jnp.asarray(valid), r,
        num_classes=K, qb=256, tb=256, interpret=True))
    m_t = moments_plain(torch.from_numpy(xyz), torch.from_numpy(label),
                        torch.from_numpy(valid), r).numpy()
    np.testing.assert_allclose(m_t[0], m_s[0], atol=0.5)       # counts
    ok = valid & (m_s[0] >= 3)
    np.testing.assert_allclose(to_cov(m_t)[:, ok], to_cov(m_s)[:, ok], rtol=1e-3, atol=1e-4)


def test_moments_plain_matches_xla_raw(rng):
    """Same uncentred raw moments as the JAX dense fallback."""
    N = 1024
    xyz = rng.normal(size=(3, N)).astype(np.float32) * 3
    lab = rng.integers(0, 4, size=N).astype(np.int32)
    val = rng.uniform(size=N) > 0.1
    m_x = np.asarray(neighborhood_moments_xla(jnp.asarray(xyz), jnp.asarray(lab),
                                              jnp.asarray(val), 1.0))
    m_t = moments_plain(torch.from_numpy(xyz), torch.from_numpy(lab),
                        torch.from_numpy(val), 1.0, qb=300).numpy()
    np.testing.assert_allclose(m_t, m_x, rtol=1e-4, atol=1e-3)


def test_preprocess_full_config_matches_jax(rng):
    K = 5
    xyz, lab = make_scene(rng, n_points=1900, extent=10.0, n_classes=K)
    over = {"cloud.n_pad": 2048, "cloud.num_classes": K}
    cj = semicp.preprocess_cloud(semicp.make_cloud(xyz, lab - 1, n_pad=2048),
                                 semicp.Config().override(over))
    ct = semicp_torch.preprocess_cloud(semicp_torch.make_cloud(xyz, lab - 1, n_pad=2048,
                                                               device="cpu"),
                                       semicp_torch.Config().override(over))
    assert ct.layout == cj.layout == "cm"
    np.testing.assert_array_equal(ct.xyz.numpy(), np.asarray(cj.xyz))
    np.testing.assert_array_equal(ct.label.numpy(), np.asarray(cj.label))
    np.testing.assert_array_equal(ct.valid.numpy(), np.asarray(cj.valid))
    # both sum UNCENTRED f32 moments in different orders: the epilogue's
    # cancellation noise reaches ~5e-3 on a few near-degenerate
    # neighbourhoods (tests/test_covariance.py allows 0.2 for the same)
    c_t, c_j = ct.cov6.numpy(), np.asarray(cj.cov6)
    np.testing.assert_allclose(c_t, c_j, rtol=2e-3, atol=0.2)
    assert np.isclose(c_t, c_j, rtol=2e-3, atol=2e-3).mean() > 0.995


def test_preprocess_bare_covconfig_keeps_layout(rng):
    xyz, lab = make_scene(rng, n_points=900, extent=8.0, n_classes=5)
    cj = semicp.preprocess_cloud(semicp.make_cloud(xyz, lab - 1, n_pad=1024),
                                 JCovConfig(radius=0.9))
    ct = semicp_torch.preprocess_cloud(semicp_torch.make_cloud(xyz, lab - 1, n_pad=1024,
                                                               device="cpu"),
                                       TCovConfig(radius=0.9))
    assert ct.layout == "raw"
    np.testing.assert_array_equal(ct.xyz.numpy(), np.asarray(cj.xyz))
    # same tolerances as the full-Config test above
    c_t, c_j = ct.cov6.numpy(), np.asarray(cj.cov6)
    np.testing.assert_allclose(c_t, c_j, rtol=2e-3, atol=0.2)
    assert np.isclose(c_t, c_j, rtol=2e-3, atol=2e-3).mean() > 0.995


def test_unported_paths_raise(rng):
    """No preprocessing path raises any more: the kNN covariances match
    the JAX package's at tests/test_covariance.py's oracle configuration
    (2000 points, k = 20, a bare CovConfig), and the raw layout runs
    everywhere. Both packages sum f32 products of the same 20 neighbours
    in other orders, so the clamped covariances agree to 1e-4."""
    xyz, lab = make_scene(rng, n_points=2000, extent=10.0)
    lab = lab - 1
    cj = semicp.preprocess_cloud(semicp.make_cloud(xyz, lab, n_pad=2048),
                                 JCovConfig(method="knn", k=20))
    ct = semicp_torch.preprocess_cloud(
        semicp_torch.make_cloud(xyz, lab, n_pad=2048, device="cpu"), TCovConfig(method="knn", k=20))
    assert ct.layout == cj.layout == "raw"
    np.testing.assert_allclose(ct.cov6.numpy(), np.asarray(cj.cov6), rtol=0, atol=1e-4)
    c = semicp_torch.make_cloud(np.zeros((10, 3), np.float32), n_pad=256, device="cpu")
    out = semicp_torch.preprocess_cloud(c, TCovConfig(radius=0.5))
    assert out.layout == "raw" and torch.isfinite(out.cov6).all()
