"""semicp_torch.geom against semicp.geom on the same numpy inputs.

Both run in f32 on the CPU with the same formulas and thresholds. The
tolerances are a few f32 ulps of the quantities compared, except for the
translation of se3_exp: just above the Taylor threshold (theta ~ 1e-4..
1e-3) the left Jacobian's (1 - cos t)/t^2 cancels catastrophically in
f32 in both packages, and the two libraries' cos round differently, so
the translations agree to ~1e-4 only there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semicp.geom import se3 as jse3
from semicp.geom import sym3 as jsym3
from semicp_torch.geom import se3 as tse3
from semicp_torch.geom import sym3 as tsym3


def tangents(rng, n, scale_r):
    v = rng.normal(size=(n, 3))
    w = rng.normal(size=(n, 3))
    w = w / np.linalg.norm(w, axis=-1, keepdims=True)
    ang = rng.uniform(0.0, scale_r, size=(n, 1))
    return np.concatenate([v, w * ang], -1).astype(np.float32)


def random_spd(rng, n):
    A = rng.normal(size=(n, 3, 3))
    return (A @ np.swapaxes(A, -1, -2) + np.eye(3)).astype(np.float32)


def planes_np(S):
    return [S[:, 0, 0], S[:, 1, 1], S[:, 2, 2], S[:, 0, 1], S[:, 0, 2], S[:, 1, 2]]


# scale 1e-5 puts every angle in the Taylor branch (theta^2 < 1e-8)
@pytest.mark.parametrize("scale_r", [1e-5, 0.5, 3.0])
def test_se3_exp_log_inverse_match_jax(rng, scale_r):
    d = tangents(rng, 256, scale_r)
    Tj = np.asarray(jse3.se3_exp(jnp.asarray(d)))
    Tt = tse3.se3_exp(torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(Tt[:, :3, :3], Tj[:, :3, :3], atol=2e-6)
    np.testing.assert_allclose(Tt[:, :3, 3], Tj[:, :3, 3], atol=1e-4)
    # log and inverse on the same (JAX-made) poses
    lj = np.asarray(jse3.se3_log(jnp.asarray(Tj)))
    lt = tse3.se3_log(torch.from_numpy(Tj.copy())).numpy()
    np.testing.assert_allclose(lt, lj, atol=2e-5)
    np.testing.assert_allclose(lt, d, atol=5e-4 if scale_r > 2.0 else 5e-5)
    Ij = np.asarray(jse3.se3_inverse(jnp.asarray(Tj)))
    It = tse3.se3_inverse(torch.from_numpy(Tj.copy())).numpy()
    np.testing.assert_allclose(It, Ij, atol=1e-6)


def test_se3_exp_zero_is_identity():
    T = tse3.se3_exp(torch.zeros(6))
    assert torch.equal(T, torch.eye(4))
    assert torch.equal(tse3.se3_log(torch.eye(4)), torch.zeros(6))


def test_sym3_rotate_inv_match_jax(rng):
    S = random_spd(rng, 128)
    w = rng.normal(size=3).astype(np.float32)
    R = np.array(jse3.so3_exp(jnp.asarray(w)))
    pj = [jnp.asarray(p) for p in planes_np(S)]
    pt = [torch.from_numpy(np.ascontiguousarray(p)) for p in planes_np(S)]
    rj = np.stack([np.asarray(x) for x in jsym3.rotate(jnp.asarray(R), pj)])
    rt = tsym3.pack(tsym3.rotate(torch.from_numpy(R), pt)).numpy()
    np.testing.assert_allclose(rt, rj, rtol=1e-5, atol=1e-5)
    ij = np.stack([np.asarray(x) for x in jsym3.inv(pj)])
    it = tsym3.pack(tsym3.inv(pt)).numpy()
    np.testing.assert_allclose(it, ij, rtol=1e-5, atol=1e-6)


def special_matrices(rng):
    """SPD matrices with distinct eigenvalues, then the zero matrix and
    an isotropic one: the inputs of the eigensolver's clamp (p^3 would
    underflow to 0/0 without it)."""
    S = random_spd(rng, 64)
    return np.concatenate([S, np.zeros((1, 3, 3), np.float32),
                           np.eye(3, dtype=np.float32)[None] * 0.7])


def test_sym3_smallest_eigvec_match_jax(rng):
    S = special_matrices(rng)
    pj = [jnp.asarray(p) for p in planes_np(S)]
    pt = [torch.from_numpy(np.ascontiguousarray(p)) for p in planes_np(S)]
    nj = np.stack([np.asarray(x) for x in jsym3.smallest_eigvec(pj)])
    nt = torch.stack(tsym3.smallest_eigvec(pt)).numpy()
    assert np.isfinite(nt).all()
    np.testing.assert_allclose(nt, nj, atol=1e-4)
    # the zero and isotropic matrices fall back to +z, as in the JAX module
    np.testing.assert_array_equal(nt[:, -2:], [[0, 0], [0, 0], [1, 1]])


@pytest.mark.parametrize("eps", [1e-3, 0.1])
def test_sym3_regularize_gicp_match_jax(rng, eps):
    S = special_matrices(rng)
    pj = [jnp.asarray(p) for p in planes_np(S)]
    pt = [torch.from_numpy(np.ascontiguousarray(p)) for p in planes_np(S)]
    gj = np.stack([np.asarray(x) for x in jsym3.regularize_gicp(pj, eps)])
    gt = tsym3.pack(tsym3.regularize_gicp(pt, eps)).numpy()
    assert np.isfinite(gt).all()
    np.testing.assert_allclose(gt, gj, atol=1e-4)
    # eigenvalues of the clamped matrix are (1, 1, eps)
    ev = np.linalg.eigvalsh(np.asarray(tsym3.to_matrix(tuple(torch.from_numpy(gt)))))
    np.testing.assert_allclose(ev, np.broadcast_to([eps, 1, 1], ev.shape), atol=1e-4)


def test_sym3_add_scale_matvec_match_jax(rng):
    """Elementwise products and sums in the same order: equal to the bit."""
    S, U = random_spd(rng, 128), random_spd(rng, 128)
    v = rng.normal(size=(3, 128)).astype(np.float32)
    pj, uj = ([jnp.asarray(p) for p in planes_np(M)] for M in (S, U))
    pt, ut = ([torch.from_numpy(np.ascontiguousarray(p)) for p in planes_np(M)] for M in (S, U))
    for got, ref in ((tsym3.add(pt, ut), jsym3.add(pj, uj)),
                     (tsym3.scale(pt, 0.37), jsym3.scale(pj, 0.37)),
                     (tsym3.matvec(pt, tuple(torch.from_numpy(v))),
                      jsym3.matvec(pj, tuple(jnp.asarray(v))))):
        np.testing.assert_array_equal(torch.stack(got).numpy(),
                                      np.stack([np.asarray(x) for x in ref]))
    mv = torch.stack(tsym3.matvec(pt, tuple(torch.from_numpy(v)))).numpy()
    np.testing.assert_allclose(mv, np.einsum("nij,jn->in", S, v), rtol=1e-5, atol=1e-4)
