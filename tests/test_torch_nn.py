"""semicp_torch per-class nearest neighbour against semicp on the same
numpy inputs.

The JAX sparse Pallas kernel runs in interpret mode, as tests/test_pallas.py
runs it, with that file's tolerances: d2 to rtol 1e-4 / atol 1e-3 (the
expanded form |q|^2 + |t|^2 - 2 q.t rounds differently per library), and
the winner's attribute rows equal — except at near-ties, where the two
may pick different targets and the port's winner must lie within the d2
tolerance of the reference minimum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semicp.cloud.cloud import Cloud as JCloud
from semicp.corr.pallas_nn2 import class_nn_attrs_sparse as j_sparse
from semicp.corr.pallas_nn2 import class_nn_attrs_xla
from semicp.corr.pallas_nn2 import prepare_sparse as j_prepare
from semicp_torch.cloud.cloud import Cloud as TCloud
from semicp_torch.corr.nn_sparse import class_nn_attrs_plain, class_nn_attrs_sparse
from semicp_torch.corr.nn_sparse import prepare_sparse as t_prepare

RTOL, ATOL = 1e-4, 1e-3


def fixture(rng, N, K, extent):
    xyz = rng.normal(size=(3, N)).astype(np.float32) * extent
    lab = rng.integers(0, K, size=N).astype(np.int32)
    val = rng.uniform(size=N) > 0.1
    cov6 = rng.normal(size=(6, N)).astype(np.float32)
    q = rng.normal(size=(3, N)).astype(np.float32) * extent
    return xyz, lab, val, cov6, q


def assert_same_winners(d2_t, at_t, d2_r, at_r, q, sel):
    """d2 within tolerance on `sel`; rows equal, or a near-tie whose
    winner is as close to the query as the reference minimum."""
    np.testing.assert_allclose(d2_t[sel], d2_r[sel], rtol=RTOL, atol=ATOL)
    same = np.all(at_t == at_r, axis=1) & sel
    ties = sel & ~same
    assert ties.sum() <= 0.01 * sel.sum(), (ties.sum(), sel.sum())
    wd2 = np.sum((at_t[:, 0:3, :] - q[None]) ** 2, axis=1)
    np.testing.assert_allclose(wd2[ties], d2_r[ties], rtol=RTOL, atol=ATOL)
    assert (at_t[:, 9][sel] == 1.0).all() and (at_t[:, 10:] == 0).all()


@pytest.mark.parametrize("K,gate", [(5, 2.0), (3, 0.5)])
def test_plain_matches_sparse_kernel_interpret_within_gate(rng, K, gate):
    N = 1024
    xyz, lab, val, cov6, q = fixture(rng, N, K, 15.0)
    jc = JCloud(xyz=jnp.asarray(xyz), label=jnp.asarray(lab), cov6=jnp.asarray(cov6),
                valid=jnp.asarray(val), count=jnp.int32(val.sum()))
    prep = j_prepare(jc, K, cell=1.0, tb=256)
    d2_s, at_s = j_sparse(prep, jnp.asarray(q), jnp.ones(N, bool), num_classes=K,
                          gate=gate, qb=256, interpret=True)
    d2_s, at_s = np.asarray(d2_s), np.asarray(at_s)
    d2_t, at_t = class_nn_attrs_plain(*map(torch.from_numpy, (xyz, lab, val, cov6, q)), K)
    d2_t, at_t = d2_t.numpy(), at_t.numpy()
    inside = d2_t <= gate * gate * (1.0 - 1e-5)
    assert inside.any(), "fixture must exercise the within-gate contract"
    assert_same_winners(d2_t, at_t, d2_s, at_s, q, inside)
    # beyond the gate the kernel may prune to INF, never report closer
    assert (d2_s[~inside] >= d2_t[~inside] * (1 - RTOL) - ATOL).all()


def test_plain_matches_xla_everywhere(rng):
    K, N = 6, 1024
    xyz, lab, val, cov6, q = fixture(rng, N, K, 10.0)
    d2_x, at_x = class_nn_attrs_xla(*map(jnp.asarray, (xyz, lab, val, cov6, q)), K)
    d2_t, at_t = class_nn_attrs_plain(*map(torch.from_numpy, (xyz, lab, val, cov6, q)), K)
    d2_x, at_x, d2_t, at_t = np.asarray(d2_x), np.asarray(at_x), d2_t.numpy(), at_t.numpy()
    found = d2_x < 1e30
    assert (found == (d2_t < 1e30)).all()
    assert_same_winners(d2_t, at_t, d2_x, at_x, q, found)


def test_class_missing_from_target(rng):
    """A class absent from the target gives d2 == INF and a zero row."""
    N, K = 512, 4
    xyz = rng.normal(size=(3, N)).astype(np.float32)
    lab = rng.integers(0, 2, size=N).astype(np.int32)          # only 0, 1
    d2, at = class_nn_attrs_plain(torch.from_numpy(xyz), torch.from_numpy(lab),
                                  torch.ones(N, dtype=torch.bool), torch.zeros(6, N),
                                  torch.from_numpy(xyz), K)
    assert (d2[2:] > 1e30).all() and (at[2:] == 0).all() and (d2[:2] < 1e30).all()


def test_prepare_sparse_and_cpu_dispatch_match_jax(rng):
    """prepare_sparse packs the same slab and tile metadata as the JAX
    package; on a CPU tensor the sparse entry point is the plain contract."""
    K, N = 5, 2048
    xyz, lab, val, cov6, q = fixture(rng, N, K, 12.0)
    jc = JCloud(xyz=jnp.asarray(xyz), label=jnp.asarray(lab), cov6=jnp.asarray(cov6),
                valid=jnp.asarray(val), count=jnp.int32(val.sum()))
    tc = TCloud(*map(torch.from_numpy, (xyz, lab, cov6, val)), count=torch.tensor(val.sum()))
    pj, pt = j_prepare(jc, K, cell=1.0), t_prepare(tc, K, cell=1.0)
    for key in ("xyz_s", "label_s", "attrs16", "lo", "hi", "cmin", "cmax"):
        np.testing.assert_array_equal(pt[key].numpy(), np.asarray(pj[key]), err_msg=key)
    qt = torch.from_numpy(q)
    d2_s, at_s = class_nn_attrs_sparse(pt, qt, torch.ones(N, dtype=torch.bool), K, gate=2.0)
    d2_p, at_p = class_nn_attrs_plain(pt["xyz_s"], pt["label_s"], pt["label_s"] < K,
                                      pt["attrs16"][3:9], qt, K)
    assert torch.equal(d2_s, d2_p) and torch.equal(at_s, at_p)
