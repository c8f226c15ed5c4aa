"""semicp_torch's one-kernel sparse E-step (K6) against semicp on the same
numpy inputs, on the CPU.

The JAX Pallas kernel runs in interpret mode with the fixture and the
tolerances of tests/test_pallas.py's fused check: weights to atol 1e-5;
A to (rtol 3e-3, atol 3e-3), b to (3e-3, 1e-2), c to (3e-3, 2e-2). The
TPU kernel averages the rows of exact ties where the port takes the
lowest index; random points in general position have no exact ties. The
slices hold T to 1e-4, the bound of tests/test_torch_register.py. The
plain version of K6's second stage (the reduce from the walk's per-class
keys) is held to the plain contract bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import semicp
import semicp_torch
from semicp.cloud.cloud import Cloud as JCloud
from semicp.corr.pallas_nn2 import prepare_sparse as j_prepare
from semicp.data import make_pair, make_scene
from semicp.register.pallas_fused import estep_sparse_fused as j_fused
from semicp_torch.cloud.cloud import Cloud as TCloud
from semicp_torch.cloud.cloud import FAR
from semicp_torch.corr.bruteforce import INF, class_nn
from semicp_torch.corr.nn_sparse import NATTR, class_nn_attrs_sparse, pack_key
from semicp_torch.corr.nn_sparse import prepare_sparse as t_prepare
from semicp_torch.register import em_icp as t_em_icp
from semicp_torch.register.estep import estep_reduce, estep_reduce_plain
from semicp_torch.register.fused import estep_fused_plain, estep_sparse_fused

TOLS = {"a6": (3e-3, 3e-3), "b3": (3e-3, 1e-2), "c": (3e-3, 2e-2)}
KEY_NONE = (1 << 63) - 1   # the walk's "no neighbour" key (~0 unsigned) in pack_key's order


def unpack_key(keys):
    """(d2 float32, idx int64, found bool) of `pack_key`'s int64 keys;
    KEY_NONE is no neighbour (its d2 and idx mean nothing)."""
    e = (keys >> 32) + (1 << 31)                     # the unsigned high word
    u = torch.where(e >= 0x80000000, e ^ 0x80000000, e ^ 0xFFFFFFFF)
    d2 = torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32).view(torch.float32)
    return d2, keys & 0xFFFFFFFF, keys != KEY_NONE


def estep_from_keys_plain(prep, keys, q_xyz, q_valid, rc6, log_sem, num_classes, gate):
    """The reduce from per-class keys (K, Q) int64 in `pack_key`'s order
    (KEY_NONE: no neighbour), each winner's row read from the prepared
    slab: the plain version of K6's second stage (csrc/estep_fused.cu
    `estep_keys_kernel`)."""
    d2, idx, found = unpack_key(keys)
    win = prep["attrs16"][:10, torch.where(found, idx, 0)].movedim(0, 1)   # (K, 10, Q)
    win = torch.where(found[:, None, :], win, torch.zeros_like(win))
    spare = torch.zeros((num_classes, NATTR - 10, keys.shape[1]), dtype=win.dtype,
                        device=win.device)
    nn_d2 = torch.where(found, d2, torch.full_like(d2, INF))
    return estep_reduce_plain(nn_d2, torch.cat([win, spare], dim=1), rc6, q_xyz, log_sem,
                              q_valid, gate * gate)


def fused_fixture(rng, N, K, extent=10.0):
    """The fixture of tests/test_pallas.py's fused check: SPD-ish target
    and source covariances, so the weight math is well conditioned."""
    xyz = rng.normal(size=(3, N)).astype(np.float32) * extent
    lab = rng.integers(0, K, size=N).astype(np.int32)
    val = rng.uniform(size=N) > 0.1
    d = rng.uniform(0.3, 1.0, size=(3, N)).astype(np.float32)
    cov6 = np.concatenate([d, rng.normal(size=(3, N)).astype(np.float32) * 0.05])
    q = rng.normal(size=(3, N)).astype(np.float32) * extent
    qval = rng.uniform(size=N) > 0.05
    rc = np.concatenate([rng.uniform(0.3, 1.0, size=(3, N)).astype(np.float32),
                         rng.normal(size=(3, N)).astype(np.float32) * 0.05])
    log_sem = (rng.normal(size=(K, N)) * 0.5).astype(np.float32)
    return xyz, lab, val, cov6, q, qval, rc, log_sem


def pad_tail(xyz, lab, val, cov6, q, qval, n_tgt, n_q):
    """Pad the last n_tgt targets and n_q queries as make_cloud pads a
    cloud: FAR coordinates, label -1, identity covariance, invalid."""
    xyz[:, -n_tgt:], lab[-n_tgt:], val[-n_tgt:] = FAR, -1, False
    cov6[:, -n_tgt:] = np.array([1, 1, 1, 0, 0, 0], np.float32)[:, None]
    q[:, -n_q:], qval[-n_q:] = FAR, False


def preps(xyz, lab, val, cov6, K):
    jc = JCloud(xyz=jnp.asarray(xyz), label=jnp.asarray(lab), cov6=jnp.asarray(cov6),
                valid=jnp.asarray(val), count=jnp.int32(val.sum()))
    tc = TCloud(*map(torch.from_numpy, (xyz, lab, cov6, val)), count=torch.tensor(val.sum()))
    return j_prepare(jc, K, cell=1.0, tb=256), t_prepare(tc, K, cell=1.0)


@pytest.mark.parametrize("K,gate,padded", [(5, 2.0, False), (3, 0.7, False), (20, 2.0, False),
                                           (5, 2.0, True)],
                         ids=["5-2.0", "3-0.7", "20-2.0", "padded"])
def test_estep_sparse_fused_matches_pallas_interpret(rng, K, gate, padded):
    """K = 20 is the bench's class count; "padded" gives the queries a
    FAR-padded tail of 4 whole invalid query warps (and 2 mixed ones) and
    the target 200 padded points."""
    N = 1024
    xyz, lab, val, cov6, q, qval, rc, log_sem = fused_fixture(rng, N, K)
    if padded:
        pad_tail(xyz, lab, val, cov6, q, qval, n_tgt=200, n_q=160)
    pj, pt = preps(xyz, lab, val, cov6, K)
    ref = j_fused(pj, *map(jnp.asarray, (q, qval, rc, log_sem)), num_classes=K, gate=gate,
                  qb=256, interpret=True)
    out = estep_sparse_fused(pt, *map(torch.from_numpy, (q, qval, rc, log_sem)), K, gate)
    a, b, c, w = (np.asarray(o) for o in ref)
    assert (w > 0).sum() > 0.02 * N, "fixture must put correspondences within the gate"
    np.testing.assert_allclose(out[3].numpy(), w, atol=1e-5)
    for name, got, want in zip(("a6", "b3", "c"), out[:3], (a, b, c)):
        rtol, atol = TOLS[name]
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol, err_msg=name)


def test_fused_contract_is_split_path(rng):
    """The fused entry point on a CPU tensor is the split path's K2 then K3
    contract, bit for bit (a 0-dim gate tensor as align passes it)."""
    K, N = 4, 1024
    xyz, lab, val, cov6, q, qval, rc, log_sem = fused_fixture(rng, N, K)
    _, pt = preps(xyz, lab, val, cov6, K)
    q, qval, rc, log_sem = map(torch.from_numpy, (q, qval, rc, log_sem))
    gate = torch.tensor(1.5)
    split = estep_reduce(*class_nn_attrs_sparse(pt, q, qval, K, gate), rc, q, log_sem, qval,
                         gate * gate)
    for got, plain, want in zip(estep_sparse_fused(pt, q, qval, rc, log_sem, K, gate),
                                estep_fused_plain(pt, q, qval, rc, log_sem, K, gate), split):
        assert torch.equal(got, want) and torch.equal(plain, want)


@pytest.mark.parametrize("K,gate", [(4, 1.5), (20, 2.0)])
def test_estep_from_keys_plain_is_the_plain_contract(rng, K, gate):
    """Stage 2's plain version, fed keys packed from class_nn's (d2, index)
    (KEY_NONE where a class has no target), equals estep_fused_plain bit
    for bit; a column of KEY_NONE gives zero planes and wsum = 0."""
    N = 1024
    xyz, lab, val, cov6, q, qval, rc, log_sem = fused_fixture(rng, N, K)
    lab[lab == K - 1] = 0                       # class K-1 has no target
    _, pt = preps(xyz, lab, val, cov6, K)
    q, qval, rc, log_sem = map(torch.from_numpy, (q, qval, rc, log_sem))
    label_s = pt["label_s"]
    idx, d2 = class_nn(pt["xyz_s"], label_s, label_s < K, q, K)
    assert bool(torch.all(d2[K - 1] == INF))
    keys = torch.where(d2 < INF, pack_key(d2, idx), torch.full_like(idx, KEY_NONE))
    keys[:, 7] = KEY_NONE
    got = estep_from_keys_plain(pt, keys, q, qval, rc, log_sem, K, gate)
    want = estep_fused_plain(pt, q, qval, rc, log_sem, K, gate)
    assert float(want[3].sum()) > 0.02 * N, "fixture must put correspondences within the gate"
    q[:, 7] = FAR                               # no target of any class near query 7
    want7 = estep_fused_plain(pt, q[:, 7:8], qval[7:8], rc[:, 7:8], log_sem[:, 7:8], K, gate)
    for g, w, w7 in zip(got, want, want7):
        assert torch.equal(g[..., :7], w[..., :7]) and torch.equal(g[..., 8:], w[..., 8:])
        assert torch.equal(g[..., 7], torch.zeros_like(g[..., 7]))
        assert torch.equal(w7[..., 0], torch.zeros_like(w7[..., 0]))


def test_unpack_key_inverts_pack_key(rng):
    """unpack_key returns pack_key's (d2, index) for negative, zero,
    positive and huge d2 (-0 as +0), and found = False at KEY_NONE only."""
    d2 = torch.from_numpy(np.concatenate([
        rng.normal(size=200).astype(np.float32) * 10.0,
        np.array([0.0, -0.0, -1e-3, 3.0e37, 1e-38, -1e-38], np.float32)]))
    idx = torch.from_numpy(rng.integers(0, 2**31 - 1, size=d2.shape[0]))
    keys = pack_key(d2, idx)
    back_d2, back_idx, found = unpack_key(keys)
    assert torch.equal(back_d2.view(torch.int32), (d2 + 0.0).view(torch.int32))
    assert torch.equal(back_idx, idx) and bool(found.all())
    assert not bool(unpack_key(torch.tensor([KEY_NONE]))[2][0])


def test_fused_estep_slice_matches_split_and_jax(rng, monkeypatch):
    """em.fused_estep against the port's split path and semicp's fused
    path, on the pair of tests/test_register.py; then the automatic
    dispatch at em.fused_auto_min_q = n_pad."""
    K = 6
    over = {"cloud.n_pad": 2048, "cloud.num_classes": K, "corr.engine": "sparse",
            "em.max_iters": 10}
    tgt_pts, tgt_lab = make_scene(rng, n_points=1900, extent=12.0, n_classes=K)
    tgt_lab = tgt_lab - 1
    delta = np.array([0.25, -0.1, 0.04, 0.01, -0.015, 0.02])
    src_pts, src_lab, T_gt = make_pair(rng, tgt_pts, tgt_lab, delta, noise=0.01,
                                       dropout=0.05, n_classes=K)

    cj = semicp.Config().override({**over, "em.fused_estep": True})
    pre = jax.jit(lambda c: semicp.preprocess_cloud(c, cj))
    rj = semicp.make_align_fn(cj)(*(pre(semicp.make_cloud(p, l, n_pad=2048))
                                    for p, l in ((src_pts, src_lab), (tgt_pts, tgt_lab))))

    calls = []

    def counted(*args, **kw):
        calls.append(args[1].shape[1])
        return estep_sparse_fused(*args, **kw)

    monkeypatch.setattr(t_em_icp, "estep_sparse_fused", counted)
    base = semicp_torch.Config().override(over)
    src, tgt = (semicp_torch.preprocess_cloud(semicp_torch.make_cloud(p, l, n_pad=2048,
                                                                      device="cpu"), base)
                for p, l in ((src_pts, src_lab), (tgt_pts, tgt_lab)))
    r_split = semicp_torch.make_align_fn(base)(src, tgt)
    assert not calls
    r_fused = semicp_torch.make_align_fn(base.override({"em.fused_estep": True}))(src, tgt)
    assert calls == [2048] * int(r_fused.iterations)
    np.testing.assert_allclose(r_fused.T.numpy(), r_split.T.numpy(), atol=1e-4)
    np.testing.assert_allclose(r_fused.T.numpy(), np.asarray(rj.T), atol=1e-4)
    err = r_fused.T.numpy().astype(np.float64) @ np.linalg.inv(T_gt.astype(np.float64))
    assert np.linalg.norm(err[:3, 3]) < 0.03

    calls.clear()
    r_auto = semicp_torch.make_align_fn(base.override({"em.fused_auto_min_q": 2048}))(src, tgt)
    assert calls == [2048] * int(r_auto.iterations)
    np.testing.assert_allclose(r_auto.T.numpy(), r_fused.T.numpy(), atol=1e-6)
