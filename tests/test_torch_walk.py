"""What surrounds the per-warp chunk walks of kernels K1 and K2, on the CPU.

The kernels run only on a card. Their culling has a plain mirror in the
package (`nn_walked_chunks`, `moments_walked_chunks`, in the kernels'
float32 arithmetic), and these tests hold it to the kernels' contracts:
the 32-point chunk boxes and class ranges lower-bound every pair, empty
and scattered chunks are culled rather than NaN, and walking only the
kept chunks gives the plain NN within the gate (tolerances of
`chip_smoke.compare_nn`: d2 rtol 1e-4, atol 1e-3) and the plain moments
at the covariance level (`compare_moments`: atol 1e-5 + rtol 1e-3). K5
runs K1's walk on an internal order of a raw-layout cloud
(`raw_walk_inputs`, `moments_raw_walked_chunks`), held the same way and
to the raw order it returns to. Also the order of K2's 64-bit merge key,
the card as the default device, and make_cloud's padding on the device.
"""

import inspect

import numpy as np
import pytest
import torch

import semicp_torch
from semicp_torch.cloud.cloud import FAR, make_cloud
from semicp_torch.cloud.moments import (
    RAW_BUCKETS,
    chunk_inputs,
    moments_plain,
    moments_raw_walked_chunks,
    moments_walked_chunks,
    raw_order,
    raw_walk_inputs,
)
from semicp_torch.convert import cloud_from_numpy
from semicp_torch.corr.bruteforce import INF
from semicp_torch.corr.layout import (
    CHUNK,
    box_gap2,
    pack_boxes,
    sort_cloud_cm,
    tile_candidates,
    tile_meta,
)
from semicp_torch.corr.morton import tile_aabbs
from semicp_torch.corr.nn_sparse import (
    class_nn_attrs_plain,
    nn_walked_chunks,
    pack_key,
    prepare_sparse,
)
from semicp_torch.data import make_pair, make_scene
from semicp_torch.utils import PhaseTimer, installed

RTOL, ATOL = 1e-4, 1e-3          # chip_smoke.compare_nn
COV_ATOL, COV_RTOL = 1e-5, 1e-3  # chip_smoke.compare_moments
K = 6
DELTA = np.array([0.5, -0.2, 0.05, 0.01, -0.02, 0.04])


def skewed_scene(rng, n):
    """Most points in one dense 2 m ball, the rest spread over 40 m: a
    density skew that makes some warps far heavier than others."""
    m = int(0.7 * n)
    dense = rng.normal(size=(m, 3)) * 0.6
    sparse = rng.uniform(-20, 20, size=(n - m, 3))
    xyz = np.concatenate([dense, sparse]).astype(np.float32)
    return xyz, rng.integers(0, K, size=n).astype(np.int32)


def pair(kind, rng, n_pad):
    """(source cloud, target cloud), cm-sorted, on the CPU. "past": the
    bench pair with the labels of 5% of each cloud set past the classes
    (K to K + 2), which the NN must ignore and the moments match label to
    label."""
    if kind == "skewed":
        xyz, lab = skewed_scene(rng, int(0.93 * n_pad))
    else:
        xyz, lab = make_scene(rng, n_points=int(0.93 * n_pad), extent=16.0, n_classes=K)
        lab = lab - 1
    src, slab, _ = make_pair(rng, xyz, lab, DELTA, noise=0.02, dropout=0.1, n_classes=K)
    if kind == "past":           # one end of the scene, so they have neighbours
        for p, lb in ((src, slab), (xyz, lab)):
            sel = p[:, 0] > np.quantile(p[:, 0], 0.95)
            lb[sel] = K + rng.integers(0, 3, size=int(sel.sum()))
    return [sort_cloud_cm(make_cloud(p, lb, n_pad, device="cpu"), K, 2.0)
            for p, lb in ((src, slab), (xyz, lab))]


def ranges_inside(box, hi):
    """Every non-empty box's class range lies inside [0, hi]."""
    cmin, cmax = box[:, 3], box[:, 7]
    full = cmin <= cmax
    return bool(full.any()) and bool(torch.all((cmin[full] >= 0) & (cmax[full] <= hi)))


def expand(walked):
    """(warp, chunk) mask -> (query, target) mask."""
    return walked.repeat_interleave(CHUNK, 0).repeat_interleave(CHUNK, 1)


@pytest.mark.parametrize("kind", ["bench", "skewed", "scattered"])
def test_chunk_boxes_lower_bound_every_pair(rng, kind):
    """Each chunk's box and class range hold its valid points; the point-to-
    box distance never exceeds a pair distance; all-invalid chunks are
    +inf away (never NaN) and so culled."""
    n = 2048
    xyz, lab = skewed_scene(rng, n) if kind == "skewed" else make_scene(
        rng, n_points=n, extent=12.0, n_classes=K)
    c = make_cloud(xyz, np.clip(lab - (kind != "skewed"), 0, K - 1), n_pad=n, device="cpu")
    valid = c.valid.clone()
    if kind == "scattered":      # NDT's voxel targets: valid scattered over the capacity
        valid &= torch.from_numpy(rng.uniform(size=n) > 0.6)
        valid[256:512] = False   # and whole chunks empty
    elif kind == "bench":
        c = sort_cloud_cm(c, K, 2.0)
        valid = c.valid
    box = pack_boxes(tile_meta(c.xyz, c.label, valid, K, CHUNK))
    nc = n // CHUNK
    pts = c.xyz.T                                                   # (n, 3)
    g = box_gap2(pts[:, None, :], pts[:, None, :], box[None, :, 0:3], box[None, :, 4:7])
    assert not torch.isnan(g).any()
    d2 = torch.sum((pts[:, None, :] - pts[None, :, :]) ** 2, dim=-1)  # (n, n)
    chunk_of = torch.arange(n) // CHUNK
    lower = g[:, chunk_of]                                          # (n, n)
    assert bool(torch.all(lower[:, valid] <= d2[:, valid] + 1e-4))
    lab_c = c.label.reshape(nc, CHUNK)
    v_c = valid.reshape(nc, CHUNK)
    cmin, cmax = box[:, 3][:, None], box[:, 7][:, None]
    assert bool(torch.all(~v_c | ((lab_c >= cmin) & (lab_c <= cmax))))
    empty = ~v_c.any(dim=1)
    assert (kind != "scattered") or bool(empty.any())
    assert bool(torch.all(torch.isinf(g[:, empty]))) and bool(torch.all(cmin[empty] > cmax[empty]))


@pytest.mark.parametrize("kind", ["bench", "skewed", "past"])
def test_nn_walk_of_kept_chunks_equals_plain(rng, kind):
    """K2's walk over only the chunks its culling keeps gives the plain
    per-class NN within the gate (d2 and winner; near-ties as in
    chip_smoke), and beyond the gate never a closer one. Targets labelled
    past the classes stay out of every box and class range (the kernel's
    per-class slots are never indexed past K) and never win."""
    gate = 2.0
    src, tgt = pair(kind, rng, 4096)
    prep = prepare_sparse(tgt, K, 2.0)
    assert ranges_inside(prep["chunk_box"], K - 1) and ranges_inside(prep["tile_box"], K - 1)
    past = tgt.valid & (tgt.label >= K)
    assert (kind != "past") == (not bool(past.any()))
    assert bool(torch.all(torch.isinf(prep["pts4"][past, 3])))
    q, qv = src.xyz, src.valid
    walked = nn_walked_chunks(prep, q, qv, gate)
    # fewer pairs than the candidate tile lists of the first port
    qlo, qhi = tile_aabbs(q, qv, 256)
    cand_count = tile_candidates(qlo, qhi, prep["lo"], prep["hi"], gate)[1]
    tb = prep["xyz_s"].shape[1] // prep["tile_box"].shape[0]
    assert int(walked.sum()) * CHUNK * CHUNK < int(cand_count.sum()) * 256 * tb
    assert bool(walked.any())

    label_s, xyz_s = prep["label_s"], prep["xyz_s"]
    t2 = torch.sum(xyz_s * xyz_s, dim=0)
    q2 = torch.sum(q * q, dim=0)
    d2 = q2[:, None] + t2[None, :] - 2.0 * (q.T @ xyz_s)            # class_nn's form
    pairs = expand(walked)
    d2_e = torch.full((K, q.shape[1]), INF)
    idx_e = torch.zeros((K, q.shape[1]), dtype=torch.int64)
    for k in range(K):
        dk = torch.where(pairs & (label_s == k)[None, :], d2, torch.full_like(d2, INF))
        d2_e[k], idx_e[k] = torch.min(dk, dim=1)
    rows = prep["attrs16"][:10]
    at_e = torch.where((d2_e < INF)[:, None, :], rows[:, idx_e].movedim(0, 1), 0.0)

    d2_p, at_p = class_nn_attrs_plain(xyz_s, label_s, label_s < K, prep["attrs16"][3:9], q, K)
    inside = (d2_p <= gate * gate * (1.0 - 1e-5)) & qv[None, :]
    assert bool(inside.any())
    err = torch.abs(d2_e - d2_p)[inside]
    assert bool(torch.all(err <= ATOL + RTOL * torch.abs(d2_p[inside])))
    same = torch.all(at_e == at_p[:, :10], dim=1) & inside
    ties = inside & ~same
    assert int(ties.sum()) <= 0.01 * int(inside.sum())
    wd2 = torch.sum((at_e[:, 0:3, :] - q[None]) ** 2, dim=1)
    assert bool(torch.all(torch.abs(wd2 - d2_p)[ties] <= ATOL + RTOL * torch.abs(d2_p[ties])))
    outside = ~inside & qv[None, :]
    assert bool(torch.all(d2_e[outside] >= d2_p[outside] * (1 - RTOL) - ATOL))


def cov64(m):
    n = torch.clamp(m[0], min=1.0)
    mx, my, mz = m[1] / n, m[2] / n, m[3] / n
    return torch.stack([m[4] / n - mx * mx, m[5] / n - my * my, m[6] / n - mz * mz,
                        m[7] / n - mx * my, m[8] / n - mx * mz, m[9] / n - my * mz])


@pytest.mark.parametrize("kind", ["bench", "skewed", "past"])
def test_moments_walk_of_kept_chunks_equals_plain(rng, kind):
    """K1's walk over only the chunks its culling keeps holds every same-
    label pair within the radius, and its query-centred moments give the
    plain covariances. Labels past the classes share the culling's bucket
    K (its tables hold K + 1 entries) and still match only their own."""
    _, c = pair(kind, rng, 2048)
    label = torch.clamp(c.label, min=0)
    r = 0.3 if kind == "skewed" else 0.6
    walked = moments_walked_chunks(c.xyz, label, c.valid, r, K)
    a = chunk_inputs(c.xyz, label, c.valid, K)
    assert ranges_inside(a["chunk_box"], K)
    span = a["span"].long()
    assert int(walked.sum()) < int(torch.clamp(span[:, 1] - span[:, 0] + 1, min=0).sum())

    x = c.xyz.double()
    diff = x[:, None, :] - x[:, :, None]                  # (3, query, target) offsets
    d2 = torch.sum(diff * diff, dim=0)
    same = (label[:, None] == label[None, :]) & c.valid[:, None] & c.valid[None, :]
    near = same & (d2 < r * r)
    past = near & (label >= K)[:, None]
    assert (kind != "past") == (int(past.sum()) <= int(torch.diagonal(past).sum()))
    assert not bool((near & ~expand(walked)).any()), "the culling dropped a neighbour"
    w = (near & expand(walked)).double()
    feats = [w.sum(1)] + [(w * diff[i]).sum(1) for i in range(3)]
    feats += [(w * diff[i] * diff[j]).sum(1) for i, j in ((0, 0), (1, 1), (2, 2),
                                                          (0, 1), (0, 2), (1, 2))]
    m_e = torch.stack(feats)
    m_p = moments_plain(x, label, c.valid, r)
    assert torch.equal(m_e[0], m_p[0])
    sel = c.valid & (m_p[0] >= 3)
    ce, cp = cov64(m_e)[:, sel], cov64(m_p)[:, sel]
    assert bool(torch.all(torch.abs(ce - cp) <= COV_ATOL + COV_RTOL * torch.abs(cp)))


def raw_cloud(kind, rng):
    """(xyz, label, valid, radius) of a raw-layout cloud on the CPU, as
    K5 gets it: "shuffled", the bench scene's points and labels in random
    order; "one_label", every label 0 (class_aware=False); "past", 5% of the
    labels past K5's buckets (shared bucket, matched label to label);
    "invalid", a fifth of the points invalid in a capacity that is not a
    whole number of chunks."""
    n_pad = 2000 if kind == "invalid" else 2048
    xyz, lab = make_scene(rng, n_points=1900, extent=12.0, n_classes=K)
    perm = rng.permutation(len(xyz))
    xyz, lab = xyz[perm], (lab[perm] - 1).clip(0)
    if kind == "one_label":
        lab = np.zeros_like(lab)
    elif kind == "past":
        sel = xyz[:, 0] > np.quantile(xyz[:, 0], 0.95)
        lab[sel] = RAW_BUCKETS + rng.choice([0, 1, 8], size=int(sel.sum()))
    c = make_cloud(xyz, lab, n_pad=n_pad, device="cpu")
    valid = c.valid.clone()
    if kind == "invalid":
        valid &= torch.from_numpy(rng.uniform(size=n_pad) > 0.2)
    return c.xyz, c.label, valid, 0.6


K5_KINDS = ["shuffled", "one_label", "past", "invalid"]


@pytest.mark.parametrize("kind", K5_KINDS)
def test_k5_order_chunk_boxes_lower_bound_every_pair(rng, kind):
    """In K5's internal order, each chunk's box and bucket range hold its
    valid points and the point-to-box distance never exceeds a pair
    distance; the padding up to whole chunks is invalid and culled."""
    xyz, label, valid, r = raw_cloud(kind, rng)
    perm, xs, ls, vs = raw_walk_inputs(xyz, label, valid, r)
    n = perm.shape[0]
    assert n % CHUNK == 0 and n - xyz.shape[1] == int((perm < 0).sum()) < CHUNK
    a = chunk_inputs(xs, ls, vs, RAW_BUCKETS)
    box, nc = a["chunk_box"], n // CHUNK
    assert ranges_inside(box, RAW_BUCKETS)
    pts = xs.T
    g = box_gap2(pts[:, None, :], pts[:, None, :], box[None, :, 0:3], box[None, :, 4:7])
    d2 = torch.sum((pts[:, None, :] - pts[None, :, :]) ** 2, dim=-1)
    lower = g[:, torch.arange(n) // CHUNK]
    assert not torch.isnan(g).any()
    assert bool(torch.all(lower[:, vs] <= d2[:, vs] + 1e-4))
    bk = a["bucket"].reshape(nc, CHUNK)
    v_c = vs.reshape(nc, CHUNK)
    assert bool(torch.all(~v_c | ((bk >= box[:, 3:4]) & (bk <= box[:, 7:8]))))
    empty = ~v_c.any(dim=1)
    assert bool(torch.all(torch.isinf(g[:, empty])))
    assert bool(torch.all(box[empty, 3] > box[empty, 7]))


@pytest.mark.parametrize("kind", K5_KINDS)
def test_k5_walk_of_kept_chunks_equals_plain(rng, kind):
    """K5's walk over only the chunks K1's culling keeps in the internal
    order holds every same-label pair within the radius, walks far fewer
    pairs than all of them, and its query-centred moments, stored to each
    query's raw column, give the plain covariances of the raw cloud."""
    xyz, label, valid, r = raw_cloud(kind, rng)
    perm, xs, ls, vs = raw_walk_inputs(xyz, label, valid, r)
    walked = moments_raw_walked_chunks(xyz, label, valid, r)
    assert torch.equal(walked, moments_walked_chunks(xs, ls, vs, r, RAW_BUCKETS))
    assert 0 < int(walked.sum()) * CHUNK * CHUNK < int(valid.sum()) ** 2 / 4

    x = xs.double()
    diff = x[:, None, :] - x[:, :, None]                  # (3, query, target) offsets
    near = ((ls[:, None] == ls[None, :]) & vs[:, None] & vs[None, :]
            & (torch.sum(diff * diff, dim=0) < r * r))
    assert (kind != "past") == (int((near & (ls >= RAW_BUCKETS)[:, None]).sum()) == 0)
    assert not bool((near & ~expand(walked)).any()), "the culling dropped a neighbour"
    w = (near & expand(walked)).double()
    feats = [w.sum(1)] + [(w * diff[i]).sum(1) for i in range(3)]
    feats += [(w * diff[i] * diff[j]).sum(1) for i, j in ((0, 0), (1, 1), (2, 2),
                                                          (0, 1), (0, 2), (1, 2))]
    m_e = torch.zeros((10, xyz.shape[1]), dtype=torch.float64)
    inside = perm >= 0
    m_e[:, perm[inside].long()] = torch.stack(feats)[:, inside]
    m_p = moments_plain(xyz.double(), label, valid, r)
    assert torch.equal(m_e[0], m_p[0])
    sel = valid & (m_p[0] >= 3)
    ce, cp = cov64(m_e)[:, sel], cov64(m_p)[:, sel]
    assert bool(torch.all(torch.abs(ce - cp) <= COV_ATOL + COV_RTOL * torch.abs(cp)))


def test_k5_order_inverse_returns_raw_order(rng):
    """raw_order is a permutation of the raw indices, bucket-major with the
    invalid points last (the walk's input pads it with -1 to whole
    chunks); scattering the ordered cloud back through it returns the raw
    cloud exactly."""
    xyz, label, valid, r = raw_cloud("invalid", rng)
    label = label.clone()
    label[:64] = RAW_BUCKETS + 5                    # past the buckets, raw order kept
    perm, xs, ls, vs = raw_walk_inputs(xyz, label, valid, r)
    n = xyz.shape[1]
    assert torch.equal(perm[:n], raw_order(xyz, label, valid, torch.tensor(r)))
    inside = perm >= 0
    assert bool(inside[:n].all()) and not bool(inside[n:].any())
    assert torch.equal(torch.sort(perm[inside]).values, torch.arange(n))
    bucket = torch.where(vs, torch.clamp(ls, 0, RAW_BUCKETS), RAW_BUCKETS + 1)[inside]
    assert bool(torch.all(bucket[1:] >= bucket[:-1]))
    back_x, back_l = torch.empty_like(xyz), torch.empty_like(label)
    back_v = torch.empty_like(valid)
    idx = perm[inside]
    back_x[:, idx], back_l[idx], back_v[idx] = xs[:, inside], ls[inside], vs[inside]
    assert torch.equal(back_x, xyz) and torch.equal(back_l, label) and torch.equal(back_v, valid)


def test_pack_key_orders_as_d2_then_index(rng):
    """K2's merge key orders lexicographically by (d2, index), with
    negative d2 (expanded-form cancellation), -0 == +0, and exact ties."""
    d2 = np.concatenate([rng.normal(size=300).astype(np.float32) * 4,
                         np.float32([-1e-3, -0.0, 0.0, 0.0, 1.0, 1.0, 1.0, INF, INF, -3e-7])])
    d2 = np.concatenate([d2, d2[:50]])                     # exact ties at other indices
    idx = rng.permutation(len(d2)).astype(np.int64)
    key = pack_key(torch.from_numpy(d2), torch.from_numpy(idx))
    order = torch.argsort(key).numpy()
    ref = np.lexsort((idx, d2 + np.float32(0.0)))          # -0 + 0 = +0
    np.testing.assert_array_equal(order, ref)
    assert len(np.unique(key.numpy())) == len(key)


def test_make_cloud_defaults_to_the_card():
    """Entry points run on the card unless the caller asks for the CPU:
    without a card, the default raises rather than falling back."""
    for fn in (make_cloud, semicp_torch.make_cloud, cloud_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    xyz = np.zeros((10, 3), np.float32)
    if torch.cuda.is_available():
        assert make_cloud(xyz, n_pad=32).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            make_cloud(xyz, n_pad=32)
        with pytest.raises((AssertionError, RuntimeError)):
            cloud_from_numpy(xyz.T, np.zeros(10), np.zeros((6, 10)), np.ones(10, bool), 10)
    assert make_cloud(xyz, n_pad=32, device="cpu").device.type == "cpu"


def host_padded(xyz, label, n_pad):
    """The padding make_cloud did on the host before it padded on the
    device: (3, n_pad) xyz, (n_pad,) labels, identity cov6, valid, count."""
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    label = np.zeros((n,), np.int32) if label is None else np.asarray(label, np.int32)
    if n_pad is None:
        n_pad = max(8, 1 << int(np.ceil(np.log2(max(n, 1)))))
    xyz_p = np.full((n_pad, 3), FAR, np.float32)
    xyz_p[:n] = xyz
    lab_p = np.full((n_pad,), -1, np.int32)
    lab_p[:n] = label
    valid = np.zeros((n_pad,), bool)
    valid[:n] = True
    cov6 = np.zeros((6, n_pad), np.float32)
    cov6[:3] = 1.0
    return {"xyz": xyz_p.T.copy(), "label": lab_p, "cov6": cov6, "valid": valid,
            "count": np.asarray(n, np.int32)}


@pytest.mark.parametrize("n, n_pad, labelled", [
    (100, 128, True),        # n < n_pad
    (128, 128, True),        # n == n_pad
    (100, None, True),       # the default n_pad, the next power of two
    (50, 64, False),         # no labels: class 0
    (200, 128, True),        # past the capacity: raises
])
def test_make_cloud_pads_as_the_host_did(n, n_pad, labelled):
    """make_cloud pads on the device to the same arrays, bit for bit, as
    the host padding it replaced; the cloud shares no memory with the
    caller's arrays, and the CPU takes no pinned upload."""
    rng = np.random.default_rng(n)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    xyz[0] = -0.0
    label = rng.integers(0, 20, n).astype(np.int32) if labelled else None
    if n_pad is not None and n > n_pad:
        with pytest.raises(ValueError, match=f"cloud has {n} points > capacity {n_pad}"):
            make_cloud(xyz, label, n_pad=n_pad, device="cpu")
        return
    want = host_padded(xyz, label, n_pad)
    with installed(PhaseTimer()) as timer:
        cloud = make_cloud(xyz, label, n_pad=n_pad, device="cpu")
    assert timer.summary()["upload.pinned"]["count"] == 0
    assert cloud.layout == "raw" and cloud.device.type == "cpu"
    for name, ref in want.items():
        got = getattr(cloud, name).numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        assert got.tobytes() == ref.tobytes(), name
        for mine in (xyz, label):
            assert mine is None or not np.shares_memory(got, mine), name
