"""Masked neighbourhood moments: the plain version and kernel K1.

Port of `semicp/cloud/pallas_cov.py`. For every point, the ten moments
n, Sx, Sy, Sz, Sxx, Syy, Szz, Sxy, Sxz, Syz of its neighbourhood
(same class, d^2 < r^2, valid; self-inclusive), from which the
covariance follows in cloud/covariance.py's epilogue.

* `moments_plain` is the dense masked version (the JAX package's
  `neighborhood_moments_xla`), chunked over queries: raw, uncentred
  moments. It is the CPU path and the kernel's reference.
* `neighborhood_moments_sparse` launches K1 (csrc/moments.cu) over a
  class-major Morton sorted cloud: each 32-point chunk's warp walks the
  same-class chunks its culling keeps within the radius. Its moments are
  centred on each query point: equal covariances through the epilogue,
  not equal raw moments. Labels past the classes (>= K) keep the plain
  version's meaning: equal labels are neighbours.
* `moments_walked_chunks` is the plain mirror of K1's culling, the
  (query chunk, target chunk) pairs it walks, for the tests and for
  `chip_smoke.py`'s check of the kernel's count.
* `neighborhood_moments_dense` is the raw-layout path (a bare CovConfig,
  or class_aware=False): plain on the CPU, kernel K5 (csrc/moments_raw.cu)
  on CUDA, which runs K1's walk on an internal order of the cloud
  (`raw_order`) and stores each query's moments to its raw column. Like
  K1's, its moments are centred on each query point.
* `raw_walk_inputs` and `moments_raw_walked_chunks` are the plain mirror of
  K5's internal order and culling, for the tests and `chip_smoke.py`.
"""

from __future__ import annotations

import torch

from semicp_torch import kernels
from semicp_torch.corr.layout import (
    CHUNK,
    cull_chunks,
    limit2,
    pack_boxes,
    radius_cell_key,
    tile_meta,
)

NMOM = 10
# K5's culling buckets: labels 0..RAW_BUCKETS-1 each have one, every label
# past them shares bucket RAW_BUCKETS (its pair test still compares labels)
RAW_BUCKETS = 32


def moments_plain(xyz, label, valid, radius, qb: int = 512):
    """(10, N) raw masked neighbourhood moments, dense over all pairs."""
    n = xyz.shape[1]
    tx, ty, tz = xyz[0], xyz[1], xyz[2]
    t2 = tx * tx + ty * ty + tz * tz
    lab = torch.where(valid, label, torch.full_like(label, -1))
    # invalid queries get -2 so they never match anything
    qlab = torch.where(valid, label, torch.full_like(label, -2))
    r2 = kernels.device_scalar(radius, xyz.dtype, xyz.device)[0] ** 2
    feats = torch.stack([torch.ones_like(tx), tx, ty, tz, tx * tx, ty * ty, tz * tz,
                         tx * ty, tx * tz, ty * tz])              # (10, N)
    out = torch.empty((NMOM, n), dtype=xyz.dtype, device=xyz.device)
    for s in range(0, n, qb):
        e = min(s + qb, n)
        d2 = (t2[s:e, None] + t2[None, :]
              - 2.0 * (tx[s:e, None] * tx[None, :] + ty[s:e, None] * ty[None, :]
                       + tz[s:e, None] * tz[None, :]))
        w = ((d2 < r2) & (qlab[s:e, None] == lab[None, :])).to(xyz.dtype)
        out[:, s:e] = feats @ w.T
    return out


def _walk_moments(xyz, label, valid, radius, num_classes: int, perm=None):
    """Launch the moments walk (csrc/moments_walk.cuh) on CUDA tensors: K1
    over the cloud as it lies (perm None), K5 over the internal order
    `perm` ((N,) int64 raw indices), padded inside the kernels to a whole
    number of chunks. Returns (10, N) query-centred moments in the
    caller's order and leaves the walked chunks in `kernels.WALKED`."""
    dev = xyz.device
    n_raw = xyz.shape[1]
    n = n_raw if perm is None else -(-n_raw // CHUNK) * CHUNK
    if n % CHUNK:
        raise ValueError(f"moments_sparse: N={n} must be a multiple of the chunk {CHUNK}")
    nc = n // CHUNK
    xyz, label, valid = xyz.contiguous(), label.to(torch.int32).contiguous(), valid.contiguous()
    kernels.check(xyz, "xyz", torch.float32, (3, n_raw))
    kernels.check(label, "label", torch.int32, (n_raw,))
    kernels.check(valid, "valid", torch.bool, (n_raw,))
    rad = kernels.device_scalar(radius, torch.float32, dev)

    def empty(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    pts4, box, span = empty((n, 4), torch.float32), empty((nc, 8), torch.float32), empty((nc, 2))
    tiles = empty(((nc + CHUNK - 1) // CHUNK, 8), torch.float32)     # boxes of 32 chunks
    count = empty((nc,))
    scratch = empty((2 * (num_classes + 1),))
    out = empty((NMOM, n_raw), torch.float32)
    meta = (pts4.data_ptr(), box.data_ptr(), tiles.data_ptr(), span.data_ptr())
    # the metadata and cost pass (not counted), then the walk, heaviest warps first
    if perm is None:
        kernels.launch("semicp_moments_cost", None, dev, xyz.data_ptr(), label.data_ptr(),
                       valid.data_ptr(), rad.data_ptr(), n, num_classes, *meta,
                       scratch.data_ptr(), count.data_ptr())
        order = torch.argsort(count, descending=True).to(torch.int32)
        kernels.launch("semicp_moments_sparse", "moments_sparse", dev, *meta, order.data_ptr(),
                       rad.data_ptr(), n, num_classes, empty((1,)).data_ptr(), out.data_ptr())
        kernels.WALKED["moments_sparse"] = count
        return out
    kernels.check(perm, "perm", torch.int64, (n_raw,))
    kernels.launch("semicp_moments_raw_cost", None, dev, xyz.data_ptr(), label.data_ptr(),
                   valid.data_ptr(), perm.data_ptr(), rad.data_ptr(), n, n_raw, num_classes,
                   *meta, scratch.data_ptr(), count.data_ptr())
    order = torch.argsort(count, descending=True).to(torch.int32)
    kernels.launch("semicp_moments_raw", "moments_dense", dev, *meta, order.data_ptr(),
                   perm.data_ptr(), rad.data_ptr(), n, n_raw, num_classes,
                   empty((1,)).data_ptr(), out.data_ptr())
    kernels.WALKED["moments_dense"] = count
    return out


def neighborhood_moments_sparse(xyz, label, valid, radius, num_classes: int):
    """(10, N) query-centred masked moments over a cm-sorted cloud (K1).

    A CPU tensor takes `moments_plain`; a CUDA tensor launches K1.
    `radius` may be a float or a 0-dim tensor (it stays on the device).
    """
    if not xyz.is_cuda:
        return moments_plain(xyz, label, valid, radius)
    return _walk_moments(xyz, label, valid, radius, num_classes)


def chunk_inputs(xyz, label, valid, num_classes: int) -> dict:
    """K1's per-call metadata in plain torch, as its kernels build it on the
    device: the packed points (N, 4) (x, y, z, the label's int32 bits, -1
    where invalid), each point's bucket (min(label, K), -1 where invalid:
    every label past the classes shares bucket K), the chunk boxes (N/32, 8)
    with bucket ranges, and each chunk's span, the first and last chunk
    holding a bucket of its range (first > last for an empty chunk). The
    span is exact in any layout; the class-major one makes it short."""
    n = xyz.shape[1]
    if n % CHUNK:
        raise ValueError(f"moments_sparse: N={n} must be a multiple of the chunk {CHUNK}")
    nc, nb = n // CHUNK, num_classes + 1
    label = torch.clamp(label.to(torch.int32), min=0)        # as tile_meta reads it
    lab = torch.where(valid, label, torch.full_like(label, -1))
    bucket = torch.where(valid, torch.clamp(label, max=num_classes), torch.full_like(label, -1))
    meta = tile_meta(xyz, bucket, valid, nb, CHUNK)          # an empty chunk: cmin = K + 1
    pts4 = torch.cat([xyz, lab.view(torch.float32)[None]], dim=0).T.contiguous()
    chunk = torch.arange(n, device=xyz.device) // CHUNK
    slot = torch.where(valid, bucket, torch.full_like(bucket, nb)).long()
    first = torch.full((nb + 1,), nc, dtype=torch.int64, device=xyz.device)
    first = first.scatter_reduce(0, slot, chunk, "amin")[:nb]
    last = torch.full((nb + 1,), -1, dtype=torch.int64, device=xyz.device)
    last = last.scatter_reduce(0, slot, chunk, "amax")[:nb]
    ks = torch.arange(nb, device=xyz.device)
    inr = (ks[None] >= meta["cmin"][:, None]) & (ks[None] <= meta["cmax"][:, None])
    span = torch.stack([torch.where(inr, first[None], nc).amin(dim=1),
                        torch.where(inr, last[None], -1).amax(dim=1)], dim=1)
    return {"pts4": pts4, "bucket": bucket, "chunk_box": pack_boxes(meta),
            "span": span.to(torch.int32).contiguous()}


def moments_walked_chunks(xyz, label, valid, radius, num_classes: int):
    """The (query chunk, target chunk) pairs K1 walks, as an (N/32, N/32)
    bool matrix: within each chunk's span, the boxes within the radius
    with overlapping bucket ranges, and then within it of a valid query
    whose bucket lies in the target chunk's range. The plain mirror of
    csrc/moments.cu's culling, in its float32 arithmetic; it syncs."""
    a = chunk_inputs(xyz, label, valid, num_classes)
    nc = a["span"].shape[0]
    lim = limit2(kernels.device_scalar(radius, torch.float32, xyz.device)[0])
    cols = torch.arange(nc, device=xyz.device)
    span = a["span"].long()
    coarse = (cols[None] >= span[:, 0:1]) & (cols[None] <= span[:, 1:2])
    pairs = torch.nonzero(coarse, as_tuple=True)
    box, pts4 = a["chunk_box"], a["pts4"]
    bucket = a["bucket"].reshape(nc, CHUNK)
    walked = torch.zeros_like(coarse)
    walked[pairs] = cull_chunks(box, box[:, 0:3], box[:, 4:7], pts4[:, :3].reshape(nc, CHUNK, 3),
                                bucket >= 0, lim, pairs, lab=bucket)
    return walked


def raw_order(xyz, label, valid, radius):
    """K5's internal order of a cloud in any layout, for one call: the
    (N,) int64 permutation that sorts `corr/layout.py radius_cell_key` at a
    cell of one radius (stable). Its key is that function on a CPU tensor
    and kernel `moments_raw_key_kernel` on CUDA; then one sort on the
    device, no host sync."""
    n = xyz.shape[1]
    cell = torch.clamp(kernels.device_scalar(radius, torch.float32, xyz.device)[0], min=1e-6)
    if not xyz.is_cuda:
        key = radius_cell_key(xyz, label, valid, RAW_BUCKETS, cell)
    else:
        xyz, label, valid = xyz.contiguous(), label.to(torch.int32).contiguous(), valid.contiguous()
        kernels.check(xyz, "xyz", torch.float32, (3, n))
        kernels.check(label, "label", torch.int32, (n,))
        kernels.check(valid, "valid", torch.bool, (n,))
        key = torch.empty((n,), dtype=torch.int64, device=xyz.device)
        lo = torch.empty((3,), dtype=torch.int32, device=xyz.device)
        kernels.launch("semicp_moments_raw_key", None, xyz.device, xyz.data_ptr(),
                       label.data_ptr(), valid.data_ptr(), cell.data_ptr(), n, RAW_BUCKETS,
                       lo.data_ptr(), key.data_ptr())
    return torch.sort(key, stable=True).indices


def raw_walk_inputs(xyz, label, valid, radius):
    """The cloud as K5's walk reads it: (perm, xyz, label, valid) in
    `raw_order`, padded to whole chunks with invalid points (index -1,
    zero coordinates, label -1)."""
    perm = raw_order(xyz, label, valid, radius)
    perm = torch.cat([perm, perm.new_full((-perm.shape[0] % CHUNK,), -1)])
    inside = perm >= 0
    idx = torch.clamp(perm, min=0)
    return (perm, torch.where(inside, xyz[:, idx], 0.0),
            torch.where(inside, label.to(torch.int32)[idx], -1), inside & valid[idx])


def moments_raw_walked_chunks(xyz, label, valid, radius):
    """The (query chunk, target chunk) pairs K5 walks: K1's culling
    (`moments_walked_chunks`) over `raw_walk_inputs`. It syncs."""
    _, xyz_s, label_s, valid_s = raw_walk_inputs(xyz, label, valid, radius)
    return moments_walked_chunks(xyz_s, label_s, valid_s, radius, RAW_BUCKETS)


def neighborhood_moments_dense(xyz, label, valid, radius):
    """(10, N) masked moments of a cloud in any layout (K5).

    A CPU tensor takes `moments_plain` (raw moments); a CUDA tensor
    launches K5 (query-centred moments, equal covariances through the
    epilogue; a negative label reads as 0, as in K1). `radius` may be a
    float or a 0-dim tensor (it stays on the device).
    """
    if not xyz.is_cuda:
        return moments_plain(xyz, label, valid, radius)
    rad = kernels.device_scalar(radius, torch.float32, xyz.device)
    return _walk_moments(xyz, label, valid, rad, RAW_BUCKETS, raw_order(xyz, label, valid, rad))


def neighborhood_moments_auto(xyz, label, valid, radius, num_classes=None,
                              layout: str = "raw"):
    """Dispatch on the layout: the sparse walk (K1) for a cm-sorted cloud,
    the dense moments (K5) otherwise. Each picks its CPU or CUDA path."""
    if layout == "cm" and num_classes is not None:
        return neighborhood_moments_sparse(xyz, label, valid, radius, num_classes)
    return neighborhood_moments_dense(xyz, label, valid, radius)
