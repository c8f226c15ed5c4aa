"""Canonical cloud layout: class-major + Morton-within-class sort.

Port of `semicp/corr/layout.py`. Sorting points by (class, Morton code),
invalid last, makes every fixed-size tile of the array cover a compact
region of (usually) one class, so per-tile AABBs and class ranges prune
whole tiles for the neighbourhood-moments and nearest-neighbour kernels.
The sort happens once per cloud at preprocess time and is recorded in
`Cloud.layout == "cm"`.

The JAX package sorts with a two-key `lax.sort` because a TPU has no
int64. Here one stable sort on the int64 key `(cls << 31) | code` gives
exactly the same permutation: the code occupies bits 0-30 (the invalid
sentinel is bit 30), so shifting the class by 31 keeps the keys ordered
lexicographically, and a stable sort breaks full-key ties by index as
the stable two-key sort does.
"""

from __future__ import annotations

import torch

from semicp_torch.cloud.cloud import Cloud
from semicp_torch.corr.morton import box_dist2, morton_codes, tile_aabbs

LAYOUT_CM = "cm"  # class-major, Morton-within-class, invalid last


def class_morton_order(xyz, label, valid, num_classes: int, cell: float):
    """Permutation sorting by (class, Morton), invalid last (class = K)."""
    code = morton_codes(xyz, valid, cell)
    cls = torch.where(valid, torch.clamp(label, min=0), torch.full_like(label, num_classes))
    key = (cls.to(torch.int64) << 31) | code.to(torch.int64)
    return torch.sort(key, stable=True).indices


def radius_cell_key(xyz, label, valid, num_buckets: int, cell):
    """(N,) int64 keys of K5's internal order (cloud/moments.py
    `raw_order`): `class_morton_order`'s key with the label clamped into
    num_buckets + 1 buckets (min(max(label, 0), num_buckets);
    num_buckets + 1 where invalid) and the Morton cell a 0-dim tensor, the
    neighbourhood radius on the device. Kernel `moments_raw_key_kernel`
    (csrc/moments_raw.cu) computes the same bits."""
    code = morton_codes(xyz, valid, cell).to(torch.int64)
    bucket = torch.where(valid, torch.clamp(label.to(torch.int64), 0, num_buckets),
                         num_buckets + 1)
    return (bucket << 31) | code


def sort_cloud_cm(cloud: Cloud, num_classes: int, cell: float) -> Cloud:
    """Return the cloud in canonical class-major Morton order."""
    order = class_morton_order(cloud.xyz, cloud.label, cloud.valid, num_classes, cell)
    return cloud.replace(
        xyz=cloud.xyz[:, order],
        label=cloud.label[order],
        cov6=cloud.cov6[:, order],
        valid=cloud.valid[order],
        layout=LAYOUT_CM,
    )


def tile_meta(xyz, label, valid, num_classes: int, tile: int) -> dict:
    """Per-tile metadata over a cm-sorted cloud.

    lo/hi (n_t, 3) exact AABBs over valid points and cmin/cmax (n_t,)
    int32 class ranges (cmin > cmax for all-invalid tiles).
    """
    n = xyz.shape[1]
    if n % tile:
        raise ValueError(f"tile_meta: N={n} must be a multiple of the tile size {tile}")
    lo, hi = tile_aabbs(xyz, valid, tile)
    lab = torch.where(valid, torch.clamp(label, min=0), torch.full_like(label, -1)).reshape(-1, tile)
    cmax = torch.amax(lab, dim=1).to(torch.int32)
    cmin = torch.amin(torch.where(lab >= 0, lab, torch.full_like(lab, num_classes)),
                      dim=1).to(torch.int32)
    return {"lo": lo, "hi": hi, "cmin": cmin, "cmax": cmax}


CHUNK = 32  # points of a chunk: one warp's width (csrc/common.cuh kChunk)


def pack_boxes(meta: dict):
    """(n_t, 8) float32 boxes of `tile_meta`: lo.x, lo.y, lo.z, cmin,
    hi.x, hi.y, hi.z, cmax, the layout the walks of K1 and K2 read as two
    float4s. An all-invalid tile keeps lo = +inf, hi = -inf, cmin > cmax."""
    f32 = torch.float32
    return torch.cat([meta["lo"], meta["cmin"][:, None].to(f32),
                      meta["hi"], meta["cmax"][:, None].to(f32)], dim=1).contiguous()


def limit2(g):
    """The squared limit with `tile_candidates`' slack, g^2 (1 + 1e-5) +
    1e-6, rounded in float32 step by step as the kernels round it."""
    g = torch.as_tensor(g, dtype=torch.float32)
    f32 = dict(dtype=torch.float32, device=g.device)
    return g * g * torch.tensor(1.00001, **f32) + torch.tensor(1e-6, **f32)


def box_gap2(alo, ahi, blo, bhi):
    """Squared distance between boxes (..., 3), zero where they overlap,
    in the kernels' order of float32 operations (csrc/common.cuh
    `box_gap2`). A box with lo = +inf, hi = -inf is +inf away from all."""
    d = torch.clamp(torch.maximum(alo - bhi, blo - ahi), min=0.0)
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def cull_chunks(boxes, wlo, whi, pts, active, lim, pairs, lab=None):
    """The chunks a warp walks (csrc/common.cuh `cull_window`): for each
    (warp, chunk) of `pairs` (two index vectors), the chunk's box must lie
    within `lim` of the warp's box and of one active lane's point. With
    `lab`, the moments' class test too: the ranges overlap, and the
    lane's label lies in the chunk's. pts (n_w, 32, 3), active and lab
    (n_w, 32). Returns a bool per pair."""
    w, c = pairs
    lo, hi = boxes[c, 0:3], boxes[c, 4:7]
    keep = box_gap2(wlo[w], whi[w], lo, hi) <= lim
    if lab is not None:
        cmin, cmax = boxes[c, 3].to(torch.int32), boxes[c, 7].to(torch.int32)
        wmin, wmax = boxes[w, 3].to(torch.int32), boxes[w, 7].to(torch.int32)
        keep &= (cmin <= wmax) & (wmin <= cmax)
    p = pts[w]                                                   # (m, 32, 3)
    hit = box_gap2(p, p, lo[:, None, :], hi[:, None, :]) <= lim
    hit &= active[w]
    if lab is not None:
        ql = lab[w]
        hit &= (ql >= cmin[:, None]) & (ql <= cmax[:, None])
    return keep & torch.any(hit, dim=1)


def tile_candidates(qlo, qhi, tlo, thi, gate, q_range=None, t_range=None):
    """Per-query-tile candidate target-tile lists under a distance gate.

    box_dist2 lower-bounds every point-pair distance between two tiles,
    so a tile beyond the gate holds no correspondence the caller would
    accept. `gate` may be a float or a 0-dim tensor (no host sync).
    q_range/t_range: optional (cmin, cmax) pairs; tiles whose class
    ranges do not overlap the query tile's are pruned as well.

    Candidates are ordered nearest-box-first (stable on ties), and the
    lists are uncapped. Returns (cand (n_qt, n_tt) int32 — real
    candidates first, the tail repeating the last real one — and
    count (n_qt,) int32).
    """
    bd2 = box_dist2(qlo, qhi, tlo, thi)                      # (n_qt, n_tt)
    gate2 = gate * gate * (1.0 + 1e-5) + 1e-6
    mask = bd2 <= gate2
    if q_range is not None and t_range is not None:
        qmin, qmax = q_range
        tmin, tmax = t_range
        mask = mask & (qmin[:, None] <= tmax[None, :]) & (tmin[None, :] <= qmax[:, None])
    count = torch.sum(mask, dim=1).to(torch.int32)
    key = torch.where(mask, bd2, torch.full_like(bd2, float("inf")))
    order = torch.argsort(key, dim=1, stable=True).to(torch.int32)
    last = torch.gather(order, 1, torch.clamp(count.long() - 1, min=0)[:, None])
    cols = torch.arange(order.shape[1], dtype=torch.int32, device=order.device)
    cand = torch.where(cols[None, :] < count[:, None], order, last)
    return cand, count
