"""Per-class nearest neighbour with winner attributes: plain and kernel K2.

Port of the parts of `semicp/corr/pallas_nn2.py` on the main path.

* `prepare_sparse` packs a class-major Morton sorted target into the
  (16, N) attribute slab (x, y, z | cov6 | 1 | |t|^2 | label | 4 spare)
  with per-tile AABBs and class ranges, once per align; for K2 also the
  packed points (N, 4) and the boxes of the target tiles and of the
  32-point chunks (corr/layout.py `pack_boxes`).
* `class_nn_attrs_plain` is the dense contract (the JAX package's
  `class_nn_attrs_xla`): exact per-class NN over all targets, then a
  gather of the winner's rows. It is the CPU path and K2's reference.
* `class_nn_attrs_sparse` launches K2 (csrc/nn_sparse.cu), which culls
  target chunks per query warp on the device.
* `walk_args` checks and gathers the arguments of K2's walk, which the
  fused E-step (K6, register/fused.py) runs too, with its scratch.
* `nn_walked_chunks` is the plain mirror of the walk's culling: the
  (query warp, target chunk) pairs K2 and K6 walk. The CPU tests walk them
  to show the culling exact; `chip_smoke.py` checks the kernels' counts.
* `pack_key` is the walk's 64-bit merge key as int64.

Contract of both, per query and class k: d2 (K, Q), INF where the class
has no candidate, and attrs (K, 16, Q) with the winner's x, y, z, cov6,
found = 1.0 in row 9 and zeros in rows 10-15. Within the gate the two
agree; beyond it the kernel may report INF (the E-step gates there).
Exact ties take the lowest target index in both. A target labelled past
the classes (label >= K) is no target of any class.
"""

from __future__ import annotations

import torch

from semicp_torch import kernels
from semicp_torch.corr.bruteforce import INF, class_nn
from semicp_torch.corr.layout import (
    CHUNK,
    LAYOUT_CM,
    box_gap2,
    cull_chunks,
    limit2,
    pack_boxes,
    sort_cloud_cm,
    tile_meta,
)
from semicp_torch.corr.morton import tile_aabbs

TB = 1024    # target tile: at most 32 chunks, one item of the walk
NATTR = 16   # attribute rows (x, y, z | cov6 | 1 | |t|^2 | label | 4 spare)


def prepare_sparse(cloud, num_classes: int, cell: float) -> dict:
    """Loop-invariant prep of a target cloud (sorted to cm layout if raw)."""
    if cloud.layout != LAYOUT_CM:
        cloud = sort_cloud_cm(cloud, num_classes, cell)
    n = cloud.n_pad
    tb = min(TB, n)
    if n % tb:
        raise ValueError(f"prepare_sparse: N={n} must be a multiple of the target "
                         f"tile tb={tb} (pad the cloud to a power of two >= {tb})")
    # a valid point whose label lies past the classes is no target, as in
    # the plain version: it stays out of every box and class range, so the
    # kernels' per-class slots (K of them) are never indexed past K
    lab = torch.clamp(cloud.label, min=0)
    valid = cloud.valid & (lab < num_classes)
    label_s = torch.where(valid, lab, torch.full_like(lab, num_classes)).to(torch.int32)
    ones = torch.ones((1, n), dtype=torch.float32, device=cloud.device)
    t2 = torch.sum(cloud.xyz * cloud.xyz, dim=0, keepdim=True)
    pad = torch.zeros((NATTR - 12, n), dtype=torch.float32, device=cloud.device)
    attrs16 = torch.cat([cloud.xyz, cloud.cov6, ones, t2,
                         label_s[None].to(torch.float32), pad], dim=0).contiguous()
    meta = tile_meta(cloud.xyz, label_s, valid, num_classes, tb)
    chunks = tile_meta(cloud.xyz, label_s, valid, num_classes, CHUNK)
    w = torch.where(valid, t2[0], torch.full_like(t2[0], float("inf")))
    pts4 = torch.cat([cloud.xyz, w[None]], dim=0).T.contiguous()
    return {"xyz_s": cloud.xyz, "label_s": label_s, "attrs16": attrs16, **meta,
            "pts4": pts4, "tile_box": pack_boxes(meta), "chunk_box": pack_boxes(chunks)}


def class_nn_attrs_plain(tgt_xyz, tgt_label, tgt_valid, tgt_cov6, q_xyz, num_classes: int):
    """Dense per-class NN + winner attribute gather (the plain contract)."""
    idx, d2 = class_nn(tgt_xyz, torch.clamp(tgt_label, min=0), tgt_valid, q_xyz, num_classes)
    n = tgt_xyz.shape[1]
    rows = torch.cat([tgt_xyz, tgt_cov6,
                      torch.ones((1, n), dtype=tgt_xyz.dtype, device=tgt_xyz.device)])
    win = rows[:, idx].movedim(0, 1)                           # (K, 10, Q)
    win = torch.where((d2 < INF)[:, None, :], win, torch.zeros_like(win))
    spare = torch.zeros((num_classes, NATTR - 10, q_xyz.shape[1]),
                        dtype=win.dtype, device=win.device)
    return d2, torch.cat([win, spare], dim=1)


def class_nn_attrs_sparse(prep: dict, q_xyz, q_valid, num_classes: int, gate):
    """Block-sparse per-class NN over a prepared target (K2 on CUDA).

    A CPU tensor takes `class_nn_attrs_plain` on the prepared target;
    a CUDA tensor launches K2. `gate` may be a float or a 0-dim tensor.
    Queries should be cm-sorted so query warps are compact (that is what
    makes the culling bite); exactness does not depend on it.
    """
    if not q_xyz.is_cuda:
        label_s = prep["label_s"]
        return class_nn_attrs_plain(prep["xyz_s"], label_s, label_s < num_classes,
                                    prep["attrs16"][3:9], q_xyz, num_classes)
    dev = q_xyz.device
    n, q = prep["xyz_s"].shape[1], q_xyz.shape[1]
    args, tb = walk_args(prep, q_xyz, q_valid, num_classes, gate, "class_nn_attrs_sparse")
    args.update(
        out_d2=torch.empty((num_classes, q), dtype=torch.float32, device=dev),
        out_attr=torch.empty((num_classes, NATTR, q), dtype=torch.float32, device=dev))
    p = {k: v.data_ptr() for k, v in args.items()}
    # one entry: the item list, the walk and the gather
    kernels.launch("semicp_nn_sparse", "nn_sparse", dev,
                   p["pts4"], p["label_s"], p["attrs16"], p["tile_box"], p["chunk_box"],
                   p["q_xyz"], p["q_valid"], p["gate"], n, q, tb, num_classes,
                   p["keys"], p["items"], p["wbox"], p["counters"], p["out_d2"], p["out_attr"])
    kernels.WALKED["nn_sparse"] = args["counters"][2:]
    return args["out_d2"], args["out_attr"]


def walk_args(prep: dict, q_xyz, q_valid, num_classes: int, gate, who: str):
    """The walk's arguments on the device, checked: the prepared target,
    the queries and the gate, and its scratch (keys (K, Q) int64, items,
    wbox, counters), which the C entry clears itself. Applies the walk's
    shape rules. Returns (args, tb)."""
    dev = q_xyz.device
    n, q = prep["xyz_s"].shape[1], q_xyz.shape[1]
    n_tt = prep["tile_box"].shape[0]
    tb = n // n_tt
    if q % CHUNK:
        raise ValueError(f"{who}: Q={q} must be a multiple of the query warp {CHUNK} "
                         f"(pad queries to a power of two >= {CHUNK})")
    if tb % CHUNK or tb > CHUNK * CHUNK or n % tb:
        raise ValueError(f"{who}: target tile tb={tb} must be a multiple of {CHUNK}, "
                         f"at most {CHUNK * CHUNK}, and divide N={n}")
    args = {"pts4": prep["pts4"], "label_s": prep["label_s"], "attrs16": prep["attrs16"],
            "tile_box": prep["tile_box"], "chunk_box": prep["chunk_box"],
            "q_xyz": q_xyz.contiguous(), "q_valid": q_valid,
            "gate": kernels.device_scalar(gate, torch.float32, dev)}
    shapes = {"pts4": (torch.float32, (n, 4)), "label_s": (torch.int32, (n,)),
              "attrs16": (torch.float32, (NATTR, n)), "tile_box": (torch.float32, (n_tt, 8)),
              "chunk_box": (torch.float32, (n // CHUNK, 8)),
              "q_xyz": (torch.float32, (3, q)), "q_valid": (torch.bool, (q,))}
    for name, (dtype, shape) in shapes.items():
        kernels.check(args[name], name, dtype, shape)
    nw = q // CHUNK
    args.update(
        keys=torch.empty((num_classes, q), dtype=torch.int64, device=dev),
        items=torch.empty((nw * n_tt,), dtype=torch.int32, device=dev),
        wbox=torch.empty((nw, 8), dtype=torch.float32, device=dev),
        counters=torch.empty((3,), dtype=torch.int64, device=dev))
    return args, tb


def nn_walked_chunks(prep: dict, q_xyz, q_valid, gate):
    """The (query warp, target chunk) pairs K2 and K6 walk, as a (Q/32, N/32)
    bool matrix: the chunk's tile lies within the gate of the warp's box
    (an item), and the chunk within it of the warp's box and of one of
    its valid queries. The plain mirror of the culling of csrc/nn_walk.cuh,
    in its float32 arithmetic; it syncs, so it is for tests and
    measurement."""
    n, q = prep["xyz_s"].shape[1], q_xyz.shape[1]
    n_tt = prep["tile_box"].shape[0]
    per_tile = n // n_tt // CHUNK
    lim = limit2(kernels.device_scalar(gate, torch.float32, q_xyz.device)[0])
    wlo, whi = tile_aabbs(q_xyz, q_valid, CHUNK)
    tbox = prep["tile_box"]
    items = box_gap2(wlo[:, None], whi[:, None], tbox[None, :, 0:3], tbox[None, :, 4:7]) <= lim
    coarse = items.repeat_interleave(per_tile, dim=1)            # (n_w, n_c)
    pairs = torch.nonzero(coarse, as_tuple=True)
    pts = q_xyz.T.reshape(q // CHUNK, CHUNK, 3)
    walked = torch.zeros_like(coarse)
    walked[pairs] = cull_chunks(prep["chunk_box"], wlo, whi, pts,
                                q_valid.reshape(-1, CHUNK), lim, pairs)
    return walked


def pack_key(d2, idx):
    """The 64-bit key of the walk's atomicMin merge (csrc/common.cuh `pack_key`)
    as an int64 tensor whose order, read as unsigned, is that of (d2, idx):
    the order-preserving bits of the float32 d2 (-0 taken as +0) above
    the index. Reference for the tests; the kernel builds its own."""
    u = (d2.to(torch.float32) + 0.0).contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    e = torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)
    # the unsigned key e * 2^32 + idx less 2^63, so that int64 order is its order
    return (e - (1 << 31)) * (1 << 32) + idx.to(torch.int64)

