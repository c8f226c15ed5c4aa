"""Batches of independent scan-pair alignments, on one device or over a mesh.

Port of `semicp/dist/batch.py`. The JAX package maps its EM program over
a batch (vmap within a shard, shard_map over the mesh axis "pairs") and
pads every batch to one size, so that the program never retraces. Here an
align is a host loop over kernel launches with nothing to retrace, so a
batch is the port's align run once a pair, with no padding: a padded pair
would be a wasted align on the card.

Over a mesh (dist/mesh.py) each rank aligns its contiguous share of the
pairs (`Mesh.shard`; the shares may differ by one) and the results are
gathered to every rank in one collective: each rank writes its rows of a
zeroed (B, 57) result block and the block is all-reduced, which copies
each row from its one rank exactly (x + 0 = x). Every process passes the
whole batch, as every process of the JAX package's program holds the
global batch; only the aligns of its share read their clouds.
"""

from __future__ import annotations

import dataclasses

import torch

from semicp_torch.config import Config
from semicp_torch.register.em_icp import AlignResult, make_align_fn

ROW = 57   # a packed AlignResult: T (16), H (36), iterations, converged, cost, n_corr, spare


def pack_results(res: AlignResult) -> torch.Tensor:
    """(B, 57) float32 rows of a batched AlignResult (the iteration count
    and the flag are exact in float32)."""
    b = res.T.shape[0]
    return torch.cat([res.T.reshape(b, 16), res.H.reshape(b, 36),
                      res.iterations.to(torch.float32)[:, None],
                      res.converged.to(torch.float32)[:, None], res.cost[:, None],
                      res.n_corr[:, None], torch.zeros_like(res.cost)[:, None]], dim=1)


def unpack_results(rows: torch.Tensor) -> AlignResult:
    """The batched AlignResult of `pack_results`' rows, as views of them."""
    b = rows.shape[0]
    return AlignResult(T=rows[:, :16].reshape(b, 4, 4), iterations=rows[:, 52].to(torch.int32),
                       converged=rows[:, 53] > 0.5, cost=rows[:, 54], n_corr=rows[:, 55],
                       H=rows[:, 16:52].reshape(b, 6, 6))


def to_host(res: AlignResult) -> AlignResult:
    """A batched AlignResult on the host, in one device-to-host copy."""
    return unpack_results(pack_results(res).cpu())


def batched_align(cfg: Config, mesh=None):
    """Return align_b(src_batch, tgt_batch, T0_batch, gate=None,
    max_iters=None) -> AlignResult with a leading batch dim.

    src_batch and tgt_batch are sequences of preprocessed clouds on one
    device (over a mesh, the rank's device; entries outside the rank's
    share are not read and may be None); T0_batch is (B, 4, 4), a host
    array or a tensor, copied to that device once. `gate` and `max_iters`
    override the config's for every pair, as in `make_align_fn`. Each
    field of the result is the pairs' results stacked on the device,
    equal to the bit to serial `make_align_fn(cfg)` calls; over a mesh
    every rank holds every pair's result.
    """
    align = make_align_fn(cfg)

    def fn(src_batch, tgt_batch, T0_batch, gate=None, max_iters=None) -> AlignResult:
        b = len(src_batch)
        if b != len(tgt_batch) or b != len(T0_batch):
            raise ValueError(f"batched_align: {b} sources, {len(tgt_batch)} targets and "
                             f"{len(T0_batch)} initial poses")
        if not b:
            raise ValueError("batched_align: an empty batch")
        lo, hi = (0, b) if mesh is None else mesh.shard(b)
        dev = mesh.device if mesh is not None else src_batch[0].device
        T0 = torch.as_tensor(T0_batch, dtype=torch.float32, device=dev)
        res = [align(src_batch[i], tgt_batch[i], T0[i], gate=gate, max_iters=max_iters)
               for i in range(lo, hi)]
        if mesh is None:
            return AlignResult(**{f.name: torch.stack([getattr(r, f.name) for r in res])
                                  for f in dataclasses.fields(AlignResult)})
        rows = torch.zeros((b, ROW), dtype=torch.float32, device=dev)
        if res:
            rows[lo:hi] = pack_results(AlignResult(**{
                f.name: torch.stack([getattr(r, f.name) for r in res])
                for f in dataclasses.fields(AlignResult)}))
        return unpack_results(mesh.all_reduce(rows))

    return fn


def shard_batch(mesh, batch: list) -> list:
    """This rank's contiguous share of a batch (a list), the pairs
    `batched_align` over the same mesh aligns here."""
    lo, hi = mesh.shard(len(batch))
    return batch[lo:hi]
