"""Batches of independent scan-pair alignments, on one device.

Port of `semicp/dist/batch.py` for a single device. The JAX package maps
its EM program over a batch (vmap within a shard, shard_map over a mesh
axis) and pads every batch to one size, so that the program never
retraces. Here an align is a host loop over kernel launches with nothing
to retrace, so a batch is the port's align run once a pair, with no
padding: a padded pair would be a wasted align on the card. The mesh
paths (`make_mesh`, `shard_batch`) belong to the port's `dist/` across
devices, still to come.
"""

from __future__ import annotations

import dataclasses

import torch

from semicp_torch.config import Config
from semicp_torch.register.em_icp import AlignResult, make_align_fn


def batched_align(cfg: Config):
    """Return align_b(src_batch, tgt_batch, T0_batch, gate=None,
    max_iters=None) -> AlignResult with a leading batch dim.

    src_batch and tgt_batch are sequences of preprocessed clouds on one
    device; T0_batch is (B, 4, 4), a host array or a tensor, copied to
    that device once. `gate` and `max_iters` override the config's for
    every pair, as in `make_align_fn`. Each field of the result is the
    pairs' results stacked on the device, equal to the bit to serial
    `make_align_fn(cfg)` calls.
    """
    align = make_align_fn(cfg)

    def fn(src_batch, tgt_batch, T0_batch, gate=None, max_iters=None) -> AlignResult:
        if len(src_batch) != len(tgt_batch) or len(src_batch) != len(T0_batch):
            raise ValueError(f"batched_align: {len(src_batch)} sources, {len(tgt_batch)} "
                             f"targets and {len(T0_batch)} initial poses")
        if not len(src_batch):
            raise ValueError("batched_align: an empty batch")
        dev = src_batch[0].device
        T0 = torch.as_tensor(T0_batch, dtype=torch.float32, device=dev)
        res = [align(s, t, T0[b], gate=gate, max_iters=max_iters)
               for b, (s, t) in enumerate(zip(src_batch, tgt_batch))]
        return AlignResult(**{f.name: torch.stack([getattr(r, f.name) for r in res])
                              for f in dataclasses.fields(AlignResult)})

    return fn
