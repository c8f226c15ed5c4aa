"""The process group the distributed paths run over: the port's mesh.

Port of `semicp/dist/mesh.py`. The JAX package names a device mesh and
lets XLA run its collectives (psum, all_gather, ppermute). Here one
process drives one device, and the mesh is the world of a
`torch.distributed` process group: NCCL between cards, gloo between CPU
processes.

* `init_distributed` joins or makes the default group. Under torchrun
  (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) it joins the
  job's group; given `init_method`, `rank` and `world_size` it joins that
  one; with neither it makes a group of one process over a local TCP
  store (127.0.0.1, a free port), so that a run on one card still takes
  the distributed path through real collectives. Every group gets a
  timeout: no rank waits on a lost peer forever.
* `make_mesh` returns a `Mesh`: the group's rank and world, the backend
  and this process's device (`cuda:LOCAL_RANK`, or the CPU when asked).
  The JAX mesh's one named axis ("pairs" for batches, "blocks" for the
  ring and the BA) is the world here, whichever the caller means.

NCCL refuses two ranks on one card, so on a machine with one card the
world is 1; worlds of 2 and more run on the CPU over gloo in the tests.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 600.0


@dataclass(frozen=True)
class Mesh:
    """One process's view of the group: its rank in a world of `world`
    processes, the collective backend, and the device it computes on."""

    rank: int
    world: int
    device: torch.device
    backend: str

    def shard(self, n: int) -> tuple[int, int]:
        """[lo, hi) of this rank's contiguous share of n items (the first
        n % world ranks take one more)."""
        return shard_bounds(n, self.world, self.rank)

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """All-reduce t in place over the world (queued on the device's
        stream under NCCL, no host wait) and return it."""
        dist.all_reduce(t, op=op)
        return t

    def agree(self, a: np.ndarray) -> np.ndarray:
        """Host array a as rank 0 holds it, on every rank. Host decisions
        that follow from device work whose sums may differ between cards
        (index_add_'s float atomics in the pose graph) are taken from one
        rank, so that every rank takes the same branches and the same
        collectives. A world of one returns a as it is."""
        if self.world == 1:
            return a
        t = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        dist.broadcast(t, src=0)
        return t.cpu().numpy()


def shard_bounds(n: int, world: int, rank: int) -> tuple[int, int]:
    """[lo, hi) of rank's contiguous share of n items over world ranks."""
    base, extra = divmod(n, world)
    lo = rank * base + min(rank, extra)
    return lo, lo + base + (rank < extra)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(backend: str, init_method: str | None = None, rank: int | None = None,
                     world_size: int | None = None, timeout_s: float = TIMEOUT_S) -> None:
    """Join the default process group unless this process is in one.

    backend: "nccl" for CUDA devices, "gloo" for the CPU. With
    init_method (e.g. "tcp://127.0.0.1:<port>"), rank and world_size,
    join that group; else under torchrun's environment, join the job's;
    else make a group of one over a local TCP store.
    """
    if dist.is_initialized():
        return
    timeout = datetime.timedelta(seconds=timeout_s)
    if init_method is not None:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, timeout=timeout)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    else:
        store = dist.TCPStore("127.0.0.1", _free_port(), 1, True, timeout=timeout)
        dist.init_process_group(backend, store=store, rank=0, world_size=1, timeout=timeout)


def make_mesh(device="cuda") -> Mesh:
    """The mesh of this process: initialises the default group where
    needed (NCCL for a CUDA device, gloo for the CPU) and binds a CUDA
    device without an index to `cuda:LOCAL_RANK`. Raises for CUDA without
    a card: nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device (torch.cuda.is_available() is "
                               "false); pass device='cpu' to run over gloo on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    init_distributed("nccl" if dev.type == "cuda" else "gloo")
    backend = dist.get_backend()
    if (backend == "nccl") != (dev.type == "cuda"):
        raise RuntimeError(f"make_mesh: the process group runs {backend}, which cannot "
                           f"reduce tensors on {dev}")
    return Mesh(rank=dist.get_rank(), world=dist.get_world_size(), device=dev,
                backend=backend)
