"""Start N local ranks and run one function on each (the port's stand-in
for the reference's simulated host devices).

`spawn(fn, n, args)` starts `n` processes with `torch.multiprocessing`
(the spawn start method), joins them into one process group through a
`FileStore` in a temporary directory, calls ``fn(rank, n, *args)`` on
every rank and returns the values, rank by rank.  `fn` and `args` are
pickled: `fn` must be a module-level function the children can import.
The group's timeout bounds every collective, so a rank that dies makes
the others fail instead of waiting; `torch.multiprocessing.spawn` then
stops every rank and raises in the caller.
"""

from __future__ import annotations

import os
import tempfile
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["spawn"]


def _rank_main(rank: int, world: int, tmp: str, backend: str,
               timeout_s: float, fn, args) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    store = dist.FileStore(str(Path(tmp) / "store"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    try:
        out = fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, Path(tmp) / f"rank{rank}.pt")


def spawn(fn, nprocs: int, args: tuple = (), backend: str = "gloo",
          timeout_s: float = 120.0) -> list:
    """Run ``fn(rank, nprocs, *args)`` on `nprocs` local ranks of one
    process group (`backend` "gloo" or "nccl") and return each rank's
    value, in rank order.  Raises when a rank raises or dies."""
    if nprocs < 1:
        raise ValueError(f"nprocs must be >= 1, got {nprocs}")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks.") as tmp:
        mp.spawn(_rank_main, args=(nprocs, tmp, backend, timeout_s, fn,
                                   args), nprocs=nprocs, join=True)
        # the values were pickled by this program's own ranks
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(nprocs)]
