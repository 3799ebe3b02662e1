"""The context of the element-sharded Nekbone solve (the reference's
`distributed.context.SolverShardCtx` and `make_solver_ctx`).

The reference shards over a 1-D JAX device mesh inside `shard_map`.  The
port runs one `torch.distributed` rank per shard, each on its own device:
every rank builds the same partition, keeps its own shard, and the
interface exchange and the PCG dots become collectives of the rank's
process group.  The process group must be initialized before
`make_solver_ctx` (see `distributed.launch.spawn`); without one, or with a
world of one rank, the context collapses to None, the exact single-device
solve.
"""

from __future__ import annotations

import os
import warnings
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.core.mesh_gen import normalize_grid

__all__ = ["SolverShardCtx", "EXCHANGES", "HALO_COMPRESS", "parse_grid_arg",
           "make_solver_ctx"]

EXCHANGES = ("psum", "neighbour")
HALO_COMPRESS = ("bf16", "int8")


class SolverShardCtx(NamedTuple):
    """One rank's view of the element-sharded solve.

    `group` is the process group (the world) whose collectives sum the
    interface dofs and the PCG dots; `rank` is this rank's shard index in
    it and `n_shards` its size.  `device` is where this rank's shard
    lives; `grid` the shard-grid spec of the partition
    (`core.mesh_gen.normalize_grid`: None for 1-D slabs, a (px[, py[,
    pz]]) tuple, or "auto").  The interface exchange is the psum: one
    all-reduce of the interface dofs an operator application.
    """

    group: object
    rank: int
    n_shards: int
    device: torch.device
    grid: object = None


def parse_grid_arg(spec: str):
    """Parse a CLI shard-grid spec: 'slab' -> None (1-D slabs), 'auto'
    -> 'auto', 'PXxPYxPZ' (e.g. '2x2x1', '2x2') -> an explicit tuple."""
    spec = spec.strip().lower()
    if spec in ("", "slab", "none"):
        return None
    if spec == "auto":
        return "auto"
    try:
        return tuple(int(p) for p in spec.split("x"))
    except ValueError:
        raise ValueError(
            f"bad grid spec {spec!r}: expected 'slab', 'auto', or "
            f"per-axis shard counts like '2x2x1'") from None


def _validate_grid_spec(grid, devices: int) -> None:
    """The mesh-independent grid rules (`normalize_grid` with shape=None);
    the extent checks run again at partition time, when the mesh is
    known."""
    normalize_grid(grid, None, devices)


def _rank_device(rank: int, device) -> torch.device:
    """The rank's device: the one the caller names, else
    ``cuda:{local_rank % device_count}``; no card and no device named
    raises rather than falling back to the CPU."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but no CUDA "
                               f"device is available")
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the shards on the CPU")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_solver_ctx(devices: Optional[int] = None, exchange: str = "psum",
                    grid=None, compress: Optional[str] = None, *,
                    device=None) -> Optional[SolverShardCtx]:
    """This rank's `SolverShardCtx` over the world process group.

    `devices` is the shard count the caller expects, None for every rank
    of the world; it must equal the world's size (one rank per shard).
    Without an initialized process group, or with one rank, returns None —
    the exact single-device solve — and warns about a `grid` that then
    cannot apply, as the reference does.  `device` names this rank's
    device (see `_rank_device`).  The neighbour exchange and its halo
    codecs (`exchange="neighbour"`, `compress=`) are not ported yet and
    raise.
    """
    if exchange not in EXCHANGES:
        raise ValueError(f"unknown exchange {exchange!r}; expected one of "
                         f"{EXCHANGES}")
    if compress is not None and compress not in HALO_COMPRESS:
        raise ValueError(f"unknown halo compress {compress!r}; expected "
                         f"None or one of {HALO_COMPRESS}")
    if exchange == "neighbour" or compress is not None:
        raise ValueError(
            f"exchange={exchange!r}, compress={compress!r}: the neighbour "
            f"exchange and its halo codecs are not ported yet; the port "
            f"runs exchange='psum' (one all-reduce of the interface dofs)")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if devices is not None and devices != world:
        raise ValueError(
            f"requested {devices} shards but the process group has {world} "
            f"rank(s): start one rank per shard (e.g. with "
            f"repro_torch.distributed.launch.spawn)")
    if world <= 1:
        if grid is not None:
            warnings.warn(
                f"make_solver_ctx: single-device context runs the exact "
                f"unsharded solve — grid={grid!r} cannot apply and will be "
                f"ignored (start more than one rank to shard)",
                UserWarning, stacklevel=2)
        return None
    _validate_grid_spec(grid, world)
    rank = dist.get_rank()
    return SolverShardCtx(dist.group.WORLD, rank, world,
                          _rank_device(rank, device), grid)
