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

The wire: the psum exchange is one `all_reduce` of the interface dofs,
which gloo takes on CUDA tensors (through the host) and NCCL on the card.
The neighbour exchange is `batch_isend_irecv` rounds with the shards a
shard borders (`core.gather_scatter.neighbour_start`): NCCL sends device
buffers on its own stream; gloo's point-to-point ops take CPU tensors
only, so on a card each round's buffers are staged through pinned host
memory (the "gloo, host-staged" wire), and on the CPU they go as they are.
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
    pz]]) tuple, or "auto").  `exchange` is the interface exchange:
    "psum", one all-reduce of the interface dofs an operator application,
    or "neighbour", point-to-point rounds with the bordering shards whose
    start comes before the interior elements' kernels.  `compress` is the
    neighbour exchange's wire codec (None, or one of HALO_COMPRESS; see
    `distributed.compression`).
    """

    group: object
    rank: int
    n_shards: int
    device: torch.device
    grid: object = None
    exchange: str = "psum"
    compress: Optional[str] = None


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
    the exact single-device solve — and warns about an `exchange`, `grid`
    or `compress` that then cannot apply, as the reference does.  `device`
    names this rank's device (see `_rank_device`); a CUDA device becomes
    the rank's current device, which NCCL's point-to-point ops need.
    An unknown exchange or codec raises, and so does `compress` without
    ``exchange="neighbour"`` (the psum has no per-buffer seam to encode
    at).
    """
    if exchange not in EXCHANGES:
        raise ValueError(f"unknown exchange {exchange!r}; expected one of "
                         f"{EXCHANGES}")
    if compress is not None and compress not in HALO_COMPRESS:
        raise ValueError(f"unknown halo compress {compress!r}; expected "
                         f"None or one of {HALO_COMPRESS}")
    if compress is not None and exchange != "neighbour":
        raise ValueError(
            f"compress={compress!r} requires exchange='neighbour': the "
            f"psum exchange is one fused all-reduce with no per-buffer "
            f"seam to compress at (got exchange={exchange!r})")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if devices is not None and devices != world:
        raise ValueError(
            f"requested {devices} shards but the process group has {world} "
            f"rank(s): start one rank per shard (e.g. with "
            f"repro_torch.distributed.launch.spawn)")
    if world <= 1:
        dropped = [f"{name}={val!r}" for name, val, default in
                   (("exchange", exchange, "psum"), ("grid", grid, None),
                    ("compress", compress, None))
                   if val != default]
        if dropped:
            warnings.warn(
                f"make_solver_ctx: single-device context runs the exact "
                f"unsharded solve — {', '.join(dropped)} cannot apply and "
                f"will be ignored (start more than one rank to shard)",
                UserWarning, stacklevel=2)
        return None
    _validate_grid_spec(grid, world)
    rank = dist.get_rank()
    device = _rank_device(rank, device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    return SolverShardCtx(dist.group.WORLD, rank, world, device, grid,
                          exchange, compress)
