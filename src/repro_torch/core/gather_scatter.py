"""Gather-scatter: the actions of Q and Q^T (paper Algorithm 1, gslib role).

Q is the sparse binary global-to-local matrix (Eq. 2); it is never built.
  scatter (Q):   global field (Ng[, d])            -> local (E, N1,N1,N1[, d])
  gather  (Q^T): local  (E, N1,N1,N1[, d])         -> global (Ng[, d]) sum

The reference package leaves the gather to XLA (`segment_sum`), which on
the CPU adds each dof's contributions one after another in ascending
local-node order.  The port sums in that order on every device, so that a
gather gives the same bits in every run, on the card and on the CPU, and
the reference's bits on the CPU: a `GatherPlan`, built once from the
global numbering, groups the dofs by multiplicity m (how many element
nodes share the dof: 1 inside an element, 2 on a face, 4 on an edge, 8 at
a vertex of a box mesh) and lists each dof's m local nodes in ascending
order; the gather reads them with one `torch.gather` and adds each
group's m values left to right (`ordered_sum`) — stock ops, no atomics.
A field with trailing components (d, or an RHS batch) is gathered, and in
the global operator also scattered (`scatter_columns`, `gather_columns`),
column by column from a column-major copy, so that every read and write
of the index gathers runs along contiguous memory: on CUDA, gathering rows
of a few components (`index_select`, indexing, or `torch.gather` with a
broadcast index) ran up to 25x slower (PERF.md).

On a sharded mesh each rank gathers its shard's elements into its local
dof space in the same fixed order (a plan over the shard's `local_ids`
that leaves out the trash slot), then one `all_reduce` of the process
group sums the interface dofs — the shared face, edge and corner dofs of
the partition, never the whole field — in float32 (`exchange_shared`;
the reference's `gather_sharded` is `gather` then `exchange_shared`, which
the shard operator of `nekbone` calls in turn, since a dropped exchange
keeps the partials between them).  See `mesh_gen.partition_elements` for
the index sets.

The neighbour exchange (`exchange_neighbour`, split into
`neighbour_start` and `neighbour_finish` so that the interior elements'
kernels run between them) trades per-pair buffers with the few shards a
shard borders instead: one round an offset k of the partition's pair
tables, each a +k and a -k shift of `torch.distributed` point-to-point
messages, optionally through a halo codec (`distributed.compression`).
Every sharer of a dof then adds the same partials in the same (canonical
source) order, so it holds the same bits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.compression import (halo_compress,
                                                 halo_decompress)

__all__ = ["GatherPlan", "gather_plan", "ordered_sum", "scatter", "gather",
           "scatter_columns", "gather_columns", "dssum", "multiplicity",
           "shared_contrib", "apply_shared", "exchange_shared",
           "NeighbourRound", "neighbour_rounds", "partition_rounds",
           "neighbour_start",
           "neighbour_finish", "halo_self_round", "exchange_neighbour"]


class GatherPlan(NamedTuple):
    """The order of the gather's sums, on the device of its tensors.

    perm:    (E N1^3,) local node positions (flat index into global_ids),
             grouped by their dof's multiplicity (ascending), dof after dof
             (ascending) within a group, and ascending within a dof.
    inv:     (Ng,) each dof's row in the groups' concatenated sums.
    classes: ((m, dofs with multiplicity m), ...), ascending m; m = 0 is
             the dofs that gather nothing (a shard's padding slots and its
             trash slot), whose sums are zero.
    """

    perm: torch.Tensor
    inv: torch.Tensor
    classes: tuple


def gather_plan(global_ids, n_global: int, device=None,
                skip: Optional[int] = None) -> GatherPlan:
    """Build the gather's plan from the numbering (numpy, at setup).  The
    contributions to dof `skip` (a shard's trash slot) are left out: its
    sum is zero."""
    ids = np.asarray(global_ids.cpu() if isinstance(global_ids, torch.Tensor)
                     else global_ids).reshape(-1).astype(np.int64)
    if device is None:
        device = global_ids.device if isinstance(global_ids, torch.Tensor) \
            else torch.device("cpu")
    counts = np.bincount(ids, minlength=n_global)
    # stable: equal dofs keep their ascending positions
    by_dof = np.argsort(ids, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    if skip is not None:
        counts[skip] = 0
    perm, order, classes = [], [], []
    for m in np.unique(counts):
        dofs = np.nonzero(counts == m)[0]
        perm.append(by_dof[starts[dofs][:, None] + np.arange(m)].reshape(-1))
        order.append(dofs)
        classes.append((int(m), len(dofs)))
    order = np.concatenate(order)
    inv = np.empty(n_global, dtype=np.int64)
    inv[order] = np.arange(len(order))
    return GatherPlan(torch.as_tensor(np.concatenate(perm), device=device),
                      torch.as_tensor(inv, device=device), tuple(classes))


def _dense(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`t` in `dtype`, contiguous: one copy where either differs, none
    where neither does."""
    if t.dtype == dtype and t.is_contiguous():
        return t
    return torch.empty(t.shape, dtype=dtype, device=t.device).copy_(t)


def ordered_sum(s: torch.Tensor) -> torch.Tensor:
    """Sum the last axis of s left to right: ((s0 + s1) + s2) + ..., the
    gather's order of addition."""
    acc = s[..., 0]
    for j in range(1, s.shape[-1]):
        acc = acc + s[..., j]
    return acc


def scatter(x_global: torch.Tensor, global_ids: torch.Tensor) -> torch.Tensor:
    """Q x: copy global dof values to element-local nodes."""
    return x_global[global_ids]


def scatter_columns(x_global: torch.Tensor,
                    global_ids: torch.Tensor) -> torch.Tensor:
    """Q x for a field of c columns, (Ng, c) -> (E, c, N1,N1,N1): the
    element kernels' layout, each column scattered from a column-major
    copy.  The same values as `scatter` with the column axis moved."""
    cols = x_global.shape[1]
    local = torch.gather(_dense(x_global.t(), x_global.dtype), 1,
                         global_ids.reshape(1, -1).expand(cols, -1))
    return local.view((cols,) + tuple(global_ids.shape)).movedim(0, 1) \
        .contiguous()


def _gather_columns(vals: torch.Tensor, plan: GatherPlan) -> torch.Tensor:
    """(cols, E N1^3) contiguous -> (cols, Ng), in the plan's order."""
    cols = vals.shape[0]
    grouped = torch.gather(vals, 1, plan.perm.expand(cols, -1))
    sums, start = [], 0
    for m, n in plan.classes:
        if m == 0:
            sums.append(vals.new_zeros((cols, n)))
            continue
        sums.append(ordered_sum(grouped[:, start:start + m * n].view(
            cols, n, m)))
        start += m * n
    return torch.gather(torch.cat(sums, 1), 1, plan.inv.expand(cols, -1))


def gather_columns(y_local: torch.Tensor, plan: GatherPlan) -> torch.Tensor:
    """Q^T y for the element kernels' layout, (E, c, N1,N1,N1) -> (Ng, c):
    the same bits as `gather` of y with the column axis moved last."""
    dt = y_local.dtype
    vals = _dense(y_local.movedim(1, 0), _accumulation(dt))
    out = _gather_columns(vals.view(y_local.shape[1], -1), plan)
    return _dense(out.t(), dt)


def _accumulation(dt: torch.dtype) -> torch.dtype:
    """Sub-fp32 floats sum in fp32; other dtypes in themselves."""
    if dt.is_floating_point and torch.finfo(dt).bits < 32:
        return torch.float32
    return dt


def gather(y_local: torch.Tensor, global_ids: torch.Tensor,
           n_global: int, plan: Optional[GatherPlan] = None) -> torch.Tensor:
    """Q^T y: sum element-local values into global dofs, in `plan`'s order
    (built from `global_ids` when not given).

    `y_local` must be shaped like `global_ids` (scalar field) or like
    `global_ids` plus one trailing component axis (a d-vector field or an
    RHS batch).  Sub-fp32 values are summed in fp32 and rounded once.
    """
    if tuple(y_local.shape[:global_ids.ndim]) != tuple(global_ids.shape):
        raise ValueError(
            f"gather: y_local leading shape {tuple(y_local.shape)} does not "
            f"match global_ids shape {tuple(global_ids.shape)} — expected "
            f"{tuple(global_ids.shape)} (scalar field) or "
            f"{tuple(global_ids.shape)} + (d,) (vector field with one "
            f"trailing component axis)")
    if y_local.ndim > global_ids.ndim + 1:
        raise ValueError(
            f"gather: y_local has {y_local.ndim - global_ids.ndim} trailing "
            f"axes beyond global_ids; vector fields must pack components "
            f"into a single trailing axis (got shape {tuple(y_local.shape)} "
            f"vs ids {tuple(global_ids.shape)})")
    if plan is None:
        plan = gather_plan(global_ids, n_global, y_local.device)
    dt = y_local.dtype
    trailing = tuple(y_local.shape[global_ids.ndim:])
    cols = int(np.prod(trailing))
    # column-major (cols, E N1^3), in the accumulation dtype
    vals = _dense(y_local.reshape(-1, cols).t(), _accumulation(dt))
    out = _gather_columns(vals, plan)
    return _dense(out.t().reshape((n_global,) + trailing), dt)


def dssum(y_local: torch.Tensor, global_ids: torch.Tensor,
          n_global: int) -> torch.Tensor:
    """Direct-stiffness summation: Q Q^T y (Nek's dssum)."""
    return scatter(gather(y_local, global_ids, n_global), global_ids)


def multiplicity(global_ids: torch.Tensor, n_global: int) -> torch.Tensor:
    """Number of elements sharing each global dof (gslib 'vmult').  Small
    integers, exact in any order of addition."""
    ones = torch.ones(global_ids.numel(), dtype=torch.float32,
                      device=global_ids.device)
    out = torch.zeros(n_global, dtype=torch.float32, device=global_ids.device)
    return out.index_add_(0, global_ids.reshape(-1), ones)


def _expand_mask(mask: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Broadcast a (Ng,) bool mask against y's trailing batch axes."""
    if y.ndim == mask.ndim:
        return mask
    return mask.reshape(tuple(mask.shape) + (1,) * (y.ndim - mask.ndim))


def shared_contrib(y_dofs: torch.Tensor, shared_idx: torch.Tensor,
                   shared_present: torch.Tensor) -> torch.Tensor:
    """This shard's partial sums at the interface dofs, zero where absent.

    y_dofs: (L[, c]) the shard's local dof values; shared_idx: (NS,) local
    slots (the trash slot where absent); shared_present: (NS,) bool.
    """
    vals = y_dofs[shared_idx]
    return torch.where(_expand_mask(shared_present, vals), vals,
                       torch.zeros((), dtype=vals.dtype, device=vals.device))


def apply_shared(y_dofs: torch.Tensor, shared_idx: torch.Tensor,
                 summed: torch.Tensor) -> torch.Tensor:
    """A copy of `y_dofs` with the summed interface values written back into
    their local slots.  Absent interface dofs carry the trash slot, so
    their writes land there (its value is never read unmasked)."""
    out = y_dofs.clone()
    out[shared_idx] = summed.to(y_dofs.dtype)
    return out


def exchange_shared(y_dofs: torch.Tensor, shared_idx: torch.Tensor,
                    shared_present: torch.Tensor, group) -> torch.Tensor:
    """Sum the interface dofs' partials across the ranks of `group`: one
    `all_reduce` of the (NS[, c]) interface buffer — the whole RHS batch
    rides along as its columns.  Sub-fp32 partials are widened to fp32,
    summed and rounded once (the gather's accumulation rule, which also
    keeps bfloat16 off the wire)."""
    contrib = shared_contrib(y_dofs, shared_idx, shared_present)
    buf = _dense(contrib, _accumulation(contrib.dtype))
    dist.all_reduce(buf, group=group)
    return apply_shared(y_dofs, shared_idx, buf)


# ---------------------------------------------------------------------------
# The neighbour exchange.  Offsets k are shard-linear distances, so one
# machinery serves slabs and boxes: a dof shared by 4 or 8 shards sits in
# the pair table of every two of its sharers, and receiving each other
# sharer's partial once is the full sum.  Pairs (s, s + k) that exist
# arithmetically but not geometrically carry all-masked rows and trade
# zero buffers, as the reference's ppermute does; a shard with no partner
# at s + k (or s - k) posts nothing on that side.
# ---------------------------------------------------------------------------


class NeighbourRound(NamedTuple):
    """One exchange round: this shard's view of offset k's pair tables.

    `lo_peer` / `hi_peer` are the ranks s + k and s - k (None where no
    such shard exists); lo_idx/lo_mask are the local slots of the dofs
    shared with s + k, hi_idx/hi_mask those shared with s - k, both in the
    same sorted-by-global-id order on the two sides of a pair, padded with
    the trash slot to the offset's width M_k.  lo_real/lo_rows (hi_*) are
    the table's real entries: their (unique) local slots and their rows in
    the buffer, which `neighbour_finish` adds with `index_add_`.  `tag`
    numbers the round; every message's tag derives from it.
    """

    k: int
    tag: int
    lo_peer: Optional[int]
    hi_peer: Optional[int]
    lo_idx: torch.Tensor
    lo_mask: torch.Tensor
    hi_idx: torch.Tensor
    hi_mask: torch.Tensor
    lo_real: torch.Tensor
    lo_rows: torch.Tensor
    hi_real: torch.Tensor
    hi_rows: torch.Tensor


class InFlight(NamedTuple):
    """The exchange between `neighbour_start` and `neighbour_finish`: the
    requests to wait on, each round's receive buffers (hi side, lo side;
    None where no partner sends; host buffers when `staged`), the device
    they go back to, and the send buffers, held until the sends are
    waited for."""

    works: list
    recvs: list
    staged: bool
    device: torch.device
    sends: list


def neighbour_rounds(offsets: Sequence[int], n_shards: int, rank: int,
                     nbr_tables: Sequence[torch.Tensor]
                     ) -> list[NeighbourRound]:
    """Zip each offset's partners with this shard's table rows.

    `nbr_tables` holds this shard's (lo_idx, lo_mask, hi_idx, hi_mask)
    for each offset, flattened in offset order (the reference's layout).
    Runs at setup: finding the real entries reads the masks on the host.
    """
    rounds = []
    for j, k in enumerate(offsets):
        lo_idx, lo_mask, hi_idx, hi_mask = nbr_tables[4 * j:4 * j + 4]
        lo_rows = torch.nonzero(lo_mask).reshape(-1)
        hi_rows = torch.nonzero(hi_mask).reshape(-1)
        rounds.append(NeighbourRound(
            int(k), j, rank + k if rank + k < n_shards else None,
            rank - k if rank - k >= 0 else None, lo_idx, lo_mask, hi_idx,
            hi_mask, lo_idx[lo_rows], lo_rows, hi_idx[hi_rows], hi_rows))
    return rounds


def partition_rounds(part, shard: int, device) -> list[NeighbourRound]:
    """`neighbour_rounds` of shard `shard` of a `mesh_gen.MeshPartition`,
    its table rows on `device`."""
    tables = []
    for j in range(len(part.nbr_offsets)):
        for a, dtype in ((part.nbr_lo_idx[j], torch.int64),
                         (part.nbr_lo_mask[j], None),
                         (part.nbr_hi_idx[j], torch.int64),
                         (part.nbr_hi_mask[j], None)):
            tables.append(torch.as_tensor(np.ascontiguousarray(a[shard]),
                                          dtype=dtype, device=device))
    return neighbour_rounds(part.nbr_offsets, part.n_shards, shard, tables)


def _tag(rnd: NeighbourRound, direction: int, part: int) -> int:
    """The message tag of one codec part of one shift: unique per (round,
    direction, part); direction 0 is the +k shift, 1 the -k one."""
    return (2 * rnd.tag + direction) * 4 + part


def shift_of_tag(tag: int) -> int:
    """The shift (2 round + direction) a message tag of `_tag` belongs
    to: the +k or -k halo shift of one offset, whatever its codec part."""
    return tag // 4


def _wire(vals: torch.Tensor, compress: Optional[str]) -> tuple:
    """The contiguous parts one buffer travels as."""
    parts = (vals,) if compress is None else halo_compress(vals, compress)
    return tuple(p.contiguous() for p in parts)


def neighbour_start(y_dofs: torch.Tensor, rounds: Sequence[NeighbourRound],
                    group, compress: Optional[str] = None) -> InFlight:
    """Post every message of the exchange; returns the exchange in flight.

    The sends read this shard's own partials (`y_dofs` after the interface
    elements' gather), so whatever runs between `neighbour_start` and
    `neighbour_finish` — the interior elements, which touch no shared dof
    — overlaps the wire.  Shard s sends its lo table to s + k and its hi
    table to s - k; each codec part (`compress`: int8 codes and scales,
    or one bf16 cast) is its own message.

    The wire: with NCCL the buffers stay on the card and NCCL moves them on
    its own stream.  gloo's point-to-point ops take CPU tensors only, so a
    CUDA `y_dofs` has every send packed on the card, copied into pinned
    host buffers and waited for (one event) before the sends post, and
    receives into pinned buffers that `neighbour_finish` copies back.
    """
    staged = y_dofs.is_cuda and dist.get_backend(group) == "gloo"
    trailing = tuple(y_dofs.shape[1:])
    # the receive buffers' parts, shaped as a partner's send of M_k rows
    like = _wire(y_dofs.new_zeros((0,) + trailing), compress)

    def buffers(rows):
        return tuple(torch.empty((rows,) + tuple(p.shape[1:]),
                                 dtype=p.dtype, pin_memory=staged,
                                 device="cpu" if staged else y_dofs.device)
                     for p in like)

    sends, recvs = [], []
    for r in rounds:
        for direction, (peer, idx, mask) in enumerate(
                ((r.lo_peer, r.lo_idx, r.lo_mask),
                 (r.hi_peer, r.hi_idx, r.hi_mask))):
            if peer is not None:
                parts = _wire(shared_contrib(y_dofs, idx, mask), compress)
                if staged:
                    parts = tuple(
                        torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
                        .copy_(p, non_blocking=True) for p in parts)
                sends.append((peer, direction, r, parts))
        m = r.lo_idx.shape[0]
        recvs.append((None if r.hi_peer is None else buffers(m),
                      None if r.lo_peer is None else buffers(m)))
    if staged and sends:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(y_dofs.device))
        event.synchronize()
    ops = []
    for peer, direction, r, parts in sends:
        ops += [dist.P2POp(dist.isend, p, peer, group, _tag(r, direction, i))
                for i, p in enumerate(parts)]
    for r, (recv_hi, recv_lo) in zip(rounds, recvs):
        # the +k shift lands on the hi side, from s - k; the -k shift on
        # the lo side, from s + k
        for direction, peer, parts in ((0, r.hi_peer, recv_hi),
                                       (1, r.lo_peer, recv_lo)):
            if parts is not None:
                ops += [dist.P2POp(dist.irecv, p, peer, group,
                                   _tag(r, direction, i))
                        for i, p in enumerate(parts)]
    works = dist.batch_isend_irecv(ops) if ops else []
    return InFlight(works, recvs, staged, y_dofs.device, sends)


def neighbour_finish(y_dofs: torch.Tensor,
                     rounds: Sequence[NeighbourRound], inflight: InFlight,
                     compress: Optional[str] = None) -> torch.Tensor:
    """Wait for the exchange and add the received partials to the local
    dofs: a dof shared by m shards ends as the sum of all m partials on
    every sharer.  With `compress` the received parts are decoded to the
    `y_dofs` dtype first (`neighbour_start` must have used the same).

    The sum runs at >= fp32 in the reference's canonical source order —
    the hi-side receives (sources s - k) by descending k, then this shard's
    own partials, then the lo-side receives (sources s + k) by ascending k
    — and is cast once, so every sharer of a dof adds the same values in
    the same order and holds the same bits (`index_add_` over each table's
    unique real slots adds each value once).
    """
    for work in inflight.works:
        work.wait()
    acc_dt = _accumulation(y_dofs.dtype)

    def decode(parts):
        if parts is None:
            return None
        if inflight.staged:
            parts = tuple(p.to(inflight.device, non_blocking=True)
                          for p in parts)
        vals = parts[0] if compress is None else halo_decompress(
            parts, compress, y_dofs.dtype)
        return vals.to(y_dofs.dtype)

    decoded = [(decode(hi), decode(lo)) for hi, lo in inflight.recvs]
    acc = torch.zeros(y_dofs.shape, dtype=acc_dt, device=y_dofs.device)
    for r, (recv_hi, _) in reversed(list(zip(rounds, decoded))):
        if recv_hi is not None:
            acc.index_add_(0, r.hi_real, recv_hi[r.hi_rows].to(acc_dt))
    acc = acc + y_dofs.to(acc_dt)
    for r, (_, recv_lo) in zip(rounds, decoded):
        if recv_lo is not None:
            acc.index_add_(0, r.lo_real, recv_lo[r.lo_rows].to(acc_dt))
    return acc.to(y_dofs.dtype)


def halo_self_round(y_dofs: torch.Tensor, shared_idx: torch.Tensor,
                    shared_present: torch.Tensor,
                    compress: str) -> torch.Tensor:
    """Round this shard's own interface partials through the wire codec.

    With a lossy codec each sharer would add its own full-precision
    partial to the others' decoded ones, and two sharers of a dof would
    hold different sums.  Replacing the own partials by their
    decode(encode(.)) image — the codec is per dof, so bit for bit what
    every partner decodes from the wire — makes every sharer add the same
    codec-rounded set.  Call it after `neighbour_start` (the sends must
    encode the original values: int8 is not idempotent) and before
    `neighbour_finish`."""
    vals = shared_contrib(y_dofs, shared_idx, shared_present)
    dec = halo_decompress(halo_compress(vals, compress), compress,
                          y_dofs.dtype)
    return apply_shared(y_dofs, shared_idx, dec)


def exchange_neighbour(y_dofs: torch.Tensor,
                       rounds: Sequence[NeighbourRound], group,
                       compress: Optional[str] = None,
                       shared_idx: Optional[torch.Tensor] = None,
                       shared_present: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Sum the interface dofs' partials pairwise with the bordering shards:
    `exchange_shared`'s result up to the order of addition.  `compress`
    rounds the partials through the wire codec, the received ones on
    decode and this shard's own through `halo_self_round`, which needs the
    interface tables `shared_idx` / `shared_present`."""
    if compress is not None and (shared_idx is None or
                                 shared_present is None):
        raise ValueError(
            f"exchange_neighbour: compress={compress!r} requires "
            f"shared_idx/shared_present for the self-rounding pass "
            f"(halo_self_round) — a lossy wire without it leaves the "
            f"sharers of a dof holding different sums")
    inflight = neighbour_start(y_dofs, rounds, group, compress=compress)
    if compress is not None:
        y_dofs = halo_self_round(y_dofs, shared_idx, shared_present,
                                 compress)
    return neighbour_finish(y_dofs, rounds, inflight, compress=compress)
