"""Nekbone-equivalent problem setup: global operator, RHS, solve.

Composes the matrix-free pipeline of Algorithm 1 (scatter -> axhelm ->
gather) into a global SPD operator on unique dofs and runs PCG, mirroring
the Nekbone proxy app (Poisson with a Dirichlet mask, or Helmholtz, which
is SPD without masking).  Single device: one right-hand side or a stack of
them (block PCG), in float32 or in the mixed-precision ``bf16_x32`` mode
(float32 outer refinement around bfloat16 inner sweeps).  The PCG loops
run on the card as replayed CUDA graphs, kept per problem
(`NekboneProblem.graphs`, see `core.graphs`); `make_block_solver` is the
reference's nrhs-polymorphic entry that captures once per RHS width.

With a `distributed.context.SolverShardCtx` the same pipeline runs
element-sharded, one `torch.distributed` rank per shard: every rank builds
the same partition (1-D slabs or Cartesian sub-boxes) and keeps its own
shard's elements, the gather becomes the shard's local gather plus the
interface exchange — one `all_reduce` of the interface dofs
(``exchange="psum"``), or point-to-point rounds with the bordering shards
started before the interior elements' kernels (``exchange="neighbour"``,
optionally through a halo codec) — and PCG's dots sum the owned dofs and
all-reduce the partials.  The wire: NCCL keeps every buffer on the card;
gloo all-reduces CUDA tensors through the host, and the neighbour
exchange stages its point-to-point buffers through pinned host memory
(gloo's point-to-point ops take CPU tensors only).  A solve takes the
replicated global right-hand side and returns the same global x on every
rank.  Every rank issues the same collectives in the same order: each stop
decision of the loops comes from all-reduced values.  The sharded loops
run eagerly.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no card and no explicit device they raise.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import axhelm as axhelm_mod
from repro_torch.core import gather_scatter as gs
from repro_torch.core.graphs import GraphCache
from repro_torch.core.mesh_gen import (BoxMesh, MeshPartition,
                                       partition_elements)
from repro_torch.core.pcg import (PCGResult, owned_dot, pcg, pcg_block,
                                  prepare as prepare_loop, refine)
from repro_torch.core.spectral import SpectralBasis, basis as make_basis
from repro_torch.kernels.axhelm import ops as kops
from repro_torch.kernels.axhelm import tune
from repro_torch.resilience import inject

__all__ = ["NekboneProblem", "ShardedNekboneProblem", "PRECISIONS",
           "resolve_device", "setup_problem",
           "rhs_from_solution", "solve", "make_block_solver", "flop_count",
           "random_solution", "random_rhs", "manufactured_error"]

PRECISIONS = (None, "bf16_x32")


class NekboneProblem(NamedTuple):
    """`op`/`diag` are always at the problem's dtype; with
    ``precision="bf16_x32"`` the bfloat16 operator of the inner refinement
    sweeps is the extra ``op_lo``.  ``graphs`` keeps the problem's solver
    loops and their CUDA graphs between solves (shared by `_replace`d
    copies, whose other operators get loops of their own)."""

    op: object                     # callable global operator A(x)
    diag: torch.Tensor             # diag(A) on global dofs (for Jacobi)
    mask: Optional[torch.Tensor]   # Dirichlet mask (None => no mask)
    mesh: BoxMesh
    basis: SpectralBasis
    d: int
    helmholtz: bool
    variant: str
    backend: str = "reference"
    device: torch.device = torch.device("cpu")
    precision: Optional[str] = None  # None (plain) or "bf16_x32"
    op_lo: object = None             # bf16 operator for the inner sweeps
    graphs: Optional[GraphCache] = None


class ShardedNekboneProblem(NamedTuple):
    """One rank's element-sharded Nekbone problem (`setup_problem(
    shard_ctx=)`).

    `op` has global-field semantics (Ng[, d] -> Ng[, d]) and runs this
    rank's shard of the scatter -> axhelm -> gather pipeline with the
    interface exchange; every rank must call it together.  `diag` and
    `mask` are global, as on one device.  `run_pcg` (and, for
    ``precision="bf16_x32"``, `run_refined`) runs the whole loop on the
    shard and returns a `PCGResult` whose `x` is reassembled on the global
    dofs, the same on every rank.  `graphs` keeps the solver loops between
    solves, as `NekboneProblem.graphs` does.
    """

    op: object                     # global-semantics A(x), collective
    diag: torch.Tensor             # diag(A) on global dofs
    mask: Optional[torch.Tensor]   # Dirichlet mask on global dofs
    mesh: BoxMesh
    basis: SpectralBasis
    d: int
    helmholtz: bool
    variant: str
    backend: str
    device: torch.device
    shard_ctx: object              # distributed.context.SolverShardCtx
    partition: MeshPartition
    run_pcg: object                # (b, tol, max_iter, ...) -> PCGResult
    precision: Optional[str] = None
    run_refined: object = None     # fp32-outer / bf16-inner sharded runner
    graphs: Optional[GraphCache] = None


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA device unless the caller
    names another.  Raises when no card is there to run on — never falls
    back to the CPU silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device "
                           f"is available")
    return device


def _global_op(element_op, mesh: BoxMesh, mask, device,
               plan: gs.GatherPlan):
    """A(x) = M Q^T A_e Q M x + (I - M) x  (M = Dirichlet zero-mask).

    The identity on masked dofs keeps the operator SPD on the full vector
    space so plain CG applies.  Accepts (Ng,), (Ng, d) and the stacked
    (Ng, nrhs) and (Ng, d, nrhs): every axis after the dof axis is
    flattened into c = d*nrhs columns, which move next to the element axis
    so the element kernel sees (E, c, N1^3) and shares its per-element
    geometry across all of them; the layout is restored on exit.  The
    gather sums in `plan`'s fixed order.
    """
    ids = torch.as_tensor(mesh.global_ids, dtype=torch.int64, device=device)
    ng = mesh.n_global

    def apply(x):
        x_in = x
        bshape = tuple(x.shape[1:])
        if mask is not None:
            m = gs._expand_mask(mask, x)
            x = torch.where(m, torch.zeros((), dtype=x.dtype,
                                           device=x.device), x)
        if bshape:
            xl = gs.scatter_columns(x.reshape(ng, -1), ids)  # (E, c, N1^3)
            y = gs.gather_columns(element_op(xl), plan).reshape(
                (ng,) + bshape)
        else:
            y = gs.gather(element_op(gs.scatter(x, ids)), ids, ng, plan)
        if mask is not None:
            y = torch.where(m, x_in, y)
        return y

    return apply


def _global_diag(mesh: BoxMesh, b: SpectralBasis, factors, lam0, lam1,
                 helmholtz: bool, d: int, mask, dtype, device,
                 plan: gs.GatherPlan) -> torch.Tensor:
    """Jacobi diagonal on global dofs from per-element factor arrays."""
    node_shape = (len(mesh.verts),) + (b.n1,) * 3
    lam0n = None if lam0 is None else torch.as_tensor(
        lam0, dtype=dtype, device=device).expand(node_shape)
    lam1n = None if lam1 is None else torch.as_tensor(
        lam1, dtype=dtype, device=device).expand(node_shape)
    dl = axhelm_mod.element_diagonal(
        factors, torch.as_tensor(b.dhat, dtype=dtype, device=device),
        lam0=lam0n, lam1=lam1n, helmholtz=helmholtz)
    ids = torch.as_tensor(mesh.global_ids, dtype=torch.int64, device=device)
    diag = gs.gather(dl, ids, mesh.n_global, plan)
    if d > 1:
        diag = diag[:, None].expand(mesh.n_global, d)
    if mask is not None:
        m = mask if d == 1 else mask[:, None]
        diag = torch.where(m, torch.ones((), dtype=dtype, device=device),
                           diag)
    return diag


def setup_problem(mesh: BoxMesh, variant: str = "precomputed", d: int = 1,
                  helmholtz: bool = False, lam0=None, lam1=None,
                  dirichlet: bool | None = None,
                  dtype: torch.dtype = torch.float32,
                  backend: str | None = None,
                  device=None,
                  nrhs: int | None = None,
                  precision: str | None = None,
                  shard_ctx=None,
                  launch: str | None = None):
    """Build the global operator + Jacobi diagonal for a mesh/variant.

    `variant` is any of `core.axhelm.VARIANTS`; merged is Helmholtz only
    and partial Poisson only, and the other equation raises the reference
    package's ValueError.  The Jacobi diagonal comes from the operator's
    own factors (`AxhelmOp.factors`).

    `backend` selects the element-kernel implementation ("reference",
    "cuda", or "auto"/None; see core.axhelm._resolve_backend) — with "cuda"
    every PCG iteration launches the hand-written axhelm kernel, and on a
    CUDA device "auto" is "cuda" (float32 or bfloat16 storage).  `device`
    defaults to the CUDA device (see :func:`resolve_device`).

    `nrhs` declares the RHS-batch width of later `solve` calls, as in the
    reference; the operator takes any width, and only ``launch="auto"``
    depends on it.

    `launch` picks the body each kernel launch runs, as the reference's
    `block_elems` picks its block: None resolves it through the launch
    tuner's caches, else `kernels.axhelm.ops.body_of`'s static route
    (`kernels.axhelm.tune.get_body`); ``"auto"`` runs the tuner's sweep
    now, at setup, for every configuration neither cache holds — the
    operator's (and a ``bf16_x32`` problem's bfloat16 one's) at
    ``d * nrhs`` columns — so no solve pays for it.

    `shard_ctx` (a `distributed.context.SolverShardCtx` from
    `make_solver_ctx`, one per rank) partitions the elements over the
    ranks of its group — as linear slabs, or as the Cartesian sub-boxes of
    ``shard_ctx.grid`` — and returns this rank's `ShardedNekboneProblem`
    on ``shard_ctx.device``; every rank of the group must call it with the
    same arguments.  ``shard_ctx=None`` takes the single-device path.
    ``shard_ctx.exchange="neighbour"`` warns when the partition leaves no
    interior elements to overlap the exchange with (see
    `_neighbour_launch_plan`).

    `precision="bf16_x32"` builds the mixed-precision solve: `op`/`diag`
    stay float32 (`dtype` must be float32, the outer precision) and a
    second, bfloat16 operator over the same mesh and coefficients becomes
    `op_lo` — vertices rounded fp64 -> fp32 -> bf16 and lambdas rounded to
    bf16, as the reference rounds them.  `solve` then runs
    `core.pcg.refine`.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one "
                         f"of {PRECISIONS}")
    if precision == "bf16_x32" and dtype != torch.float32:
        raise ValueError(
            f"precision='bf16_x32' keeps the outer solve in float32 (the "
            f"bf16 operator is the separate inner machinery); pass "
            f"dtype=torch.float32, got {str(dtype).removeprefix('torch.')}")
    if nrhs is not None and (int(nrhs) != nrhs or nrhs < 1):
        raise ValueError(f"nrhs must be a positive integer, got {nrhs!r}")
    if launch not in kops.LAUNCHES:
        raise ValueError(f"launch must be one of {kops.LAUNCHES}, got "
                         f"{launch!r}")
    if shard_ctx is not None:
        if device is not None and torch.device(device) != shard_ctx.device:
            raise ValueError(f"device {device} differs from the shard's "
                             f"device {shard_ctx.device}")
        device = shard_ctx.device
    device = resolve_device(device)
    b = make_basis(mesh.order)
    verts = torch.as_tensor(mesh.verts, dtype=dtype, device=device)
    if helmholtz and lam1 is None:
        lam1 = 0.1   # Nekbone's h2-like shift
    if helmholtz and lam0 is None:
        lam0 = 1.0
    if dirichlet is None:
        dirichlet = not helmholtz  # Poisson needs the mask to be SPD
    mask = torch.as_tensor(mesh.boundary, device=device) if dirichlet else None
    if launch == "auto":
        _tune_launches(variant, b, helmholtz, dtype, backend, device,
                       d * (nrhs or 1), precision)
    if shard_ctx is not None and shard_ctx.n_shards > 1:
        part = partition_elements(mesh, shard_ctx.n_shards,
                                  grid=shard_ctx.grid)
        if shard_ctx.exchange == "neighbour" and \
                not _neighbour_launch_plan(part)[0]:
            warnings.warn(
                f"exchange='neighbour' has no interior elements to "
                f"overlap the halo exchange with (every shard slot up "
                f"to e_iface={part.e_iface} of e_per_shard="
                f"{part.e_per_shard} is interface on some shard, grid="
                f"{part.grid}): running the unsplit pipeline — the "
                f"exchange is still point-to-point but nothing hides "
                f"it.  A box decomposition (make_solver_ctx(grid="
                f"'auto')) shrinks the interface surface and restores "
                f"the overlap window.", UserWarning, stacklevel=2)
        return _setup_problem_sharded(mesh, b, variant, d, helmholtz, lam0,
                                      lam1, mask, dtype, backend, shard_ctx,
                                      part, precision)
    op = axhelm_mod.make_axhelm(variant, b, verts, lam0=lam0, lam1=lam1,
                                helmholtz=helmholtz, dtype=dtype,
                                backend=backend, device=device)
    plan = gs.gather_plan(mesh.global_ids, mesh.n_global, device)
    apply = _global_op(op.apply, mesh, mask, device, plan)
    diag = _global_diag(mesh, b, op.factors, lam0, lam1, helmholtz, d, mask,
                        dtype, device, plan)
    op_lo_apply = None
    if precision == "bf16_x32":
        op_lo = axhelm_mod.make_axhelm(variant, b, verts, lam0=lam0,
                                       lam1=lam1, helmholtz=helmholtz,
                                       dtype=torch.bfloat16, backend=backend,
                                       device=device)
        op_lo_apply = _global_op(op_lo.apply, mesh, mask, device, plan)
    return NekboneProblem(apply, diag, mask, mesh, b, d, helmholtz, variant,
                          op.backend, device, precision, op_lo_apply,
                          GraphCache())


def _tune_launches(variant: str, b: SpectralBasis, helmholtz: bool, dtype,
                   backend, device, ncols: int, precision) -> None:
    """``launch="auto"``: tune the launches the problem's operators will
    make (`kernels.axhelm.tune.get_body` with a sweep on a miss) when they
    run the kernels on a card; the plain version has no launch to tune."""
    if axhelm_mod._resolve_backend(backend, dtype, device, b.n1) != "cuda" \
            or torch.device(device).type != "cuda":
        return
    # the equation the kernel runs: merged is Helmholtz, partial Poisson
    helm = {"merged": True, "partial": False}.get(variant, helmholtz)
    for dt in (dtype,) + ((torch.bfloat16,) if precision == "bf16_x32"
                          else ()):
        tune.get_body(variant, b.n1, dt, helm, ncols, device=device,
                      autotune_now=True)


def _neighbour_launch_plan(part: MeshPartition) -> tuple[bool, int]:
    """The element launches of the neighbour exchange's shard operator:
    ``(split, cut)``.  With `split` the operator runs two launches, the
    interface slots ``[0, cut)`` first (their gather completes every
    shared-dof partial, so the exchange starts after it) and the interior
    slots ``[cut, EP)`` while the exchange is in flight.  Where some shard
    is all interface (``e_iface == e_per_shard``, thin slabs at high shard
    counts) or none is (``e_iface == 0``) no split point leaves work on
    both sides: one unsplit launch of all EP slots, ``cut = EP``.  The
    reference's plan also returns its block autotuner's clamp; the port
    has no block size to tune."""
    ep, ei = part.e_per_shard, part.e_iface
    split = 0 < ei < ep
    return split, ei if split else ep


def _partition_lam_field(lam, part: MeshPartition, shard: int) -> np.ndarray:
    """Shard `shard`'s slots of an (E, N1, N1, N1) lambda field, in the
    partition's element order (`elem_perm`, interface first), with its dead
    padding slots set to 1.0 (any finite value works: their outputs land
    in the trash slot)."""
    lam = np.asarray(lam.cpu() if isinstance(lam, torch.Tensor) else lam)
    perm = part.elem_perm[shard]                 # (EP,); -1 on dead slots
    vals = lam[np.where(perm >= 0, perm, 0)]
    vals[perm < 0] = 1.0
    return vals


def _setup_problem_sharded(mesh: BoxMesh, b: SpectralBasis, variant: str,
                           d: int, helmholtz: bool, lam0, lam1, mask,
                           dtype: torch.dtype, backend, ctx,
                           part: MeshPartition, precision
                           ) -> ShardedNekboneProblem:
    """This rank's shard: its element operator (and, for ``bf16_x32``, a
    second bfloat16 one over the same shard), the global Jacobi diagonal of
    the whole mesh, and the runners."""
    device, shard = ctx.device, ctx.rank
    node_shape = (len(mesh.verts),) + (b.n1,) * 3
    lam_sh = []
    for name, lam in (("lam0", lam0), ("lam1", lam1)):
        if lam is not None and getattr(lam, "ndim", 0) > 0:
            if tuple(lam.shape) != node_shape:
                raise ValueError(
                    f"{name} must be a scalar or a per-node (E, N1, N1, N1) "
                    f"field of shape {node_shape} (the unpartitioned mesh "
                    f"layout), got {tuple(lam.shape)}")
            lam = _partition_lam_field(lam, part, shard)
        lam_sh.append(lam)
    verts = torch.as_tensor(part.verts[shard], dtype=dtype, device=device)
    elem_ops, elem_apply, backend_used = axhelm_mod.make_axhelm_elem_ops(
        variant, b, verts, lam0=lam_sh[0], lam1=lam_sh[1],
        helmholtz=helmholtz, dtype=dtype, backend=backend, device=device)
    # the diagonal of the whole mesh, as on one device
    factors = axhelm_mod.setup_factors(
        variant, b, torch.as_tensor(mesh.verts, device=device), dtype)
    diag = _global_diag(mesh, b, factors, lam0, lam1, helmholtz, d, mask,
                        dtype, device, gs.gather_plan(
                            mesh.global_ids, mesh.n_global, device))
    apply_lo = None
    if precision == "bf16_x32":
        ops_lo, elem_apply_lo, _ = axhelm_mod.make_axhelm_elem_ops(
            variant, b, verts, lam0=lam_sh[0], lam1=lam_sh[1],
            helmholtz=helmholtz, dtype=torch.bfloat16, backend=backend,
            device=device)
        apply_lo = (elem_apply_lo, ops_lo)
    graphs = GraphCache()
    op, run_pcg, run_refined = _build_sharded_runner(
        part, ctx, (elem_apply, elem_ops), apply_lo, mask, diag, d,
        mesh.n_global, graphs)
    return ShardedNekboneProblem(op, diag, mask, mesh, b, d, helmholtz,
                                 variant, backend_used, device, ctx, part,
                                 run_pcg, precision, run_refined, graphs)


def _build_sharded_runner(part: MeshPartition, ctx, elem, elem_lo, mask,
                          diag: torch.Tensor, d: int, n_global: int,
                          graphs: GraphCache):
    """Wire this rank's shard of the pipeline: index sets on its device,
    the shard operator with the interface exchange, and the runners, whose
    loops `graphs` keeps.  `elem` (and `elem_lo`, the bfloat16 operator of
    a ``bf16_x32`` problem, or None) is ``(elem_apply, elem_ops)`` over the
    shard's EP element slots.

    The collectives are the interface exchange of each operator
    application — the `all_reduce` of `gs.exchange_shared`, or with
    ``ctx.exchange == "neighbour"`` the point-to-point rounds of
    `gs.neighbour_start` — the `all_reduce` of each PCG dot (`owned_dot`)
    and the one of `globalize`.  ``ctx.compress`` is the neighbour wire's
    codec: it applies to the operator of the inner sweeps, the bfloat16
    one where there is one, else the plain one; a refined problem's fp32
    outer operator always exchanges at full width.  Returns
    ``(apply_global, run_pcg, run_refined)``; the last is None without a
    bfloat16 operator.
    """
    shard, dev, group = ctx.rank, ctx.device, ctx.group
    nl, ep = part.n_local, part.e_per_shard

    def rows(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a[shard]), dtype=dtype,
                               device=dev)

    lid = rows(part.local_ids, torch.int64)
    sidx = rows(part.shared_idx, torch.int64)
    spres = rows(part.shared_present)
    l2g = rows(part.local_to_global, torch.int64)
    own, val = rows(part.owned_mask), rows(part.valid_mask)
    own_slots = torch.as_tensor(np.flatnonzero(part.owned_mask[shard]),
                                device=dev)
    own_g = l2g[own_slots]
    diag_loc = diag[l2g]
    mask_loc = None if mask is None else mask[l2g]
    expand = gs._expand_mask
    neighbour = ctx.exchange == "neighbour"
    rounds = None
    # the element slots of each launch: the interface slots, whose gather
    # the neighbour exchange starts after, then the interior ones
    cuts = [0, ep]
    if neighbour:
        rounds = gs.partition_rounds(part, shard, dev)
        split, cut = _neighbour_launch_plan(part)
        if split:
            cuts = [0, cut, ep]
    # each launch's slots, and the fixed-order gather of its slots into the
    # shard's dofs (the trash slot gathers nothing)
    batches = [(lo, hi, lid[lo:hi], gs.gather_plan(
        part.local_ids[shard][lo:hi], nl, dev, skip=nl - 1))
        for lo, hi in zip(cuts[:-1], cuts[1:])]
    dots = {batched: owned_dot(own, group, batched)
            for batched in (False, True)}

    def zero(t):
        return torch.zeros((), dtype=t.dtype, device=t.device)

    def localize(xg):
        xl = xg[l2g]
        return torch.where(expand(val, xl), xl, zero(xl))

    def globalize(xl):
        # every dof has one owner: one index_add_ a rank, then the
        # all_reduce adds zeros to it elsewhere — exact
        acc = gs._accumulation(xl.dtype)
        out = torch.zeros((n_global,) + tuple(xl.shape[1:]), dtype=acc,
                          device=xl.device)
        out.index_add_(0, own_g, xl[own_slots].to(acc))
        dist.all_reduce(out, group=group)
        return out.to(xl.dtype)

    def make_a_op(elem_apply, elem_ops, wire):
        """The shard operator of one element operator; `wire` is the halo
        codec of its neighbour exchange (None: full width)."""
        launches = [(lids, plan, {k: v[lo:hi] for k, v in elem_ops.items()})
                    for lo, hi, lids, plan in batches]

        def partials(x, batch, bshape):
            """Axhelm on one launch's slots and their gather into the
            shard's dofs."""
            lids, plan, ops = launches[batch]
            if bshape:
                return gs.gather_columns(elem_apply(
                    gs.scatter_columns(x.reshape(nl, -1), lids), ops), plan)
            return gs.gather(elem_apply(gs.scatter(x, lids), ops), lids, nl,
                             plan)

        def a_op_local(x, it=None, fault=None, fdof=None):
            """This shard's A(x): mask -> scatter -> axhelm -> local gather
            -> interface exchange (+ mask), on (L[, ...]) local fields;
            trailing axes are flattened into the c columns of one
            exchange.  In neighbour mode the interface slots run first,
            the exchange starts, and the interior slots (which touch no
            shared dof) run while it is in flight.  `fault` strikes on its
            shard when the device counter `it` reaches its iteration:
            nan/bitflip poison the local dof `fdof` after all masking;
            drop_exchange keeps the shard's pre-exchange partials (a lost
            message: its shared dofs miss every remote contribution).
            Every rank still takes part in the exchange."""
            x_in = x
            bshape = tuple(x.shape[1:])
            if mask_loc is not None:
                m = expand(mask_loc, x)
                x = torch.where(m, zero(x), x)
            y_pre = partials(x, 0, bshape)
            if neighbour:
                inflight = gs.neighbour_start(y_pre, rounds, group, wire)
                for batch in range(1, len(launches)):
                    y_pre = y_pre + partials(x, batch, bshape)
                if wire is not None:
                    # every sharer then adds the same codec-rounded set
                    y_pre = gs.halo_self_round(y_pre, sidx, spres, wire)
                y = gs.neighbour_finish(y_pre, rounds, inflight, wire)
            else:
                y = gs.exchange_shared(y_pre, sidx, spres, group)
            fire = None
            if fault is not None and fault.shard == shard:
                fire = it == fault.iteration
                if fault.mode == "drop_exchange":
                    y = torch.where(fire, y_pre, y)
            if bshape:
                y = y.reshape((nl,) + bshape)
            if mask_loc is not None:
                y = torch.where(m, x_in, y)
            # dead-element and padding slots stay exactly zero
            y = torch.where(expand(val, y), y, zero(y))
            if fire is not None and fault.mode != "drop_exchange":
                y = inject.poison(y, fdof, fire, fault)
            return y

        return a_op_local

    a_op_local = make_a_op(*elem, ctx.compress if elem_lo is None else None)
    a_op_lo_local = None if elem_lo is None else make_a_op(*elem_lo,
                                                           ctx.compress)

    def apply_global(xg):
        return globalize(a_op_local(localize(xg)))

    def validate_fault(fault):
        """The fault's checks, the same on every rank, and its local dof
        (None for drop_exchange)."""
        if not 0 <= fault.shard < part.n_shards:
            raise ValueError(f"fault.shard {fault.shard} out of range for "
                             f"{part.n_shards} shards")
        if fault.mode == "drop_exchange":
            return None
        fdof = inject.fault_dof(part.local_ids[fault.shard], fault)
        if part.elem_perm[fault.shard, fault.element] < 0:
            raise ValueError(
                f"fault.element {fault.element} is a dead padding slot on "
                f"shard {fault.shard}: pick a live element")
        return fdof

    def operator(fault, lo: bool):
        """The iteration-aware faulted shard operator (memoized), or the
        plain one."""
        base = a_op_lo_local if lo else a_op_local
        if fault is None:
            return base

        def make():
            fdof = validate_fault(fault)

            def a_op(x, it):
                return base(x, it=it, fault=fault, fdof=fdof)

            a_op.takes_iteration = True
            return a_op

        return graphs.memo(("sharded_fault", lo, fault), make)

    def preconditioner(precond, refined, batched):
        if precond != "jacobi":
            return None
        return graphs.memo(("sharded_jacobi", refined, batched),
                           lambda: _jacobi(diag_loc, refined, batched))

    def run_pcg(b_global, tol, max_iter, precond="jacobi", x0=None,
                stagnation_window=0, fault=None):
        batched = b_global.ndim > (2 if d > 1 else 1)
        runner = pcg_block if batched else pcg
        res = runner(operator(fault, False), localize(b_global),
                     x0=None if x0 is None else localize(x0),
                     precond=preconditioner(precond, False, batched),
                     tol=tol, max_iter=max_iter, dot=dots[batched],
                     stagnation_window=stagnation_window, graphs=graphs,
                     capture=False)
        return res._replace(x=globalize(res.x))

    run_refined = None
    if a_op_lo_local is not None:
        def run_refined(b_global, tol, max_iter, precond="jacobi", x0=None,
                        stagnation_window=0, fault=None):
            """The whole refine loop on the shard: fp32 outer residual
            through the full-precision shard operator, bf16 inner sweeps
            through the bf16 one (which a `fault` strikes in every
            sweep)."""
            batched = b_global.ndim > (2 if d > 1 else 1)
            res = refine(
                a_op_local, operator(fault, True),
                localize(b_global.to(torch.float32)),
                x0=None if x0 is None else localize(x0.to(torch.float32)),
                precond=preconditioner(precond, True, batched),
                tol=tol, max_iter=max_iter, dot=dots[batched],
                batched=batched, inner_window=stagnation_window or 5,
                graphs=graphs, capture=False)
            return res._replace(x=globalize(res.x))

    return apply_global, run_pcg, run_refined


def rhs_from_solution(problem: NekboneProblem,
                      x_true: torch.Tensor) -> torch.Tensor:
    """Manufactured RHS b = A x_true (x_true zeroed on the mask first).

    `x_true` may carry a trailing RHS-batch axis — (Ng, nrhs) or
    (Ng, d, nrhs) — giving a stacked RHS for the block solve."""
    if problem.mask is not None:
        m = gs._expand_mask(problem.mask, x_true)
        x_true = torch.where(m, torch.zeros((), dtype=x_true.dtype,
                                            device=x_true.device), x_true)
    return problem.op(x_true)


def solve(problem: NekboneProblem, b_rhs: torch.Tensor,
          precond: str = "jacobi", tol: float = 1e-8, max_iter: int = 200,
          x0: Optional[torch.Tensor] = None,
          stagnation_window: int = 0, fault=None,
          capture: Optional[bool] = None) -> PCGResult:
    """Solve A x = b (PCG).

    `b_rhs` is (Ng,) for d=1 or (Ng, d) for vector problems; one extra
    trailing axis stacks nrhs right-hand sides — (Ng, nrhs) / (Ng, d, nrhs)
    — solved together by block PCG (`core.pcg.pcg_block`): one operator
    application for the whole block per iteration, per-column convergence,
    and per-column iterations, residuals and statuses in the result.  A
    trailing axis of size 1 takes the single-RHS path, so that degenerate
    batch gives exactly the unbatched result.  A ``bf16_x32`` problem runs
    `core.pcg.refine` with the bfloat16 operator `op_lo` and a bfloat16
    Jacobi preconditioner for the inner sweeps, `stagnation_window` (or 5)
    as their window.  The result's ``status`` reports WHY each solve or
    column stopped (a `resilience.status.SolveStatus` code).

    `x0` warm-starts the iteration.  `fault` (a
    `resilience.inject.FaultSpec`) corrupts one operator application inside
    the loop — of `op_lo` on a ``bf16_x32`` problem, where it recurs every
    sweep; the test harness of `resilience`, None in production.  On a card
    the loops run as CUDA graphs kept in ``problem.graphs``, so a repeat
    solve of the same shape captures nothing; ``capture=False`` runs them
    eagerly, for comparisons.

    A `ShardedNekboneProblem` runs its shard's loop on every rank (each
    rank calls `solve` with the same replicated `b_rhs`) and returns the
    global x on every rank; its loops run eagerly (``capture=True``
    raises: capturing the sharded loop is not ported yet)."""
    if precond not in ("jacobi", "copy"):
        raise ValueError(f"unknown preconditioner {precond!r}")
    base = 1 if problem.d == 1 else 2
    if b_rhs.ndim not in (base, base + 1):
        raise ValueError(
            f"solve: b_rhs must be rank {base} (single RHS) or {base + 1} "
            f"(stacked RHS) for a d={problem.d} problem, got shape "
            f"{tuple(b_rhs.shape)}")
    batched = b_rhs.ndim == base + 1
    if batched and b_rhs.shape[-1] == 1:
        res = solve(problem, b_rhs[..., 0], precond=precond, tol=tol,
                    max_iter=max_iter,
                    x0=None if x0 is None else x0[..., 0],
                    stagnation_window=stagnation_window, fault=fault,
                    capture=capture)
        return PCGResult(res.x[..., None], res.iterations[None],
                         res.residual[None], res.initial_residual[None],
                         res.breakdown[None], res.status[None])
    refined = problem.precision == "bf16_x32"
    if isinstance(problem, ShardedNekboneProblem):
        if capture:
            raise ValueError("capture=True: the sharded loops run eagerly "
                             "(capturing them is not ported yet)")
        runner = problem.run_refined if refined else problem.run_pcg
        return runner(b_rhs, tol, max_iter, precond=precond, x0=x0,
                      stagnation_window=stagnation_window, fault=fault)
    graphs, pre, op = _loop_parts(problem, precond, batched, fault)
    if refined:
        return refine(problem.op, op, b_rhs, x0=x0, precond=pre,
                      tol=tol, max_iter=max_iter, batched=batched,
                      inner_window=stagnation_window or 5, graphs=graphs,
                      capture=capture)
    runner = pcg_block if batched else pcg
    return runner(op, b_rhs, x0=x0, precond=pre, tol=tol,
                  max_iter=max_iter, stagnation_window=stagnation_window,
                  graphs=graphs, capture=capture)


def _loop_parts(problem: NekboneProblem, precond: str, batched: bool,
                fault=None):
    """The graph cache, preconditioner and operator of a single-device
    solve's loop: the Jacobi preconditioner and the fault-wrapped operator
    are memoized with the loops, so that a repeat solve (or `prepare`)
    finds the key of the loop (and graph) it captured.  A ``bf16_x32``
    problem's loop is the inner one: its bfloat16 operator and
    preconditioner."""
    refined = problem.precision == "bf16_x32"
    graphs = problem.graphs if problem.graphs is not None else GraphCache()
    pre = None
    if precond == "jacobi":
        # keyed by the diagonal's id; the memo holds the diagonal, so the
        # id stays its own
        _, pre = graphs.memo(
            ("jacobi", id(problem.diag), refined, batched),
            lambda: (problem.diag, _jacobi(problem.diag, refined, batched)))
    op = problem.op_lo if refined else problem.op
    if fault is not None:
        op = graphs.memo(("fault", op, fault), lambda: inject.wrap_operator(
            op, fault, problem.mesh.global_ids))
    return graphs, pre, op


def _jacobi(diag: torch.Tensor, refined: bool, batched: bool):
    """The Jacobi preconditioner r -> r / diag(A), in bfloat16 for the
    inner sweeps of a ``bf16_x32`` solve."""
    inv_diag = 1.0 / diag
    if refined:
        inv_diag = inv_diag.to(torch.bfloat16)
    if batched:
        inv_diag = inv_diag[..., None]

    def pre(r):
        return inv_diag * r

    return pre


def make_block_solver(problem: NekboneProblem, *, precond: str = "jacobi",
                      tol: float = 1e-8, max_iter: int = 200,
                      stagnation_window: int = 0, on_capture=None):
    """An nrhs-polymorphic solve entry for padded RHS blocks, the
    reference's `make_block_solver`.

    Returns ``solve_block(b_blk, x0_blk) -> PCGResult`` with the solver's
    settings closed over.  Each RHS width gets its loop, and on a card its
    CUDA graph, once, in ``problem.graphs``; every later call of that width
    replays it.  `x0_blk` is required (zeros for a cold start, which give
    the same bits as ``x0=None``).  ``solve_block.prepare(shape)`` builds
    the loops of a block of `shape` — for a ``bf16_x32`` problem its inner
    loop — and on a card captures them, without solving (`core.pcg.
    prepare`), so that the first call of that width replays; it raises on
    a sharded problem, whose loops run eagerly.

    Callers may pad a block to a bucket width with zero columns: a zero
    column converges at iteration 0 and block PCG's freeze keeps it from
    perturbing live columns, and since every per-column operation of the
    block solve — the operator, the preconditioner, the updates and the
    per-column dots (`core.pcg._column_dot`) — gives column j the same
    bits whatever the width and the other columns, a real column comes out
    bitwise as it would unpadded (tests/test_torch_serving.py; on a card
    tests/test_torch_serving_cuda.py and `chip_smoke.py` phases serve and
    serve_8).

    ``on_capture(shape)``, if given, is called with the block's shape when
    a call or a `prepare` captured a graph — on the CPU, where nothing is
    captured, when it built a width's loop — and never on a call that
    replays: the counterpart of the reference's ``on_trace``.
    """
    if problem.graphs is None:
        problem = problem._replace(graphs=GraphCache())
    graphs = problem.graphs
    base = 1 if problem.d == 1 else 2

    def made():
        return graphs.captures if problem.device.type == "cuda" \
            else graphs.builds

    def solve_block(b_blk: torch.Tensor, x0_blk: torch.Tensor) -> PCGResult:
        before = made()
        res = solve(problem, b_blk, precond=precond, tol=tol,
                    max_iter=max_iter, x0=x0_blk,
                    stagnation_window=stagnation_window)
        if on_capture is not None and made() > before:
            on_capture(tuple(b_blk.shape))
        return res

    def prepare(shape) -> None:
        if isinstance(problem, ShardedNekboneProblem):
            raise ValueError("prepare: the sharded loops run eagerly, built "
                             "by each solve (capturing them is not ported "
                             "yet)")
        shape = tuple(shape)
        if len(shape) != base + 1:
            raise ValueError(f"prepare: a block of a d={problem.d} problem "
                             f"has rank {base + 1}, got shape {shape}")
        batched = shape[-1] > 1   # width 1 runs the single-RHS loop
        refined = problem.precision == "bf16_x32"
        _, pre, op = _loop_parts(problem, precond, batched)
        b = torch.zeros(shape if batched else shape[:-1],
                        dtype=torch.bfloat16 if refined
                        else problem.diag.dtype, device=problem.device)
        before = made()
        prepare_loop(op, b, batched=batched, precond=pre,
                     stagnation_window=(stagnation_window or 5) if refined
                     else stagnation_window, graphs=graphs)
        if on_capture is not None and made() > before:
            on_capture(shape)

    solve_block.prepare = prepare
    return solve_block


def flop_count(mesh: BoxMesh, d: int, helmholtz: bool, iterations: int) -> float:
    """Nekbone-style useful-FLOP count for GFLOPS reporting (Table 6).

    Per CG iteration: one axhelm (F_ax per element) + vector ops
    (~7 flops/dof: 2 dots, 3 axpy-likes with fused mul-add counted as 2).
    """
    n1 = mesh.order + 1
    e = len(mesh.verts)
    is_helm = 1 if helmholtz else 0
    f_ax = d * (12.0 * n1**4 + (15.0 + 5.0 * is_helm) * n1**3) * e
    f_vec = 7.0 * mesh.n_global * d
    return (f_ax + f_vec) * iterations


def manufactured_error(problem: NekboneProblem, x: torch.Tensor,
                       x_true: torch.Tensor) -> float:
    """Relative error of a solve against its manufactured solution (the
    solution is zero on Dirichlet dofs)."""
    ref = x_true
    if problem.mask is not None:
        ref = torch.where(gs._expand_mask(problem.mask, x_true),
                          torch.zeros((), dtype=x_true.dtype,
                                      device=x_true.device), x_true)
    return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))


def random_solution(problem: NekboneProblem, seed: int = 0,
                    dtype: torch.dtype = torch.float32,
                    nrhs: int = 1) -> torch.Tensor:
    """A standard-normal x_true on the problem's dofs, made with numpy from
    `seed` so every backend and device sees the same numbers; with
    ``nrhs > 1`` a stack of them on a trailing axis."""
    shape = (problem.mesh.n_global,) if problem.d == 1 else \
        (problem.mesh.n_global, problem.d)
    if nrhs > 1:
        shape = shape + (nrhs,)
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                           device=problem.device)


def random_rhs(problem: NekboneProblem, nrhs: int = 1) -> torch.Tensor:
    """The right-hand side of the reference's precision benchmark
    (`benchmarks/bench_nekbone.py::precision_rows`): standard normal in
    float32 from numpy seed 0, zero on the mesh's Dirichlet boundary (also
    for an unmasked problem), each right-hand side scaled to 2-norm 30; with
    ``nrhs > 1`` a stack of them on a trailing axis."""
    shape = (problem.mesh.n_global,) if problem.d == 1 else \
        (problem.mesh.n_global, problem.d)
    if nrhs > 1:
        shape = shape + (nrhs,)
    b = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    b[np.asarray(problem.mesh.boundary)] = 0.0
    axes = 0 if problem.d == 1 else (0, 1)
    b = b / np.linalg.norm(b, axis=axes) * 30.0
    return torch.as_tensor(b, device=problem.device)
