"""End-to-end Nekbone solve of the port, on one device or element-sharded
over local ranks.

Solves Poisson/Helmholtz on a box of trilinear elements with Jacobi PCG and
the chosen axhelm variant; prints status / iterations / error / wall /
GFLOPS / GDOFS, like `examples/nekbone_solve.py` in the reference package.
Variants: precomputed, trilinear, parallelepiped (on an affinely deformed
box, whose elements are parallelepipeds), merged (Helmholtz only) and
partial (Poisson only).

Run:  PYTHONPATH=src python -m repro_torch.nekbone_solve \
          [--elements 4 4 4] [--order 7] [--variant trilinear] \
          [--equation poisson] [--d 1] [--nrhs 1] [--backend auto] \
          [--device cuda] [--devices 1] [--grid slab] [--exchange psum] \
          [--dist-backend nccl]

--order N runs on the card at every order, each through its axhelm body
(`kernels.axhelm.ops.body_of`): `--elements 6 6 6 --order 19` the slab
body (1,520,875 dofs), `--elements 4 4 4 --order 31` the plane body
(1,953,125 dofs), `--elements 2 2 2 --order 63` the staged body (2,048,383
dofs).

--nrhs R solves R stacked right-hand sides with block PCG (1 is the exact
single-RHS path) and adds iters/column and wall/rhs to the result line.

--backend auto drives the hand-written CUDA axhelm kernel inside the PCG
loop on a card and the plain PyTorch reference on the CPU.  --device
defaults to the card; --device cpu runs the whole solve on the CPU.  On
the card the PCG loop runs as a replayed CUDA graph, captured by the
warm-up solve.

--devices N shards the elements over N local ranks (`distributed.launch`,
one process each, rank 0 prints): --grid picks the partition ('slab',
'auto', or a box like '2x2x1'); --exchange picks the interface exchange,
one all-reduce of the interface dofs (psum, the default) or point-to-point
rounds with the bordering shards, started before the interior elements'
kernels (neighbour); the PCG dots are all-reduced.  --dist-backend: nccl
(the default) needs one card per rank; gloo runs any number of ranks on
one card (the neighbour rounds staged through pinned host memory), or on
the CPU with --device cpu.  The sharded loop runs eagerly.  The parent
builds the kernels before it starts the ranks.

--inject MODE@ITER corrupts one operator application inside the loop
(`resilience.inject.FaultSpec`: nan@3, bitflip@2, and on sharded runs
drop_exchange@2, which strikes shard 0); --resilient solves
through `resilience.retry.solve_resilient` (true-residual verification and
the restart -> precision ladder of the default policy; the backend rung,
which answers with the plain version in place of the kernels, is opt-in
through `RetryPolicy(backend_fallback=True)`) and prints each attempt.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import mesh_gen, nekbone
from repro_torch.distributed.context import make_solver_ctx, parse_grid_arg
from repro_torch.distributed.launch import spawn
from repro_torch.resilience.inject import FaultSpec
from repro_torch.resilience.retry import solve_resilient
from repro_torch.resilience.status import SolveStatus


def _parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--elements", type=int, nargs=3, default=[4, 4, 4])
    ap.add_argument("--order", type=int, default=7)
    ap.add_argument("--variant", default="trilinear",
                    choices=["precomputed", "trilinear", "parallelepiped",
                             "merged", "partial"])
    ap.add_argument("--equation", default="poisson",
                    choices=["poisson", "helmholtz"])
    ap.add_argument("--d", type=int, default=1, choices=[1, 3])
    ap.add_argument("--nrhs", type=int, default=1,
                    help="solve R stacked right-hand sides with block PCG "
                         "(1 = the exact single-RHS path)")
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--max-iter", type=int, default=400)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "reference", "cuda"],
                    help="element kernel: cuda (hand-written kernels), "
                         "reference (plain torch), or auto")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--resilient", action="store_true",
                    help="run through resilience.retry.solve_resilient: "
                         "true-residual verification plus the restart -> "
                         "precision ladder (the default policy: the "
                         "backend rung, which answers with the plain "
                         "version, is opt-in through RetryPolicy); prints "
                         "the per-attempt audit trail")
    ap.add_argument("--inject", default=None, metavar="MODE@ITER",
                    help="fault injection: corrupt one operator "
                         "application, e.g. 'nan@3', 'bitflip@2', "
                         "'drop_exchange@2' (sharded only)")
    ap.add_argument("--devices", type=int, default=1,
                    help="shard the solve over N local ranks (1 = the "
                         "exact single-device path)")
    ap.add_argument("--grid", default="slab",
                    help="element-partition shard grid: 'slab' (1-D), "
                         "'auto' (smallest-surface factorization), or an "
                         "explicit box like '2x2x1' (must multiply to "
                         "--devices)")
    ap.add_argument("--exchange", default="psum",
                    choices=["psum", "neighbour"],
                    help="interface-dof exchange of the sharded solve: one "
                         "all-reduce (psum), or point-to-point rounds with "
                         "the bordering shards overlapped with the interior "
                         "elements' kernels (neighbour)")
    ap.add_argument("--dist-backend", default="nccl",
                    choices=["nccl", "gloo"],
                    help="torch.distributed backend of the sharded solve: "
                         "nccl needs one card per rank; gloo runs any "
                         "number of ranks on one card or on the CPU")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host(a):
    """A solve's (tensor) or a report's (numpy) per-column values, on the
    host."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else a


def main(argv=None):
    args = _parse_args(argv)
    if args.devices < 1:
        raise SystemExit(f"--devices must be >= 1, got {args.devices}")
    if args.devices == 1:
        # no process group: None, with a warning when --grid cannot apply
        _run(args, make_solver_ctx(exchange=args.exchange,
                                   grid=parse_grid_arg(args.grid)))
        return
    device = nekbone.resolve_device(args.device)
    if args.dist_backend == "nccl" and (
            device.type != "cuda"
            or torch.cuda.device_count() < args.devices):
        cards = torch.cuda.device_count() if device.type == "cuda" else 0
        raise SystemExit(
            f"--dist-backend nccl needs one card per rank: {args.devices} "
            f"ranks, {cards} card(s) on {device.type}; pass --dist-backend "
            f"gloo to run the ranks on fewer cards or on the CPU")
    if device.type == "cuda" and args.backend != "reference":
        from repro_torch.kernels.axhelm import build
        build.build()           # once here, not in every rank
    spawn(_rank_main, args.devices, (args,), backend=args.dist_backend)


def _rank_main(rank: int, world: int, args) -> None:
    """One rank of a sharded run: on its own card (`--device cuda` too:
    rank r takes card r modulo the count), or on the named device."""
    device = None if args.device in (None, "cuda") else args.device
    ctx = make_solver_ctx(devices=world, exchange=args.exchange,
                          grid=parse_grid_arg(args.grid), device=device)
    _run(args, ctx)


def _run(args, shard_ctx=None) -> None:
    """Set up, solve and report; on a sharded run every rank solves and
    rank 0 prints."""
    rank = 0 if shard_ctx is None else shard_ctx.rank

    def say(msg: str) -> None:
        if rank == 0:
            print(msg, flush=True)

    fault = None
    if args.inject is not None:
        mode, _, it = args.inject.partition("@")
        fault = FaultSpec(mode=mode, iteration=int(it) if it else 3)
    device = nekbone.resolve_device(
        args.device if shard_ctx is None else shard_ctx.device)
    helm = args.equation == "helmholtz"
    nx, ny, nz = args.elements
    mesh = mesh_gen.box_mesh(nx, ny, nz, args.order)
    if args.variant == "parallelepiped":
        mesh = mesh_gen.deform_affine(mesh, seed=2)
    else:
        mesh = mesh_gen.deform_trilinear(mesh, seed=3)
    n_shards = 1 if shard_ctx is None else shard_ctx.n_shards
    say(f"mesh: E={len(mesh.verts)} N={args.order} dofs={mesh.n_global} "
        f"variant={args.variant} eq={args.equation} d={args.d} "
        f"nrhs={args.nrhs} shards={n_shards} exchange={args.exchange}")
    prob = nekbone.setup_problem(mesh, variant=args.variant, d=args.d,
                                 helmholtz=helm, backend=args.backend,
                                 device=device, nrhs=args.nrhs,
                                 shard_ctx=shard_ctx)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    say(f"backend={prob.backend} device={device} ({name})")
    if shard_ctx is not None:
        part = prob.partition
        say(f"partition: shards={part.n_shards} grid={part.grid} "
            f"dist_backend={args.dist_backend} "
            f"elems/shard={[int(c) for c in part.elem_counts]} "
            f"local_dofs={part.n_local} shared_dofs={part.n_shared} "
            f"({part.n_shared / mesh.n_global:.1%} of the field exchanged) "
            f"iface_elems={float(part.iface_counts.sum()) / len(mesh.verts):.1%} "
            f"neighbour_offsets={list(part.nbr_offsets)}")
    x_true = nekbone.random_solution(prob, seed=0, nrhs=args.nrhs)
    b = nekbone.rhs_from_solution(prob, x_true)

    if args.resilient:
        t0 = time.perf_counter()
        res = solve_resilient(prob, b, tol=args.tol, max_iter=args.max_iter,
                              fault=fault)
        _sync(device)
        dt = time.perf_counter() - t0
        for a in res.attempts:
            say(f"attempt rung={a.rung} columns={list(a.columns)} "
                f"status={[SolveStatus(int(s)).name for s in a.status]} "
                f"true_residual="
                f"{np.array2string(a.true_residual, precision=2)}")
        say(f"resilient: converged={res.converged} rung={list(res.rung)}")
    else:
        def run():
            return nekbone.solve(prob, b, tol=args.tol,
                                 max_iter=args.max_iter, fault=fault)

        run()       # warm-up: kernel build, graph capture (one device)
        _sync(device)
        t0 = time.perf_counter()
        res = run()
        _sync(device)
        dt = time.perf_counter() - t0

    iters_all = [int(i) for i in np.ravel(_host(res.iterations))]
    iters = max(iters_all)
    err = nekbone.manufactured_error(prob, res.x, x_true)
    # useful FLOPs: each column pays for the iterations it ran
    flops = sum(nekbone.flop_count(mesh, args.d, helm, it)
                for it in iters_all)
    status = [SolveStatus(int(s)).name for s in np.ravel(_host(res.status))]
    msg = (f"status={status if len(status) > 1 else status[0]} "
           f"iters={iters} error={err:.2e} wall={dt:.3f}s "
           f"GFLOPS={flops / dt / 1e9:.2f} "
           f"GDOFS={mesh.n_global * args.d * sum(iters_all) / dt / 1e9:.4f}")
    if args.nrhs > 1:
        msg += f" iters/column={iters_all} wall/rhs={dt / args.nrhs:.3f}s"
    say(f"{msg} device={name}")


if __name__ == "__main__":
    main()
