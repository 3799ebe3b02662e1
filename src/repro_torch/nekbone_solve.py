"""End-to-end Nekbone solve of the port (single device).

Solves Poisson/Helmholtz on a box of trilinear elements with Jacobi PCG and
the chosen axhelm variant; prints status / iterations / error / wall /
GFLOPS / GDOFS, like `examples/nekbone_solve.py` in the reference package.
Variants: precomputed, trilinear, parallelepiped (on an affinely deformed
box, whose elements are parallelepipeds), merged (Helmholtz only) and
partial (Poisson only).

Run:  PYTHONPATH=src python -m repro_torch.nekbone_solve \
          [--elements 4 4 4] [--order 7] [--variant trilinear] \
          [--equation poisson] [--d 1] [--nrhs 1] [--backend auto] \
          [--device cuda]

--nrhs R solves R stacked right-hand sides with block PCG (1 is the exact
single-RHS path) and adds iters/column and wall/rhs to the result line.

--backend auto drives the hand-written CUDA axhelm kernel inside the PCG
loop on a card and the plain PyTorch reference on the CPU.  --device
defaults to the card; --device cpu runs the whole solve on the CPU.  On
the card the PCG loop runs as a replayed CUDA graph, captured by the
warm-up solve.

--inject MODE@ITER corrupts one operator application inside the loop
(`resilience.inject.FaultSpec`: nan@3, bitflip@2); --resilient solves
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
                         "application, e.g. 'nan@3' or 'bitflip@2'")
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
    fault = None
    if args.inject is not None:
        mode, _, it = args.inject.partition("@")
        fault = FaultSpec(mode=mode, iteration=int(it) if it else 3)
    device = nekbone.resolve_device(args.device)
    helm = args.equation == "helmholtz"
    nx, ny, nz = args.elements
    mesh = mesh_gen.box_mesh(nx, ny, nz, args.order)
    if args.variant == "parallelepiped":
        mesh = mesh_gen.deform_affine(mesh, seed=2)
    else:
        mesh = mesh_gen.deform_trilinear(mesh, seed=3)
    print(f"mesh: E={len(mesh.verts)} N={args.order} dofs={mesh.n_global} "
          f"variant={args.variant} eq={args.equation} d={args.d} "
          f"nrhs={args.nrhs}")
    prob = nekbone.setup_problem(mesh, variant=args.variant, d=args.d,
                                 helmholtz=helm, backend=args.backend,
                                 device=device, nrhs=args.nrhs)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"backend={prob.backend} device={device} ({name})")
    x_true = nekbone.random_solution(prob, seed=0, nrhs=args.nrhs)
    b = nekbone.rhs_from_solution(prob, x_true)

    if args.resilient:
        t0 = time.perf_counter()
        res = solve_resilient(prob, b, tol=args.tol, max_iter=args.max_iter,
                              fault=fault)
        _sync(device)
        dt = time.perf_counter() - t0
        for a in res.attempts:
            print(f"attempt rung={a.rung} columns={list(a.columns)} "
                  f"status={[SolveStatus(int(s)).name for s in a.status]} "
                  f"true_residual="
                  f"{np.array2string(a.true_residual, precision=2)}")
        print(f"resilient: converged={res.converged} rung={list(res.rung)}")
    else:
        def run():
            return nekbone.solve(prob, b, tol=args.tol,
                                 max_iter=args.max_iter, fault=fault)

        run()                   # warm-up: kernel build, graph capture
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
    print(f"{msg} device={name}")


if __name__ == "__main__":
    main()
