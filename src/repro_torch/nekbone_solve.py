"""End-to-end Nekbone solve of the port (single device).

Solves Poisson/Helmholtz on a box of trilinear elements with Jacobi PCG and
the chosen axhelm variant; prints status / iterations / error / wall /
GFLOPS / GDOFS, like `examples/nekbone_solve.py` in the reference package.

Run:  PYTHONPATH=src python -m repro_torch.nekbone_solve \
          [--elements 4 4 4] [--order 7] [--variant trilinear] \
          [--equation poisson] [--d 1] [--backend auto] [--device cuda]

--backend auto drives the hand-written CUDA axhelm kernel inside the PCG
loop on a card and the plain PyTorch reference on the CPU.  --device
defaults to the card; --device cpu runs the whole solve on the CPU.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import mesh_gen, nekbone
from repro_torch.resilience.status import SolveStatus


def _parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--elements", type=int, nargs=3, default=[4, 4, 4])
    ap.add_argument("--order", type=int, default=7)
    ap.add_argument("--variant", default="trilinear",
                    choices=["precomputed", "trilinear"])
    ap.add_argument("--equation", default="poisson",
                    choices=["poisson", "helmholtz"])
    ap.add_argument("--d", type=int, default=1, choices=[1, 3])
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--max-iter", type=int, default=400)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "reference", "cuda"],
                    help="element kernel: cuda (hand-written kernels), "
                         "reference (plain torch), or auto")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    args = _parse_args(argv)
    device = nekbone.resolve_device(args.device)
    helm = args.equation == "helmholtz"
    nx, ny, nz = args.elements
    mesh = mesh_gen.deform_trilinear(
        mesh_gen.box_mesh(nx, ny, nz, args.order), seed=3)
    print(f"mesh: E={len(mesh.verts)} N={args.order} dofs={mesh.n_global} "
          f"variant={args.variant} eq={args.equation} d={args.d}")
    prob = nekbone.setup_problem(mesh, variant=args.variant, d=args.d,
                                 helmholtz=helm, backend=args.backend,
                                 device=device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"backend={prob.backend} device={device} ({name})")
    x_true = nekbone.random_solution(prob, seed=0)
    b = nekbone.rhs_from_solution(prob, x_true)

    def run():
        return nekbone.solve(prob, b, tol=args.tol, max_iter=args.max_iter)

    run()                       # warm-up: kernel build, allocator
    _sync(device)
    t0 = time.perf_counter()
    res = run()
    _sync(device)
    dt = time.perf_counter() - t0

    iters = int(res.iterations)
    err = nekbone.manufactured_error(prob, res.x, x_true)
    flops = nekbone.flop_count(mesh, args.d, helm, iters)
    print(f"status={SolveStatus(int(res.status)).name} iters={iters} "
          f"error={err:.2e} wall={dt:.3f}s "
          f"GFLOPS={flops / dt / 1e9:.2f} "
          f"GDOFS={mesh.n_global * args.d * iters / dt / 1e9:.4f} "
          f"device={name}")


if __name__ == "__main__":
    main()
