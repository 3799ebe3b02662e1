#!/usr/bin/env python3
"""How far the sharded solve ends from the single-device one after a fixed
number of iterations: the spread the `sharded` phase of chip_smoke.py sets
its bounds from.

Solves the config's trilinear Dirichlet Poisson problem (fp32, Jacobi,
tol 1e-8, so every solve runs its whole iteration budget: MAXITER) on a
box of n^3 elements at order 7, once on one device (eagerly) and once on
gloo ranks for each shard count and grid (2 slab, 4 as the (2, 2, 1) box),
with the same right-hand side, and prints one JSON line per sharded solve:
the relative difference of the final residuals and the relative L2
distance of the iterates.  Different orders of summation (the interface
all-reduce, the owned dots) are the only difference between the solves.

Run:  PYTHONPATH=src python3 scripts/sharded_spread.py [--n 8] \
          [--iterations 200] [--device cuda|cpu]
(--device cuda, the default, runs the kernels on the card; --device cpu
their plain versions on the CPU).
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import mesh_gen, nekbone  # noqa: E402
from repro_torch.distributed.context import make_solver_ctx  # noqa: E402
from repro_torch.distributed.launch import spawn  # noqa: E402

TOL = 1e-8
SHARDINGS = ((2, None), (4, (2, 2, 1)))


def _mesh(n: int):
    return mesh_gen.deform_trilinear(mesh_gen.box_mesh(n, n, n, 7), seed=3)


def _rank(rank, world, grid, n, iterations, device, ref_path):
    if device == "cpu":
        torch.set_num_threads(1)
    ref = torch.load(ref_path)
    ctx = make_solver_ctx(devices=world, grid=grid,
                          device=None if device == "cuda" else device)
    prob = nekbone.setup_problem(_mesh(n), variant="trilinear",
                                 shard_ctx=ctx)
    res = nekbone.solve(prob, ref["b"].to(ctx.device), tol=TOL,
                        max_iter=iterations)
    x_ref = ref["x"].to(ctx.device)
    return {"shards": world, "grid": list(prob.partition.grid),
            "status": int(res.status), "iterations": int(res.iterations),
            "residual": float(res.residual),
            "residual_rel_diff": abs(float(res.residual) - ref["residual"])
            / ref["residual"],
            "x_rel_l2": float(torch.linalg.norm(res.x - x_ref)
                              / torch.linalg.norm(x_ref))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--iterations", type=int, default=200)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("sharded_spread.py: no CUDA device (pass --device cpu)")
    device = nekbone.resolve_device(args.device)
    prob = nekbone.setup_problem(_mesh(args.n), variant="trilinear",
                                 device=device)
    b = nekbone.rhs_from_solution(prob, nekbone.random_solution(prob))
    res = nekbone.solve(prob, b, tol=TOL, max_iter=args.iterations,
                        capture=False)
    print(json.dumps({"shards": 1, "device": str(device),
                      "status": int(res.status),
                      "iterations": int(res.iterations),
                      "residual": float(res.residual)}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = str(Path(tmp) / "ref.pt")
        torch.save({"b": b.cpu(), "x": res.x.cpu(),
                    "residual": float(res.residual)}, ref_path)
        for world, grid in SHARDINGS:
            rows = spawn(_rank, world, (grid, args.n, args.iterations,
                                        args.device, ref_path))
            print(json.dumps(rows[0]), flush=True)


if __name__ == "__main__":
    main()
