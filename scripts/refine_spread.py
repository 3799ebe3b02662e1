#!/usr/bin/env python3
"""Spread of the port's `bf16_x32` refined solve: the solves of
`chip_smoke.py` phases 4b and 5b (its `REFINE_CASES_8` and
`CONFIG_BF16_RUNS`), repeated through the bf16 kernels and the plain
reference backend, and solved once by each of the plain version's other
roundings (`chip_smoke.witnesses`: the correctly rounded operator and
re-rounded ones).

The gather sums in a fixed order, so a repeat gives the same bits; near
refinement's envelope a one-ulp change in a few outputs of the bf16
operator moves the sweep at which the true residual stops improving, which
is what the witnesses sample.  The kernels' and the plain version's solves
run as users run them (captured on a card); the witnesses run eagerly, as
their re-rounding draws from a generator of their own.  Prints one JSON
line per case and solver: the status, iterations and fp32 true residual of
every repeat.  `--device cpu` runs the 8^3 cases on the CPU (plain version
only; no kernels there).

Run:  python3 scripts/refine_spread.py [--device cuda] [--repeats 8]
          [--witnesses 6] [--sizes 8 16]
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--repeats", type=int, default=8,
                    help="solves of each case per backend")
    ap.add_argument("--witnesses", type=int, default=6,
                    help="re-rounded witnesses (seeds 0..n-1)")
    ap.add_argument("--sizes", type=int, nargs="+", default=[8, 16],
                    choices=(8, 16))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from repro_torch.core import mesh_gen, nekbone
    from repro_torch.resilience.status import SolveStatus

    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("refine_spread.py: no CUDA device (pass --device cpu)")
    if args.device == "cpu" and 16 in args.sizes:
        sys.exit("refine_spread.py: the 16^3 cases run on a card only")
    chip_smoke.WITNESS_SEEDS = args.witnesses
    # (name, variant, mesh, helmholtz, dirichlet, nrhs, tol, elements)
    cases = []
    if 8 in args.sizes:
        cases += [(f"8^3 {name}", *rest, 8)
                  for name, *rest in chip_smoke.REFINE_CASES_8]
    if 16 in args.sizes:
        cases += [(f"16^3 nrhs={nrhs} tol={tol}", "trilinear", "trilinear",
                   False, True, nrhs, tol, 16)
                  for nrhs, tol in chip_smoke.CONFIG_BF16_RUNS
                  if tol != 3.0]
    solvers = [("kernels", "cuda", None)] if args.device == "cuda" else []
    solvers += [("reference", "reference", None)]
    meshes = {}
    for name, variant, mesh_name, helm, dirichlet, nrhs, tol, n in cases:
        if (mesh_name, n) not in meshes:
            box = mesh_gen.box_mesh(n, n, n, 7)
            meshes[mesh_name, n] = mesh_gen.deform_affine(box, seed=2) \
                if mesh_name == "affine" else \
                mesh_gen.deform_trilinear(box, seed=3)
        mesh = meshes[mesh_name, n]
        for solver, backend, plain in solvers + [
                (w, "reference", fn) for w, fn in chip_smoke.witnesses()]:
            with chip_smoke.plain_version(plain):
                prob = nekbone.setup_problem(
                    mesh, variant=variant, helmholtz=helm,
                    dirichlet=dirichlet, backend=backend,
                    precision="bf16_x32", device=args.device)
            b = nekbone.random_rhs(prob, nrhs=nrhs)
            runs = []
            repeats = args.repeats if plain is None else 1
            for _ in range(repeats):
                res = nekbone.solve(prob, b, tol=tol, max_iter=3000,
                                    capture=False if plain else None)
                true = torch.linalg.norm(b - prob.op(res.x), dim=0)
                runs.append({
                    "status": [SolveStatus(int(s)).name
                               for s in res.status.reshape(-1)],
                    "iterations": res.iterations.reshape(-1).tolist(),
                    "true_residual": true.reshape(-1).tolist()})
            print(json.dumps({"case": name, "solver": solver, "tol": tol,
                              "device": args.device,
                              "runs": runs}), flush=True)
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=False)
        print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
