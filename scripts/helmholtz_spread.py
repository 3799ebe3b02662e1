#!/usr/bin/env python3
"""Spread of unmasked Helmholtz over one-ulp roundings of its operator.

The 2x1x1 order-31 box of `chip_smoke.py` phase `high_order` (its
`HIGH_ORDER_SMALL_BOX`, tol `HIGH_ORDER_TOL`), unmasked merged Helmholtz
and trilinear Helmholtz, fp32: the solve through the kernels (as users run
it), through the plain version (the reference backend), and through
witnesses of the plain version -- its arithmetic in float64 rounded once to
fp32 (the correctly rounded operator), then that result with a share of
its inexact outputs moved to their other fp32 neighbour (`--rates`, seeds
0..`--seeds`-1; a kernel that sums in another order than the plain
version's einsums differs from it in many outputs by an ulp or more).
Where the kernels' iterations fall among the members' says whether they
differ from the plain version by more than the rounding of its sums does.
Prints one JSON line a solve, then the card line.  `--device cpu` runs the
plain version and its witnesses only.

Run:  python3 scripts/helmholtz_spread.py [--device cuda] [--seeds 4]
          [--rates 0.01 0.1 0.5]
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the Helmholtz paths of phase `high_order`, both on its trilinear mesh
PATHS = ("merged", "trilinear")


def fp32_witness(flip_rate: float = 0.0, seed: int = 0):
    """A stand-in for `ops.reference` at float32 storage: its arithmetic
    in float64, rounded once, then a random `flip_rate` share of the
    outputs that were not exact (numbers from torch `seed`) moved one ulp
    to their other fp32 neighbour."""
    import torch

    from repro_torch.kernels.axhelm import ops

    gens = {}

    def witness(x, basis, variant, geom, lam0=None, lam1=None,
                helmholtz=False):
        y = ops.unrounded(x, basis, variant, geom, lam0, lam1, helmholtz,
                          compute=torch.float64)
        y32 = y.to(torch.float32)
        if not flip_rate:
            return y32
        if x.device not in gens:
            gens[x.device] = torch.Generator(device=x.device).manual_seed(
                seed)
        wide = y32.to(torch.float64)
        toward = torch.where(y > wide, torch.full_like(y32, float("inf")),
                             torch.full_like(y32, -float("inf")))
        flip = (y != wide) & (torch.rand(y32.shape, generator=gens[x.device],
                                         device=x.device) < flip_rate)
        return torch.where(flip, torch.nextafter(y32, toward), y32)

    return witness


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--rates", type=float, nargs="+",
                    default=[0.01, 0.1, 0.5])
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from repro_torch.core import mesh_gen, nekbone
    from repro_torch.resilience.status import SolveStatus

    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("helmholtz_spread.py: no CUDA device (pass --device cpu)")
    box = mesh_gen.box_mesh(*chip_smoke.HIGH_ORDER_SMALL_BOX,
                            chip_smoke.HIGH_ORDER)
    mesh = mesh_gen.deform_trilinear(box, seed=3)
    members = [("kernels", "cuda", None)] if args.device == "cuda" else []
    members += [("reference", "reference", None),
                ("correctly_rounded", "reference", fp32_witness())]
    members += [(f"rerounded_rate{r}_seed{s}", "reference",
                 fp32_witness(r, s))
                for r in args.rates for s in range(args.seeds)]
    for variant in PATHS:
        for name, backend, plain in members:
            with chip_smoke.plain_version(plain):
                prob = nekbone.setup_problem(
                    mesh, variant=variant, helmholtz=True, backend=backend,
                    device=args.device)
            b = nekbone.rhs_from_solution(
                prob, nekbone.random_solution(prob, seed=0))
            res = nekbone.solve(prob, b, tol=chip_smoke.HIGH_ORDER_TOL,
                                max_iter=chip_smoke.HIGH_ORDER_MAX_ITER,
                                capture=False if plain else None)
            print(json.dumps({
                "path": f"{variant}/helmholtz", "member": name,
                "order": chip_smoke.HIGH_ORDER, "device": args.device,
                "status": SolveStatus(int(res.status)).name,
                "iterations": int(res.iterations)}), flush=True)
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=False)
        print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
