#!/usr/bin/env python3
"""The JAX reference's mixed-precision `bf16_x32` solves at 8x8x8, N=7, on
the CPU: the yardstick for the port's `chip_smoke.py` phase 4b.

Runs `repro.core.nekbone` (the JAX package, not the port) with
`precision="bf16_x32"` on the meshes and right-hand side of phase 4b —
trilinear-deformed box (`deform_trilinear(seed=3)`; the affine box
`deform_affine(seed=2)` for parallelepiped), b standard normal from numpy
seed 0, zero on the Dirichlet mask, each column normalised to 30,
`max_iter` 3000 — and prints one JSON line per case: the status and
iterations of every column and the fp32 true residual ||b - A x||.  The
Pallas kernel runs in interpret mode off a TPU, so a case takes tens of
seconds to minutes.

Run:  PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_refine.py \
          [--backend pallas] [--cases trilinear trilinear/nrhs4 ...]
"""

import argparse
import json
import time

import jax.numpy as jnp
import numpy as np

from repro.core import mesh_gen, nekbone
from repro.resilience.status import SolveStatus

# name -> (variant, helmholtz, dirichlet, nrhs, tol), as chip_smoke.py 4b
CASES = {
    "trilinear": ("trilinear", False, True, 1, 0.03),
    "trilinear/nrhs4": ("trilinear", False, True, 4, 0.03),
    "partial": ("partial", False, True, 1, 0.03),
    "parallelepiped": ("parallelepiped", False, True, 1, 0.03),
    "merged": ("merged", True, True, 1, 0.03),
    "trilinear/helmholtz_unmasked": ("trilinear", True, False, 1, 0.03),
    "trilinear/tol1e-4": ("trilinear", False, True, 1, 1e-4),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default="pallas",
                    choices=["pallas", "reference"])
    ap.add_argument("--cases", nargs="+", default=list(CASES),
                    choices=list(CASES))
    args = ap.parse_args(argv)
    box = mesh_gen.box_mesh(8, 8, 8, 7)
    meshes = {"trilinear": mesh_gen.deform_trilinear(box, seed=3),
              "affine": mesh_gen.deform_affine(box, seed=2)}
    for name in args.cases:
        variant, helm, dirichlet, nrhs, tol = CASES[name]
        mesh = meshes["affine" if variant == "parallelepiped"
                      else "trilinear"]
        shape = (mesh.n_global,) if nrhs == 1 else (mesh.n_global, nrhs)
        b = np.random.default_rng(0).standard_normal(shape).astype(
            np.float32)
        b[np.asarray(mesh.boundary)] = 0.0
        b = jnp.asarray(b / np.linalg.norm(b, axis=0) * 30.0)
        kw = dict(variant=variant, helmholtz=helm, dirichlet=dirichlet)
        t0 = time.perf_counter()
        prob = nekbone.setup_problem(mesh, backend=args.backend,
                                     precision="bf16_x32", **kw)
        res = nekbone.solve(prob, b, tol=tol, max_iter=3000)
        hi = nekbone.setup_problem(mesh, backend="reference", **kw)
        true = jnp.linalg.norm(b - hi.op(res.x), axis=0)
        print(json.dumps({
            "case": name, "backend": args.backend, "tol": tol,
            "status": [SolveStatus(int(s)).name
                       for s in np.atleast_1d(np.asarray(res.status))],
            "iterations": np.atleast_1d(np.asarray(res.iterations)).tolist(),
            "true_residual": np.atleast_1d(np.asarray(true)).tolist(),
            "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
