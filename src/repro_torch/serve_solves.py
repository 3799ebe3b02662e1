"""Serve Nekbone solves through the port's bucketed batching service (the
reference's `examples/serve_solves.py`).

Warms the bucket ladder once — every width's block solver loops captured
as CUDA graphs on a card (built, on the CPU), and its verification
operator — then submits a bursty stream of right-hand sides and drains
it, printing the warm-up's count, what the stream captured after it (the
gate: 0), p50/p95 wall time and the first requests' status, iterations,
true residual and queue/solve split.

Run:  PYTHONPATH=src python -m repro_torch.serve_solves [--nx 3]
          [--order 4] [--max-batch 8] [--requests 20] [--tol 1e-6]
          [--variant trilinear] [--precision fp32] [--device cuda]

The mesh is an nx x nx x 1 box, trilinearly deformed (affinely for
parallelepiped); merged solves Helmholtz, every other variant Dirichlet
Poisson.  --precision bf16_x32 serves the mixed-precision solve (and warms
its precision:float32 fallback ladder).  The service runs on the card
unless --device cpu is given; with no card it raises.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import mesh_gen, nekbone
from repro_torch.serving.solve_service import SolveRequest, SolveService


def _parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=3)
    ap.add_argument("--order", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--variant", default="trilinear",
                    choices=["precomputed", "trilinear", "parallelepiped",
                             "merged", "partial"])
    ap.add_argument("--precision", default="fp32",
                    choices=["fp32", "bf16_x32"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    return ap.parse_args(argv)


def main(argv=None):
    args = _parse_args(argv)
    device = nekbone.resolve_device(args.device)
    box = mesh_gen.box_mesh(args.nx, args.nx, 1, args.order)
    mesh = mesh_gen.deform_affine(box, seed=2) \
        if args.variant == "parallelepiped" \
        else mesh_gen.deform_trilinear(box, seed=3)
    prob = nekbone.setup_problem(
        mesh, variant=args.variant, helmholtz=args.variant == "merged",
        device=device,
        precision=None if args.precision == "fp32" else args.precision)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"mesh: E={len(mesh.verts)} N={args.order} dofs={mesh.n_global} "
          f"variant={args.variant} precision={args.precision} "
          f"backend={prob.backend} device={device} ({name})", flush=True)
    svc = SolveService(prob, max_batch=args.max_batch, tol=args.tol,
                       max_iter=300)

    t0 = time.perf_counter()
    warm = svc.warmup()
    made = "captures" if device.type == "cuda" else "builds"
    print(f"warmup: {warm} {made} (bucket ladder {svc.cache.buckets}) in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)

    rng = np.random.default_rng(0)
    reqs = []
    while len(reqs) < args.requests:
        # bursty arrivals: queue depths wander over 1..max_batch
        for _ in range(min(int(rng.integers(1, args.max_batch + 1)),
                           args.requests - len(reqs))):
            b = nekbone.rhs_from_solution(prob, torch.as_tensor(
                rng.standard_normal(mesh.n_global), dtype=torch.float32,
                device=device))
            req = SolveRequest(uid=len(reqs), b=b)
            svc.submit(req)
            reqs.append(req)
        svc.step()
    svc.run_until_drained()

    walls = np.array([r.wall_s for r in reqs]) * 1e3
    print(f"served {len(reqs)} requests, {svc.trace_count - warm} new "
          f"{made} after warmup (gate: 0), errors={svc.errors}, "
          f"p50={np.percentile(walls, 50):.1f}ms "
          f"p95={np.percentile(walls, 95):.1f}ms", flush=True)
    for r in reqs[:4]:
        if r.report is None:
            print(f"  req {r.uid}: ERROR {r.error}")
            continue
        print(f"  req {r.uid}: {'ok' if r.report.converged else 'FAIL'} "
              f"rung={r.report.rung[0]} "
              f"iters={int(r.report.iterations[0])} "
              f"true_res={float(r.report.true_residual[0]):.2e} "
              f"queue={r.queue_s * 1e3:.1f}ms solve={r.solve_s * 1e3:.1f}ms")


if __name__ == "__main__":
    main()
