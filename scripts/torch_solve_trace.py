#!/usr/bin/env python3
"""Where the time of the port's Nekbone solve goes, on one CUDA device.

For each axhelm variant, on the Nekbone config mesh (16x16x16, N=7,
Poisson, fp32, Jacobi) through the CUDA kernels, one solve of
`--trace-iter` iterations under torch.profiler, after a warm-up solve:
device kernel time by kernel name, kernels launched per iteration, and
the device's busy and idle share of the span from its first kernel to its
last.  (The solve's ms per iteration is timed by chip_smoke.py, phase 5.)

Prints one JSON line per variant, then the card's nvidia-smi name and
power limit.  Needs a CUDA device; imports neither jax nor the reference
package.

Run:  python3 scripts/torch_solve_trace.py [--trace-iter 40]
"""

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace-iter", type=int, default=40)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_solve_trace: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.nekbone import CONFIG
    from repro_torch.core import mesh_gen, nekbone

    mesh = mesh_gen.deform_trilinear(
        mesh_gen.box_mesh(*CONFIG.elements, CONFIG.order), seed=3)
    for variant in ("trilinear", "precomputed"):
        prob = nekbone.setup_problem(mesh, variant=variant, backend="cuda")
        x_true = nekbone.random_solution(prob, seed=0)
        b = nekbone.rhs_from_solution(prob, x_true)

        def run(max_iter):
            res = nekbone.solve(prob, b, tol=CONFIG.tol, max_iter=max_iter)
            torch.cuda.synchronize()
            return res

        run(args.trace_iter)                                 # warm-up
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = run(args.trace_iter)
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        line = {"variant": variant,
                "iterations": int(res.iterations), "host_wall_ms": wall_ms}
        if not kernels:
            line["device"] = "not measured: the profiler saw no CUDA kernels"
        else:
            by_name = defaultdict(lambda: [0, 0.0])
            for e in kernels:
                by_name[e.name][0] += 1
                by_name[e.name][1] += e.time_range.elapsed_us()
            busy = sum(t for _, t in by_name.values())
            span = (max(e.time_range.end for e in kernels)
                    - min(e.time_range.start for e in kernels))
            top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
            line.update({
                "kernels_launched": len(kernels),
                "kernels_per_iteration": len(kernels) / int(res.iterations),
                "device_busy_us": busy, "device_span_us": span,
                "device_busy_share": busy / span,
                "device_idle_share": 1 - busy / span,
                "top_kernels": [{"name": n[:90], "count": c, "us": t}
                                for n, (c, t) in top]})
        print(json.dumps(line), flush=True)
        del prob, b, x_true
        torch.cuda.empty_cache()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
