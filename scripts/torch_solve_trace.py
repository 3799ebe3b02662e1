#!/usr/bin/env python3
"""Where the time of the port's Nekbone solve goes, on one CUDA device:
the captured solve (its PCG loops replayed as CUDA graphs, as users run
it) beside the same solve run eagerly.

For each axhelm variant's main path on the Nekbone config mesh (16x16x16,
N=7, fp32, Jacobi) through the CUDA kernels — precomputed, trilinear and
partial Poisson, parallelepiped Poisson on the affinely deformed box,
merged and trilinear Helmholtz, and trilinear Poisson with 4 stacked
right-hand sides (block PCG) — one solve of `--trace-iter` iterations of
each mode under torch.profiler, after a warm-up solve of each (the
captured one captures the loop); then the bf16 slice's main path, the
`bf16_x32` trilinear Poisson solve at nrhs 1 and 4 with b of
`nekbone.random_rhs` (norm 30 a column) to tol 3.0, one whole refined
solve (one sweep) of each mode.  Per solve: the device's kernels an
iteration and its kernel time by name, the host's launch calls an
iteration (the runtime's kernel and graph launches the profiler records on
the CPU), and the device's busy and idle share of the span from its first
kernel to its last.  The profiler's tracing slows graph replays, so each
solve also runs once unprofiled, just before: its host wall (ending in a
synchronize) gives ``device_idle_share_unprofiled`` = 1 - profiled kernel
time / unprofiled wall, and for the captured solve CUDA events recorded
around each graph replay give the replays' device time and the idle share
between the first replay's start and the last one's end.  (The solve's ms
per iteration is timed by chip_smoke.py, phase 5c.)

Prints one JSON line per solve, then the card's nvidia-smi name and
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
# the CUDA API calls that put kernels or graphs on the device
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")


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
    from repro_torch.core import graphs, mesh_gen, nekbone

    replay_events = []
    plain_replay = graphs.GraphCache.replay

    def timed_replay(self, graph):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        plain_replay(self, graph)
        stop.record()
        replay_events.append((start, stop))

    graphs.GraphCache.replay = timed_replay

    box = mesh_gen.box_mesh(*CONFIG.elements, CONFIG.order)
    meshes = {"trilinear": mesh_gen.deform_trilinear(box, seed=3),
              "affine": mesh_gen.deform_affine(box, seed=2)}
    # (variant, helmholtz, precision, nrhs)
    runs = [("trilinear", False, None, 1), ("precomputed", False, None, 1),
            ("parallelepiped", False, None, 1), ("partial", False, None, 1),
            ("merged", True, None, 1), ("trilinear", True, None, 1),
            ("trilinear", False, None, 4),
            ("trilinear", False, "bf16_x32", 1),
            ("trilinear", False, "bf16_x32", 4)]
    for variant, helm, precision, nrhs in runs:
        mesh = meshes["affine" if variant == "parallelepiped"
                      else "trilinear"]
        prob = nekbone.setup_problem(mesh, variant=variant, helmholtz=helm,
                                     backend="cuda", precision=precision)
        if precision is None:
            x_true = nekbone.random_solution(prob, seed=0, nrhs=nrhs)
            b = nekbone.rhs_from_solution(prob, x_true)
            tol = CONFIG.tol
        else:
            b = nekbone.random_rhs(prob, nrhs=nrhs)
            tol = 3.0
        max_iter = args.trace_iter if precision is None else 3000

        def run(capture):
            res = nekbone.solve(prob, b, tol=tol, max_iter=max_iter,
                                capture=capture)
            torch.cuda.synchronize()
            return res

        for capture in (False, True):
            run(capture)                     # warm-up; captures the loops
        for capture in (False, True):
            replay_events.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(capture)
            plain_wall_ms = (time.perf_counter() - t0) * 1e3
            replay_us = [1e3 * s.elapsed_time(e) for s, e in replay_events]
            replay_span_us = 1e3 * replay_events[0][0].elapsed_time(
                replay_events[-1][1]) if replay_events else 0.0
            replay_events.clear()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                res = run(capture)
                wall_ms = (time.perf_counter() - t0) * 1e3
            events = prof.events()
            kernels = [e for e in events if e.device_type == DeviceType.CUDA]
            launches = [e for e in events if e.device_type == DeviceType.CPU
                        and e.name in LAUNCH_CALLS]
            iterations = int(res.iterations.max())
            line = {"variant": variant,
                    "equation": "helmholtz" if helm else "poisson",
                    "precision": precision or "fp32", "nrhs": nrhs,
                    "mode": "captured" if capture else "eager",
                    "iterations": iterations, "host_wall_ms": wall_ms,
                    "host_wall_ms_unprofiled": plain_wall_ms,
                    "host_launch_calls": len(launches),
                    "host_launch_calls_per_iteration":
                        len(launches) / iterations,
                    "host_launch_calls_by_name": {
                        n: sum(e.name == n for e in launches)
                        for n in sorted({e.name for e in launches})}}
            if not kernels:
                line["device"] = ("not measured: the profiler saw no CUDA "
                                  "kernels")
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
                    "kernels_per_iteration": len(kernels) / iterations,
                    "device_busy_us": busy, "device_span_us": span,
                    "device_busy_share": busy / span,
                    "device_idle_share": 1 - busy / span,
                    "device_idle_share_unprofiled":
                        1 - busy / (plain_wall_ms * 1e3),
                    "top_kernels": [{"name": n[:90], "count": c, "us": t}
                                    for n, (c, t) in top]})
            if capture:
                line["replays"] = len(replay_us)
                if replay_us:
                    line.update({
                        "replay_device_us": sum(replay_us),
                        "replay_span_us": replay_span_us,
                        "replay_idle_share":
                            1 - sum(replay_us) / replay_span_us,
                        "replay_us_per_iteration":
                            sum(replay_us) / iterations})
            print(json.dumps(line), flush=True)
        del prob, b
        torch.cuda.empty_cache()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
