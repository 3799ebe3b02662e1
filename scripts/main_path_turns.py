#!/usr/bin/env python3
"""The 16^3 fp32 main paths of two source trees, in turns, on one GPU.

Runs what `chip_smoke.py` phase 5 times, for two checkouts of this
repository (e.g. a `git archive` of an earlier commit unpacked into a
gitignored directory, and the working tree), each in a process of its own
with the tree's `src` first on the path, in the order old, new, new, old.
Each process builds its tree's kernels (cached under the tree's `build/`),
then for each of the six main paths (as the tree runs them: a tree with
`repro_torch.core.graphs` replays its PCG loops as CUDA graphs) (the five variants on their main
equation, and trilinear Helmholtz) sets up the 16^3 N=7 problem of
`configs/nekbone.py` through the kernels, solves it once to warm up and
times 7 solves (host clock around each solve, ending in `synchronize()`):
ms per PCG iteration, median and quartiles, with the status and the
iterations.  A solve whose entry point was not launched once per operator
application fails the run.  Then the wrapper's host time: for each
variant, `ops.axhelm` called WRAPPER_CALLS times back to back on 64
elements at N=7 (whose kernel takes a few microseconds, so the host sets
the pace), host clock over the calls ending in `synchronize()`, the
median of 5 such runs in microseconds a call.  Then each entry point's
kernel time at N1 = 4 and 8 (orders 3 and 7 on the 16^3 box, E = 4096, c =
1, its main equation with setup's scalar lambdas, fp32 and bf16): a CUDA
graph of 50 calls, the median of 5 replays (the tree's own
`chip_smoke.graph_ms`).  Prints one JSON line per process and writes them
all to main_path_turns.json in the output directory.

Run:  python3 scripts/main_path_turns.py OLD_TREE NEW_TREE
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPEATS = 7
WRAPPER_CALLS = 2000
VARIANTS = ("precomputed", "trilinear", "parallelepiped", "merged", "partial")
# (variant, helmholtz): each variant's main equation, and trilinear
# Helmholtz (merged's yardstick), as chip_smoke.py's phase 5 runs them
PATHS = [(v, v == "merged") for v in VARIANTS] + [("trilinear", True)]


def worker(tree: Path) -> dict:
    """The main paths of one tree, in this process."""
    sys.path.insert(0, str(tree / "src"))
    import torch

    from repro_torch.configs.nekbone import CONFIG
    from repro_torch.core import axhelm as core_axhelm
    from repro_torch.core import mesh_gen, nekbone
    from repro_torch.core.spectral import basis
    from repro_torch.kernels.axhelm import build, ops
    from repro_torch.resilience.status import SolveStatus
    try:    # a tree whose launches count once per graph replay
        from repro_torch.core.graphs import count
    except ImportError:
        def count(counter, key):
            counter[key] += 1

    t0 = time.perf_counter()
    build.library()
    out = {"tree": str(tree), "build_s": time.perf_counter() - t0,
           "paths": {}}
    box = mesh_gen.box_mesh(*CONFIG.elements, CONFIG.order)
    meshes = {"affine": mesh_gen.deform_affine(box, seed=2),
              "trilinear": mesh_gen.deform_trilinear(box, seed=3)}
    for variant, helm in PATHS:
        mesh = meshes["affine" if variant == "parallelepiped"
                      else "trilinear"]
        prob = nekbone.setup_problem(mesh, variant=variant, helmholtz=helm,
                                     backend="cuda")
        applications = {"n": 0}
        op = prob.op

        def counted(x, _op=op):
            count(applications, "n")
            return _op(x)
        prob = prob._replace(op=counted)
        b = nekbone.rhs_from_solution(prob,
                                      nekbone.random_solution(prob, seed=0))
        nekbone.solve(prob, b, tol=CONFIG.tol, max_iter=CONFIG.max_iter)
        walls = []
        for _ in range(REPEATS):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            applications["n"] = 0
            t = time.perf_counter()
            res = nekbone.solve(prob, b, tol=CONFIG.tol,
                                max_iter=CONFIG.max_iter)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            name = ops.entry_point(variant, torch.float32)
            if ops.launch_counts[name] != applications["n"] or \
                    applications["n"] == 0:
                raise SystemExit(f"{tree}: {variant}: {name} launched "
                                 f"{ops.launch_counts[name]} times for "
                                 f"{applications['n']} applications")
        iters = int(res.iterations)
        ms = sorted(w * 1e3 / max(iters, 1) for w in walls)
        q1, med, q3 = statistics.quantiles(ms, n=4)
        out["paths"][f"{variant}/{'helmholtz' if helm else 'poisson'}"] = {
            "status": SolveStatus(int(res.status)).name,
            "iterations": iters, "ms_per_iteration": med,
            "ms_per_iteration_q1": q1, "ms_per_iteration_q3": q3}
    out["wrapper_us"] = {}
    b = basis(CONFIG.order)
    small = mesh_gen.deform_trilinear(mesh_gen.box_mesh(4, 4, 4,
                                                        CONFIG.order), seed=3)
    verts = torch.as_tensor(small.verts, dtype=torch.float32, device="cuda")
    x = torch.randn((len(small.verts),) + (b.n1,) * 3, device="cuda")
    for variant in VARIANTS:
        helm = variant == "merged"
        elem_ops, _, _ = core_axhelm.make_axhelm_elem_ops(
            variant, b, verts, helmholtz=helm, backend="cuda", device="cuda")
        geom = elem_ops.pop("geom")
        runs = []
        for _ in range(6):                     # the first one warms up
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(WRAPPER_CALLS):
                ops.axhelm(x, b, variant, geom, helmholtz=helm, **elem_ops)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t) / WRAPPER_CALLS * 1e6)
        out["wrapper_us"][variant] = statistics.median(runs[1:])
    sys.path.insert(0, str(tree))
    from chip_smoke import graph_ms

    out["kernel_us"] = {}
    for order in (3, 7):
        b = basis(order)
        box = mesh_gen.box_mesh(*CONFIG.elements, order)
        meshes = {"affine": mesh_gen.deform_affine(box, seed=2),
                  "trilinear": mesh_gen.deform_trilinear(box, seed=3)}
        gen = torch.Generator(device="cuda").manual_seed(order)
        x32 = torch.randn((len(box.verts),) + (b.n1,) * 3, generator=gen,
                          device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            for variant in VARIANTS:
                helm = variant == "merged"
                mesh = meshes["affine" if variant == "parallelepiped"
                              else "trilinear"]
                verts = torch.as_tensor(mesh.verts, dtype=torch.float32,
                                        device="cuda")
                lams = {"lam0": 1.0, "lam1": 0.1} if helm else {}
                elem_ops, _, _ = core_axhelm.make_axhelm_elem_ops(
                    variant, b, verts, helmholtz=helm, dtype=dtype,
                    backend="cuda", device="cuda", **lams)
                geom = elem_ops.pop("geom")
                x = x32.to(dtype)
                key = f"{ops.entry_point(variant, dtype)}/N1={b.n1}"
                out["kernel_us"][key] = 1e3 * graph_ms(
                    lambda: ops.axhelm(x, b, variant, geom, helmholtz=helm,
                                       **elem_ops))
                del geom, elem_ops, x
    return out


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        print(json.dumps(worker(Path(sys.argv[2]).resolve())), flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("main_path_turns: no CUDA device")
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    old, new = (Path(a).resolve() for a in sys.argv[1:])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    lines = [{"card": smi, "order": ["old", "new", "new", "old"],
              "old": str(old), "new": str(new)}]
    print(json.dumps(lines[0]), flush=True)
    for label, tree in (("old", old), ("new", new), ("new", new),
                        ("old", old)):
        run = subprocess.run([sys.executable, __file__, "--worker",
                              str(tree)], capture_output=True, text=True,
                             check=False)
        if run.returncode != 0:
            sys.exit(f"{label} tree {tree} failed:\n{run.stderr[-3000:]}")
        line = dict(json.loads(run.stdout.strip().splitlines()[-1]),
                    label=label)
        lines.append(line)
        print(json.dumps(line), flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "main_path_turns.json").write_text(
        json.dumps(lines, indent=1))


if __name__ == "__main__":
    main()
