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
`chip_smoke.graph_ms`).

With --orders (e.g. 24,31,47), each process also times the ten entry
points at each of those orders on the 4x4x4 box (E = 64, c = 1, the main
equation with setup's scalar lambdas, the same way) beside the staged
body's timing-only twin `ops.staged` on the same operands; runs the six
order-HIGH_ORDER main paths on the 4x4x4 box as it runs the 16^3 ones;
and runs the staged body at N1 = 49 (E = 64) and 64 (E = 8): each entry
point's output on a seeded x as a SHA-256 of its bytes, and its time.
With --staged, each process runs only the staged body: its times and
digests at N1 = 49 and 64 as --orders runs them, and the six order-63
main paths on the 2x2x2 box (2,048,383 dofs) as it runs the 16^3 ones.
With --generic, each process runs only orders 16 to 23: each entry point at
every N1 from 17 to 24 on the 6x6x6 box (E = 216, c = 1, the main equation
with setup's scalar lambdas) through the body the tree routes it to
(`ops.axhelm`), the generic body (`ops.generic`), the plane twin
(`ops.plane`) and, where the tree has it, the slab twin (`ops.slab`), the
four in turns on the same operands (routed, generic, plane, slab, then
back), each a CUDA graph of 50 calls; and the six order-19 main paths on
the 6x6x6 box (1,520,875 dofs) as it runs the 16^3 ones.
The last line sums the turns up: each tree's times as the mean of its two
runs, side by side.

Prints one JSON line per process and writes them all to
main_path_turns.json in the output directory.

Run:  python3 scripts/main_path_turns.py OLD_TREE NEW_TREE [--orders 24,31,47]
      python3 scripts/main_path_turns.py OLD_TREE NEW_TREE --staged
      python3 scripts/main_path_turns.py OLD_TREE NEW_TREE --generic
"""

import argparse
import hashlib
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
HIGH_BOX = (4, 4, 4)      # the box of --orders (E = 64)
HIGH_ORDER = 31           # the order of the main paths --orders adds
# the staged body's runs of --orders and --staged: (order, box)
STAGED_RUNS = ((48, (4, 4, 4)), (63, (2, 2, 2)))
# the box of the staged body's main paths (--staged)
STAGED_BOX = (2, 2, 2)
# --generic: the N1 it times, its box (E = 216) and its main paths' order
MIDDLE_N1 = tuple(range(17, 25))
MIDDLE_BOX = (6, 6, 6)
MIDDLE_ORDER = 19


def main_paths(meshes: dict) -> dict:
    """The six main paths on `meshes` (the affine and trilinear
    deformations of one box): per path the status, the iterations and the
    ms per iteration of REPEATS solves after a warm-up."""
    import torch

    from repro_torch.configs.nekbone import CONFIG
    from repro_torch.core import nekbone
    from repro_torch.kernels.axhelm import ops
    from repro_torch.resilience.status import SolveStatus
    try:    # a tree whose launches count once per graph replay
        from repro_torch.core.graphs import count
    except ImportError:
        def count(counter, key):
            counter[key] += 1

    paths = {}
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
                raise SystemExit(f"{variant}: {name} launched "
                                 f"{ops.launch_counts[name]} times for "
                                 f"{applications['n']} applications")
        iters = int(res.iterations)
        ms = sorted(w * 1e3 / max(iters, 1) for w in walls)
        q1, med, q3 = statistics.quantiles(ms, n=4)
        paths[f"{variant}/{'helmholtz' if helm else 'poisson'}"] = {
            "status": SolveStatus(int(res.status)).name,
            "iterations": iters, "ms_per_iteration": med,
            "ms_per_iteration_q1": q1, "ms_per_iteration_q3": q3}
        del prob, b
        torch.cuda.empty_cache()
    return paths


def worker(tree: Path, orders: tuple, staged_only: bool = False,
           middle_only: bool = False) -> dict:
    """The main paths of one tree, in this process."""
    sys.path.insert(0, str(tree / "src"))
    import torch

    from repro_torch.configs.nekbone import CONFIG
    from repro_torch.core import axhelm as core_axhelm
    from repro_torch.core import mesh_gen
    from repro_torch.core.spectral import basis
    from repro_torch.kernels.axhelm import build, ops

    t0 = time.perf_counter()
    build.library()
    out = {"tree": str(tree), "build_s": time.perf_counter() - t0}

    def meshes_of(box):
        return {"affine": mesh_gen.deform_affine(box, seed=2),
                "trilinear": mesh_gen.deform_trilinear(box, seed=3)}

    def operands(variant, dtype, b, meshes):
        """An entry point's geom and kwargs at basis b on `meshes`, its main
        equation with setup's scalar lambdas."""
        helm = variant == "merged"
        mesh = meshes["affine" if variant == "parallelepiped"
                      else "trilinear"]
        verts = torch.as_tensor(mesh.verts, dtype=torch.float32,
                                device="cuda")
        lams = {"lam0": 1.0, "lam1": 0.1} if helm else {}
        elem_ops, _, _ = core_axhelm.make_axhelm_elem_ops(
            variant, b, verts, helmholtz=helm, dtype=dtype, backend="cuda",
            device="cuda", **lams)
        return elem_ops.pop("geom"), dict(elem_ops, helmholtz=helm)

    def seeded_x(order, e, n1):
        gen = torch.Generator(device="cuda").manual_seed(order)
        return torch.randn((e,) + (n1,) * 3, generator=gen, device="cuda")

    def staged_runs() -> dict:
        """Each entry point on the staged body at STAGED_RUNS: the digest
        of its output on a seeded x, and its time."""
        runs = {}
        for order, box in STAGED_RUNS:
            b = basis(order)
            meshes = meshes_of(mesh_gen.box_mesh(*box, order))
            x32 = seeded_x(order, len(meshes["trilinear"].verts), b.n1)
            for dtype in (torch.float32, torch.bfloat16):
                for variant in VARIANTS:
                    geom, kw = operands(variant, dtype, b, meshes)
                    x = x32.to(dtype)
                    y = ops.axhelm(x, b, variant, geom, **kw)
                    torch.cuda.synchronize()
                    runs[f"{ops.entry_point(variant, dtype)}/"
                         f"N1={b.n1}"] = {
                        "body": ops.body_of(variant, b.n1),
                        "sha256": hashlib.sha256(
                            y.view(torch.uint8).cpu().numpy().tobytes())
                        .hexdigest(),
                        "us": 1e3 * graph_ms(
                            lambda: ops.axhelm(x, b, variant, geom, **kw))}
                    del geom, kw, x, y
            del x32
            torch.cuda.empty_cache()
        return runs

    sys.path.insert(0, str(tree))
    from chip_smoke import graph_ms

    if middle_only:
        out["middle_us"] = {}
        for n1 in MIDDLE_N1:
            b = basis(n1 - 1)
            meshes = meshes_of(mesh_gen.box_mesh(*MIDDLE_BOX, b.n))
            x32 = seeded_x(b.n, len(meshes["trilinear"].verts), n1)
            bodies = {"us": ops.axhelm, "generic_us": ops.generic,
                      "plane_us": ops.plane}
            if hasattr(ops, "slab"):
                bodies["slab_us"] = ops.slab
            for dtype in (torch.float32, torch.bfloat16):
                for variant in VARIANTS:
                    geom, kw = operands(variant, dtype, b, meshes)
                    x = x32.to(dtype)
                    row = {"body": ops.body_of(variant, n1)}
                    for name in list(bodies) + list(bodies)[::-1]:
                        us = 1e3 * graph_ms(lambda: bodies[name](
                            x, b, variant, geom, **kw))
                        row[name] = row.get(name, 0.0) + us / 2
                    out["middle_us"][f"{ops.entry_point(variant, dtype)}/"
                                     f"N1={n1}"] = row
                    del geom, kw, x
            del x32
            torch.cuda.empty_cache()
        out["middle_paths"] = main_paths(meshes_of(
            mesh_gen.box_mesh(*MIDDLE_BOX, MIDDLE_ORDER)))
        return out
    if staged_only:
        out["staged"] = staged_runs()
        out["staged_paths"] = main_paths(meshes_of(
            mesh_gen.box_mesh(*STAGED_BOX, STAGED_RUNS[-1][0])))
        return out
    out["paths"] = main_paths(meshes_of(
        mesh_gen.box_mesh(*CONFIG.elements, CONFIG.order)))
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

    out["kernel_us"] = {}
    for order in (3, 7):
        b = basis(order)
        meshes = meshes_of(mesh_gen.box_mesh(*CONFIG.elements, order))
        x32 = seeded_x(order, len(meshes["trilinear"].verts), b.n1)
        for dtype in (torch.float32, torch.bfloat16):
            for variant in VARIANTS:
                geom, kw = operands(variant, dtype, b, meshes)
                x = x32.to(dtype)
                key = f"{ops.entry_point(variant, dtype)}/N1={b.n1}"
                out["kernel_us"][key] = 1e3 * graph_ms(
                    lambda: ops.axhelm(x, b, variant, geom, **kw))
                del geom, kw, x
    if not orders:
        return out

    out["orders_us"] = {}
    for order in orders:
        b = basis(order)
        meshes = meshes_of(mesh_gen.box_mesh(*HIGH_BOX, order))
        x32 = seeded_x(order, len(meshes["trilinear"].verts), b.n1)
        for dtype in (torch.float32, torch.bfloat16):
            for variant in VARIANTS:
                geom, kw = operands(variant, dtype, b, meshes)
                x = x32.to(dtype)
                out["orders_us"][f"{ops.entry_point(variant, dtype)}/"
                                 f"N1={b.n1}"] = {
                    "body": ops.body_of(variant, b.n1),
                    "us": 1e3 * graph_ms(
                        lambda: ops.axhelm(x, b, variant, geom, **kw)),
                    "staged_us": 1e3 * graph_ms(
                        lambda: ops.staged(x, b, variant, geom, **kw))}
                del geom, kw, x
        del x32
        torch.cuda.empty_cache()
    out["high_order_paths"] = main_paths(meshes_of(
        mesh_gen.box_mesh(*HIGH_BOX, HIGH_ORDER)))
    out["staged"] = staged_runs()
    return out


def summary(lines: list) -> dict:
    """Each tree's numbers as the mean of its two runs, side by side."""
    runs = {label: [r for r in lines[1:] if r["label"] == label]
            for label in ("old", "new")}

    def mean(label, *path):
        vals = []
        for r in runs[label]:
            v = r
            for key in path:
                v = v.get(key) if isinstance(v, dict) else None
            if v is not None:
                vals.append(v)
        return statistics.fmean(vals) if len(vals) == 2 else None

    out = {"summary": "mean of each tree's two runs"}
    for section in ("orders_us", "staged"):
        keys = runs["new"][0].get(section, {})
        if not keys:
            continue
        out[section] = {key: {
            "old_us": mean("old", section, key, "us"),
            "new_us": mean("new", section, key, "us"),
            **({"staged_us": mean("new", section, key, "staged_us")}
               if section == "orders_us" else
               {"bitwise_same": len({r[section][key]["sha256"]
                                    for r in lines[1:]
                                    if key in r.get(section, {})}) == 1})}
            for key in keys}
    keys = runs["new"][0].get("middle_us", {})
    if keys:
        out["middle_us"] = {key: {
            "old_us": mean("old", "middle_us", key, "us"),
            "new_us": mean("new", "middle_us", key, "us"),
            "body": runs["new"][0]["middle_us"][key]["body"],
            **{f"{label}_{name}": mean(label, "middle_us", key, name)
               for label in ("old", "new")
               for name in ("generic_us", "plane_us")},
            "slab_us": mean("new", "middle_us", key, "slab_us")}
            for key in keys}
    for section in ("paths", "high_order_paths", "staged_paths",
                    "middle_paths"):
        keys = runs["new"][0].get(section, {})
        out[section] = {key: {
            label: mean(label, section, key, "ms_per_iteration")
            for label in ("old", "new")} for key in keys}
    out["kernel_us"] = {key: {label: mean(label, "kernel_us", key)
                              for label in ("old", "new")}
                        for key in runs["new"][0].get("kernel_us", {})}
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("old", nargs="?")
    parser.add_argument("new", nargs="?")
    parser.add_argument("--orders", default="",
                        help="comma-separated orders, e.g. 24,31,47")
    parser.add_argument("--staged", action="store_true",
                        help="only the staged body and its order-63 paths")
    parser.add_argument("--generic", action="store_true",
                        help="only orders 16-23: every entry point through "
                             "the routed, generic, plane and slab bodies, "
                             "and the order-19 paths")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_args()
    orders = tuple(int(o) for o in args.orders.split(",") if o)
    if args.worker:
        print(json.dumps(worker(Path(args.worker).resolve(), orders,
                                args.staged, args.generic)), flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("main_path_turns: no CUDA device")
    if args.old is None or args.new is None:
        sys.exit(__doc__)
    old, new = Path(args.old).resolve(), Path(args.new).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    lines = [{"card": smi, "order": ["old", "new", "new", "old"],
              "old": str(old), "new": str(new), "orders": orders,
              "staged_only": args.staged, "generic_only": args.generic}]
    print(json.dumps(lines[0]), flush=True)
    for label, tree in (("old", old), ("new", new), ("new", new),
                        ("old", old)):
        run = subprocess.run([sys.executable, __file__, "--worker",
                              str(tree), "--orders", args.orders]
                             + (["--staged"] if args.staged else [])
                             + (["--generic"] if args.generic else []),
                             capture_output=True, text=True, check=False)
        if run.returncode != 0:
            sys.exit(f"{label} tree {tree} failed:\n{run.stderr[-3000:]}")
        line = dict(json.loads(run.stdout.strip().splitlines()[-1]),
                    label=label)
        lines.append(line)
        print(json.dumps(line), flush=True)
    lines.append(summary(lines))
    print(json.dumps(lines[-1]), flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "main_path_turns.json").write_text(
        json.dumps(lines, indent=1))


if __name__ == "__main__":
    main()
