#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

Drives the port's main path — the single-device Nekbone Jacobi-PCG solve
with the hand-written axhelm CUDA kernels — through the entry points a user
calls (`setup_problem`, `rhs_from_solution`, `solve`), once for each of the
five axhelm variants, and holds every kernel against its plain PyTorch
version on the card.  Phases, one line each:

  1. device   nvidia-smi name and power limit, torch and CUDA versions
  2. build    nvcc builds the kernels from the sources in this checkout;
              registers, shared memory and spills of every instantiation
  3. kernels  every kernel against its plain version: Poisson and
              Helmholtz with random per-node lam0/lam1 (merged: Helmholtz
              only, Lam2/Lam3 of them; partial: Poisson only, gScale), c in
              {1, 3, nrhs*d = 2*3}, N1 in {4, 8}, an odd E = 37, and each
              variant's main-path shape; max|y_k - y_p| / max|y_p| <= 1e-4
  4. converge 8x8x8, N=7, kernels and reference backend: precomputed,
              trilinear and partial Poisson on the trilinear mesh,
              parallelepiped and precomputed Poisson on the affine mesh,
              merged and trilinear Helmholtz; CONVERGED, iterations within
              +-1 of the other backend and of the same operator reached
              through another variant, one kernel launch per operator
              application
  5. config   the Nekbone config (16x16x16, N=7, fp32, Jacobi, 200
              iterations) through the kernels — the main path of each
              variant: precomputed, trilinear and partial Poisson,
              parallelepiped Poisson on the affinely deformed box, merged
              and trilinear Helmholtz; 7 timed solves each after a warm-up;
              status and iterations (+-1) of the reference backend (solved
              once), at MAXITER its final residual within 1%; ms per
              iteration (median and quartiles), GFLOPS, GDOFS, peak memory
  6. timing   device time of each kernel (E=4096 and E=32768, N1=8,
              c=1; K1, K2, K3, K5 Poisson, K4 Helmholtz) from a replayed
              CUDA graph, and its time in eager calls back to back, beside
              its bound, the plain version's time and the share of a solve
              iteration spent in it
  7. the `kernels` line, then the card line, then the result line.

Exits non-zero, printing no result, when a phase fails, when there is no
CUDA device, or when it is not run from a checkout of the repository.
Run:  python3 chip_smoke.py
"""

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet), at the full 700 W limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
RTOL_KERNEL = 1e-4
SOLVE_REPEATS = 7     # timed 16^3 kernel-backend solves per variant
SOURCE = "src/repro_torch/kernels/axhelm/csrc/axhelm.cu"
_TPU_KERNEL = "src/repro/kernels/axhelm/kernel.py"
REPLACES = {"precomputed": f"{_TPU_KERNEL}:122",
            "trilinear": f"{_TPU_KERNEL}:126",
            "parallelepiped": f"{_TPU_KERNEL}:132",
            "merged": f"{_TPU_KERNEL}:137",
            "partial": f"{_TPU_KERNEL}:154"}
ENTRY = {v: f"axhelm_{v}_f32" for v in REPLACES}
# in the order of the GeomSource enum of the CUDA source
VARIANTS = ("precomputed", "trilinear", "parallelepiped", "merged", "partial")
# the equations each kernel takes (helmholtz flag), and the one its main
# path and its timing run solve
EQUATIONS = {"precomputed": (False, True), "trilinear": (False, True),
             "parallelepiped": (False, True), "merged": (True,),
             "partial": (False,)}
MAIN_HELMHOLTZ = {v: v == "merged" for v in VARIANTS}
# The 8^3 Helmholtz solve (lambda1 = 0.1, no Dirichlet mask) needs 700
# iterations to reach 1e-8, and its conditioning turns that residual into
# a manufactured error near 2e-4 (`python -m repro_torch.nekbone_solve
# --elements 8 8 8 --equation helmholtz --max-iter 1000 --device cpu`:
# 700 iterations, error 1.97e-4): the error bound there is 1e-3, not 1e-5.
CONVERGE_MAX_ITER = {False: 400, True: 1000}
CONVERGE_ERROR = {False: 1e-5, True: 1e-3}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def trilinear_geometry_flops(n1: int) -> int:
    """FLOPs per element of paper Alg. 3 with its shared terms: E0/E1 and
    F0/F1 per j and i (12 a component), the third Jacobian column per
    (j, i) (4 + 3 * 11), then per node the two-column assembly (12),
    K = J^T J (30), adj(K) (18), det (14), gscale (2), G (6) and gwj (2)."""
    return 2 * n1 * 3 * 12 + n1 ** 2 * (4 + 3 * 11) + n1 ** 3 * 84


def adjugate_geometry_flops(n1: int) -> int:
    """FLOPs per element of K4/K5's recomputation: Alg. 3's shared terms,
    then per node the two-column assembly (12), K = J^T J (30), adj(K) (18)
    and its scaling by the Lam2/gScale field (6) — no det, no division."""
    return 2 * n1 * 3 * 12 + n1 ** 2 * (4 + 3 * 11) + n1 ** 3 * 66


def axhelm_bound(variant: str, e: int, n1: int, helmholtz: bool = False,
                 ncols: int = 1):
    """(bound_ms, bound_by, bytes, flops) of one call as the timing phase
    makes it (no user lambda fields): each input read once, the output
    written once.  Geometry bytes per element: K1 the 6(+1) factor fields,
    K2 24 vertex words, K3 7 words, K4 Lam2 + Lam3 + 24 words, K5
    gScale + 24 words."""
    nodes = e * n1 ** 3
    nbytes = 4 * (2 * ncols * nodes)                       # x in, y out
    nbytes += 4 * {"precomputed": (6 + helmholtz) * nodes,
                   "trilinear": 24 * e,
                   "parallelepiped": 7 * e,
                   "merged": 2 * nodes + 24 * e,
                   "partial": nodes + 24 * e}[variant]
    # flop_count's F_ax
    flops = ncols * (12 * n1 ** 4 + (15 + 5 * helmholtz) * n1 ** 3) * e
    if variant == "trilinear":
        flops += e * trilinear_geometry_flops(n1)
    elif variant in ("merged", "partial"):
        flops += e * adjugate_geometry_flops(n1)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, flops)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is False")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("src/repro_torch is missing: run chip_smoke.py from a checkout "
             "of the repository")
    sys.path.insert(0, str(ROOT / "src"))

    import numpy as np

    from repro_torch.configs.nekbone import CONFIG
    from repro_torch.core import axhelm as core_axhelm
    from repro_torch.core import mesh_gen, nekbone
    from repro_torch.core.spectral import basis
    from repro_torch.kernels.axhelm import build, ops
    from repro_torch.resilience.status import SolveStatus

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. device -----------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=False)
    require(smi.returncode == 0 and smi.stdout.strip(),
            f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    build_s = time.perf_counter() - t0
    report = build.ptxas_report()
    inst, cur = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            # axhelm_kernel<N1, GeomSource> mangles as ILi<N1>E...GeomSourceE<n>E
            k = re.search(r"axhelm_kernelILi(\d+)E.*?GeomSourceE?(\d+)E",
                          m.group(1))
            cur = {"kernel": m.group(1)}
            if k:
                cur = {"variant": VARIANTS[int(k.group(2))],
                       "n1": int(k.group(1))}
            inst.append(cur)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem_bytes"] = int(m.group(1)) if m else 0
    build_line = {"phase": "build", "library": str(lib_path.relative_to(ROOT)),
                  "seconds": build_s, "instantiations": inst}
    reported = {(c.get("variant"), c.get("n1")) for c in inst
                if "registers" in c}
    missing = sorted({(v, n) for v in VARIANTS for n in ops.KERNEL_N1}
                     - reported)
    if missing:     # an unfamiliar ptxas format: show the report as it is
        build_line["ptxas"] = report
    emit(build_line)
    require(not missing, f"no ptxas report for instantiations {missing}")

    # 3. kernels against their plain versions ------------------------------
    rng = np.random.default_rng(2024)
    worst = {v: 0.0 for v in VARIANTS}
    cases = []

    def operands(variant, verts, b, helm, lam0=None, lam1=None):
        """geom and lambda-slot kwargs of one kernel call, assembled from
        vertices and the user's lambdas by the entry points' own
        `make_axhelm_elem_ops`: merged takes Lam2/Lam3 of lam0/lam1,
        partial gScale."""
        elem_ops, _, _ = core_axhelm.make_axhelm_elem_ops(
            variant, b, verts, lam0=lam0, lam1=lam1, helmholtz=helm,
            dtype=torch.float32, backend="cuda", device=dev)
        return elem_ops.pop("geom"), elem_ops

    def check(variant, b, x, geom, label, **kw):
        y = ops.axhelm(x, b, variant, geom, **kw)
        torch.cuda.synchronize()
        y_p = ops.reference(x, b, variant, geom, **kw)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(y).all()), f"{label}: non-finite y")
        abs_err = float((y - y_p).abs().max())
        rel = abs_err / float(y_p.abs().max())
        worst[variant] = max(worst[variant], rel)
        cases.append({"case": label, "rel_err": rel})
        require(rel <= RTOL_KERNEL, f"{label}: relative error {rel:.3e} > "
                f"{RTOL_KERNEL}")
        return abs_err

    def mesh_for(variant, box):
        """The entry point's mesh: affine for parallelepiped, else
        trilinear-deformed."""
        if variant == "parallelepiped":
            return mesh_gen.deform_affine(box, seed=2)
        return mesh_gen.deform_trilinear(box, seed=3)

    e_odd = 37
    for n1 in (4, 8):
        b = basis(n1 - 1)
        box = mesh_gen.box_mesh(4, 4, 3, n1 - 1)
        node = (e_odd,) + (n1,) * 3
        for variant in VARIANTS:
            verts = torch.as_tensor(mesh_for(variant, box).verts[:e_odd],
                                    dtype=torch.float32, device=dev)
            for helm in EQUATIONS[variant]:
                for nrhs, d in ((1, 1), (1, 3), (2, 3)):
                    shape = (e_odd, nrhs, d) + (n1,) * 3
                    x = torch.as_tensor(rng.standard_normal(shape),
                                        dtype=torch.float32, device=dev)
                    x = x[:, 0, 0] if d == 1 else (x[:, 0] if nrhs == 1
                                                   else x)
                    lam0 = torch.as_tensor(1 + 0.3 * rng.random(node),
                                           dtype=torch.float32, device=dev)
                    lam1 = torch.as_tensor(0.5 + 0.2 * rng.random(node),
                                           dtype=torch.float32,
                                           device=dev) if helm else None
                    geom, kw = operands(variant, verts, b, helm, lam0, lam1)
                    label = (f"{variant} N1={n1} E={e_odd} "
                             f"{'helmholtz' if helm else 'poisson'} "
                             f"nrhs={nrhs} d={d}")
                    check(variant, b, x.contiguous(), geom, label,
                          helmholtz=helm, **kw)

    nx, ny, nz = CONFIG.elements
    b_cfg = basis(CONFIG.order)
    cfg_box = mesh_gen.box_mesh(nx, ny, nz, CONFIG.order)
    cfg_meshes = {v: mesh_for(v, cfg_box) for v in ("trilinear",
                                                    "parallelepiped")}

    def cfg_mesh_for(variant):
        return cfg_meshes["parallelepiped" if variant == "parallelepiped"
                          else "trilinear"]

    e_main = len(cfg_box.verts)
    n1 = b_cfg.n1
    main_abs = {}

    def main_operands(variant, verts, helm):
        """Operands of the main path's call, with setup_problem's scalar
        lambdas: none for Poisson, lam0=1 and lam1=0.1 for Helmholtz."""
        lams = (1.0, 0.1) if helm else (None, None)
        return operands(variant, verts, b_cfg, helm, *lams)

    for variant in VARIANTS:
        helm = MAIN_HELMHOLTZ[variant]
        verts = torch.as_tensor(cfg_mesh_for(variant).verts,
                                dtype=torch.float32, device=dev)
        geom, kw = main_operands(variant, verts, helm)
        x = torch.as_tensor(rng.standard_normal((e_main,) + (n1,) * 3),
                            dtype=torch.float32, device=dev)
        main_abs[variant] = check(
            variant, b_cfg, x, geom, f"{variant} main path E={e_main} "
            f"N1={n1} {'helmholtz' if helm else 'poisson'} c=1",
            helmholtz=helm, **kw)
        del geom, kw, x, verts
    emit({"phase": "kernels", "cases": len(cases), "tolerance": RTOL_KERNEL,
          "worst_rel_err": worst, "main_path_abs_err": main_abs})

    # 4. converging solve at 8x8x8 ----------------------------------------
    def counted(prob):
        """The problem with its global operator counting applications."""
        box = {"n": 0}

        def op(x):
            box["n"] += 1
            return prob.op(x)
        return prob._replace(op=op), box

    def run_solve(mesh, variant, backend, tol, max_iter, helm=False,
                  repeats=1):
        """`repeats` solves of one problem, after one warm-up solve when
        repeats > 1.  Every count is set to 0 just before each solve and
        read just after it: through the kernels, one launch per operator
        application; through the reference backend, none."""
        prob = nekbone.setup_problem(mesh, variant=variant, helmholtz=helm,
                                     backend=backend)
        require(prob.backend == backend, f"backend {prob.backend} != "
                f"{backend}")
        prob, box = counted(prob)
        x_true = nekbone.random_solution(prob, seed=0)
        b = nekbone.rhs_from_solution(prob, x_true)
        if repeats > 1:
            nekbone.solve(prob, b, tol=tol, max_iter=max_iter)    # warm-up
        walls = []
        for _ in range(repeats):
            torch.cuda.synchronize()
            box["n"] = 0
            ops.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = nekbone.solve(prob, b, tol=tol, max_iter=max_iter)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches = dict(ops.launch_counts)
            want = {v: (box["n"] if backend == "cuda" and v == variant
                        else 0) for v in VARIANTS}
            require(launches == want and box["n"] > 0,
                    f"{variant}/{backend}: launches {launches} for "
                    f"{box['n']} operator applications")
        iters = int(res.iterations)
        ms = sorted(w * 1e3 / iters for w in walls)
        q = statistics.quantiles(ms, n=4) if len(ms) > 1 else [ms[0]] * 3
        out = {"variant": variant, "backend": backend,
               "equation": "helmholtz" if helm else "poisson",
               "status": SolveStatus(int(res.status)).name,
               "iterations": iters, "residual": float(res.residual),
               "error": nekbone.manufactured_error(prob, res.x, x_true),
               "applications": box["n"], "launches": launches[variant],
               "solves_timed": len(ms), "ms_per_iteration": q[1],
               "ms_per_iteration_q1": q[0], "ms_per_iteration_q3": q[2],
               "max_memory_allocated": torch.cuda.max_memory_allocated()}
        require(bool(torch.isfinite(res.x).all()), f"{out}: non-finite x")
        return out

    conv_box = mesh_gen.box_mesh(8, 8, 8, CONFIG.order)
    conv_meshes = {"trilinear": mesh_for("trilinear", conv_box),
                   "affine": mesh_for("parallelepiped", conv_box)}
    # (name, variant, mesh, helmholtz); the pairs below reach one operator
    # through two variants
    conv_runs = [("precomputed", "precomputed", "trilinear", False),
                 ("trilinear", "trilinear", "trilinear", False),
                 ("partial", "partial", "trilinear", False),
                 ("trilinear/helmholtz", "trilinear", "trilinear", True),
                 ("merged", "merged", "trilinear", True),
                 ("precomputed/affine", "precomputed", "affine", False),
                 ("parallelepiped", "parallelepiped", "affine", False)]
    same_operator = [("merged", "trilinear/helmholtz"),
                     ("partial", "trilinear"),
                     ("parallelepiped", "precomputed/affine")]
    conv = {}
    for name, variant, mesh_name, helm in conv_runs:
        k, r = (run_solve(conv_meshes[mesh_name], variant, backend, 1e-8,
                          CONVERGE_MAX_ITER[helm], helm=helm)
                for backend in ("cuda", "reference"))
        for s in (k, r):
            s["mesh"] = mesh_name
            require(s["status"] == "CONVERGED", f"8^3 solve: {s}")
            require(s["error"] <= CONVERGE_ERROR[helm],
                    f"8^3 solve error: {s}")
        require(abs(k["iterations"] - r["iterations"]) <= 1,
                f"8^3 iterations differ: {k} vs {r}")
        conv[name] = {"kernel": k, "reference": r}
    for a, b_ in same_operator:
        for backend in ("kernel", "reference"):
            ia, ib = conv[a][backend]["iterations"], \
                conv[b_][backend]["iterations"]
            require(abs(ia - ib) <= 1, f"8^3 {backend} solves of one "
                    f"operator: {a} took {ia} iterations, {b_} {ib}")
    emit({"phase": "converge", "mesh": "8x8x8", "order": CONFIG.order,
          "dofs": conv_box.n_global, "max_iter": CONVERGE_MAX_ITER,
          "error_bound": CONVERGE_ERROR, "same_operator": same_operator,
          "solves": conv})

    # 5. the config, through the kernels (the main path) -------------------
    # Every variant's main path: the kernel-backend solves are timed
    # SOLVE_REPEATS times (median and quartiles); the slow reference-backend
    # solve runs once, for its status, iterations and residual.  K2 runs
    # twice: Poisson (the config's own equation) and Helmholtz, K4's
    # yardstick.
    cfg_runs = [(v, MAIN_HELMHOLTZ[v]) for v in VARIANTS] + \
        [("trilinear", True)]
    config = {}
    for variant, helm in cfg_runs:
        mesh = cfg_mesh_for(variant)
        k = run_solve(mesh, variant, "cuda", CONFIG.tol, CONFIG.max_iter,
                      helm=helm, repeats=SOLVE_REPEATS)
        r = run_solve(mesh, variant, "reference", CONFIG.tol,
                      CONFIG.max_iter, helm=helm)
        require(k["status"] == r["status"] and
                abs(k["iterations"] - r["iterations"]) <= 1,
                f"16^3 solves differ: {k} vs {r}")
        rdiff = abs(k["residual"] - r["residual"]) / r["residual"]
        if k["status"] == "MAXITER":
            require(rdiff <= 0.01, f"16^3 residual differs by {rdiff:.3%}: "
                    f"{k} vs {r}")
        flops = nekbone.flop_count(mesh, 1, helm, 1)
        k["GFLOPS"] = flops / k["ms_per_iteration"] / 1e6
        k["GDOFS"] = mesh.n_global / k["ms_per_iteration"] / 1e6
        config[f"{variant}/{k['equation']}"] = {
            "kernel": k, "reference": r, "residual_rel_diff": rdiff,
            "mesh": "affine" if variant == "parallelepiped" else "trilinear"}
    emit({"phase": "config", "mesh": "x".join(map(str, CONFIG.elements)),
          "order": CONFIG.order, "elements": e_main,
          "dofs": cfg_box.n_global, "solves": config})

    # 6. kernel times -------------------------------------------------------
    def event_ms(fn, reps, warmup):
        for _ in range(warmup):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    def graph_ms(fn, reps, replays):
        """Device time of one call: `reps` calls captured in one CUDA graph,
        replayed `replays` times between CUDA events; the median replay over
        `reps`.  Back-to-back eager calls can be bound by the wrapper's host
        time (checks, ctypes), which a replay does not contain."""
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()                                            # warm-up
        times = []
        for _ in range(replays):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            graph.replay()
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop) / reps)
        del graph
        torch.cuda.empty_cache()
        return statistics.median(times)

    def main_key(variant):
        equation = "helmholtz" if MAIN_HELMHOLTZ[variant] else "poisson"
        return f"{variant}/{equation}"

    timing = {v: {} for v in VARIANTS}
    big_box = mesh_gen.box_mesh(32, 32, 32, CONFIG.order)
    big_meshes = {v: mesh_for(v, big_box) for v in ("trilinear",
                                                    "parallelepiped")}
    for e_label, meshes in (("e4096", cfg_meshes), ("e32768", big_meshes)):
        e = len(meshes["trilinear"].verts)
        x = torch.as_tensor(rng.standard_normal((e,) + (n1,) * 3),
                            dtype=torch.float32, device=dev)
        for variant in VARIANTS:
            helm = MAIN_HELMHOLTZ[variant]
            mesh = meshes["parallelepiped" if variant == "parallelepiped"
                          else "trilinear"]
            verts = torch.as_tensor(mesh.verts, dtype=torch.float32,
                                    device=dev)
            geom, kw = main_operands(variant, verts, helm)

            def kernel():
                return ops.axhelm(x, b_cfg, variant, geom, helmholtz=helm,
                                  **kw)
            ms = graph_ms(kernel, reps=50, replays=5)
            ms_eager = event_ms(kernel, reps=200, warmup=20)
            plain_ms = event_ms(lambda: ops.reference(x, b_cfg, variant,
                                                      geom, helmholtz=helm,
                                                      **kw),
                                reps=20, warmup=3)
            bound_ms, bound_by, nbytes, flops = axhelm_bound(variant, e, n1,
                                                             helm)
            timing[variant][e_label] = {
                "E": e, "equation": "helmholtz" if helm else "poisson",
                "ms": ms, "ms_eager": ms_eager, "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by, "bytes": nbytes, "flops": flops,
                "roofline_share": bound_ms / ms,
                "GBps": nbytes / ms / 1e6, "GFLOPS": flops / ms / 1e6}
            del geom, kw, verts
        del x
        torch.cuda.empty_cache()
    for variant in VARIANTS:
        k = config[main_key(variant)]["kernel"]
        k["axhelm_share"] = (timing[variant]["e4096"]["ms"]
                             * k["applications"]
                             / (k["ms_per_iteration"] * k["iterations"]))
    emit({"phase": "timing", "card": card,
          "ms": "CUDA graph of 50 calls, median of 5 replays",
          "ms_eager": "200 eager calls back to back, CUDA events",
          "library": "none: no single PyTorch call computes axhelm",
          "kernels": timing,
          "axhelm_share_of_solve": {
              v: config[main_key(v)]["kernel"]["axhelm_share"]
              for v in VARIANTS},
          "ms_per_iteration": {key: c["kernel"]["ms_per_iteration"]
                               for key, c in config.items()}})

    # 7. the kernels line, the card line, the result line -------------------
    kernels = []
    for variant in VARIANTS:
        t = timing[variant]["e4096"]
        kernels.append({
            "name": ENTRY[variant], "variant": variant, "route": "cuda",
            "source": SOURCE, "replaces": REPLACES[variant],
            "main_path": main_key(variant),
            "launches": config[main_key(variant)]["kernel"]["launches"],
            "max_abs_err": main_abs[variant],
            "max_rel_err": worst[variant],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
            "ms_eager": t["ms_eager"],
            "ms_e32768": timing[variant]["e32768"]["ms"],
            "bound_ms_e32768": timing[variant]["e32768"]["bound_ms"],
            "plain_ms_e32768": timing[variant]["e32768"]["plain_ms"]})
    for kern in kernels:
        require(kern["launches"] > 0, f"{kern['name']} was not launched on "
                f"the main path")
    emit({"kernels": kernels})
    emit({"phase": "done", "wall_s": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
