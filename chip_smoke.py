#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

Drives the port's main path — the single-device Nekbone Jacobi-PCG solve
with the hand-written axhelm CUDA kernels — through the entry points a user
calls (`setup_problem`, `rhs_from_solution`, `solve`), and holds every
kernel against its plain PyTorch version on the card.  Phases, one line
each:

  1. device   nvidia-smi name and power limit, torch and CUDA versions
  2. build    nvcc builds the kernels from the sources in this checkout;
              registers, shared memory and spills per instantiation
  3. kernels  every kernel against its plain version: both variants,
              Poisson and Helmholtz with random per-node lam0/lam1, c in
              {1, 3, nrhs*d = 2*3}, N1 in {4, 8}, an odd E = 37, and the main
              path's shape; max|y_k - y_p| / max|y_p| <= 1e-4
  4. converge 8x8x8, N=7, both variants, kernels and reference backend:
              CONVERGED, iterations within +-1, error <= 1e-5, one kernel
              launch per operator application
  5. config   the Nekbone config (16x16x16, N=7, Poisson, fp32, Jacobi,
              200 iterations): precomputed, then trilinear, through the
              kernels — the main path, 7 timed solves each after a warm-up;
              MAXITER at 200, final residual within 1% of the reference
              backend's (solved once); ms per iteration (median and
              quartiles), GFLOPS, GDOFS, peak memory
  6. timing   CUDA-event times of each kernel (E=4096 and E=32768, N1=8,
              c=1, Poisson) beside its bound, the plain version's time and
              the share of a solve iteration spent in it
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
REPLACES = {"precomputed": "src/repro/kernels/axhelm/kernel.py:122",
            "trilinear": "src/repro/kernels/axhelm/kernel.py:126"}
ENTRY = {"precomputed": "axhelm_precomputed_f32",
         "trilinear": "axhelm_trilinear_f32"}
VARIANTS = ("precomputed", "trilinear")


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


def axhelm_bound(variant: str, e: int, n1: int, ncols: int = 1):
    """(bound_ms, bound_by, bytes, flops) of one Poisson call without
    lambda fields: each input read once, the output written once."""
    nodes = e * n1 ** 3
    nbytes = 4 * (2 * ncols * nodes)                       # x in, y out
    nbytes += 4 * 6 * nodes if variant == "precomputed" else 4 * 24 * e
    flops = ncols * (12 * n1 ** 4 + 15 * n1 ** 3) * e       # flop_count's F_ax
    if variant == "trilinear":
        flops += e * trilinear_geometry_flops(n1)
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
    from repro_torch.core import geometry, mesh_gen, nekbone
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
            k = re.search(r"axhelm_kernelILi(\d+)ELb([01])E", m.group(1))
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
    if not inst:    # an unfamiliar ptxas format: show the report as it is
        build_line["ptxas"] = report
    emit(build_line)

    # 3. kernels against their plain versions ------------------------------
    rng = np.random.default_rng(2024)
    worst = {v: 0.0 for v in VARIANTS}
    cases = []

    def geom_for(variant, verts, b):
        if variant == "trilinear":
            return verts.contiguous()
        f = geometry.factors_discrete(geometry.node_coords(verts, b), b)
        return torch.cat([f.g, f.gwj[..., None]], dim=-1).contiguous()

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

    e_odd = 37
    for n1 in (4, 8):
        b = basis(n1 - 1)
        mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(4, 4, 3, n1 - 1))
        verts = torch.as_tensor(mesh.verts[:e_odd], dtype=torch.float32,
                                device=dev)
        for variant in VARIANTS:
            geom = geom_for(variant, verts, b)
            for helm in (False, True):
                for nrhs, d in ((1, 1), (1, 3), (2, 3)):
                    shape = (e_odd, nrhs, d) + (n1,) * 3
                    x = torch.as_tensor(rng.standard_normal(shape),
                                        dtype=torch.float32, device=dev)
                    x = x[:, 0, 0] if d == 1 else (x[:, 0] if nrhs == 1
                                                   else x)
                    node = (e_odd,) + (n1,) * 3
                    kw = {"lam0": torch.as_tensor(
                        1 + 0.3 * rng.random(node), dtype=torch.float32,
                        device=dev)}
                    if helm:
                        kw["lam1"] = torch.as_tensor(
                            0.5 + 0.2 * rng.random(node),
                            dtype=torch.float32, device=dev)
                    label = (f"{variant} N1={n1} E={e_odd} "
                             f"{'helmholtz' if helm else 'poisson'} "
                             f"nrhs={nrhs} d={d}")
                    check(variant, b, x.contiguous(), geom, label,
                          helmholtz=helm, **kw)

    nx, ny, nz = CONFIG.elements
    b_cfg = basis(CONFIG.order)
    cfg_mesh = mesh_gen.deform_trilinear(
        mesh_gen.box_mesh(nx, ny, nz, CONFIG.order), seed=3)
    e_main = len(cfg_mesh.verts)
    n1 = b_cfg.n1
    cfg_verts = torch.as_tensor(cfg_mesh.verts, dtype=torch.float32,
                                device=dev)
    main_abs = {}
    for variant in VARIANTS:
        geom = geom_for(variant, cfg_verts, b_cfg)
        x = torch.as_tensor(rng.standard_normal((e_main,) + (n1,) * 3),
                            dtype=torch.float32, device=dev)
        main_abs[variant] = check(variant, b_cfg, x, geom,
                                  f"{variant} main path E={e_main} N1={n1} "
                                  f"poisson c=1")
        del geom, x
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

    def run_solve(mesh, variant, backend, tol, max_iter, repeats=1):
        """`repeats` solves of one problem, after one warm-up solve when
        repeats > 1.  Every count is set to 0 just before each solve and
        read just after it: through the kernels, one launch per operator
        application; through the reference backend, none."""
        prob = nekbone.setup_problem(mesh, variant=variant, backend=backend)
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
               "status": SolveStatus(int(res.status)).name,
               "iterations": iters, "residual": float(res.residual),
               "error": nekbone.manufactured_error(prob, res.x, x_true),
               "applications": box["n"], "launches": launches[variant],
               "solves_timed": len(ms), "ms_per_iteration": q[1],
               "ms_per_iteration_q1": q[0], "ms_per_iteration_q3": q[2],
               "max_memory_allocated": torch.cuda.max_memory_allocated()}
        require(bool(torch.isfinite(res.x).all()), f"{out}: non-finite x")
        return out

    conv_mesh = mesh_gen.deform_trilinear(
        mesh_gen.box_mesh(8, 8, 8, CONFIG.order), seed=3)
    conv = []
    for variant in VARIANTS:
        k = run_solve(conv_mesh, variant, "cuda", 1e-8, 400)
        r = run_solve(conv_mesh, variant, "reference", 1e-8, 400)
        conv += [k, r]
        for s in (k, r):
            require(s["status"] == "CONVERGED", f"8^3 solve: {s}")
            require(s["error"] <= 1e-5, f"8^3 solve error: {s}")
        require(abs(k["iterations"] - r["iterations"]) <= 1,
                f"8^3 iterations differ: {k} vs {r}")
    emit({"phase": "converge", "mesh": "8x8x8", "order": CONFIG.order,
          "dofs": conv_mesh.n_global, "solves": conv})

    # 5. the config, through the kernels (the main path) -------------------
    # The kernel-backend solves are timed SOLVE_REPEATS times (median and
    # quartiles); the slow reference-backend solve runs once, for its
    # residual only.
    config = {}
    for variant in VARIANTS:
        k = run_solve(cfg_mesh, variant, "cuda", CONFIG.tol, CONFIG.max_iter,
                      repeats=SOLVE_REPEATS)
        r = run_solve(cfg_mesh, variant, "reference", CONFIG.tol,
                      CONFIG.max_iter)
        for s in (k, r):
            require(s["status"] == "MAXITER" and
                    s["iterations"] == CONFIG.max_iter, f"16^3 solve: {s}")
        rdiff = abs(k["residual"] - r["residual"]) / r["residual"]
        require(rdiff <= 0.01, f"16^3 residual differs by {rdiff:.3%}: "
                f"{k} vs {r}")
        flops = nekbone.flop_count(cfg_mesh, 1, False, 1)
        k["GFLOPS"] = flops / k["ms_per_iteration"] / 1e6
        k["GDOFS"] = cfg_mesh.n_global / k["ms_per_iteration"] / 1e6
        config[variant] = {"kernel": k, "reference": r,
                           "residual_rel_diff": rdiff}
    emit({"phase": "config", "mesh": "x".join(map(str, CONFIG.elements)),
          "order": CONFIG.order, "elements": e_main,
          "dofs": cfg_mesh.n_global, "solves": config})

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

    timing = {v: {} for v in VARIANTS}
    big_mesh = mesh_gen.deform_trilinear(
        mesh_gen.box_mesh(32, 32, 32, CONFIG.order), seed=3)
    for e_label, mesh in (("e4096", cfg_mesh), ("e32768", big_mesh)):
        verts = torch.as_tensor(mesh.verts, dtype=torch.float32, device=dev)
        e = len(mesh.verts)
        x = torch.as_tensor(rng.standard_normal((e,) + (n1,) * 3),
                            dtype=torch.float32, device=dev)
        for variant in VARIANTS:
            geom = geom_for(variant, verts, b_cfg)
            ms = event_ms(lambda: ops.axhelm(x, b_cfg, variant, geom),
                          reps=200, warmup=20)
            plain_ms = event_ms(lambda: ops.reference(x, b_cfg, variant,
                                                      geom),
                                reps=20, warmup=3)
            bound_ms, bound_by, nbytes, flops = axhelm_bound(variant, e, n1)
            timing[variant][e_label] = {
                "E": e, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "bytes": nbytes, "flops": flops,
                "roofline_share": bound_ms / ms,
                "GBps": nbytes / ms / 1e6, "GFLOPS": flops / ms / 1e6}
            del geom
        del x, verts
        torch.cuda.empty_cache()
    for variant in VARIANTS:
        k = config[variant]["kernel"]
        k["axhelm_share"] = (timing[variant]["e4096"]["ms"]
                             * k["applications"]
                             / (k["ms_per_iteration"] * k["iterations"]))
    emit({"phase": "timing", "card": card, "reps": 200,
          "library": "none: no single PyTorch call computes axhelm",
          "kernels": timing,
          "axhelm_share_of_solve": {v: config[v]["kernel"]["axhelm_share"]
                                    for v in VARIANTS},
          "ms_per_iteration": {v: config[v]["kernel"]["ms_per_iteration"]
                               for v in VARIANTS}})

    # 7. the kernels line, the card line, the result line -------------------
    kernels = []
    for variant in VARIANTS:
        t = timing[variant]["e4096"]
        kernels.append({
            "name": ENTRY[variant], "variant": variant, "route": "cuda",
            "source": SOURCE, "replaces": REPLACES[variant],
            "launches": config[variant]["kernel"]["launches"],
            "max_abs_err": main_abs[variant],
            "max_rel_err": worst[variant],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
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
