"""Rank functions of tests/test_torch_sharded.py: the port's sharded solves
on gloo ranks on the CPU, beside the single-device solves each rank also
runs.  Spawned children import this module, so it imports neither jax nor
the reference package, and every function here is module-level.

`cases(rank, world, grid, groups)` runs the case groups named in `groups`
and returns ``{group: rows}``; every rank returns its own rows, which the
tests compare across ranks where the port promises equal results.  The
`nbr_*` groups run the neighbour exchange (`exchange="neighbour"`, with
and without a halo codec) beside the psum exchange.
"""

import functools
import hashlib
import warnings

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis import record
from repro_torch.core import gather_scatter as gs
from repro_torch.core import mesh_gen, nekbone
from repro_torch.core.pcg import owned_dot
from repro_torch.distributed.context import make_solver_ctx
from repro_torch.resilience.inject import FaultSpec
from repro_torch.resilience.retry import solve_resilient
from repro_torch.resilience.status import SolveStatus

TOL = 1e-6
CPU = torch.device("cpu")


def mesh_3x3x2():
    return mesh_gen.deform_trilinear(mesh_gen.box_mesh(3, 3, 2, 3), seed=3)


def jax_rhs(mesh) -> np.ndarray:
    """The right-hand side both packages solve in the JAX comparison:
    standard normal float32 from numpy seed 0."""
    return np.random.default_rng(0).standard_normal(
        mesh.n_global).astype(np.float32)


def digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.contiguous().numpy().tobytes()).hexdigest()


def _ints(t) -> list:
    return [int(v) for v in torch.atleast_1d(t)]


def _ctx(world, grid, exchange="psum", compress=None):
    ctx = make_solver_ctx(devices=world, grid=grid, device="cpu",
                          exchange=exchange, compress=compress)
    assert ctx is not None and ctx.n_shards == world
    assert (ctx.exchange, ctx.compress) == (exchange, compress)
    return ctx


def op_rows(world, grid, exchange="psum"):
    """The sharded operator against the single-device one, every variant,
    nrhs 1 and 4 (test_nekbone_sharded.py::test_sharded_op_matches_global_op);
    the diagonals."""
    box = mesh_gen.box_mesh(3, 3, 2, 3)
    rng = np.random.default_rng(1)
    rows = []
    for variant in ("precomputed", "trilinear", "parallelepiped", "merged",
                    "partial"):
        mesh = mesh_gen.deform_affine(box, seed=2) \
            if variant == "parallelepiped" \
            else mesh_gen.deform_trilinear(box, seed=3)
        helm = variant == "merged"
        for nrhs in (1, 4):
            shape = (mesh.n_global,) + ((nrhs,) if nrhs > 1 else ())
            x = torch.as_tensor(rng.standard_normal(shape),
                                dtype=torch.float32)
            kw = dict(variant=variant, helmholtz=helm, backend="cuda")
            ref = nekbone.setup_problem(mesh, device=CPU, **kw)
            sh = nekbone.setup_problem(
                mesh, shard_ctx=_ctx(world, grid, exchange), **kw)
            y0, y1 = ref.op(x), sh.op(x)
            rows.append({"variant": variant, "nrhs": nrhs,
                         "rel": float((y1 - y0).abs().max()
                                      / y0.abs().max()),
                         "diag_diff": float((sh.diag - ref.diag).abs().max()),
                         "y_digest": digest(y1)})
    return rows


def solve_rows(world, grid):
    """Sharded solves against single-device ones, both equations, the
    reference backend (trilinear) and the kernels' plain versions (merged,
    partial) (test_nekbone_sharded.py::test_sharded_solve_matches_single_
    device)."""
    meshes = [mesh_3x3x2()]
    if world == 2:
        meshes.append(mesh_gen.deform_trilinear(
            mesh_gen.box_mesh(5, 1, 1, 3), seed=4))
    rng = np.random.default_rng(0)
    rows = []
    for mesh in meshes:
        x_true = torch.as_tensor(rng.standard_normal(mesh.n_global),
                                 dtype=torch.float32)
        for helm in (False, True):
            for backend in ("reference", "cuda"):
                variant = ("merged" if helm else "partial") \
                    if backend == "cuda" else "trilinear"
                kw = dict(variant=variant, helmholtz=helm, backend=backend)
                ref = nekbone.setup_problem(mesh, device=CPU, **kw)
                b = nekbone.rhs_from_solution(ref, x_true)
                r0 = nekbone.solve(ref, b, tol=TOL, max_iter=300)
                sh = nekbone.setup_problem(mesh, shard_ctx=_ctx(world, grid),
                                           **kw)
                r1 = nekbone.solve(sh, b, tol=TOL, max_iter=300)
                rows.append({
                    "elements": len(mesh.verts), "helm": helm,
                    "backend": backend, "variant": variant,
                    "status_ref": int(r0.status), "status_sh": int(r1.status),
                    "it_ref": int(r0.iterations), "it_sh": int(r1.iterations),
                    "res_ref": float(r0.residual),
                    "res_sh": float(r1.residual),
                    "r0_ref": float(r0.initial_residual),
                    "dx": float((r1.x - r0.x).abs().max()),
                    "x_digest": digest(r1.x)})
    return rows


def vector_rows(world, grid):
    """d=3, Jacobi and no preconditioner, sharded against single-device
    (test_nekbone_sharded.py::test_sharded_vector_field_and_copy_precond)."""
    mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(3, 2, 1, 3), seed=3)
    x_true = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (mesh.n_global, 3)), dtype=torch.float32)
    rows = []
    for precond in ("jacobi", "copy"):
        ref = nekbone.setup_problem(mesh, variant="trilinear", d=3,
                                    backend="reference", device=CPU)
        b = nekbone.rhs_from_solution(ref, x_true)
        r0 = nekbone.solve(ref, b, precond=precond, tol=TOL, max_iter=300)
        sh = nekbone.setup_problem(mesh, variant="trilinear", d=3,
                                   backend="reference",
                                   shard_ctx=_ctx(world, grid))
        r1 = nekbone.solve(sh, b, precond=precond, tol=TOL, max_iter=300)
        rows.append({"precond": precond, "it_ref": int(r0.iterations),
                     "it_sh": int(r1.iterations),
                     "dx": float((r1.x - r0.x).abs().max())})
    return rows


def box_rows(world, grid, exchange="psum"):
    """The solves test_nekbone_box.py::test_box_solve_matches_slab runs with
    `exchange`, on this (S, grid): the tests hold the slab's rows against
    the box's."""
    mesh_acc = mesh_gen.deform_trilinear(mesh_gen.box_mesh(6, 6, 6, 2),
                                         seed=3)
    mesh_odd = mesh_gen.deform_trilinear(mesh_gen.box_mesh(5, 3, 2, 2),
                                         seed=4)
    cases = []
    for helm in (False, True):
        for nrhs in (1, 4):
            cases.append(("acc", "reference", helm, nrhs))
        cases.append(("odd", "reference", helm, 1))
        cases.append(("acc", "cuda", helm, 1))
    cases.append(("acc", "cuda", False, 4))
    rng = np.random.default_rng(0)
    rows = []
    for name, backend, helm, nrhs in cases:
        mesh = mesh_acc if name == "acc" else mesh_odd
        shape = (mesh.n_global,) + ((nrhs,) if nrhs > 1 else ())
        x_true = torch.as_tensor(rng.standard_normal(shape),
                                 dtype=torch.float32)
        variant = ("merged" if helm else "partial") if backend == "cuda" \
            else "trilinear"
        kw = dict(variant=variant, helmholtz=helm, backend=backend)
        b = nekbone.rhs_from_solution(
            nekbone.setup_problem(mesh, device=CPU, **kw), x_true)
        sh = nekbone.setup_problem(mesh, shard_ctx=_ctx(world, grid,
                                                        exchange),
                                   nrhs=nrhs, **kw)
        res = nekbone.solve(sh, b, tol=TOL, max_iter=300)
        rows.append({"mesh": list(mesh.shape), "backend": backend,
                     "helm": helm, "nrhs": nrhs,
                     "grid": list(sh.partition.grid),
                     "iterations": _ints(res.iterations),
                     "status": _ints(res.status),
                     "breakdown": bool(res.breakdown.any()),
                     "x": res.x.numpy()})
    return rows


def lambda_rows(world, grid):
    """Per-node lambda fields under a shard context
    (test_nekbone_box.py::test_lambda_fields_match_scalars_sharded):
    constant fields reproduce the scalar solve exactly, a varying field
    solved sharded matches the single-device solve."""
    mesh = mesh_3x3x2()
    n1 = mesh.order + 1
    node = (len(mesh.verts), n1, n1, n1)
    rng = np.random.default_rng(0)
    x_true = torch.as_tensor(rng.standard_normal(mesh.n_global),
                             dtype=torch.float32)
    lam0_var = (1.0 + 0.5 * rng.random(node)).astype(np.float32)
    lam1_var = (0.05 + 0.1 * rng.random(node)).astype(np.float32)
    rows = []
    for backend in ("reference", "cuda"):
        kw = dict(variant="trilinear", helmholtz=True, backend=backend)
        ref = nekbone.setup_problem(mesh, lam0=lam0_var, lam1=lam1_var,
                                    device=CPU, **kw)
        b_var = nekbone.rhs_from_solution(ref, x_true)
        r_ref = nekbone.solve(ref, b_var, tol=TOL, max_iter=300)
        ctx = _ctx(world, grid)
        ps = nekbone.setup_problem(mesh, lam0=1.3, lam1=0.1, shard_ctx=ctx,
                                   **kw)
        pf = nekbone.setup_problem(mesh, lam0=np.full(node, 1.3, np.float32),
                                   lam1=np.full(node, 0.1, np.float32),
                                   shard_ctx=ctx, **kw)
        b = nekbone.rhs_from_solution(ps, x_true)
        rs = nekbone.solve(ps, b, tol=TOL, max_iter=300)
        rf = nekbone.solve(pf, b, tol=TOL, max_iter=300)
        pv = nekbone.setup_problem(mesh, lam0=lam0_var, lam1=lam1_var,
                                   shard_ctx=ctx, **kw)
        rv = nekbone.solve(pv, b_var, tol=TOL, max_iter=300)
        rows.append({"backend": backend,
                     "it_scalar": int(rs.iterations),
                     "it_const_field": int(rf.iterations),
                     "dx_const": float((rf.x - rs.x).abs().max()),
                     "it_var_ref": int(r_ref.iterations),
                     "it_var_sh": int(rv.iterations),
                     "dx_var": float((rv.x - r_ref.x).abs().max())})
    return rows


def nan_rows(world, grid, exchange="psum"):
    """A NaN on the last shard at iteration 3, nrhs 1 and 4 (column 2)
    (test_resilience_sharded.py::test_sharded_nan_detected_within_one_
    iteration), through `exchange`."""
    mesh = mesh_3x3x2()
    rng = np.random.default_rng(0)
    rows = []
    for nrhs in (1, 4):
        sh = nekbone.setup_problem(mesh, variant="trilinear",
                                   backend="reference",
                                   shard_ctx=_ctx(world, grid, exchange),
                                   nrhs=nrhs)
        shape = (mesh.n_global,) + ((nrhs,) if nrhs > 1 else ())
        x_true = torch.as_tensor(rng.standard_normal(shape),
                                 dtype=torch.float32)
        b = nekbone.rhs_from_solution(sh, x_true)
        col = None if nrhs == 1 else 2
        spec = FaultSpec(mode="nan", iteration=3, shard=world - 1,
                         column=col)
        res = nekbone.solve(sh, b, tol=TOL, max_iter=300, fault=spec)
        clean = nekbone.solve(sh, b, tol=TOL, max_iter=300)
        rows.append({"nrhs": nrhs, "col": col, "status": _ints(res.status),
                     "iters": _ints(res.iterations),
                     "clean_status": _ints(clean.status),
                     "clean_iters": _ints(clean.iterations),
                     "finite": bool(torch.isfinite(res.x).all())})
    return rows


def drop_rows(world, grid, exchange="psum"):
    """drop_exchange on shard 1 at iteration 2 under the retry ladder
    (test_resilience_sharded.py::test_drop_exchange_caught_by_verification_
    and_restart), through `exchange`."""
    mesh = mesh_3x3x2()
    x_true = torch.as_tensor(np.random.default_rng(0).standard_normal(
        mesh.n_global), dtype=torch.float32)
    sh = nekbone.setup_problem(mesh, variant="trilinear", backend="reference",
                               shard_ctx=_ctx(world, grid, exchange))
    b = nekbone.rhs_from_solution(sh, x_true)
    spec = FaultSpec(mode="drop_exchange", iteration=2, shard=1)
    rep = solve_resilient(sh, b, tol=TOL, max_iter=300, fault=spec,
                          persistent=False)
    ref = nekbone.solve(sh, b, tol=TOL, max_iter=300)
    return [{"converged": rep.converged,
             "rungs": [a.rung for a in rep.attempts],
             "initial_failed": [int(c) for c in
                                rep.attempts[0].failed_columns],
             "initial_status": int(rep.attempts[0].status[0]),
             "true_residual": float(rep.true_residual[0]),
             "dx": float((rep.x - ref.x).abs().max())}]


def refined_rows(world, grid, wires=(("psum", None),)):
    """The sharded bf16_x32 solve on each (exchange, compress) wire, nrhs 1
    and 4, tol 1e-5: CONVERGED, true residual (fp32 reference-backend
    operator) within 1.5 tol (test_mixed_precision.py::test_sharded_
    refined_solve_every_wire)."""
    mesh = mesh_3x3x2()
    rng = np.random.default_rng(0)
    ref = nekbone.setup_problem(mesh, backend="reference", device=CPU)
    tol = 1e-5
    rows = []
    for nrhs in (1, 4):
        shape = (mesh.n_global,) + ((nrhs,) if nrhs > 1 else ())
        b = rng.standard_normal(shape).astype(np.float32)
        b = torch.as_tensor(b / np.linalg.norm(b, axis=0) * 30.0)
        for exchange, compress in wires:
            p = nekbone.setup_problem(
                mesh, backend="reference", nrhs=nrhs, precision="bf16_x32",
                shard_ctx=_ctx(world, grid, exchange, compress))
            res = nekbone.solve(p, b, tol=tol, max_iter=500)
            true = torch.linalg.norm(b - ref.op(res.x), dim=0)
            rows.append({"nrhs": nrhs, "tol": tol, "exchange": exchange,
                         "compress": compress, "it": _ints(res.iterations),
                         "status": _ints(res.status),
                         "true": [float(t) for t in torch.atleast_1d(true)],
                         "x_digest": digest(res.x)})
    return rows


def jax_rows(world, grid, exchange="psum"):
    """The reference-backend trilinear solve of `jax_rhs` through
    `exchange`, twice (the repeat must be bitwise equal), for the
    comparison with the JAX package's sharded solve."""
    mesh = mesh_3x3x2()
    sh = nekbone.setup_problem(mesh, variant="trilinear", backend="reference",
                               shard_ctx=_ctx(world, grid, exchange))
    b = torch.as_tensor(jax_rhs(mesh))
    first = nekbone.solve(sh, b, tol=TOL, max_iter=300)
    again = nekbone.solve(sh, b, tol=TOL, max_iter=300)
    return [{"iterations": int(first.iterations),
             "status": int(first.status), "x": first.x.numpy(),
             "x_digest": digest(first.x),
             "repeat_bitwise": torch.equal(first.x, again.x)}]


def collective_rows(world, grid):
    """The collectives of one global operator application at nrhs 4
    (`analysis.record.CollectiveRecorder`): the interface all_reduce of
    (NS, 4) and globalize's one of (Ng, 4)."""
    mesh = mesh_3x3x2()
    sh = nekbone.setup_problem(mesh, variant="trilinear", backend="reference",
                               shard_ctx=_ctx(world, grid), nrhs=4)
    with record.CollectiveRecorder() as rec:
        sh.op(torch.ones((mesh.n_global, 4)))
    return [{"shapes": [list(c.shape) for c in rec.events
                        if c.kind == "all_reduce"],
             "events": rec.events, "n_shared": int(sh.partition.n_shared),
             "n_global": mesh.n_global}]


def nbr_solve_rows(world, grid):
    """The neighbour solve beside the psum solve of the same b
    (test_nekbone_neighbour.py::test_neighbour_solve_matches_psum): both
    equations, the reference backend at nrhs 1 and 4 and the kernels'
    plain versions (merged, partial) at nrhs 1, on the 18-element mesh and,
    at two shards, the 5-element one (E divisible by neither)."""
    meshes = [mesh_3x3x2()]
    if world == 2:
        meshes.append(mesh_gen.deform_trilinear(
            mesh_gen.box_mesh(5, 1, 1, 3), seed=4))
    rng = np.random.default_rng(0)
    rows = []
    for mesh in meshes:
        for nrhs in (1, 4):
            shape = (mesh.n_global,) + ((nrhs,) if nrhs > 1 else ())
            x_true = torch.as_tensor(rng.standard_normal(shape),
                                     dtype=torch.float32)
            for helm in (False, True):
                for backend in ("reference", "cuda"):
                    if backend == "cuda" and nrhs > 1:
                        continue
                    variant = ("merged" if helm else "partial") \
                        if backend == "cuda" else "trilinear"
                    kw = dict(variant=variant, helmholtz=helm,
                              backend=backend, nrhs=nrhs)
                    ps = nekbone.setup_problem(
                        mesh, shard_ctx=_ctx(world, grid), **kw)
                    b = nekbone.rhs_from_solution(ps, x_true)
                    r0 = nekbone.solve(ps, b, tol=TOL, max_iter=300)
                    nb = nekbone.setup_problem(
                        mesh, shard_ctx=_ctx(world, grid, "neighbour"), **kw)
                    r1 = nekbone.solve(nb, b, tol=TOL, max_iter=300)
                    rows.append({
                        "elements": len(mesh.verts), "helm": helm,
                        "backend": backend, "nrhs": nrhs,
                        "split": nekbone._neighbour_launch_plan(
                            nb.partition)[0],
                        "status_psum": _ints(r0.status),
                        "status_nbr": _ints(r1.status),
                        "it_psum": _ints(r0.iterations),
                        "it_nbr": _ints(r1.iterations),
                        "dx": float((r1.x - r0.x).abs().max()),
                        "x_digest": digest(r1.x)})
    return rows


def nbr_wire_rows(world, grid):
    """One neighbour exchange of this rank's own random partials on every
    wire, nrhs 1 and 4 (and bfloat16 partials on the uncompressed wire):
    each rank returns the global ids of its interface dofs, the values it
    holds after the exchange and, for the comparison, the psum exchange's
    values."""
    mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(4, 4, 2, 2), seed=3)
    ctx = _ctx(world, grid, "neighbour")
    part = mesh_gen.partition_elements(mesh, world, grid=grid)
    t = ctx.rank

    def rows_of(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a[t]), dtype=dtype)

    rounds = gs.partition_rounds(part, t, CPU)
    sidx = rows_of(part.shared_idx, torch.int64)
    spres = rows_of(part.shared_present)
    present = np.flatnonzero(part.shared_present[t])
    slots = torch.as_tensor(part.shared_idx[t][present])
    gids = part.local_to_global[t][part.shared_idx[t][present]]
    rng = np.random.default_rng(100 + t)
    rows = []
    for dtype, wire in ((torch.float32, None), (torch.bfloat16, None),
                        (torch.float32, "bf16"), (torch.float32, "int8"),
                        (torch.bfloat16, "int8")):
        for nrhs in (1, 4):
            shape = (part.n_local,) + ((nrhs,) if nrhs > 1 else ())
            y = torch.as_tensor(rng.standard_normal(shape),
                                dtype=torch.float32).to(dtype)
            got = gs.exchange_neighbour(y, rounds, ctx.group, wire, sidx,
                                        spres)
            psum = gs.exchange_shared(y, sidx, spres, ctx.group)
            rows.append({"dtype": str(dtype), "wire": wire, "nrhs": nrhs,
                         "gids": gids,
                         "bits": got[slots].view(torch.int16 if dtype ==
                                                 torch.bfloat16 else
                                                 torch.int32).numpy(),
                         "vals": got[slots].float().numpy(),
                         "psum": psum[slots].float().numpy()})
    return rows


def nbr_ladder_rows(world, grid):
    """A persistent NaN in the bf16 inner sweeps of a neighbour + int8
    bf16_x32 solve: the ladder climbs to precision:float32, whose rebuilt
    problem keeps the shard context's exchange and codec (each rung's
    problem is recorded as it solves)."""
    mesh = mesh_3x3x2()
    x_true = torch.as_tensor(np.random.default_rng(0).standard_normal(
        mesh.n_global), dtype=torch.float32)
    prob = nekbone.setup_problem(
        mesh, variant="trilinear", backend="reference",
        precision="bf16_x32",
        shard_ctx=_ctx(world, grid, "neighbour", "int8"))
    b = nekbone.rhs_from_solution(prob, x_true)
    seen = []

    def solve_fn(p, b_arr, x0, fault):
        seen.append([p.precision, p.shard_ctx.exchange, p.shard_ctx.compress,
                     fault is not None])
        return nekbone.solve(
            p, torch.as_tensor(b_arr, dtype=p.diag.dtype), tol=TOL,
            max_iter=300, fault=fault,
            x0=None if x0 is None else torch.as_tensor(x0, dtype=p.diag.dtype))

    rep = solve_resilient(prob, b, tol=TOL, max_iter=300,
                          fault=FaultSpec(mode="nan", iteration=2, shard=1),
                          persistent=True, solve_fn=solve_fn)
    return [{"converged": rep.converged,
             "rungs": [a.rung for a in rep.attempts],
             "problems": seen,
             "true_residual": float(rep.true_residual[0])}]


def nbr_collective_rows(world, grid):
    """The collectives of one neighbour operator application at nrhs 4
    (`analysis.record.CollectiveRecorder`): every all_reduce's shape, and
    every point-to-point op of each `batch_isend_irecv` (send or receive,
    peer, shape, dtype, tag)."""
    mesh = mesh_3x3x2() if grid is None else mesh_gen.deform_trilinear(
        mesh_gen.box_mesh(4, 4, 2, 2), seed=3)
    sh = nekbone.setup_problem(mesh, variant="trilinear", backend="reference",
                               shard_ctx=_ctx(world, grid, "neighbour"),
                               nrhs=4)
    with record.CollectiveRecorder() as rec:
        sh.op(torch.ones((mesh.n_global, 4)))
    part = sh.partition
    return [{"rank": dist.get_rank(),
             "all_reduce": [list(c.shape) for c in rec.events
                            if c.kind == "all_reduce"],
             "batches": [[[c.kind, c.peer, list(c.shape), f"torch.{c.dtype}",
                           c.tag] for c in batch]
                         for batch in rec.batches()],
             "events": rec.events, "offsets": list(part.nbr_offsets),
             "widths": [int(t.shape[1]) for t in part.nbr_lo_idx],
             "n_shared": int(part.n_shared), "n_global": mesh.n_global}]


def contract_rows(world, grid):
    """One global operator application of each exchange on the 3x3x2 mesh,
    recorded after a warm-up application (`analysis.record`): psum,
    neighbour, and neighbour over the int8 wire, nrhs 1; with the
    partition's interface size and neighbour offsets (the lint's contract
    tests)."""
    mesh = mesh_3x3x2()
    rows = []
    for exchange, compress in (("psum", None), ("neighbour", None),
                               ("neighbour", "int8")):
        sh = nekbone.setup_problem(
            mesh, variant="trilinear", backend="reference",
            shard_ctx=_ctx(world, grid, exchange, compress))
        x = torch.ones(mesh.n_global)
        sh.op(x)
        with record.CollectiveRecorder() as rec, \
                record.OpRecorder() as ops:
            sh.op(x)
        rows.append({"exchange": exchange, "compress": compress,
                     "events": rec.events, "ops": ops.ops,
                     "rank": dist.get_rank(),
                     "n_shared": int(sh.partition.n_shared),
                     "offsets": list(sh.partition.nbr_offsets)})
    return rows


def nbr_thin_rows(world, grid):
    """An all-interface partition (a thin 4x1x1 mesh, one element a
    shard): setup warns that nothing overlaps the exchange, and the
    unsplit neighbour solve matches the psum one
    (test_nekbone_box.py::test_degenerate_overlap_warns_at_setup)."""
    mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(4, 1, 1, 2), seed=3)
    x_true = torch.as_tensor(np.random.default_rng(0).standard_normal(
        mesh.n_global), dtype=torch.float32)
    ps = nekbone.setup_problem(mesh, variant="trilinear", backend="reference",
                               shard_ctx=_ctx(world, grid))
    b = nekbone.rhs_from_solution(ps, x_true)
    r0 = nekbone.solve(ps, b, tol=TOL, max_iter=300)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        nb = nekbone.setup_problem(
            mesh, variant="trilinear", backend="reference",
            shard_ctx=_ctx(world, grid, "neighbour"))
    r1 = nekbone.solve(nb, b, tol=TOL, max_iter=300)
    msgs = [str(w.message) for w in caught
            if "no interior elements" in str(w.message)]
    return [{"warned": len(msgs), "mentions_grid": "grid" in "".join(msgs),
             "it_psum": int(r0.iterations), "it_nbr": int(r1.iterations),
             "status": [int(r0.status), int(r1.status)],
             "dx": float((r1.x - r0.x).abs().max())}]


def width_rows(world, grid):
    """One right-hand side at column 0 of sharded `pcg_block` blocks of
    width 1, 2, 4 and 8, the other columns zero (a served block's padding):
    column 0's x, status, iterations and residual at each width; and the
    per-column dots of `owned_dot(batched=True)` of one random column
    padded the same way, on a random ownership mask of this rank's."""
    mesh = mesh_3x3x2()
    sh = nekbone.setup_problem(mesh, variant="trilinear",
                               shard_ctx=_ctx(world, grid))
    b0 = torch.as_tensor(jax_rhs(mesh))
    n = mesh.n_global
    rng = np.random.default_rng(20 + dist.get_rank())
    u0, v0 = (torch.as_tensor(rng.standard_normal(n), dtype=torch.float32)
              for _ in range(2))
    dot = owned_dot(torch.as_tensor(rng.random(n) < 0.7), None,
                    batched=True)

    def padded(col, width):
        return torch.cat([col[:, None], torch.zeros(n, width - 1)], dim=-1)

    rows = []
    for width in (1, 2, 4, 8):
        res = sh.run_pcg(padded(b0, width), TOL, 300)
        d = dot(padded(u0, width), padded(v0, width))
        rows.append({"width": width, "x_digest": digest(res.x[:, 0]),
                     "status": int(res.status[0]),
                     "iterations": int(res.iterations[0]),
                     "residual": float(res.residual[0]),
                     "dot": float(d[0]), "pad_dots": d[1:].tolist()})
    return rows


NEIGHBOUR_WIRES = (("neighbour", None), ("neighbour", "bf16"),
                   ("neighbour", "int8"))
GROUPS = {"op": op_rows, "solve": solve_rows, "vector": vector_rows,
          "box": box_rows, "lambda": lambda_rows, "nan": nan_rows,
          "drop": drop_rows, "refined": refined_rows, "jax": jax_rows,
          "collectives": collective_rows, "width": width_rows,
          "nbr_op": functools.partial(op_rows, exchange="neighbour"),
          "nbr_solve": nbr_solve_rows, "nbr_wire": nbr_wire_rows,
          "nbr_box": functools.partial(box_rows, exchange="neighbour"),
          "nbr_nan": functools.partial(nan_rows, exchange="neighbour"),
          "nbr_drop": functools.partial(drop_rows, exchange="neighbour"),
          "nbr_refined": functools.partial(refined_rows,
                                           wires=NEIGHBOUR_WIRES),
          "nbr_ladder": nbr_ladder_rows,
          "nbr_jax": functools.partial(jax_rows, exchange="neighbour"),
          "nbr_collectives": nbr_collective_rows, "nbr_thin": nbr_thin_rows,
          "contracts": contract_rows}


def cases(rank, world, grid, groups):
    torch.set_num_threads(1)
    return {name: GROUPS[name](world, grid) for name in groups}


def fail_on_rank_1(rank, world):
    """Rank 1 raises; rank 0 waits for it in a collective."""
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    dist.all_reduce(torch.ones(1))


def card_rows(rank, world):
    """Two gloo ranks on the card at 8^3, N=7, through the kernels: the
    sharded solve against the single-device one each rank also runs."""
    ctx = make_solver_ctx(devices=world)
    rows = []
    for variant, helm in (("trilinear", False), ("merged", True)):
        mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(8, 8, 8, 7),
                                         seed=3)
        kw = dict(variant=variant, helmholtz=helm, backend="cuda")
        one = nekbone.setup_problem(mesh, device=ctx.device, **kw)
        x_true = nekbone.random_solution(one, seed=0)
        b = nekbone.rhs_from_solution(one, x_true)
        r0 = nekbone.solve(one, b, tol=TOL, max_iter=1000)
        sh = nekbone.setup_problem(mesh, shard_ctx=ctx, **kw)
        r1 = nekbone.solve(sh, b, tol=TOL, max_iter=1000)
        rows.append({"variant": variant, "device": str(ctx.device),
                     "backend": sh.backend,
                     "status": [int(r0.status), int(r1.status)],
                     "iterations": [int(r0.iterations),
                                    int(r1.iterations)],
                     "dx": float((r1.x - r0.x).abs().max()),
                     "x_digest": digest(r1.x.cpu())})
    return rows


def card_neighbour_rows(rank, world):
    """Two gloo ranks on the card at 8^3, N=7, through the kernels, with
    the neighbour exchange staged through pinned host memory: the psum and
    neighbour solves of trilinear Poisson and merged Helmholtz, and the
    bf16_x32 trilinear solve at tol 0.03 on the neighbour wire with each
    codec."""
    mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(8, 8, 8, 7), seed=3)
    rows = []
    for variant, helm in (("trilinear", False), ("merged", True)):
        kw = dict(variant=variant, helmholtz=helm, backend="cuda")
        ps = nekbone.setup_problem(mesh, shard_ctx=make_solver_ctx(
            devices=world), **kw)
        b = nekbone.rhs_from_solution(ps, nekbone.random_solution(ps))
        r0 = nekbone.solve(ps, b, tol=TOL, max_iter=1000)
        nb = nekbone.setup_problem(mesh, shard_ctx=make_solver_ctx(
            devices=world, exchange="neighbour"), **kw)
        r1 = nekbone.solve(nb, b, tol=TOL, max_iter=1000)
        rows.append({"variant": variant, "device": str(nb.device),
                     "split": nekbone._neighbour_launch_plan(
                         nb.partition)[0],
                     "status": [int(r0.status), int(r1.status)],
                     "iterations": [int(r0.iterations), int(r1.iterations)],
                     "dx": float((r1.x - r0.x).abs().max()),
                     "x_digest": digest(r1.x.cpu())})
    fp32 = nekbone.setup_problem(mesh, variant="trilinear", backend="cuda",
                                 shard_ctx=make_solver_ctx(devices=world))
    for wire in (None, "bf16", "int8"):
        p = nekbone.setup_problem(
            mesh, variant="trilinear", backend="cuda", precision="bf16_x32",
            shard_ctx=make_solver_ctx(devices=world, exchange="neighbour",
                                      compress=wire))
        b = nekbone.random_rhs(p)
        res = nekbone.solve(p, b, tol=0.03, max_iter=3000)
        rows.append({"variant": "trilinear/bf16_x32", "wire": wire,
                     "status": _ints(res.status),
                     "iterations": _ints(res.iterations),
                     "true": float(torch.linalg.norm(b - fp32.op(res.x))),
                     "x_digest": digest(res.x.cpu())})
    return rows
