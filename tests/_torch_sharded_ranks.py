"""Rank functions of tests/test_torch_sharded.py: the port's sharded solves
on gloo ranks on the CPU, beside the single-device solves each rank also
runs.  Spawned children import this module, so it imports neither jax nor
the reference package, and every function here is module-level.

`cases(rank, world, grid, groups)` runs the case groups named in `groups`
and returns ``{group: rows}``; every rank returns its own rows, which the
tests compare across ranks where the port promises equal results.
"""

import hashlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import mesh_gen, nekbone
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


def _ctx(world, grid):
    ctx = make_solver_ctx(devices=world, grid=grid, device="cpu")
    assert ctx is not None and ctx.n_shards == world
    return ctx


def op_rows(world, grid):
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
            sh = nekbone.setup_problem(mesh, shard_ctx=_ctx(world, grid),
                                       **kw)
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


def box_rows(world, grid):
    """The solves test_nekbone_box.py::test_box_solve_matches_slab runs with
    the psum exchange, on this (S, grid): the tests hold the slab's rows
    against the box's."""
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
        sh = nekbone.setup_problem(mesh, shard_ctx=_ctx(world, grid),
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


def nan_rows(world, grid):
    """A NaN on the last shard at iteration 3, nrhs 1 and 4 (column 2)
    (test_resilience_sharded.py::test_sharded_nan_detected_within_one_
    iteration, the psum exchange)."""
    mesh = mesh_3x3x2()
    rng = np.random.default_rng(0)
    rows = []
    for nrhs in (1, 4):
        sh = nekbone.setup_problem(mesh, variant="trilinear",
                                   backend="reference",
                                   shard_ctx=_ctx(world, grid), nrhs=nrhs)
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


def drop_rows(world, grid):
    """drop_exchange on shard 1 at iteration 2 under the retry ladder
    (test_resilience_sharded.py::test_drop_exchange_caught_by_verification_
    and_restart, the psum exchange)."""
    mesh = mesh_3x3x2()
    x_true = torch.as_tensor(np.random.default_rng(0).standard_normal(
        mesh.n_global), dtype=torch.float32)
    sh = nekbone.setup_problem(mesh, variant="trilinear", backend="reference",
                               shard_ctx=_ctx(world, grid))
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


def refined_rows(world, grid):
    """The sharded bf16_x32 solve with the psum exchange, nrhs 1 and 4,
    tol 1e-5: CONVERGED, true residual (fp32 reference-backend operator)
    within 1.5 tol (test_mixed_precision.py::test_sharded_refined_solve_
    every_wire, its psum wire)."""
    mesh = mesh_3x3x2()
    rng = np.random.default_rng(0)
    ref = nekbone.setup_problem(mesh, backend="reference", device=CPU)
    tol = 1e-5
    rows = []
    for nrhs in (1, 4):
        shape = (mesh.n_global,) + ((nrhs,) if nrhs > 1 else ())
        b = rng.standard_normal(shape).astype(np.float32)
        b = torch.as_tensor(b / np.linalg.norm(b, axis=0) * 30.0)
        p = nekbone.setup_problem(mesh, backend="reference",
                                  shard_ctx=_ctx(world, grid), nrhs=nrhs,
                                  precision="bf16_x32")
        res = nekbone.solve(p, b, tol=tol, max_iter=500)
        true = torch.linalg.norm(b - ref.op(res.x), dim=0)
        rows.append({"nrhs": nrhs, "tol": tol, "it": _ints(res.iterations),
                     "status": _ints(res.status),
                     "true": [float(t) for t in torch.atleast_1d(true)]})
    return rows


def jax_rows(world, grid):
    """The reference-backend trilinear solve of `jax_rhs`, twice (the
    repeat must be bitwise equal), for the comparison with the JAX
    package's sharded solve."""
    mesh = mesh_3x3x2()
    sh = nekbone.setup_problem(mesh, variant="trilinear", backend="reference",
                               shard_ctx=_ctx(world, grid))
    b = torch.as_tensor(jax_rhs(mesh))
    first = nekbone.solve(sh, b, tol=TOL, max_iter=300)
    again = nekbone.solve(sh, b, tol=TOL, max_iter=300)
    return [{"iterations": int(first.iterations),
             "status": int(first.status), "x": first.x.numpy(),
             "x_digest": digest(first.x),
             "repeat_bitwise": torch.equal(first.x, again.x)}]


def collective_rows(world, grid):
    """The collectives of one global operator application at nrhs 4: the
    interface all_reduce of (NS, 4) and globalize's one of (Ng, 4)."""
    mesh = mesh_3x3x2()
    sh = nekbone.setup_problem(mesh, variant="trilinear", backend="reference",
                               shard_ctx=_ctx(world, grid), nrhs=4)
    shapes = []
    real = dist.all_reduce

    def counting(tensor, *args, **kwargs):
        shapes.append(list(tensor.shape))
        return real(tensor, *args, **kwargs)

    dist.all_reduce = counting
    try:
        sh.op(torch.ones((mesh.n_global, 4)))
    finally:
        dist.all_reduce = real
    return [{"shapes": shapes, "n_shared": int(sh.partition.n_shared),
             "n_global": mesh.n_global}]


GROUPS = {"op": op_rows, "solve": solve_rows, "vector": vector_rows,
          "box": box_rows, "lambda": lambda_rows, "nan": nan_rows,
          "drop": drop_rows, "refined": refined_rows, "jax": jax_rows,
          "collectives": collective_rows}


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
