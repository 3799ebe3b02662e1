"""The port's contract lint: `python -m repro_torch.analysis.lint`.

The counterpart of `repro.analysis.lint`: a registry of the port's real
entry points — the dense solve, the sharded psum and neighbour solves on 2
and 4 ranks, the reduced-width bf16 and int8 wires, the ``bf16_x32``
refined solve, the bucketed solve service, and all five axhelm variants —
each bound to the contract suite that checks its invariants
(`analysis.contracts`), under the reference's 14 names.

Each entry builds its problem, runs what it checks once as the warm-up,
then records one captured loop body (8 gated iterations) or one operator
application (`analysis.record`) and evaluates its contracts.  The sharded
entries run on `torch.distributed` gloo ranks (`distributed.launch.spawn`,
one spawn for the entries of each world size): on the CPU, or all on the
one card, as `chip_smoke.py`'s phases 5f and 5g do; every rank's records
are checked.  The counts the sharded suites expect come from the port's
own partition (`partition.n_shared`, `partition.nbr_offsets`), which the
tests hold equal to the reference's for the same mesh.  On the card the
lint also replays each captured chunk under sync debug mode "error" and
reads the build's ptxas report (registers, spills) for every launch the
axhelm entries resolve.

    python -m repro_torch.analysis.lint                  # every entry
    python -m repro_torch.analysis.lint --list           # the registry
    python -m repro_torch.analysis.lint --only dense_poisson,psum_solve_2dev
    python -m repro_torch.analysis.lint --json report.json --device cpu

It prints a line an entry and exits nonzero on any violation or error.
The entries run on the card unless ``--device cpu`` (``device="cpu"``)
says otherwise.  Registering a new entry: a builder ``(device) ->
[(EntryArtifacts, [contracts...]), ...]`` decorated with
``@entry(name, description)`` (``ranks=n`` for one that runs on n ranks).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.analysis import contracts as C
from repro_torch.analysis import record

Check = Tuple[C.EntryArtifacts, List[C.Contract]]

# the N1 the axhelm entries check a launch at: the main path's (order 7),
# then one a body — tuned (order 9), slab, plane, staged
AXHELM_N1 = (8, 10, 20, 32, 64)
SPAWN_TIMEOUT_S = 300.0


@dataclass
class Entry:
    name: str
    description: str
    build: Callable[[torch.device], List[Check]]
    ranks: int = 0          # > 0: built on that many gloo ranks


REGISTRY: Dict[str, Entry] = {}


def entry(name: str, description: str, ranks: int = 0):
    def deco(fn):
        REGISTRY[name] = Entry(name, description, fn, ranks)
        return fn
    return deco


# ------------------------------------------------------- shared builders ---


def _mesh(nx=3, ny=3, nz=2, order=3, deform=True):
    from repro_torch.core import mesh_gen
    mesh = mesh_gen.box_mesh(nx, ny, nz, order)
    return mesh_gen.deform_trilinear(mesh, seed=3) if deform else mesh


def _no_collectives_census() -> C.CollectiveCensus:
    return C.CollectiveCensus(exact={"all_reduce": 0, "p2p": 0})


def _solve_artifacts(name: str, problem) -> C.EntryArtifacts:
    """One captured loop body of `problem`'s solve loops (after the
    warm-up solve that built them), and on a card the sync-free replays."""
    from repro_torch.core.nekbone import ShardedNekboneProblem

    ops, events, applications = record.record_chunks(problem.graphs)
    meta = {"applications": applications}
    # the sharded loops run eagerly: no graph to replay
    if problem.device.type == "cuda" and \
            not isinstance(problem, ShardedNekboneProblem):
        meta["replay_error"] = record.replay_sync_error(problem.graphs)
    return C.EntryArtifacts(name, ops=ops, collectives=events, meta=meta)


def _op_artifacts(name: str, op, x, **meta) -> C.EntryArtifacts:
    """One application of the global operator `op` to `x`, after one
    application as the warm-up (the first builds the basis constants,
    `ops._constants`, from float64 arrays)."""
    op(x)
    with record.CollectiveRecorder() as rec, record.OpRecorder() as ops:
        op(x)
    return C.EntryArtifacts(name, ops=ops.ops, collectives=rec.events,
                            meta={"applications": 1, **meta})


def _dense_checks(name: str, device, precision=None, tol=1e-6):
    from repro_torch.core import nekbone

    mesh = _mesh(2, 2, 1)
    prob = nekbone.setup_problem(mesh, variant="trilinear",
                                 dtype=torch.float32, device=device,
                                 precision=precision)
    b = torch.ones(mesh.n_global, dtype=torch.float32, device=device)
    nekbone.solve(prob, b, tol=tol, max_iter=200)
    art = _solve_artifacts(f"{name}:solve", prob)
    return [(art, [_no_collectives_census(), C.AccumulationDtype(),
                   C.NoF64Leak(), C.NoHostTransfer()])]


@contextlib.contextmanager
def _quiet_overlap():
    """Silence setup's warning that a 4-slab partition of the 3x3x2 mesh
    leaves no interior elements for the neighbour exchange to overlap: the
    lint checks the reference's mesh, whose wire, not its overlap, the
    contracts read."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="exchange='neighbour' has "
                                "no interior elements", category=UserWarning)
        yield


def _rank_rounds(part, rank: int) -> int:
    """The neighbour exchange's shifts a rank takes part in, an
    application: a +k and a -k shift for each offset k with a partner at
    rank + k or rank - k (`gather_scatter.neighbour_rounds`) — 2 x
    len(nbr_offsets) wherever every offset has one."""
    return 2 * sum(1 for k in part.nbr_offsets
                   if rank + k < part.n_shards or rank - k >= 0)


def _sharded_solve_checks(name, exchange, devices, device, nrhs=1):
    """One rank's op and solve artifacts and the census suites of one
    sharded configuration."""
    from repro_torch.core import nekbone
    from repro_torch.distributed.context import make_solver_ctx

    mesh = _mesh()
    ctx = make_solver_ctx(devices=devices, exchange=exchange, device=device)
    with _quiet_overlap():
        sh = nekbone.setup_problem(mesh, variant="trilinear",
                                   dtype=torch.float32, shard_ctx=ctx,
                                   nrhs=nrhs)
    part = sh.partition
    ns = int(part.n_shared)
    shape = (mesh.n_global, nrhs) if nrhs > 1 else (mesh.n_global,)
    b = torch.ones(shape, dtype=torch.float32, device=ctx.device)
    where = f"@rank{ctx.rank}"
    op_art = _op_artifacts(f"{name}:op{where}", sh.op, b)
    nekbone.solve(sh, b, tol=1e-6, max_iter=300)
    sv_art = _solve_artifacts(f"{name}:solve{where}", sh)
    base = [C.NoF64Leak(), C.NoHostTransfer()]
    if exchange == "psum":
        census = C.CollectiveCensus(
            exact={"p2p": 0},
            matchers=[C.interface_allreduce(ns, nrhs=nrhs, exact=1)])
    else:
        census = C.CollectiveCensus(
            exact={"permute": _rank_rounds(part, ctx.rank)},
            matchers=[C.interface_allreduce(ns, exact=0)])
    return [(op_art, [census] + base),
            (sv_art, [census, C.AccumulationDtype()] + base)]


# --------------------------------------------------------------- entries ---


@entry("dense_poisson",
       "single-device trilinear Poisson solve: zero collectives, fp32 "
       "accumulation, no f64, no host reads in the captured loop body")
def _dense_poisson(device) -> List[Check]:
    return _dense_checks("dense_poisson", device)


@entry("psum_solve_2dev",
       "sharded psum solve, 2 ranks: ONE interface all_reduce per "
       "application, zero point-to-point messages", ranks=2)
def _psum2(device) -> List[Check]:
    return _sharded_solve_checks("psum_solve_2dev", "psum", 2, device)


@entry("psum_solve_4dev",
       "sharded psum solve, 4 ranks, nrhs=4: the batch rides ONE "
       "interface all_reduce per application", ranks=4)
def _psum4(device) -> List[Check]:
    return _sharded_solve_checks("psum_solve_4dev", "psum", 4, device,
                                 nrhs=4)


@entry("neighbour_solve_2dev",
       "neighbour (point-to-point) solve, 2 ranks: 2 shifts per offset "
       "per application, ZERO interface all_reduces", ranks=2)
def _nbr2(device) -> List[Check]:
    return _sharded_solve_checks("neighbour_solve_2dev", "neighbour", 2,
                                 device)


@entry("neighbour_solve_4dev",
       "neighbour solve, 4 ranks, nrhs=4: same shift counts as nrhs=1, "
       "ZERO interface all_reduces", ranks=4)
def _nbr4(device) -> List[Check]:
    return _sharded_solve_checks("neighbour_solve_4dev", "neighbour", 4,
                                 device, nrhs=4)


def _wire_checks(name, compress, require, device):
    from repro_torch.core import nekbone
    from repro_torch.distributed.context import make_solver_ctx

    mesh = _mesh()
    ctx = make_solver_ctx(devices=4, exchange="neighbour",
                          compress=compress, device=device)
    with _quiet_overlap():
        sh = nekbone.setup_problem(mesh, variant="trilinear",
                                   dtype=torch.float32, shard_ctx=ctx,
                                   precision="bf16_x32")
    ns = int(sh.partition.n_shared)
    b = torch.ones(mesh.n_global, dtype=torch.float32, device=ctx.device)
    nekbone.solve(sh, b, tol=1e-5, max_iter=300)
    # the inner sweeps' loop body: the bf16 operator over the codec's wire
    art = _solve_artifacts(f"{name}:refined_solve@rank{ctx.rank}", sh)
    suite = [
        C.WireWidth(require=require),
        C.CollectiveCensus(min_counts={"p2p": 1},
                           matchers=[C.interface_allreduce(ns, exact=0)]),
        C.NoF64Leak(), C.NoHostTransfer(),
    ]
    return [(art, suite)]


@entry("neighbour_wire_bf16_4dev",
       "bf16-compressed halo wire: the inner sweeps' messages ship "
       "bfloat16, zero interface all_reduces", ranks=4)
def _wire_bf16(device) -> List[Check]:
    return _wire_checks("neighbour_wire_bf16_4dev", "bf16", {"bfloat16"},
                        device)


@entry("neighbour_wire_int8_4dev",
       "int8-compressed halo wire: the inner sweeps' messages ship int8 "
       "codes, zero interface all_reduces", ranks=4)
def _wire_int8(device) -> List[Check]:
    return _wire_checks("neighbour_wire_int8_4dev", "int8", {"int8"},
                        device)


@entry("bf16_x32_refine_dense",
       "dense mixed-precision refined solve: bf16 storage, >= fp32 "
       "accumulation in the inner sweeps' loop body")
def _refine_dense(device) -> List[Check]:
    return _dense_checks("bf16_x32_refine_dense", device,
                         precision="bf16_x32", tol=1e-5)


@entry("service_buckets",
       "bucketed solve service: after warmup a randomized request stream "
       "captures (on the CPU: builds) ZERO new loops or operators")
def _service(device) -> List[Check]:
    import numpy as np

    from repro_torch.core import nekbone
    from repro_torch.serving.solve_service import SolveRequest, SolveService

    mesh = _mesh(2, 2, 1)
    prob = nekbone.setup_problem(mesh, variant="trilinear",
                                 dtype=torch.float32, device=device)
    svc = SolveService(prob, max_batch=4, tol=1e-6, max_iter=200)
    svc.warmup()
    warm = svc.trace_count
    rng = np.random.default_rng(0)
    depth_rng = np.random.default_rng(1)
    uid = 0
    for _ in range(4):
        for _ in range(int(depth_rng.integers(1, svc.max_batch + 1))):
            x = torch.as_tensor(rng.standard_normal(mesh.n_global),
                                dtype=torch.float32, device=prob.device)
            svc.submit(SolveRequest(uid=uid,
                                    b=nekbone.rhs_from_solution(prob, x)))
            uid += 1
        svc.step()
    svc.run_until_drained()
    art = C.EntryArtifacts("service_buckets:stream",
                           meta={"traces_before": warm,
                                 "traces_after": svc.trace_count,
                                 "requests": uid})
    return [(art, [C.NoRetrace()])]


def _axhelm_checks(variant: str, device) -> List[Check]:
    from repro_torch.core import nekbone
    from repro_torch.kernels.axhelm import build

    helm = variant == "merged"
    # parallelepiped geometry must stay affine — no trilinear deformation
    mesh = _mesh(2, 2, 1, deform=variant != "parallelepiped")
    # the bf16 plain operator drives the AccumulationDtype check: its
    # contractions must accumulate in fp32 even at bf16 storage
    prob = nekbone.setup_problem(mesh, variant=variant, helmholtz=helm,
                                 dtype=torch.bfloat16, backend="reference",
                                 device=device)
    x = torch.ones(mesh.n_global, dtype=torch.bfloat16, device=prob.device)
    meta = {}
    if prob.device.type == "cuda":
        meta["ptxas"] = build.ptxas_instantiations(build.ptxas_report())
    art = _op_artifacts(f"axhelm_{variant}:op_bf16", prob.op, x, **meta)
    return [(art, [C.AccumulationDtype()] + [
        C.ResourceBudget(variant, n1, dtype, helmholtz=helm,
                         device=prob.device)
        for n1 in AXHELM_N1 for dtype in (torch.float32, torch.bfloat16)])]


for _variant in ("precomputed", "trilinear", "parallelepiped", "merged",
                 "partial"):
    entry(f"axhelm_{_variant}",
          f"axhelm[{_variant}]: the resolved launch fits the card's shared "
          f"memory (and registers, without spills, on the card) at N1 "
          f"{', '.join(map(str, AXHELM_N1))}; the bf16 plain operator "
          f"accumulates in fp32")(
        lambda device, v=_variant: _axhelm_checks(v, device))


# ------------------------------------------------------------------- CLI ---


def _row(e: Entry) -> dict:
    return {"entry": e.name, "description": e.description,
            "status": "pass", "violations": [], "checks": 0}


def _evaluate(row: dict, checks: List[Check]) -> None:
    for art, suite in checks:
        row["checks"] += len(suite)
        for v in C.check_suite(art, suite):
            row["violations"].append({"contract": v.contract,
                                      "artifact": v.entry,
                                      "message": v.message})
    if row["violations"]:
        row["status"] = "fail"


def run_entry(e: Entry, device) -> dict:
    """Build and check one single-process entry."""
    t0 = time.monotonic()
    row = _row(e)
    try:
        _evaluate(row, e.build(device))
    except Exception as exc:  # an entry that cannot build is a failure
        row["status"] = "error"
        row["error"] = f"{type(exc).__name__}: {exc}"
    row["seconds"] = time.monotonic() - t0
    return row


def _rank_entries(rank: int, world: int, names, device) -> dict:
    """One gloo rank: build each named entry; {name: (checks, seconds)}
    (module level: the spawned ranks import it)."""
    torch.set_num_threads(1)
    out = {}
    for name in names:
        t0 = time.monotonic()
        checks = REGISTRY[name].build(device)
        out[name] = (checks, time.monotonic() - t0)
    return out


def run_entries(names, device) -> List[dict]:
    """Check the named entries on `device`: each single-process entry in
    this process, the sharded ones in one spawn of ranks per world size
    (a rank that raises fails every entry of its spawn)."""
    from repro_torch.core.nekbone import resolve_device
    from repro_torch.distributed.launch import spawn

    device = resolve_device(device)
    rows = {}
    worlds: Dict[int, list] = {}
    for name in names:
        e = REGISTRY[name]
        if e.ranks:
            worlds.setdefault(e.ranks, []).append(name)
        else:
            rows[name] = run_entry(e, device)
    for world, group in worlds.items():
        try:
            per_rank = spawn(_rank_entries, world, (group, str(device)),
                             timeout_s=SPAWN_TIMEOUT_S)
        except Exception as exc:  # a rank raised or died
            for name in group:
                rows[name] = {**_row(REGISTRY[name]), "status": "error",
                              "error": f"{type(exc).__name__}: {exc}",
                              "seconds": 0.0}
            continue
        for name in group:
            row = _row(REGISTRY[name])
            for built in per_rank:
                _evaluate(row, built[name][0])
            row["seconds"] = max(built[name][1] for built in per_rank)
            rows[name] = row
    return [rows[n] for n in names]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="check the port's performance contracts")
    ap.add_argument("--only", default="",
                    help="comma-separated entry names (default: all)")
    ap.add_argument("--list", action="store_true",
                    help="list registered entries and exit")
    ap.add_argument("--json", default="",
                    help="write the JSON report to this path")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    if args.list:
        for e in REGISTRY.values():
            print(f"{e.name:26s} {e.description}")
        return 0

    names = [n for n in args.only.split(",") if n] or list(REGISTRY)
    unknown = [n for n in names if n not in REGISTRY]
    if unknown:
        print(f"unknown entries: {', '.join(unknown)}; "
              f"try --list", file=sys.stderr)
        return 2

    rows = run_entries(names, args.device)
    for row in rows:
        mark = {"pass": "ok  ", "fail": "FAIL", "error": "ERR "}[
            row["status"]]
        print(f"[{mark}] {row['entry']:26s} {row['checks']:2d} checks  "
              f"{row['seconds']:6.2f}s")
        for v in row["violations"]:
            print(f"       - [{v['contract']}] {v['artifact']}: "
                  f"{v['message']}")
        if row["status"] == "error":
            print(f"       ! {row['error']}")
    report = {
        "entries": rows,
        "passed": sum(r["status"] == "pass" for r in rows),
        "failed": sum(r["status"] != "pass" for r in rows),
    }
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
        print(f"report -> {args.json}")
    print(f"{report['passed']}/{len(rows)} entries clean")
    return 1 if report["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
