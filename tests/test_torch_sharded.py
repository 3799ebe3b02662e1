"""Port parity, the element-sharded solve: `repro_torch` on gloo ranks on
the CPU (the kernels' plain versions), against the port's single-device
solve, against itself across ranks and partitions, and against the JAX
package's sharded solve.

Each spawn of ranks (`distributed.launch.spawn`, module-scoped below) runs
every case of its (shard count, grid) and returns rows
(`tests/_torch_sharded_ranks.py`); the tests hold them to the reference
package's tests and tolerances:

  * tests/test_nekbone_sharded.py: the sharded operator within 1e-5
    relative of the single-device one; solves within +-1 iteration, final
    residual within 10x of max(single-device residual, 1e-6 r0), dx < 1e-3;
  * tests/test_nekbone_box.py: the (2, 2, 1) box within +-1 iteration of
    the (4, 1, 1) slab, dx < 5e-3; lambda fields;
  * tests/test_resilience_sharded.py: a NaN caught at its iteration, the
    other columns untouched; drop_exchange refused by the audit and cured
    by the restart rung;
  * tests/test_mixed_precision.py: the refined solve on every wire (psum,
    neighbour, neighbour + bf16, neighbour + int8) CONVERGED with the true
    residual <= 1.5 tol, neighbour + bf16 bitwise the uncompressed
    neighbour solve;
  * tests/test_nekbone_neighbour.py: the neighbour exchange (the `nbr_*`
    case groups) within +-1 iteration of the psum one, the same status,
    dx < 1e-3; its operator within 1e-5 relative of one device; no
    interface all_reduce, exactly the point-to-point messages of the pair
    tables; and every sharer of an interface dof holding the same bits
    after an exchange, on every wire.

The JAX comparison runs the reference package in a subprocess with two
simulated host devices (as tests/test_nekbone_sharded.py does), with each
exchange: +-1 iteration, the same status, dx < 1e-3.
"""

import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch.multiprocessing as mp

import _torch_sharded_ranks as ranks
from repro_torch import nekbone_solve
from repro_torch.analysis.contracts import (CollectiveCensus, EntryArtifacts,
                                            interface_allreduce)
from repro_torch.distributed.launch import spawn
from repro_torch.resilience.status import SolveStatus, is_failure

ROOT = Path(__file__).resolve().parents[1]
RES_FACTOR = 10.0

# (shard count, grid spec, case groups) of each spawn of ranks
SPAWNS = {
    "slab2": (2, None, ("op", "solve", "lambda", "nan", "drop", "refined",
                        "jax", "collectives", "width", "nbr_op", "nbr_solve",
                        "nbr_wire", "nbr_nan", "nbr_drop", "nbr_refined",
                        "nbr_ladder", "nbr_jax", "nbr_collectives")),
    "slab4": (4, None, ("op", "solve", "vector", "box", "nan", "refined",
                        "nbr_solve", "nbr_wire", "nbr_box", "nbr_nan",
                        "nbr_refined", "nbr_thin")),
    "box4": (4, (2, 2, 1), ("op", "solve", "box", "nbr_op", "nbr_solve",
                            "nbr_wire", "nbr_box", "nbr_collectives")),
}

_JAX_SCRIPT = textwrap.dedent("""
    import json
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.core import mesh_gen, nekbone
    from repro.distributed.context import make_solver_ctx
    assert jax.device_count() == 2, jax.devices()
    mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(3, 3, 2, 3), seed=3)
    b = np.random.default_rng(0).standard_normal(mesh.n_global).astype(
        np.float32)
    out = {}
    for exchange in ("psum", "neighbour"):
        sh = nekbone.setup_problem(
            mesh, variant="trilinear", dtype=jnp.float32,
            backend="reference",
            shard_ctx=make_solver_ctx(devices=2, exchange=exchange))
        res = nekbone.solve(sh, jnp.asarray(b), tol=%(tol)g, max_iter=300)
        out[exchange] = {"iterations": int(res.iterations),
                         "status": int(res.status),
                         "x": np.asarray(res.x).tolist()}
    print(json.dumps({**out["psum"], "b": b.tolist(),
                      "neighbour": out["neighbour"]}))
""") % {"tol": ranks.TOL}


@pytest.fixture(scope="module", autouse=True)
def jax_reference():
    """The JAX package's 2-device sharded solves (psum and neighbour
    exchange), started first so they run while the ranks do."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    proc = subprocess.Popen([sys.executable, "-c", _JAX_SCRIPT], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def runs():
    """Each spawn's rows, rank by rank, spawned at first use."""
    done = {}

    def get(name):
        if name not in done:
            world, grid, groups = SPAWNS[name]
            done[name] = spawn(ranks.cases, world, (grid, groups),
                               timeout_s=300)
        return done[name]

    return get


def _same_on_every_rank(per_rank, group, key):
    firsts = [row[key] for row in per_rank[0][group]]
    for other in per_rank[1:]:
        assert [row[key] for row in other[group]] == firsts, (group, key)


def test_sharded_column_has_the_same_bits_at_every_width(runs):
    """A sharded `pcg_block` column (S=2 slab) padded with zero columns to
    widths 2, 4 and 8 has the bits of the unpadded width-1 block solve: x,
    status, iterations and residual; and `owned_dot(batched=True)` gives
    its column the same bits at every width, the padding 0 (each column
    folded in one fixed tree before the all_reduce, as `_column_dot`)."""
    for per in runs("slab2"):
        rows = per["width"]
        assert [r["width"] for r in rows] == [1, 2, 4, 8]
        assert rows[0]["status"] == SolveStatus.CONVERGED
        for key in ("x_digest", "status", "iterations", "residual", "dot"):
            assert len({r[key] for r in rows}) == 1, (key, rows)
        assert all(d == 0.0 for r in rows for d in r["pad_dots"])
    _same_on_every_rank(runs("slab2"), "width", "x_digest")
    _same_on_every_rank(runs("slab2"), "width", "dot")


@pytest.mark.parametrize("name", ["slab2", "slab4", "box4"])
def test_sharded_op_matches_single_device(runs, name):
    per_rank = runs(name)
    rows = per_rank[0]["op"]
    assert len(rows) == 10   # five variants x nrhs 1, 4
    for r in rows:
        assert r["rel"] < 1e-5, r
        # the diagonal is the single-device one, computed on the whole mesh
        assert r["diag_diff"] == 0.0, r
    _same_on_every_rank(per_rank, "op", "y_digest")


@pytest.mark.parametrize("name", ["slab2", "slab4", "box4"])
def test_sharded_solve_matches_single_device(runs, name):
    per_rank = runs(name)
    rows = per_rank[0]["solve"]
    # 18-element mesh x {poisson, helmholtz} x {reference, plain kernels},
    # plus the 5-element mesh on 2 shards
    assert len(rows) == (8 if name == "slab2" else 4)
    for r in rows:
        assert r["status_sh"] == r["status_ref"] == SolveStatus.CONVERGED, r
        assert abs(r["it_sh"] - r["it_ref"]) <= 1, r
        bound = RES_FACTOR * max(r["res_ref"], ranks.TOL * r["r0_ref"])
        assert r["res_sh"] <= bound, r
        assert r["dx"] < 1e-3, r
    _same_on_every_rank(per_rank, "solve", "x_digest")


def test_sharded_vector_field_and_copy_precond(runs):
    rows = runs("slab4")[0]["vector"]
    assert [r["precond"] for r in rows] == ["jacobi", "copy"]
    for r in rows:
        assert abs(r["it_sh"] - r["it_ref"]) <= 1, r
        assert r["dx"] < 1e-3, r


def test_box_solve_matches_slab(runs):
    slab, box = runs("slab4")[0]["box"], runs("box4")[0]["box"]
    # 2 equations x (2 nrhs + 1 odd mesh + 1 plain-kernel) + 1 kernel nrhs 4
    assert len(slab) == len(box) == 9
    assert any(r["backend"] == "cuda" and r["nrhs"] == 4 for r in box)
    assert any(r["mesh"] == [5, 3, 2] for r in box)
    for r0, r1 in zip(slab, box):
        assert r0["grid"] == [4, 1, 1] and r1["grid"] == [2, 2, 1], (r0, r1)
        assert not r0["breakdown"] and not r1["breakdown"], (r0, r1)
        assert set(r0["status"]) == set(r1["status"]) == {0}, (r0, r1)
        for a, b in zip(r0["iterations"], r1["iterations"]):
            assert abs(a - b) <= 1, (r0, r1)
        assert np.abs(r1["x"] - r0["x"]).max() < 5e-3


def test_lambda_fields_match_scalars_sharded(runs):
    rows = runs("slab2")[0]["lambda"]
    assert [r["backend"] for r in rows] == ["reference", "cuda"]
    for r in rows:
        # constant field vs scalar: the same broadcast products
        assert r["it_scalar"] == r["it_const_field"], r
        assert r["dx_const"] == 0.0, r
        # varying field: sharded == single device
        assert abs(r["it_var_sh"] - r["it_var_ref"]) <= 1, r
        assert r["dx_var"] < 1e-3, r


@pytest.mark.parametrize("name", ["slab2", "slab4"])
def test_sharded_nan_detected_within_one_iteration(runs, name):
    rows = runs(name)[0]["nan"]
    assert len(rows) == 2   # nrhs 1, 4
    for r in rows:
        assert r["finite"], r
        assert all(s == SolveStatus.CONVERGED for s in r["clean_status"])
        if r["col"] is None:
            assert r["status"] == [SolveStatus.DIVERGED], r
            assert r["iters"] == [3], r
        else:
            for j, (s, i) in enumerate(zip(r["status"], r["iters"])):
                if j == r["col"]:
                    assert s == SolveStatus.DIVERGED and i == 3, r
                else:
                    assert s == SolveStatus.CONVERGED, r
                    assert i == r["clean_iters"][j], r


def test_drop_exchange_caught_by_verification_and_restart(runs):
    (r,) = runs("slab2")[0]["drop"]
    assert r["initial_failed"] == [0], r
    assert is_failure(r["initial_status"]) or \
        r["initial_status"] == SolveStatus.CONVERGED, r
    assert r["converged"], r
    assert r["rungs"] == ["initial", "restart"], r
    assert r["true_residual"] < 1e-4, r
    assert r["dx"] < 5e-3, r


@pytest.mark.parametrize("name", ["slab2", "slab4"])
def test_sharded_refined_solve_psum_wire(runs, name):
    rows = runs(name)[0]["refined"]
    assert [r["nrhs"] for r in rows] == [1, 4]
    for r in rows:
        assert all(s == SolveStatus.CONVERGED for s in r["status"]), r
        assert all(t <= r["tol"] * 1.5 for t in r["true"]), r


@pytest.fixture(scope="module")
def jax_result(jax_reference):
    """The JAX subprocess's one JSON line."""
    out, err = jax_reference.communicate(timeout=600)
    assert jax_reference.returncode == 0, err[-4000:]
    (j,) = [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]
    return j


def test_sharded_solve_matches_jax(runs, jax_result):
    per_rank = runs("slab2")
    (r,) = per_rank[0]["jax"]
    j = jax_result
    mesh = ranks.mesh_3x3x2()
    np.testing.assert_array_equal(np.asarray(j["b"], np.float32),
                                  ranks.jax_rhs(mesh))
    assert r["status"] == j["status"] == SolveStatus.CONVERGED, (r, j)
    assert abs(r["iterations"] - j["iterations"]) <= 1, (r, j)
    assert np.abs(r["x"] - np.asarray(j["x"])).max() < 1e-3
    # a repeat solve gives the same bits, and every rank the same x
    assert r["repeat_bitwise"], r
    _same_on_every_rank(per_rank, "jax", "x_digest")


def test_one_interface_all_reduce_per_application(runs):
    """A global operator application at nrhs 4 makes two all_reduces: the
    interface exchange of (NS, 4) — the whole batch in one — and the
    reassembly of the global field."""
    (r,) = runs("slab2")[0]["collectives"]
    assert r["shapes"] == [[r["n_shared"], 4], [r["n_global"], 4]], r
    art = EntryArtifacts("psum:op", collectives=r["events"])
    assert CollectiveCensus(exact={"all_reduce": 2, "p2p": 0}, matchers=[
        interface_allreduce(r["n_shared"], nrhs=4, exact=1)]).check(art) == []


# ---------------------------------------------- the neighbour exchange --


@pytest.mark.parametrize("name", ["slab2", "box4"])
def test_neighbour_op_matches_single_device(runs, name):
    """The neighbour-exchange operator within 1e-5 relative of the single-
    device one, every variant, nrhs 1 and 4
    (test_nekbone_neighbour.py::test_neighbour_op_matches_dense_operator)."""
    per_rank = runs(name)
    rows = per_rank[0]["nbr_op"]
    assert len(rows) == 10
    for r in rows:
        assert r["rel"] < 1e-5, r
        assert r["diag_diff"] == 0.0, r
    _same_on_every_rank(per_rank, "nbr_op", "y_digest")


@pytest.mark.parametrize("name", ["slab2", "slab4", "box4"])
def test_neighbour_solve_matches_psum(runs, name):
    """Neighbour within +-1 iteration of psum, the same status, dx < 1e-3:
    both equations, the reference backend at nrhs 1 and 4, the plain
    kernels at nrhs 1, E divisible by neither 4 nor 2 (the 5-element mesh
    at two shards, whose partition splits the launches)."""
    per_rank = runs(name)
    rows = per_rank[0]["nbr_solve"]
    assert len(rows) == (12 if name == "slab2" else 6)
    if name == "slab2":
        assert any(r["split"] for r in rows)
    for r in rows:
        assert r["status_nbr"] == r["status_psum"], r
        assert set(r["status_psum"]) == {SolveStatus.CONVERGED}, r
        for a, b in zip(r["it_psum"], r["it_nbr"]):
            assert abs(a - b) <= 1, r
        assert r["dx"] < 1e-3, r
    _same_on_every_rank(per_rank, "nbr_solve", "x_digest")


@pytest.mark.parametrize("name", ["slab2", "slab4", "box4"])
def test_every_sharer_holds_the_same_bits(runs, name):
    """After one neighbour exchange every rank that holds an interface dof
    holds the same bits for it, on every wire (none with fp32 and bf16
    partials, bf16, int8); the uncompressed fp32 exchange is within 1e-6
    relative of the psum exchange, the others within their wire's
    rounding (1e-2 relative)."""
    per_rank = runs(name)
    n_rows = len(per_rank[0]["nbr_wire"])
    assert n_rows == 10
    for i in range(n_rows):
        held = {}
        for rank in per_rank:
            r = rank["nbr_wire"][i]
            scale = float(np.abs(r["psum"]).max())
            bound = 1e-6 if r["wire"] is None and "float32" in r["dtype"] \
                else 1e-2
            assert np.abs(r["vals"] - r["psum"]).max() <= bound * scale, \
                (r["dtype"], r["wire"], r["nrhs"])
            for gid, bits in zip(r["gids"], r["bits"]):
                held.setdefault(int(gid), []).append(bits.tobytes())
        assert held and all(len(v) >= 2 for v in held.values())
        for gid, copies in held.items():
            assert len(set(copies)) == 1, (i, gid)


def test_neighbour_box_solve_matches_slab(runs):
    """test_box_solve_matches_slab's cases with the neighbour exchange."""
    slab, box = runs("slab4")[0]["nbr_box"], runs("box4")[0]["nbr_box"]
    assert len(slab) == len(box) == 9
    for r0, r1 in zip(slab, box):
        assert r0["grid"] == [4, 1, 1] and r1["grid"] == [2, 2, 1], (r0, r1)
        assert not r0["breakdown"] and not r1["breakdown"], (r0, r1)
        assert set(r0["status"]) == set(r1["status"]) == {0}, (r0, r1)
        for a, b in zip(r0["iterations"], r1["iterations"]):
            assert abs(a - b) <= 1, (r0, r1)
        assert np.abs(r1["x"] - r0["x"]).max() < 5e-3
    # and each against the psum exchange on the same partition
    for name in ("slab4", "box4"):
        for r0, r1 in zip(runs(name)[0]["box"], runs(name)[0]["nbr_box"]):
            for a, b in zip(r0["iterations"], r1["iterations"]):
                assert abs(a - b) <= 1, (r0, r1)
            assert np.abs(r1["x"] - r0["x"]).max() < 1e-3


@pytest.mark.parametrize("name", ["slab2", "slab4"])
def test_neighbour_nan_detected_within_one_iteration(runs, name):
    rows = runs(name)[0]["nbr_nan"]
    assert len(rows) == 2
    for r in rows:
        assert r["finite"], r
        assert all(s == SolveStatus.CONVERGED for s in r["clean_status"])
        if r["col"] is None:
            assert r["status"] == [SolveStatus.DIVERGED], r
            assert r["iters"] == [3], r
        else:
            for j, (s, i) in enumerate(zip(r["status"], r["iters"])):
                if j == r["col"]:
                    assert s == SolveStatus.DIVERGED and i == 3, r
                else:
                    assert s == SolveStatus.CONVERGED, r
                    assert i == r["clean_iters"][j], r


def test_neighbour_drop_exchange_caught_by_verification_and_restart(runs):
    (r,) = runs("slab2")[0]["nbr_drop"]
    assert r["initial_failed"] == [0], r
    assert is_failure(r["initial_status"]) or \
        r["initial_status"] == SolveStatus.CONVERGED, r
    assert r["converged"], r
    assert r["rungs"] == ["initial", "restart"], r
    assert r["true_residual"] < 1e-4, r
    assert r["dx"] < 5e-3, r


@pytest.mark.parametrize("name", ["slab2", "slab4"])
def test_sharded_refined_solve_neighbour_wires(runs, name):
    """Neighbour, neighbour + bf16 and neighbour + int8: CONVERGED with the
    true residual <= 1.5 tol; on bf16 partials the bf16 codec is lossless,
    so its solve is bitwise the uncompressed one (iterations and x)."""
    rows = runs(name)[0]["nbr_refined"]
    assert [(r["nrhs"], r["compress"]) for r in rows] == [
        (n, c) for n in (1, 4) for c in (None, "bf16", "int8")]
    for r in rows:
        assert all(s == SolveStatus.CONVERGED for s in r["status"]), r
        assert all(t <= r["tol"] * 1.5 for t in r["true"]), r
    by = {(r["nrhs"], r["compress"]): r for r in rows}
    for nrhs in (1, 4):
        plain, bf16 = by[(nrhs, None)], by[(nrhs, "bf16")]
        assert bf16["it"] == plain["it"], (bf16, plain)
        assert bf16["x_digest"] == plain["x_digest"], (bf16, plain)
    _same_on_every_rank(runs(name), "nbr_refined", "x_digest")


def test_ladder_rebuild_keeps_exchange_and_codec(runs):
    """A persistent fault in the bf16 sweeps of a neighbour + int8 refined
    solve: initial and restart fail, precision:float32 rebuilds over the
    same shard context — neighbour, int8 — and converges."""
    (r,) = runs("slab2")[0]["nbr_ladder"]
    assert r["rungs"] == ["initial", "restart", "precision:float32"], r
    assert r["problems"] == [["bf16_x32", "neighbour", "int8", True],
                             ["bf16_x32", "neighbour", "int8", True],
                             [None, "neighbour", "int8", False]], r
    assert r["converged"], r
    assert r["true_residual"] < 1e-4, r


def test_neighbour_solve_matches_jax(runs, jax_result):
    """The port's 2-rank neighbour solve against the JAX package's 2-device
    one: +-1 iteration, the same status, dx < 1e-3."""
    per_rank = runs("slab2")
    (r,) = per_rank[0]["nbr_jax"]
    j = jax_result["neighbour"]
    assert r["status"] == j["status"] == SolveStatus.CONVERGED, (r, j)
    assert abs(r["iterations"] - j["iterations"]) <= 1, (r, j)
    assert np.abs(r["x"] - np.asarray(j["x"])).max() < 1e-3
    assert r["repeat_bitwise"], r
    _same_on_every_rank(per_rank, "nbr_jax", "x_digest")


@pytest.mark.parametrize("name", ["slab2", "box4"])
def test_neighbour_application_is_point_to_point(runs, name):
    """A neighbour application at nrhs 4 makes no interface all_reduce
    (only globalize's (Ng, 4)) and posts, in one batch, exactly the
    messages its pair tables call for: for each offset k a send to and a
    receive from s + k and s - k where they exist, each the whole
    (M_k, 4) batch in fp32, tagged by round and direction
    (test_neighbour_hlo_gate, test_box_grid_hlo_gate)."""
    per_rank = runs(name)
    world = len(per_rank)
    for rank_rows in per_rank:
        (r,) = rank_rows["nbr_collectives"]
        s = r["rank"]
        assert r["all_reduce"] == [[r["n_global"], 4]], r
        assert len(r["batches"]) == 1, r
        want = []
        for j, (k, m) in enumerate(zip(r["offsets"], r["widths"])):
            if s + k < world:
                want.append(["send", s + k, [m, 4], "torch.float32",
                             8 * j])
            if s - k >= 0:
                want.append(["send", s - k, [m, 4], "torch.float32",
                             8 * j + 4])
        for j, (k, m) in enumerate(zip(r["offsets"], r["widths"])):
            if s - k >= 0:
                want.append(["recv", s - k, [m, 4], "torch.float32",
                             8 * j])
            if s + k < world:
                want.append(["recv", s + k, [m, 4], "torch.float32",
                             8 * j + 4])
        assert r["batches"][0] == want, r
        # the same, through the lint's contract: one shift a direction an
        # offset with a partner, no interface all_reduce
        shifts = 2 * sum(1 for k in r["offsets"] if s + k < world or s >= k)
        art = EntryArtifacts(f"neighbour:op@rank{s}",
                             collectives=r["events"])
        assert CollectiveCensus(
            exact={"permute": shifts, "all_reduce": 1,
                   "p2p": len(want)},
            matchers=[interface_allreduce(r["n_shared"], exact=0)]
        ).check(art) == []
    if name == "box4":
        assert len(per_rank[0]["nbr_collectives"][0]["offsets"]) >= 3


def test_degenerate_overlap_neighbour_solve(runs):
    """An all-interface partition warns at setup (pointing at the box
    decomposition) and its unsplit neighbour solve matches the psum one."""
    (r,) = runs("slab4")[0]["nbr_thin"]
    assert r["warned"] == 1 and r["mentions_grid"], r
    assert r["status"] == [SolveStatus.CONVERGED] * 2, r
    assert abs(r["it_psum"] - r["it_nbr"]) <= 1, r
    assert r["dx"] < 1e-3, r


def test_cli_neighbour_solves_on_ranks():
    """`--exchange neighbour` with `--devices 2 --dist-backend gloo` on the
    CPU: rank 0 prints one result, converged within +-1 iteration of the
    psum run, and the partition line names the neighbour offsets."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    iters = {}
    for exchange in ("psum", "neighbour"):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.nekbone_solve", "--devices",
             "2", "--device", "cpu", "--dist-backend", "gloo", "--elements",
             "4", "2", "2", "--order", "3", "--tol", "1e-6", "--exchange",
             exchange],
            env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-4000:]
        lines = out.stdout.splitlines()
        assert sum(line.startswith("status=") for line in lines) == 1, lines
        assert f"exchange={exchange}" in out.stdout
        assert "neighbour_offsets=[1]" in out.stdout, out.stdout
        assert "status=CONVERGED" in out.stdout, out.stdout
        (line,) = [ln for ln in lines if ln.startswith("status=")]
        iters[exchange] = int(line.split("iters=")[1].split()[0])
    assert abs(iters["psum"] - iters["neighbour"]) <= 1, iters


def test_cli_solves_on_ranks():
    """`--devices 2 --dist-backend gloo` on the CPU: rank 0 prints one
    result, the solve converges."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.nekbone_solve", "--devices", "2",
         "--device", "cpu", "--dist-backend", "gloo", "--elements", "2",
         "2", "2", "--order", "3", "--tol", "1e-6"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.splitlines()
    assert sum(line.startswith("status=") for line in lines) == 1, lines
    assert "shards=2" in out.stdout and "grid=(2, 1, 1)" in out.stdout
    assert "status=CONVERGED" in out.stdout, out.stdout


def test_cli_nccl_needs_a_card_per_rank():
    with pytest.raises(SystemExit, match="--dist-backend gloo"):
        nekbone_solve.main(["--devices", "2", "--device", "cpu"])


def test_a_failing_rank_fails_the_run():
    """Rank 1 raises while rank 0 waits in a collective: `spawn` raises in
    the caller instead of hanging."""
    t0 = time.perf_counter()
    # whichever rank's error `spawn` sees first: rank 1's own, or rank 0's
    # broken collective
    with pytest.raises((mp.ProcessRaisedException, mp.ProcessExitedException)):
        spawn(ranks.fail_on_rank_1, 2, timeout_s=60)
    assert time.perf_counter() - t0 < 60
