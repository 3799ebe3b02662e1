"""`repro_torch.analysis.lint`: the registry beside the reference's, the
counts its sharded suites derive from the port's partition beside the
reference's partition, every entry clean on the CPU (the sharded ones on
gloo ranks, one spawn of 2 and one of 4), and the CLI.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.analysis import lint as jlint
from repro.core import mesh_gen as jmesh
from repro_torch.analysis import contracts as C
from repro_torch.analysis import lint
from repro_torch.core import mesh_gen

ROOT = Path(__file__).resolve().parents[1]
SHARDED = [n for n, e in lint.REGISTRY.items() if e.ranks]
SINGLE = [n for n, e in lint.REGISTRY.items() if not e.ranks]


def test_registry_names_equal_the_references():
    assert list(lint.REGISTRY) == list(jlint.REGISTRY)
    assert len(lint.REGISTRY) == 14
    assert {lint.REGISTRY[n].ranks for n in SHARDED} == {2, 4}


@pytest.mark.parametrize("shards", [2, 4])
def test_partition_counts_equal_the_references(shards):
    """The 3x3x2 order-3 mesh of the sharded entries: the port's interface
    size and neighbour offsets are the reference's, and every rank takes
    part in a +k and a -k shift of every offset — the reference's 2 x
    len(nbr_offsets) collective-permutes an application."""
    port = mesh_gen.partition_elements(lint._mesh(), shards)
    ref = jmesh.partition_elements(
        jmesh.deform_trilinear(jmesh.box_mesh(3, 3, 2, 3), seed=3), shards)
    assert int(port.n_shared) == int(ref.n_shared)
    assert tuple(port.nbr_offsets) == tuple(ref.nbr_offsets)
    for rank in range(shards):
        assert lint._rank_rounds(port, rank) == 2 * len(ref.nbr_offsets)


@pytest.mark.parametrize("name", SINGLE)
def test_single_process_entry_is_clean_on_the_cpu(name):
    (row,) = lint.run_entries([name], "cpu")
    assert row["status"] == "pass", row
    assert row["checks"] == {"service_buckets": 1}.get(
        name, 11 if name.startswith("axhelm_") else 4)


@pytest.fixture(scope="module")
def sharded_rows():
    return {r["entry"]: r for r in lint.run_entries(SHARDED, "cpu")}


@pytest.mark.parametrize("name", SHARDED)
def test_sharded_entry_is_clean_on_gloo_ranks(sharded_rows, name):
    """Every rank's op and solve records pass their suites (14 checks a
    rank for the solves, 4 for the wires)."""
    row = sharded_rows[name]
    assert row["status"] == "pass", row
    per_rank = 4 if "wire" in name else 7
    assert row["checks"] == per_rank * lint.REGISTRY[name].ranks


def test_cli_lists_the_registry_and_exits_by_status(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def run(*args):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis.lint", *args],
            env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)

    out = run("--device", "cpu", "--list")
    assert out.returncode == 0, out.stderr
    assert [ln.split()[0] for ln in out.stdout.splitlines()] == \
        list(jlint.REGISTRY)
    report = tmp_path / "report.json"
    out = run("--device", "cpu", "--only", "dense_poisson,axhelm_merged",
              "--json", str(report))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "2/2 entries clean" in out.stdout
    data = json.loads(report.read_text())
    assert data["passed"] == 2 and data["failed"] == 0
    assert [r["entry"] for r in data["entries"]] == ["dense_poisson",
                                                     "axhelm_merged"]
    out = run("--device", "cpu", "--only", "no_such_entry")
    assert out.returncode == 2 and "unknown entries" in out.stderr


def test_main_exits_nonzero_on_a_violation_or_an_error(monkeypatch,
                                                       capsys):
    """A violation prints the contract and its message and fails the run;
    an entry that cannot build is an error, never a pass."""
    registry = dict(lint.REGISTRY)
    monkeypatch.setattr(lint, "REGISTRY", registry)

    def moved(device):
        return [(C.EntryArtifacts("bad:stream", meta={
            "traces_before": 4, "traces_after": 5}), [C.NoRetrace()])]

    def broken(device):
        raise RuntimeError("cannot build")

    lint.entry("moved", "a counter that moves")(moved)
    lint.entry("broken", "an entry that raises")(broken)
    assert lint.main(["--only", "moved", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "[FAIL] moved" in out and "[no-retrace] bad:stream" in out
    assert lint.main(["--only", "broken,service_buckets",
                      "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "[ERR ] broken" in out and "RuntimeError: cannot build" in out
    assert "1/2 entries clean" in out


def test_lint_runs_on_the_card_unless_asked_for_the_cpu():
    """No card and no device named: the run raises instead of falling
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lint.run_entries(["dense_poisson"], None)
