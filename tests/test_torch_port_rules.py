"""The port's rules: `repro_torch` and `chip_smoke.py` import neither jax
nor the reference package, entry points default to the card and never fall
back to the CPU, and the CUDA wrapper refuses what its kernel does not take.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import mesh_gen, nekbone
from repro_torch.core.spectral import basis
from repro_torch.kernels.axhelm import build, ops

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import_in_source(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_port_runs_with_jax_and_reference_blocked():
    """Import every port module and run a tiny CPU solve in a process where
    importing jax or repro fails."""
    code = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
from repro_torch.core import mesh_gen, nekbone
from repro_torch.resilience.status import SolveStatus
mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(2, 2, 2, 3))
prob = nekbone.setup_problem(mesh, variant="trilinear", device="cpu")
x = nekbone.random_solution(prob, seed=0)
res = nekbone.solve(prob, nekbone.rhs_from_solution(prob, x), tol=1e-6)
assert SolveStatus(int(res.status)) is SolveStatus.CONVERGED, res.status
assert nekbone.manufactured_error(prob, res.x, x) < 1e-4
assert sys.modules["jax"] is None and sys.modules["repro"] is None
print("ok", int(res.iterations))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = mesh_gen.box_mesh(1, 1, 1, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nekbone.setup_problem(mesh)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nekbone.setup_problem(mesh, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nekbone.resolve_device(None)
    prob = nekbone.setup_problem(mesh, device="cpu")
    assert prob.device.type == "cpu" and prob.backend == "reference"


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("variant", ["precomputed", "trilinear"])
def test_cuda_wrapper_refuses_fp64_and_non_cuda_tensors(variant):
    """Tensors that are not on the CPU take the kernel path, which checks
    before it launches (meta tensors stand in for card tensors here)."""
    b = basis(7)
    geom_shape = (3, 8, 8, 8, 7) if variant == "precomputed" else (3, 8, 3)
    with pytest.raises(TypeError, match="float32 only"):
        ops.axhelm(_meta((3, 8, 8, 8), torch.float64), b, variant,
                   _meta(geom_shape, torch.float64))
    with pytest.raises(TypeError, match="float32 only"):
        ops.axhelm(_meta((3, 8, 8, 8), torch.float32), b, variant,
                   _meta(geom_shape, torch.float64))
    with pytest.raises(ValueError, match="CUDA device"):
        ops.axhelm(_meta((3, 8, 8, 8), torch.float32), b, variant,
                   _meta(geom_shape, torch.float32))


def test_failed_build_raises_and_leaves_no_library(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build.__wrapped__()
    assert list(tmp_path.iterdir()) == []


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("a CUDA toolkit is installed at the default location")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()


def test_chip_smoke_refuses_without_a_card():
    """No card: chip_smoke.py exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
