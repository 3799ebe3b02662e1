"""The port's rules: `repro_torch` and `chip_smoke.py` import neither jax
nor the reference package, entry points default to the card and never fall
back to the CPU, and the CUDA wrapper refuses what its kernel does not take.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs, quickstart, serve_lm, serve_solves, train_lm
from repro_torch.core import mesh_gen, nekbone
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import serve as lm_serve
from repro_torch.launch import train as lm_train
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.train_loop import TrainConfig, init_state
from repro_torch.models.registry import build_model
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


# the scripts that drive the port on the card
PORT_SCRIPTS = [ROOT / "chip_smoke.py",
                ROOT / "scripts" / "torch_solve_trace.py",
                ROOT / "scripts" / "refine_spread.py",
                ROOT / "scripts" / "column_launch_sweep.py",
                ROOT / "scripts" / "line_staging_sweep.py",
                ROOT / "scripts" / "main_path_turns.py",
                ROOT / "scripts" / "slab_phase_probe.py",
                ROOT / "scripts" / "sharded_spread.py",
                ROOT / "scripts" / "lm_train_trace.py",
                ROOT / "scripts" / "lm_serve_trace.py"]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + PORT_SCRIPTS,
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
mixed = nekbone.setup_problem(mesh, precision="bf16_x32", device="cpu")
xs = nekbone.random_solution(mixed, seed=1, nrhs=3)
mres = nekbone.solve(mixed, nekbone.rhs_from_solution(mixed, xs), tol=1e-3)
assert (mres.status == SolveStatus.CONVERGED).all(), mres.status
from repro_torch.resilience.inject import FaultSpec
from repro_torch.resilience.retry import solve_resilient
b = nekbone.rhs_from_solution(prob, x)
rep = solve_resilient(prob, b, tol=1e-6, fault=FaultSpec(iteration=2),
                      persistent=False)
assert rep.converged and rep.rung == ("restart",), rep.rung
widths = []
block = nekbone.make_block_solver(prob, tol=1e-6, on_capture=widths.append)
for w in (2, 2):
    bb = nekbone.rhs_from_solution(prob, nekbone.random_solution(prob, nrhs=w))
    block(bb, bb * 0)
assert widths == [(mesh.n_global, 2)], widths
from repro_torch.serving.solve_service import SolveRequest, SolveService
svc = SolveService(prob, max_batch=2, tol=1e-6)
warm = svc.warmup()
svc.submit(SolveRequest(uid=0, b=b))
svc.step()
assert warm == 4 and svc.trace_count == warm, (warm, svc.trace_count)
from repro_torch import configs
from repro_torch.launch.serve import build_served_model, make_requests
from repro_torch.serving.engine import ServeEngine
lm = build_served_model(configs.reduced("qwen3_0_6b"), "cpu")
engine = ServeEngine(lm, max_len=32, slots=2, eos_id=-1)
lm_reqs = make_requests(lm.cfg.vocab_size, 3, max_new_tokens=3)
for r in lm_reqs:
    engine.submit(r)
engine.run_until_drained()
assert all(len(r.output) == 3 for r in lm_reqs)
from repro_torch.launch.train import build_run
for arch in ("xlstm-350m", "seamless-m4t-medium", "qwen3-0.6b",
             "moonshot-v1-16b-a3b"):
    run = build_run(arch, "demo", steps=2, device="cpu")
    state = run.state
    for i in range(2):
        state, m = run.step(state, run.data.batch_at(i))
    assert int(state["step"]) == 2 and bool(m["loss"].isfinite())
assert float(m["aux"]) > 0.9
assert sys.modules["jax"] is None and sys.modules["repro"] is None
print("ok", int(res.iterations))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_solve_resilient_catches_no_exception():
    """The retry ladder acts on solve statuses only: no `try` in
    `solve_resilient` (nested functions included), so a kernel that fails
    to build or launch raises through it."""
    tree = ast.parse((PORT / "resilience" / "retry.py").read_text())
    (fn,) = [n for n in tree.body if isinstance(n, ast.FunctionDef)
             and n.name == "solve_resilient"]
    assert not [n for n in ast.walk(fn) if isinstance(n, ast.Try)]


def test_graph_code_catches_no_capture_failure():
    """A capture or replay that fails raises: the loop, graph and bucket
    cache modules have no `except` that could turn one into an eager
    fallback."""
    for rel in ("core/graphs.py", "core/pcg.py", "serving/bucket_cache.py"):
        tree = ast.parse((PORT / rel).read_text())
        assert not [n for n in ast.walk(tree)
                    if isinstance(n, ast.ExceptHandler)], rel


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = mesh_gen.box_mesh(1, 1, 1, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nekbone.setup_problem(mesh)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nekbone.setup_problem(mesh, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nekbone.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_solves.main(["--nx", "1", "--order", "2"])
    prob = nekbone.setup_problem(mesh, device="cpu")
    assert prob.device.type == "cpu" and prob.backend == "reference"
    # LM serving: the launcher, the serve_lm twin and the model itself
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_serve.main(["--arch", "qwen3-0.6b"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_serve.main(["--arch", "qwen3-0.6b", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main([])
    for arch in ("qwen3_0_6b", "xlstm_350m", "seamless_m4t_medium"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(configs.reduced(arch))
    model = build_model(configs.reduced("qwen3_0_6b"), device="cpu")
    assert model.device.type == "cpu"
    # LM training: the launcher, the train_lm twin, the quickstart, the data
    cfg = configs.reduced("qwen3_0_6b")
    for main, argv in ((lm_train.main, ["--arch", "qwen3-0.6b"]),
                       (lm_train.main, ["--arch", "qwen3-0.6b", "--preset",
                                        "full", "--device", "cuda"]),
                       (train_lm.main, []), (quickstart.main, [])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticLM(cfg, batch=2, seq=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_train.build_run("qwen3-0.6b")


def test_train_state_lives_on_the_models_device():
    """The train state is made where the model is (the meta device here),
    never on the CPU; the data lands where it is told."""
    model = build_model(configs.get("qwen3-0.6b"), device="meta")
    for eight_bit in (False, True):
        state = init_state(model, TrainConfig(eight_bit_optimizer=eight_bit))
        assert {t.device.type for t in tree_leaves(state)} == {"meta"}
    batch = SyntheticLM(configs.reduced("qwen3_0_6b"), 2, 8,
                        device="meta").batch_at(0)
    assert batch["tokens"].device.type == "meta"


def test_training_and_data_name_no_cpu_fallback():
    """`training/` and `data/` never choose the CPU: the one "cpu" in them
    is the checkpoint's host copy (`checkpoint._to_numpy`)."""
    found = []
    for path in sorted((PORT / "training").glob("*.py")) + sorted(
            (PORT / "data").glob("*.py")):
        tree = ast.parse(path.read_text())
        for fn in ast.walk(tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Constant) and node.value == "cpu":
                    found.append((path.name, fn.name))
    assert sorted(set(found)) == [("checkpoint.py", "_to_numpy")], found


def test_training_entry_points_run_on_the_cpu_when_told(tmp_path, capsys):
    """The launcher's demo preset, the train_lm twin with an injected
    failure and the quickstart, each on the CPU; --multi-pod raises."""
    state, hist = lm_train.main(["--arch", "qwen3-0.6b", "--steps", "2",
                                 "--device", "cpu", "--ckpt-dir",
                                 str(tmp_path / "launch")])
    assert int(state["step"]) == 2 and hist["restarts"] == 0
    state, hist = train_lm.main(["--steps", "3", "--batch", "2", "--seq",
                                 "16", "--inject-failure", "1", "--device",
                                 "cpu", "--ckpt-dir", str(tmp_path / "lm")])
    assert int(state["step"]) == 3 and hist["restarts"] == 1
    losses = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "no CUDA kernel runs" in out and "quickstart OK" in out
    assert len(losses) == 20 and all(np.isfinite(losses))
    with pytest.raises(NotImplementedError, match="slice 8"):
        lm_train.main(["--arch", "qwen3-0.6b", "--multi-pod", "--device",
                       "cpu"])


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("variant", ops.KERNEL_VARIANTS)
def test_cuda_wrapper_refuses_fp64_and_non_cuda_tensors(variant):
    """Tensors that are not on the CPU take the kernel path, which checks
    before it launches (meta tensors stand in for card tensors here): the
    storage is float32 or bfloat16, every operand in x's dtype."""
    b = basis(7)
    geom_shape = {"precomputed": (3, 8, 8, 8, 7),
                  "parallelepiped": (3, 7)}.get(variant, (3, 8, 3))
    # merged reads Lam2/Lam3 and partial gScale from the lambda slots
    slots = {"merged": ("lam0", "lam1"), "partial": ("lam0",)}.get(variant,
                                                                  ())

    def lams(dtype):
        return {name: _meta((3, 8, 8, 8), dtype) for name in slots}

    with pytest.raises(TypeError, match="float32 or bfloat16 storage.*"
                       "x is torch.float64, x is torch.float64"):
        ops.axhelm(_meta((3, 8, 8, 8), torch.float64), b, variant,
                   _meta(geom_shape, torch.float64), **lams(torch.float64))
    with pytest.raises(TypeError, match="float32 or bfloat16 storage.*"
                       "geom is torch.float64, x is torch.float32"):
        ops.axhelm(_meta((3, 8, 8, 8), torch.float32), b, variant,
                   _meta(geom_shape, torch.float64), **lams(torch.float32))
    with pytest.raises(TypeError, match="geom is torch.float32, x is "
                       "torch.bfloat16"):
        ops.axhelm(_meta((3, 8, 8, 8), torch.bfloat16), b, variant,
                   _meta(geom_shape, torch.float32), **lams(torch.bfloat16))
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="CUDA device"):
            ops.axhelm(_meta((3, 8, 8, 8), dtype), b, variant,
                       _meta(geom_shape, dtype), **lams(dtype))


def test_failed_build_raises_and_leaves_no_library(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build.__wrapped__()
    assert list(tmp_path.iterdir()) == []


def test_build_moves_library_and_report_into_place(monkeypatch, tmp_path):
    """A stand-in nvcc that writes its -o file and a ptxas line: the build
    leaves exactly the library and its ptxas report, both moved into place
    from the scratch directory (ranks that build at once never read a
    partial report)."""
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then out="$2"; fi; shift\n'
                    'done\necho "ptxas info : Used 1 registers" >&2\n'
                    ': > "$out"\n')
    fake.chmod(0o755)
    out_dir = tmp_path / "kernels"
    monkeypatch.setattr(build, "_BUILD_DIR", out_dir)
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    lib = build.build.__wrapped__()
    assert lib == build.library_path() and lib.exists()
    assert sorted(p.name for p in out_dir.iterdir()) == sorted(
        [lib.name, build._report_path().name])
    assert "ptxas info" in build._report_path().read_text()


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
