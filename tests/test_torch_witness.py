"""The yardsticks `chip_smoke.py` holds the bf16 kernels and the refined
solve to: the plain version before its one rounding (`ops.unrounded`), the
reference's precision-benchmark RHS (`nekbone.random_rhs`), bf16 ulp
distances, the plain version's re-roundings and the ensemble rule.  CPU
only: the re-roundings are built on the plain version.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import axhelm as core_axhelm
from repro_torch.core import mesh_gen, nekbone
from repro_torch.core.spectral import basis
from repro_torch.kernels.axhelm import ops

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

BF16 = torch.bfloat16
VARIANTS = ("precomputed", "trilinear", "parallelepiped", "merged",
            "partial")


def _call(variant, n=3, nrhs=2, seed=0):
    """Operands of one bf16 call on 5 elements of a deformed 2x2x2 box."""
    rng = np.random.default_rng(seed)
    b = basis(n)
    box = mesh_gen.box_mesh(2, 2, 2, n)
    mesh = mesh_gen.deform_affine(box, seed=2) \
        if variant == "parallelepiped" else \
        mesh_gen.deform_trilinear(box, seed=3)
    helm = variant == "merged"
    node = (5,) + (b.n1,) * 3
    lam0 = torch.as_tensor(1 + 0.3 * rng.random(node), dtype=torch.float32)
    lam1 = torch.as_tensor(0.5 + 0.2 * rng.random(node),
                           dtype=torch.float32) if helm else None
    elem_ops, _, _ = core_axhelm.make_axhelm_elem_ops(
        variant, b, torch.as_tensor(mesh.verts[:5], dtype=torch.float32),
        lam0=lam0, lam1=lam1, helmholtz=helm, dtype=BF16, device="cpu")
    geom = elem_ops.pop("geom")
    x = torch.as_tensor(rng.standard_normal((5, nrhs, 1) + (b.n1,) * 3),
                        dtype=BF16)
    return x, b, geom, dict(helmholtz=helm, **elem_ops)


@pytest.mark.parametrize("variant", VARIANTS)
def test_reference_is_unrounded_rounded_once(variant):
    """The plain version is its float32 result rounded once; the float64
    result rounds to within one ulp of it."""
    x, b, geom, kw = _call(variant)
    y = ops.reference(x, b, variant, geom, **kw)
    wide = ops.unrounded(x, b, variant, geom, **kw)
    assert wide.dtype == torch.float32 and y.dtype == BF16
    assert torch.equal(wide.to(BF16), y)
    exact = ops.unrounded(x, b, variant, geom, compute=torch.float64, **kw)
    assert exact.dtype == torch.float64
    assert int(chip_smoke.ulp_distance(exact.to(BF16), y).max()) <= 1
    # float32 storage: nothing to round
    x32, geom32 = x.float(), geom.float()
    kw32 = {k: (v.float() if torch.is_tensor(v) else v)
            for k, v in kw.items()}
    assert torch.equal(ops.unrounded(x32, b, variant, geom32, **kw32),
                       ops.reference(x32, b, variant, geom32, **kw32))


@pytest.mark.parametrize("nrhs", [1, 4])
def test_random_rhs_is_the_benchmarks_rhs(nrhs):
    """Standard normal float32 from numpy seed 0, zero on the boundary,
    every column of norm 30 — bit for bit what the reference's precision
    benchmark builds."""
    mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(3, 3, 2, 3), seed=3)
    prob = nekbone.setup_problem(mesh, variant="trilinear", device="cpu")
    b = nekbone.random_rhs(prob, nrhs=nrhs)
    shape = (mesh.n_global,) if nrhs == 1 else (mesh.n_global, nrhs)
    want = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want[mesh.boundary] = 0.0
    want = want / np.linalg.norm(want, axis=0) * 30.0
    assert b.dtype == torch.float32 and tuple(b.shape) == shape
    np.testing.assert_array_equal(b.numpy(), want)
    np.testing.assert_allclose(torch.linalg.norm(b, dim=0).numpy(), 30.0,
                               rtol=1e-6)


def test_ulp_distance_counts_representable_values():
    one = torch.tensor([1.0], dtype=BF16)
    up = torch.tensor([1.0 + 2.0 ** -7], dtype=BF16)  # the next bf16 above 1
    assert float(up) == 1.0 + 2.0 ** -7
    tiny = torch.tensor([2.0 ** -133], dtype=BF16)  # the least subnormal
    pairs = [(one, one, 0), (one, up, 1), (up, one, 1), (one, -one, 2 * 0x3F80),
             (tiny, -tiny, 2), (torch.zeros(1, dtype=BF16), tiny, 1)]
    for a, b, want in pairs:
        assert int(chip_smoke.ulp_distance(a, b)) == want, (a, b)


@pytest.mark.parametrize("variant", ["trilinear", "parallelepiped"])
def test_rounding_witness(variant):
    """Without flips the witness is the plain version (float32) or the
    correctly rounded one (float64); with every inexact output flipped,
    each moves one ulp to the other side of its unrounded value."""
    x, b, geom, kw = _call(variant, nrhs=3)
    plain = chip_smoke.rounding_witness(torch.float32)
    assert torch.equal(plain(x, b, variant, geom, **kw),
                       ops.reference(x, b, variant, geom, **kw))
    exact = chip_smoke.rounding_witness(torch.float64)
    wide = ops.unrounded(x, b, variant, geom, compute=torch.float64, **kw)
    assert torch.equal(exact(x, b, variant, geom, **kw), wide.to(BF16))
    flipped = chip_smoke.rounding_witness(torch.float32, flip_rate=1.0)(
        x, b, variant, geom, **kw)
    y = ops.reference(x, b, variant, geom, **kw)
    wide = ops.unrounded(x, b, variant, geom, **kw)
    inexact = (wide != y.double().float()) & (y != 0)
    d = chip_smoke.ulp_distance(flipped, y)
    assert bool(inexact.any())
    assert bool((d[inexact] == 1).all()) and bool((d[~inexact] == 0).all())
    # the flipped value lies on the other side of the unrounded one
    side = torch.sign(wide - y.float()) * torch.sign(wide - flipped.float())
    assert bool((side[inexact] < 0).all())
    # float32 storage passes through to the plain version
    assert torch.equal(plain(x.float(), b, variant, geom.float(),
                             **{k: (v.float() if torch.is_tensor(v) else v)
                                for k, v in kw.items()}),
                       ops.reference(x.float(), b, variant, geom.float(),
                                     **{k: (v.float() if torch.is_tensor(v)
                                            else v)
                                        for k, v in kw.items()}))


def test_rounding_witness_is_seeded():
    x, b, geom, kw = _call("trilinear", nrhs=3)
    runs = [chip_smoke.rounding_witness(torch.float32, 0.3, seed)(
        x, b, "trilinear", geom, **kw) for seed in (0, 0, 1)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])


def test_plain_version_builds_the_reference_backend_on_a_witness():
    """Inside `plain_version(fn)`, setup_problem's reference backend applies
    `fn` for its bf16 operator; outside, the plain version again."""
    mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(2, 2, 2, 3), seed=3)
    calls = {"n": 0}

    def fn(*args, **kw):
        calls["n"] += 1
        return ops.reference(*args, **kw)
    with chip_smoke.plain_version(fn):
        prob = nekbone.setup_problem(mesh, variant="trilinear",
                                     backend="reference",
                                     precision="bf16_x32", device="cpu")
    assert ops.reference is not fn
    x = torch.ones(mesh.n_global, dtype=BF16)
    prob.op_lo(x)
    assert calls["n"] == 1
    with chip_smoke.plain_version(None):
        assert ops.reference.__name__ == "reference"


def _member(status, iterations):
    return {"status": status, "iterations": iterations}


@pytest.mark.parametrize("run,ok", [
    (_member(["CONVERGED"], [127]), True),
    (_member(["CONVERGED"], [134]), True),      # 128 + 5% of 128
    (_member(["CONVERGED"], [135]), False),
    (_member(["CONVERGED"], [121]), True),      # 127 - 5% of 127
    (_member(["CONVERGED"], [120]), False),
    (_member(["STAGNATED"], [127]), False),     # no member stagnated
])
def test_ensemble_verdict_unanimous(run, ok):
    """Where every member agrees, the rule is the plain comparison: the
    same status and iterations within max(3, 5%)."""
    members = [_member(["CONVERGED"], [127]), _member(["CONVERGED"], [128])]
    problems, robust = chip_smoke.ensemble_verdict(run, members)
    assert robust == [True]
    assert (not problems) == ok, problems


def test_ensemble_verdict_spread():
    """A spread ensemble admits any status a member ends in and iterations
    within its range; the robust flag is per column."""
    members = [_member(["STAGNATED", "CONVERGED"], [53, 116]),
               _member(["CONVERGED", "CONVERGED"], [161, 116]),
               _member(["CONVERGED", "CONVERGED"], [140, 117])]
    run = _member(["STAGNATED", "CONVERGED"], [138, 116])
    problems, robust = chip_smoke.ensemble_verdict(run, members)
    assert robust == [False, True] and not problems
    problems, _ = chip_smoke.ensemble_verdict(
        _member(["DIVERGED", "CONVERGED"], [100, 116]), members)
    assert problems and "status DIVERGED" in problems[0]
    problems, _ = chip_smoke.ensemble_verdict(
        _member(["CONVERGED", "CONVERGED"], [171, 116]), members)
    assert problems and "outside" in problems[0]
    problems, _ = chip_smoke.ensemble_verdict(
        _member(["CONVERGED", "CONVERGED"], [140, 3]), members)
    assert problems and problems[0].startswith("column 1")
