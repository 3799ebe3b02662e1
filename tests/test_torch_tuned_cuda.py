"""Card tests of the tuned bodies at every order from 1 to 15 (N1 = 2 to
16): the column body (`csrc/axhelm_column.cu`, K2 and K5) and the line body
(`csrc/axhelm_line.cu`, K1, K3 and K4), every entry point, float32 and
bfloat16 storage, E in {1, 3, 37} (ragged blocks and groups) and c in
{1, 4}, against its plain PyTorch version, the launch counted once under
the entry point; bf16 also against the correctly rounded result (the
one-ulp rule of `chip_smoke.py` phase 3b, the share of outputs off judged
on calls of at least 1,000 outputs and on the small ones pooled); x at an
element offset of a larger batch, which at odd N1 no vector load could
take; and 2x1x1 order-9 solves through the kernels against the reference
backend.

Every test carries the `cuda` marker and skips without a card; whether a
card is present is decided in the `card` fixture, at run time.  This file
imports neither jax nor the reference package:

    python -m pytest -q -m cuda tests/test_torch_tuned_cuda.py

Tolerance: max|y_kernel - y_plain| / max|y_plain| <= 1e-4 for float32 (the
kernel sums in another order than the einsums) and 8e-3 for bfloat16 (one
bf16 ulp of the largest entry: both round one float32 result once); at
most 1e-3 of a bf16 kernel's outputs off the correctly rounded value, none
by more than one ulp unless within 1e-6 of max|y|.
"""

import pytest
import torch

from repro_torch.core import mesh_gen, nekbone
from repro_torch.kernels.axhelm import ops
from repro_torch.resilience.status import SolveStatus

from test_torch_cuda import (_VARIANT_EQUATIONS, _operands, card,  # noqa: F401
                             chip_smoke)

pytestmark = pytest.mark.cuda

RTOL = {torch.float32: 1e-4, torch.bfloat16: 8e-3}


def _against_plain(y, x, b, variant, geom, kw, dtype):
    """The tolerance, and for bf16 the one-ulp rule: no output more than one
    ulp off the correctly rounded value (but within ULP_ABS_FLOOR of
    max|y|); at most ULP_RATE_BOUND of them off at all, judged on a call of
    at least 1 / ULP_RATE_BOUND outputs (on fewer, one output off is more
    than the share: `test_small_bf16_calls_round_as_the_rule_says` pools
    them).  Returns the bf16 counts of outputs off and outputs."""
    assert y.dtype == dtype and bool(torch.isfinite(y.float()).all())
    y_plain = ops.reference(x, b, variant, geom, **kw).float()
    err = float((y.float() - y_plain).abs().max() / y_plain.abs().max())
    assert err <= RTOL[dtype], err
    if dtype != torch.bfloat16:
        return 0, y.numel()
    y_e = ops.unrounded(x, b, variant, geom, compute=torch.float64,
                        **kw).to(torch.bfloat16)
    d = chip_smoke.ulp_distance(y, y_e)
    floor = chip_smoke.ULP_ABS_FLOOR * float(y_e.float().abs().max())
    far = int(((d > 1) & ((y.float() - y_e.float()).abs() > floor)).sum())
    off = int((d != 0).sum())
    assert far == 0, far
    if d.numel() * chip_smoke.ULP_RATE_BOUND >= 1:
        assert off <= chip_smoke.ULP_RATE_BOUND * d.numel(), (off, d.numel())
    return off, d.numel()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ncols", [1, 4])
@pytest.mark.parametrize("e", [1, 3, 37])
@pytest.mark.parametrize("n", range(1, ops.N1_TUNED_MAX))
@pytest.mark.parametrize("variant,helm", _VARIANT_EQUATIONS)
def test_tuned_body_matches_plain_version(card, variant, helm, n, e, ncols,
                                          dtype):
    b, x, geom, kw = _operands(variant, n, e, ncols, helm, card, seed=n + e,
                               dtype=dtype)
    assert ops.body_of(variant, b.n1) == (
        "column" if variant in ops.COLUMN_VARIANTS else "line")
    name = ops.entry_point(variant, dtype)
    before = ops.launch_counts[name]
    y = ops.axhelm(x, b, variant, geom, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts[name] == before + 1
    _against_plain(y, x, b, variant, geom, kw, dtype)


@pytest.mark.parametrize("variant,helm", _VARIANT_EQUATIONS)
def test_small_bf16_calls_round_as_the_rule_says(card, variant, helm):
    """The bf16 calls of fewer than 1 / ULP_RATE_BOUND outputs (E = 1 and 3,
    c = 1 and 4, at every N1) of one entry point, pooled: at most
    ULP_RATE_BOUND of their outputs off the correctly rounded value."""
    off = total = 0
    for n in range(1, ops.N1_TUNED_MAX):
        for e in (1, 3):
            for ncols in (1, 4):
                b, x, geom, kw = _operands(variant, n, e, ncols, helm, card,
                                           seed=n + e,
                                           dtype=torch.bfloat16)
                y = ops.axhelm(x, b, variant, geom, **kw)
                o, m = _against_plain(y, x, b, variant, geom, kw,
                                      torch.bfloat16)
                off, total = off + o, total + m
    assert off <= chip_smoke.ULP_RATE_BOUND * total, (off, total)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [2, 4, 6, 8, 9, 12, 14])
@pytest.mark.parametrize("variant,helm", _VARIANT_EQUATIONS)
def test_tuned_body_takes_operands_at_an_element_offset(card, variant, helm,
                                                        n, dtype):
    """Elements 1-5 of a batch of 6 (as a shard's interior launch takes
    them): at odd N1 the views start off every vector boundary, and the
    line body stages them one value a load; at even N1 they keep the
    vectors' alignment.  The same as the plain version on the same
    views."""
    b, x, geom, kw = _operands(variant, n, 6, 1, helm, card, seed=n,
                               dtype=dtype)
    x, geom = x[1:], geom[1:]
    kw = {k: v[1:] if isinstance(v, torch.Tensor) else v
          for k, v in kw.items()}
    if b.n1 % 2:
        assert x.data_ptr() % 8
    y = ops.axhelm(x, b, variant, geom, **kw)
    torch.cuda.synchronize()
    _against_plain(y, x, b, variant, geom, kw, dtype)


@pytest.mark.parametrize("variant,helm", _VARIANT_EQUATIONS)
def test_order_9_solve_matches_reference_backend(card, variant, helm):
    """The 2x1x1 order-9 box (N1 = 10: the column body's D-hat from shared
    memory and rolled k loops, the line body's 8-byte vectors and its t
    components in shared memory), through the tuned bodies and through the
    reference backend on the card: the same status and iterations within
    +-1; the kernels launched only through the tuned bodies' backend."""
    box = mesh_gen.box_mesh(2, 1, 1, 9)
    mesh = mesh_gen.deform_affine(box, seed=2) \
        if variant == "parallelepiped" else mesh_gen.deform_trilinear(box)
    out = {}
    for backend in ("cuda", "reference"):
        prob = nekbone.setup_problem(mesh, variant=variant, helmholtz=helm,
                                     backend=backend, device=card)
        x_true = nekbone.random_solution(prob, seed=0)
        b = nekbone.rhs_from_solution(prob, x_true)
        ops.reset_launch_counts()
        out[backend] = nekbone.solve(prob, b, tol=1e-6, max_iter=2000)
        launches = ops.launch_counts[ops.entry_point(variant,
                                                     torch.float32)]
        assert (launches > 0) == (backend == "cuda")
    k, r = out["cuda"], out["reference"]
    assert int(k.status) == int(r.status) == SolveStatus.CONVERGED
    assert abs(int(k.iterations) - int(r.iterations)) <= 1


@pytest.mark.parametrize("n,variant,helm", [(15, "trilinear", False),
                                            (15, "merged", True),
                                            (16, "trilinear", False),
                                            (16, "merged", True)])
def test_dynamic_shared_memory_bodies_run_captured(card, n, variant, helm):
    """Order 15 (the column body's 67.7 KB and the line body's shared
    memory above 48 KB) and order 16 (N1 = 17, the slab body): bodies
    that opt in to their dynamic shared memory at every launch, inside a
    captured solve too; captured x bitwise the eager x, one entry-point
    launch an application either way."""
    mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(2, 1, 1, n), seed=3)
    prob = nekbone.setup_problem(mesh, variant=variant, helmholtz=helm,
                                 backend="cuda", device=card)
    assert ops.body_of(variant, n + 1) == (
        "slab" if n + 1 > ops.N1_TUNED_MAX else
        "column" if variant in ops.COLUMN_VARIANTS else "line")
    b = nekbone.rhs_from_solution(prob, nekbone.random_solution(prob))
    name = ops.entry_point(variant, torch.float32)
    results = []
    for capture in (True, False):
        ops.reset_launch_counts()
        results.append((nekbone.solve(prob, b, tol=1e-6, max_iter=200,
                                      capture=capture),
                        ops.launch_counts[name]))
    (cap, n_cap), (eager, n_eager) = results
    assert prob.graphs.captures >= 1
    assert int(cap.iterations) == int(eager.iterations)
    assert torch.equal(cap.x, eager.x)
    assert n_cap == n_eager > 0

