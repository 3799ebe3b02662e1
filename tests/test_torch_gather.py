"""The port's fixed-order gather (`core/gather_scatter.py`) on the CPU.

The gather sums each dof's contributions in the order its `GatherPlan`
fixes: each dof's local nodes in ascending order, added left to right.
Checked here:

  * against a numpy sum in that order, built independently from the
    numbering with a Python loop: bitwise (the same float additions in the
    same order; bf16 inputs widened to fp32, summed, rounded once);
  * against the JAX reference's `gather` (XLA `segment_sum`, which on the
    CPU adds in that same order): bitwise in fp32 and fp64, which is within
    the 1e-6 relative bound a gather in another order would be held to;
  * repeated calls: the same bits;
  * the plan itself: a permutation of the local nodes grouped by the box
    mesh's multiplicities 1, 2, 4, 8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gather_scatter as jgs
from repro.core import mesh_gen as jmesh
from repro_torch.core import gather_scatter as tgs

RTOL_JAX = 1e-6
BF16 = torch.bfloat16

# (name, trailing axes, storage dtype)
CASES = [("scalar", (), torch.float32), ("d3", (3,), torch.float32),
         ("nrhs4", (4,), torch.float32), ("bf16", (), BF16),
         ("bf16_nrhs2", (2,), BF16), ("fp64", (3,), torch.float64)]
SHAPES = [(2, 2, 2, 3), (3, 2, 1, 2), (2, 3, 2, 5)]


def _mesh(shape):
    return jmesh.deform_trilinear(jmesh.box_mesh(*shape), seed=3)


def _local(mesh, trailing, dtype, seed=1):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal(mesh.global_ids.shape + trailing)
    return torch.as_tensor(y, dtype=torch.float32).to(dtype)


def _numpy_fixed_order(y, global_ids, n_global):
    """The gather the plan promises, from scratch: every dof's local
    positions in ascending order, added left to right in the accumulation
    dtype."""
    flat = np.asarray(global_ids).reshape(-1)
    vals = y.reshape((flat.size,) + y.shape[global_ids.ndim:])
    out = [None] * n_global
    for pos, dof in enumerate(flat):
        out[dof] = vals[pos].copy() if out[dof] is None \
            else out[dof] + vals[pos]
    return np.stack(out)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name,trailing,dtype", CASES,
                         ids=[c[0] for c in CASES])
def test_gather_equals_numpy_in_the_plans_order(shape, name, trailing,
                                                dtype):
    mesh = _mesh(shape)
    ids = torch.as_tensor(mesh.global_ids, dtype=torch.int64)
    y = _local(mesh, trailing, dtype)
    got = tgs.gather(y, ids, mesh.n_global)
    acc = np.float64 if dtype == torch.float64 else np.float32
    want = _numpy_fixed_order(y.to(torch.float64 if acc is np.float64
                                   else torch.float32).numpy(),
                              mesh.global_ids, mesh.n_global)
    assert got.dtype == dtype and got.shape == (mesh.n_global,) + trailing
    want_t = torch.as_tensor(want).to(dtype)
    assert torch.equal(got.view(torch.int16) if dtype == BF16 else got,
                       want_t.view(torch.int16) if dtype == BF16
                       else want_t)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("trailing", [(), (3,), (4,)], ids=str)
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["fp32", "fp64"])
def test_gather_matches_the_reference_gather(shape, trailing, dtype):
    mesh = _mesh(shape)
    ids = torch.as_tensor(mesh.global_ids, dtype=torch.int64)
    y = np.random.default_rng(2).standard_normal(
        mesh.global_ids.shape + trailing).astype(dtype)
    got = tgs.gather(torch.as_tensor(y), ids, mesh.n_global).numpy()
    saved = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", dtype is np.float64)
    try:
        ref = np.asarray(jgs.gather(jnp.asarray(y),
                                    jnp.asarray(mesh.global_ids),
                                    mesh.n_global))
    finally:
        jax.config.update("jax_enable_x64", saved)
    assert ref.dtype == got.dtype
    err = np.max(np.abs(got.astype(np.float64) - ref)) / np.max(np.abs(ref))
    assert err <= RTOL_JAX, err
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name,trailing,dtype", CASES,
                         ids=[c[0] for c in CASES])
def test_gather_repeats_bitwise(name, trailing, dtype):
    mesh = _mesh((3, 3, 2, 3))
    ids = torch.as_tensor(mesh.global_ids, dtype=torch.int64)
    plan = tgs.gather_plan(mesh.global_ids, mesh.n_global)
    y = _local(mesh, trailing, dtype, seed=3)
    first = tgs.gather(y, ids, mesh.n_global, plan)
    for again in (tgs.gather(y, ids, mesh.n_global, plan),
                  tgs.gather(y.clone(), ids, mesh.n_global)):
        assert torch.equal(again, first)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plan_is_a_permutation_grouped_by_multiplicity(shape):
    mesh = _mesh(shape)
    plan = tgs.gather_plan(mesh.global_ids, mesh.n_global)
    n_local = mesh.global_ids.size
    assert plan.perm.dtype == plan.inv.dtype == torch.int64
    assert sorted(plan.perm.tolist()) == list(range(n_local))
    assert sorted(plan.inv.tolist()) == list(range(mesh.n_global))
    counts = np.bincount(mesh.global_ids.reshape(-1),
                         minlength=mesh.n_global)
    assert [m for m, _ in plan.classes] == sorted(set(counts.tolist()))
    assert set(m for m, _ in plan.classes) <= {1, 2, 4, 8}
    assert sum(m * n for m, n in plan.classes) == n_local
    assert sum(n for _, n in plan.classes) == mesh.n_global
    # within a group, each dof's positions are ascending
    flat = mesh.global_ids.reshape(-1)
    perm, start = plan.perm.numpy(), 0
    for m, n in plan.classes:
        block = perm[start:start + m * n].reshape(n, m)
        assert (np.diff(block, axis=1) > 0).all()
        assert (flat[block] == flat[block[:, :1]]).all()
        start += m * n


@pytest.mark.parametrize("m", [1, 2, 3, 5, 8])
def test_ordered_sum_adds_left_to_right(m):
    rng = np.random.default_rng(m)
    s = rng.standard_normal((7, m, 2)).astype(np.float32)
    want = s[:, 0].copy()
    for j in range(1, m):
        want = want + s[:, j]
    np.testing.assert_array_equal(
        tgs.ordered_sum(torch.as_tensor(s).movedim(1, -1)).numpy(), want)


@pytest.mark.parametrize("cols", [1, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, BF16, torch.float64],
                         ids=["fp32", "bf16", "fp64"])
def test_column_layout_matches_the_plain_gather_and_scatter(cols, dtype):
    """The global operator's column-major scatter and gather, on the
    element kernels' (E, c, N1,N1,N1) layout, give `scatter`'s values and
    `gather`'s bits."""
    mesh = _mesh((3, 2, 2, 3))
    ids = torch.as_tensor(mesh.global_ids, dtype=torch.int64)
    plan = tgs.gather_plan(mesh.global_ids, mesh.n_global)
    rng = np.random.default_rng(cols)
    x = torch.as_tensor(rng.standard_normal((mesh.n_global, cols)),
                        dtype=torch.float32).to(dtype)
    assert torch.equal(tgs.scatter_columns(x, ids),
                       torch.movedim(tgs.scatter(x, ids), -1, 1))
    y = _local(mesh, (cols,), dtype, seed=cols + 10)
    y_elem = torch.movedim(y, -1, 1).contiguous()
    got = tgs.gather_columns(y_elem, plan)
    assert got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got, tgs.gather(y, ids, mesh.n_global, plan))
