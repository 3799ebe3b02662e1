"""Port parity, the element partition and the sharded gather's parts, in
one process: `repro_torch.core.mesh_gen.partition_elements` bitwise equal
to the reference package's, field by field; the grid helpers and the
shard context's validation (tests/test_nekbone_box.py); and a shard's
local gather, interface contributions and owned dot against the
reference's, with the exchange's all-reduce replaced by a sum over the
shards in numpy and the dot's by a one-rank group (tolerance: bitwise for the partition and the local gather, which
sum in the same order; 1e-12 relative in float64 for the exchange, whose
sum over shards runs in another order).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import gather_scatter as jgs
from repro.core import mesh_gen as jmesh
from repro.core.pcg import owned_dot as jowned_dot
from repro.distributed.context import parse_grid_arg as jparse_grid_arg
from repro_torch.core import gather_scatter as tgs
from repro_torch.core import mesh_gen as tmesh
from repro_torch.core.pcg import owned_dot as towned_dot
from repro_torch.distributed import context as tctx
from _torch_x64 import x64  # noqa: F401

MESHES = {"3x3x2_o3": ((3, 3, 2), 3), "5x1x1_o3": ((5, 1, 1), 3),
          "5x3x2_o2": ((5, 3, 2), 2)}
# every shard count on the slab and "auto" grids, and the (2, 2, 1) box at
# four shards
CASES = [(m, s, g) for m in MESHES for s in (2, 3, 4, 8)
         for g in (None, "auto")] + [(m, 4, (2, 2, 1)) for m in MESHES]


def _meshes(name):
    shape, order = MESHES[name]
    jm = jmesh.deform_trilinear(jmesh.box_mesh(*shape, order), seed=3)
    return jm, tmesh.BoxMesh(*jm)


def _partition_or_error(module, mesh, n_shards, grid):
    try:
        return module.partition_elements(mesh, n_shards, grid=grid)
    except ValueError as exc:
        return str(exc)


@pytest.mark.parametrize("name,n_shards,grid", CASES,
                         ids=[f"{m}-S{s}-{g}" for m, s, g in CASES])
def test_partition_matches_reference_bitwise(name, n_shards, grid):
    """Every field, the neighbour tables too, with its dtype; where the
    reference refuses the case (more shards than elements, a box that does
    not fit), the port refuses it with the same message."""
    jm, tm = _meshes(name)
    ref = _partition_or_error(jmesh, jm, n_shards, grid)
    got = _partition_or_error(tmesh, tm, n_shards, grid)
    if isinstance(ref, str):
        assert got == ref
        return
    assert got._fields == ref._fields
    for field in ref._fields:
        a, b = getattr(got, field), getattr(ref, field)
        if isinstance(b, tuple) and b and isinstance(b[0], np.ndarray):
            assert len(a) == len(b), field
            for x, y in zip(a, b):
                assert x.dtype == y.dtype, field
                np.testing.assert_array_equal(x, y, err_msg=field)
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        else:
            assert a == b, (field, a, b)


def test_auto_grid_minimizes_cut_surface():
    for shape, n in [((6, 6, 6), 4), ((8, 2, 2), 4), ((4, 4, 2), 8),
                     ((6, 6, 6), 8), ((1, 8, 1), 4), ((2, 2, 2), 7),
                     ((16, 16, 16), 4), ((8, 8, 8), 2)]:
        assert tmesh.auto_grid(shape, n) == jmesh.auto_grid(shape, n)
    assert tmesh.auto_grid((6, 6, 6), 4) == (2, 2, 1)
    assert tmesh.auto_grid((2, 2, 2), 7) == (7, 1, 1)


@pytest.mark.parametrize("grid,shape,n,match", [
    ((2, 2), (3, 3, 2), 3, "shards"),
    ((2, 1, 1, 1), (3, 3, 2), 2, "1-3 axes"),
    ((2, 0, 1), (3, 3, 2), 0, ">= 1"),
    ((1, 1, 4), (3, 3, 2), 4, "extents"),
    ("cube", (3, 3, 2), 4, "tuple"),
])
def test_normalize_grid_rejects_what_the_reference_rejects(grid, shape, n,
                                                           match):
    with pytest.raises(ValueError, match=match) as got:
        tmesh.normalize_grid(grid, shape, n)
    with pytest.raises(ValueError) as ref:
        jmesh.normalize_grid(grid, shape, n)
    assert str(got.value) == str(ref.value)


def test_normalize_grid_resolves_like_the_reference():
    for grid, shape, n in [(None, (3, 3, 2), 4), ((4, 1, 1), (3, 3, 2), 4),
                           ("auto", (3, 3, 2), 4), ((2,), (3, 3, 2), 2),
                           ("auto", None, 4), ((2, 2), None, 4)]:
        assert tmesh.normalize_grid(grid, shape, n) == \
            jmesh.normalize_grid(grid, shape, n)


@pytest.mark.parametrize("spec", ["slab", "auto", "2x2x1", "2x2", " SLAB ",
                                  "none", ""])
def test_parse_grid_arg_matches_reference(spec):
    assert tctx.parse_grid_arg(spec) == jparse_grid_arg(spec)


def test_parse_grid_arg_rejects_bad_specs():
    with pytest.raises(ValueError, match="grid spec"):
        tctx.parse_grid_arg("2,2")


def test_make_solver_ctx_validation():
    """Without a process group the world has one rank: the context
    collapses to None, warning about an exchange, grid or codec it cannot
    apply (the reference's warning); bad settings raise before that."""
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert tctx.make_solver_ctx() is None
        assert tctx.make_solver_ctx(devices=1) is None
    assert not w
    with pytest.warns(UserWarning, match="grid.*ignored"):
        assert tctx.make_solver_ctx(grid="auto") is None
    with pytest.raises(ValueError, match="unknown exchange"):
        tctx.make_solver_ctx(exchange="ring")
    with pytest.raises(ValueError, match="unknown halo compress"):
        tctx.make_solver_ctx(compress="zstd")
    with pytest.warns(UserWarning, match="exchange='neighbour'.*ignored"):
        assert tctx.make_solver_ctx(exchange="neighbour") is None
    with pytest.warns(UserWarning, match="compress='int8'.*ignored"):
        assert tctx.make_solver_ctx(exchange="neighbour",
                                    compress="int8") is None
    with pytest.raises(ValueError, match="requires exchange='neighbour'"):
        tctx.make_solver_ctx(compress="bf16")
    with pytest.raises(ValueError, match="2 shards.*1 rank"):
        tctx.make_solver_ctx(devices=2)
    # the mesh-independent grid rules run eagerly
    with pytest.raises(ValueError, match="devices"):
        tctx._validate_grid_spec((2, 2), 2)
    with pytest.raises(ValueError, match=">= 1"):
        tctx._validate_grid_spec((2, 0), 4)
    tctx._validate_grid_spec((2, 2), 4)
    tctx._validate_grid_spec("auto", 4)


def test_rank_device():
    assert tctx._rank_device(3, "cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tctx._rank_device(0, None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tctx._rank_device(0, "cuda:1")


@pytest.mark.parametrize("grid", [None, (2, 2, 1)])
@pytest.mark.parametrize("trailing", [(), (3,)])
def test_shard_gather_and_exchange_match_reference(x64, grid, trailing):
    """Each shard's local gather (the trash slot gathers nothing, padding
    slots are zero) equals the reference's segment sum bitwise at every
    real slot; its interface contributions equal the reference's, and
    summing them over the shards and writing them back gives every real
    local slot the global gather's value."""
    jm, tm = _meshes("3x3x2_o3")
    part = tmesh.partition_elements(tm, 4, grid=grid)
    rng = np.random.default_rng(3)
    nl, ep = part.n_local, part.e_per_shard
    y = rng.standard_normal((4, ep) + part.local_ids.shape[2:] + trailing)
    dofs_t, dofs_j, contrib_t, contrib_j = [], [], [], []
    for s in range(4):
        lid = part.local_ids[s]
        plan = tgs.gather_plan(lid, nl, skip=nl - 1)
        yt = tgs.gather(torch.as_tensor(y[s]),
                        torch.as_tensor(lid, dtype=torch.int64), nl, plan)
        yj = np.asarray(jgs.gather_sharded(jnp.asarray(y[s]),
                                           jnp.asarray(lid), nl, None, None,
                                           None))
        real = part.valid_mask[s]
        np.testing.assert_array_equal(yt.numpy()[real], yj[real])
        assert not yt.numpy()[~real].any()
        dofs_t.append(yt)
        dofs_j.append(yj)
        sidx, spres = part.shared_idx[s], part.shared_present[s]
        contrib_t.append(tgs.shared_contrib(
            yt, torch.as_tensor(sidx, dtype=torch.int64),
            torch.as_tensor(spres)).numpy())
        contrib_j.append(np.asarray(jgs.shared_contrib(
            jnp.asarray(yj), jnp.asarray(sidx), jnp.asarray(spres))))
        np.testing.assert_array_equal(contrib_t[-1], contrib_j[-1])
    summed = np.sum(contrib_t, axis=0)
    full = jgs.gather(jnp.asarray(
        np.concatenate([y[s, :c] for s, c in enumerate(part.elem_counts)])),
        jnp.asarray(jm.global_ids[np.concatenate(
            [part.elem_perm[s, :c] for s, c in enumerate(part.elem_counts)])]),
        jm.n_global)
    full = np.asarray(full)
    for s in range(4):
        out = tgs.apply_shared(dofs_t[s], torch.as_tensor(
            part.shared_idx[s], dtype=torch.int64),
            torch.as_tensor(summed)).numpy()
        real = part.valid_mask[s]
        want = full[part.local_to_global[s][real]]
        assert np.max(np.abs(out[real] - want)) <= 1e-12 * np.max(
            np.abs(want))


@pytest.fixture
def one_rank_group(tmp_path):
    """A gloo process group of this process alone: its all-reduce returns
    the partial it is given."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


@pytest.mark.parametrize("batched", [False, True])
def test_owned_dot_matches_reference(x64, one_rank_group, batched):
    """The shard's partial owned dot (over a one-rank group, whose
    all-reduce leaves it as it is) equals the reference's within 1e-12
    relative in float64 (another reduction order); bfloat16 operands sum
    in float32."""
    jm, tm = _meshes("3x3x2_o3")
    part = tmesh.partition_elements(tm, 2)
    rng = np.random.default_rng(4)
    shape = (part.n_local,) + ((3,) if batched else ())
    u, v = rng.standard_normal(shape), rng.standard_normal(shape)
    for s in range(2):
        w = part.owned_mask[s]
        got = towned_dot(torch.as_tensor(w), one_rank_group, batched)(
            torch.as_tensor(u), torch.as_tensor(v)).numpy()
        want = np.asarray(jowned_dot(jnp.asarray(w), batched=batched)(
            jnp.asarray(u), jnp.asarray(v)))
        assert got.shape == want.shape
        assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))
    lo = torch.as_tensor(u, dtype=torch.bfloat16)
    got = towned_dot(torch.as_tensor(part.owned_mask[0]), one_rank_group,
                     batched)(lo, lo)
    assert got.dtype == torch.float32
