"""Port parity, the neighbour exchange without a process group: the halo
codecs, `neighbour_finish` on emulated rounds, the launch plan, the
degenerate-overlap warning and the shard context's validation, against
the reference package (tests/test_nekbone_neighbour.py,
tests/test_nekbone_box.py, tests/test_mixed_precision.py).

The rounds' transport is played in numpy, as the reference's property
tests play `ppermute`: shard t receives on its hi side shard t - k's lo
send and on its lo side shard t + k's hi send.  The port's tables, sends
and accumulation are its own; the reference's `neighbour_finish` gets the
same received values.  Tolerances: the codecs and `neighbour_finish` are
bitwise the reference's (the same values added in the same order per
dof, fp32 accumulation for bf16); the emulated exchange against the psum
exchange and the dense gather within 1e-6 relative in float32.  The
exchange on gloo ranks is in tests/test_torch_sharded.py.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gather_scatter as jgs
from repro.core import mesh_gen as jmesh
from repro.core.nekbone import _neighbour_launch_plan as jplan
from repro.distributed import compression as jcomp
from repro_torch.core import gather_scatter as tgs
from repro_torch.core import mesh_gen as tmesh
from repro_torch.core import nekbone as tnek
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed import context as tctx
from repro_torch.kernels.axhelm import ops as kops
from repro_torch.core import axhelm as taxhelm
from repro_torch.core.spectral import basis as tbasis

CPU = torch.device("cpu")
TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _np(t: torch.Tensor) -> np.ndarray:
    """A tensor's values in numpy, bf16 widened exactly to fp32."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _bits_equal(got: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    got_np = got.view(torch.int16).numpy() if got.dtype == torch.bfloat16 \
        else got.numpy()
    ref_np = ref.view(np.int16) if ref.dtype == jnp.bfloat16 else ref
    assert got_np.shape == ref_np.shape, (got_np.shape, ref_np.shape)
    assert got_np.dtype.itemsize == ref_np.dtype.itemsize
    np.testing.assert_array_equal(
        np.atleast_1d(got_np).view(np.uint8),
        np.ascontiguousarray(np.atleast_1d(ref_np)).view(np.uint8))


# ------------------------------------------------------------ the codecs --


def _codec_inputs(seed: int, shape) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 10.0 ** rng.integers(
        -3, 4, size=shape[:1])[(...,) + (None,) * (len(shape) - 1)])
    x = x.astype(np.float32)
    x[::7] = 0.0            # all-zero rows (padding lanes)
    if len(shape) == 2 and shape[1] >= 4:
        # exact halves of the scale: round half to even decides them
        x[1, :4] = [127.0, 0.5, 1.5, -2.5]
    return x


@pytest.mark.parametrize("method", ["bf16", "int8"])
@pytest.mark.parametrize("shape", [(53,), (53, 4)], ids=["M", "Mx4"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_halo_codec_matches_reference_bitwise(method, shape, dtype):
    """Every wire part and the decoded partials, bitwise."""
    x = _codec_inputs(7, shape)
    xt = torch.as_tensor(x).to(TORCH_DT[dtype])
    xj = jnp.asarray(x).astype(JAX_DT[dtype])
    got = tcomp.halo_compress(xt, method)
    ref = jcomp.halo_compress(xj, method)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        _bits_equal(g, r)
    _bits_equal(tcomp.halo_decompress(got, method, TORCH_DT[dtype]),
                jcomp.halo_decompress(ref, method, JAX_DT[dtype]))


def test_quantize_int8_matches_reference_bitwise():
    """Per-row scales at two axes, one scale for a 1-D tensor (and scale
    1 for all zeros), half-to-even rounding of x32 / scale."""
    for x in (_codec_inputs(3, (40, 6)), _codec_inputs(4, (40,)),
              np.zeros(5, np.float32), np.zeros((3, 2), np.float32)):
        q, s = tcomp.quantize_int8(torch.as_tensor(x))
        qj, sj = jcomp.quantize_int8(jnp.asarray(x))
        _bits_equal(q, qj)
        _bits_equal(s, sj)
        _bits_equal(tcomp.dequantize_int8(q, s), jcomp.dequantize_int8(qj,
                                                                       sj))


def test_halo_codec_is_per_dof():
    """A dof encodes the same whichever buffer slices it (the self-round
    relies on it)."""
    x = torch.as_tensor(_codec_inputs(5, (30, 4)))
    for method in ("bf16", "int8"):
        whole = tcomp.halo_decompress(tcomp.halo_compress(x, method), method,
                                      torch.float32)
        part = tcomp.halo_decompress(tcomp.halo_compress(x[7:19], method),
                                     method, torch.float32)
        assert torch.equal(whole[7:19], part), method


def test_unknown_codec_raises():
    with pytest.raises(ValueError, match="unknown halo compress"):
        tcomp.halo_compress(torch.zeros(3), "zstd")
    with pytest.raises(ValueError, match="unknown halo compress"):
        tcomp.halo_decompress((torch.zeros(3),), "zstd", torch.float32)


# --------------------------------------------- emulated exchange rounds --

# (mesh shape, order, shards, grid): 8^3 and a mesh no shard count divides
PARTITIONS = [((8, 8, 8), 1, 2, None), ((8, 8, 8), 1, 4, (2, 2, 1)),
              ((5, 3, 2), 2, 2, None), ((5, 3, 2), 2, 4, (2, 2, 1))]


def _partition(shape, order, shards, grid):
    jm = jmesh.deform_trilinear(jmesh.box_mesh(*shape, order), seed=3)
    tm = tmesh.BoxMesh(*jm)
    return jm, tm, tmesh.partition_elements(tm, shards, grid=grid)


def _tables(part, t):
    return [torch.as_tensor(a[t]) for j in range(len(part.nbr_offsets))
            for a in (part.nbr_lo_idx[j], part.nbr_lo_mask[j],
                      part.nbr_hi_idx[j], part.nbr_hi_mask[j])]


def _emulate(part, y_dofs, compress=None):
    """Every shard's rounds (port and reference) and the receives of each
    round, the transport played in numpy: the port's InFlight per shard,
    and the reference's recvs (zeros where no source sends)."""
    s = part.n_shards
    rounds = [tgs.neighbour_rounds(part.nbr_offsets, s, t, _tables(part, t))
              for t in range(s)]
    jrounds = [jgs.neighbour_rounds(part.nbr_offsets, s,
                                    [jnp.asarray(a.numpy())
                                     for a in _tables(part, t)])
               for t in range(s)]

    def send(t, j, side):
        r = rounds[t][j]
        idx, mask = (r.lo_idx, r.lo_mask) if side == "lo" else \
            (r.hi_idx, r.hi_mask)
        vals = tgs.shared_contrib(y_dofs[t], idx, mask)
        return (vals,) if compress is None else \
            tcomp.halo_compress(vals, compress)

    def to_jax(parts):
        return tuple(jnp.asarray(_np(p)).astype(
            jnp.bfloat16 if p.dtype == torch.bfloat16 else _np(p).dtype)
            for p in parts)

    inflight, jrecvs = [], []
    for t in range(s):
        recvs, jr = [], []
        for j, k in enumerate(part.nbr_offsets):
            hi = send(t - k, j, "lo") if t - k >= 0 else None
            lo = send(t + k, j, "hi") if t + k < s else None
            recvs.append((hi, lo))
            zero = tuple(torch.zeros_like(p) for p in send(t, j, "lo"))
            pair = tuple(to_jax(zero if p is None else p) for p in (hi, lo))
            jr.append(pair if compress is not None else
                      (pair[0][0], pair[1][0]))
        inflight.append(tgs.InFlight([], recvs, False, CPU, []))
        jrecvs.append(jr)
    return rounds, jrounds, inflight, jrecvs


def _shard_dofs(jm, part, rng, nrhs, dtype):
    """Each shard's local gather of a random element field, as the shard
    operator forms it, in `dtype`; and the dense single-device gather."""
    n1 = jm.order + 1
    bshape = (nrhs,) if nrhs > 1 else ()
    y = rng.standard_normal((len(jm.verts), n1, n1, n1) + bshape)
    y = torch.as_tensor(y, dtype=torch.float32).to(TORCH_DT[dtype])
    dense = tgs.gather(y.double(), torch.as_tensor(jm.global_ids),
                       jm.n_global)
    out = []
    for t in range(part.n_shards):
        blk = torch.zeros((part.e_per_shard,) + tuple(y.shape[1:]),
                          dtype=y.dtype)
        ne = part.elem_counts[t]
        blk[:ne] = y[torch.as_tensor(part.elem_perm[t, :ne])]
        out.append(tgs.gather(blk, torch.as_tensor(part.local_ids[t]),
                              part.n_local))
    return out, dense


@pytest.mark.parametrize("case", PARTITIONS,
                         ids=[f"{'x'.join(map(str, c[0]))}-S{c[2]}-"
                              f"{'slab' if c[3] is None else 'box'}"
                              for c in PARTITIONS])
@pytest.mark.parametrize("dtype,compress",
                         [("f32", None), ("bf16", None), ("f32", "bf16"),
                          ("f32", "int8"), ("bf16", "int8")])
@pytest.mark.parametrize("nrhs", [1, 4])
def test_neighbour_finish_matches_reference_bitwise(case, dtype, compress,
                                                    nrhs):
    """The same y_dofs and received values through the reference's
    `neighbour_finish` and the port's: bitwise equal on every local slot
    of every shard (fp32 accumulation for bf16)."""
    jm, _, part = _partition(*case)
    rng = np.random.default_rng(0)
    y_dofs, _ = _shard_dofs(jm, part, rng, nrhs, dtype)
    rounds, jrounds, inflight, jrecvs = _emulate(part, y_dofs, compress)
    for t in range(part.n_shards):
        got = tgs.neighbour_finish(y_dofs[t], rounds[t], inflight[t],
                                   compress)
        yj = jnp.asarray(_np(y_dofs[t])).astype(JAX_DT[dtype])
        ref = jgs.neighbour_finish(yj, jrounds[t], jrecvs[t],
                                   compress=compress)
        _bits_equal(got, ref)


@pytest.mark.parametrize("case", PARTITIONS,
                         ids=[f"{'x'.join(map(str, c[0]))}-S{c[2]}-"
                              f"{'slab' if c[3] is None else 'box'}"
                              for c in PARTITIONS])
@pytest.mark.parametrize("nrhs", [1, 3])
def test_emulated_exchange_matches_psum_and_dense(case, nrhs):
    """Every valid slot ends with the full global sum: within 1e-6
    relative (float32) of the psum exchange and of the dense gather."""
    jm, _, part = _partition(*case)
    y_dofs, dense = _shard_dofs(jm, part, np.random.default_rng(1), nrhs,
                                "f32")
    rounds, _, inflight, _ = _emulate(part, y_dofs)
    total = sum(tgs.shared_contrib(y_dofs[t],
                                   torch.as_tensor(part.shared_idx[t]),
                                   torch.as_tensor(part.shared_present[t]))
                for t in range(part.n_shards))
    for t in range(part.n_shards):
        got = tgs.neighbour_finish(y_dofs[t], rounds[t], inflight[t])
        psum = tgs.apply_shared(y_dofs[t], torch.as_tensor(
            part.shared_idx[t]), total)
        valid = torch.as_tensor(part.valid_mask[t])
        gids = torch.as_tensor(part.local_to_global[t])[valid]
        scale = float(dense.abs().max())
        assert float((got[valid] - psum[valid]).abs().max()) <= 1e-6 * scale
        assert float((got[valid].double() - dense[gids]).abs().max()) \
            <= 1e-6 * scale


def test_self_round_is_what_partners_decode():
    """After `halo_self_round` a shard's own interface partials are bit for
    bit what a partner decodes from its sends."""
    jm, _, part = _partition((5, 3, 2), 2, 4, (2, 2, 1))
    y_dofs, _ = _shard_dofs(jm, part, np.random.default_rng(2), 4, "f32")
    for t in range(part.n_shards):
        rounds = tgs.neighbour_rounds(part.nbr_offsets, part.n_shards, t,
                                      _tables(part, t))
        sidx = torch.as_tensor(part.shared_idx[t])
        spres = torch.as_tensor(part.shared_present[t])
        for method in ("bf16", "int8"):
            own = tgs.halo_self_round(y_dofs[t], sidx, spres, method)
            for r in rounds:
                sent = tcomp.halo_decompress(tcomp.halo_compress(
                    tgs.shared_contrib(y_dofs[t], r.lo_idx, r.lo_mask),
                    method), method, torch.float32)
                assert torch.equal(own[r.lo_real], sent[r.lo_rows])


def test_rounds_name_partners_and_real_slots():
    """s + k and s - k where they exist; the real entries are the masked
    ones, each slot once; tags differ per (round, direction, part)."""
    _, _, part = _partition((5, 3, 2), 2, 4, (2, 2, 1))
    s = part.n_shards
    tags = set()
    for t in range(s):
        rounds = tgs.neighbour_rounds(part.nbr_offsets, s, t,
                                      _tables(part, t))
        assert [r.k for r in rounds] == list(part.nbr_offsets)
        for j, r in enumerate(rounds):
            k = part.nbr_offsets[j]
            assert r.lo_peer == (t + k if t + k < s else None)
            assert r.hi_peer == (t - k if t - k >= 0 else None)
            for real, rows, idx, mask in ((r.lo_real, r.lo_rows, r.lo_idx,
                                           r.lo_mask),
                                          (r.hi_real, r.hi_rows, r.hi_idx,
                                           r.hi_mask)):
                assert torch.equal(rows, torch.nonzero(mask).reshape(-1))
                assert torch.equal(real, idx[mask])
                assert len(set(real.tolist())) == len(real)
            for direction in (0, 1):
                for p in range(2):
                    tags.add((t, tgs._tag(r, direction, p)))
    assert len(tags) == s * len(part.nbr_offsets) * 4


def test_exchange_neighbour_with_codec_needs_the_tables():
    y = torch.zeros(5)
    with pytest.raises(ValueError, match="requires shared_idx"):
        tgs.exchange_neighbour(y, [], None, compress="int8")


# ----------------------------------------------------- launch plan, ctx --


def test_neighbour_launch_plan_matches_reference():
    """The reference's chunky and thin partitions
    (tests/test_nekbone_box.py::test_neighbour_launch_plan_degenerate_
    cases): split and cut as the reference's plan has them."""
    for shape, order, shards, grid in (((6, 6, 6), 2, 4, (2, 2, 1)),
                                       ((4, 1, 1), 2, 4, None),
                                       ((8, 8, 8), 7, 2, None),
                                       ((8, 8, 8), 7, 4, (2, 2, 1))):
        jm = jmesh.box_mesh(*shape, order)
        jp = jmesh.partition_elements(jm, shards, grid=grid)
        tp = tmesh.partition_elements(tmesh.BoxMesh(*jm), shards, grid=grid)
        split, cut = tnek._neighbour_launch_plan(tp)
        assert (split, cut) == tuple(jplan(jp)[:2]), shape
    thin = tmesh.partition_elements(tmesh.box_mesh(4, 1, 1, 2), 4)
    assert thin.e_iface == thin.e_per_shard
    assert tnek._neighbour_launch_plan(thin) == (False, thin.e_per_shard)


def _fake_ctx(shards, exchange, compress=None, grid=None):
    """A shard context with no process group: enough for setup, which
    makes no collective call."""
    return tctx.SolverShardCtx(None, 0, shards, CPU, grid, exchange,
                               compress)


def test_degenerate_overlap_warns_at_setup():
    """An all-interface partition (a thin 4x1x1 mesh at S=4) warns and
    points at the box decomposition; a split one does not warn."""
    thin = tmesh.deform_trilinear(tmesh.box_mesh(4, 1, 1, 2), seed=3)
    with pytest.warns(UserWarning, match="no interior elements.*grid"):
        tnek.setup_problem(thin, variant="trilinear", backend="reference",
                           shard_ctx=_fake_ctx(4, "neighbour"))
    chunky = tmesh.deform_trilinear(tmesh.box_mesh(6, 6, 6, 2), seed=3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tnek.setup_problem(chunky, variant="trilinear", backend="reference",
                           shard_ctx=_fake_ctx(4, "neighbour",
                                               grid=(2, 2, 1)))
        tnek.setup_problem(thin, variant="trilinear", backend="reference",
                           shard_ctx=_fake_ctx(4, "psum"))


def test_make_solver_ctx_neighbour_validation():
    """The reference's rules (src/repro/distributed/context.py): unknown
    exchange or codec, and a codec without the neighbour exchange, raise;
    a one-rank world returns None and warns about what it drops."""
    with pytest.raises(ValueError, match="unknown exchange"):
        tctx.make_solver_ctx(exchange="ring")
    with pytest.raises(ValueError, match="unknown halo compress"):
        tctx.make_solver_ctx(exchange="neighbour", compress="fp8")
    for comp in tctx.HALO_COMPRESS:
        with pytest.raises(ValueError, match="requires exchange"):
            tctx.make_solver_ctx(compress=comp)
    with pytest.warns(UserWarning,
                      match="exchange='neighbour', compress='bf16' cannot "
                            "apply"):
        assert tctx.make_solver_ctx(devices=1, exchange="neighbour",
                                    compress="bf16") is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tctx.make_solver_ctx(devices=1) is None


@pytest.mark.parametrize("n", [3, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sub_batch_operands_stay_aligned(n, dtype):
    """The interior launch reads its operands from element `cut` on: the
    slices stay contiguous and 16-byte aligned, as the line body's staged
    loads need (`ops._check_staged_alignment`), for every line variant at
    N1 = 4 and 8 in fp32 and bf16 — on the 8^3 partitions' cuts."""
    box = tmesh.box_mesh(8, 8, 8, n)
    mesh = tmesh.deform_trilinear(box, seed=3)
    cuts = {tnek._neighbour_launch_plan(tmesh.partition_elements(
        mesh, s, grid=g))[1] for s, g in ((2, None), (4, (2, 2, 1)))}
    b = tbasis(n)
    for variant in kops.LINE_VARIANTS:
        helm = variant == "merged"
        ops, _, _ = taxhelm.make_axhelm_elem_ops(
            variant, b, torch.as_tensor(mesh.verts), helmholtz=helm,
            dtype=dtype, backend="reference",
            lam0=1.0 if helm else None, lam1=0.1 if helm else None)
        x = torch.zeros((len(mesh.verts), 4) + (n + 1,) * 3, dtype=dtype)
        for cut in cuts:
            sub = {k: v[cut:] for k, v in ops.items()}
            for name, t in sub.items():
                assert t.is_contiguous(), (variant, name)
                assert t.data_ptr() % kops.STAGED_ALIGNMENT == 0, \
                    (variant, name, cut)
            kops._check_staged_alignment(variant, x[cut:],
                                         sub.get("lam0"), sub.get("lam1"))
