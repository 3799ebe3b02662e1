"""The line body of the K1 (precomputed), K3 (parallelepiped) and K4
(merged) axhelm kernels, `csrc/axhelm_line.cu`, on the CPU: what of it is
not CUDA.

* Its phases, written here in the kernel's order on its padded shared
  layout (the r and s lines and the node columns of an element, the
  factors applied by the column owner, the transposes on the lines, the
  three sums), against the reference package's jnp oracle: float64,
  <= 1e-12 relative (the same formulas in another order), K1 and K3
  Poisson and Helmholtz with per-node lambdas (K1's factors read from its
  planar (E, 7, N1^3) operand, plane p of node n at p N1^3 + n) and K4,
  N in {3, 7}.
* That the roles cover every line and column of an element once, and that
  the layout is free of bank conflicts at N1 = 8, as the source note counts.
* The wrapper's persistent launch arithmetic (every element exactly once
  over the blocks' walk), the by-value D-hat and xi and the storage-rounded
  w3 on the device, the arguments `ops` passes to each new entry point,
  its refusal of a misaligned staged operand, and `chip_smoke.py`'s
  knowledge of the body.

The kernels themselves run on the card only: tests/test_torch_cuda.py.
"""

import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import axhelm as jax_axhelm
from repro.core import geometry as jgeom
from repro.core import mesh_gen as jmesh
from repro.core.spectral import basis as jbasis
from repro.kernels.axhelm import ops as jops
from repro.kernels.axhelm import ref as jref
from repro_torch.core.spectral import basis as tbasis
from repro_torch.kernels.axhelm import build, ops

from test_torch_axhelm_column import _meta, column_geometry, fake_card  # noqa: F401,E501

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))
import chip_smoke  # noqa: E402
import line_staging_sweep  # noqa: E402
from _torch_x64 import x64  # noqa: F401

RTOL64 = 1e-12


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def slab_stride(n1, itemsize):
    """The kernel's slab_stride: values of a k-slab in shared memory."""
    return n1 * n1 + 16 // itemsize


def roles(n1):
    """Per thread t of an element: its node column (i, j), its r line
    (j', k') and its s line (i', k''), as the kernel assigns them."""
    out = []
    for t in range(n1 * n1):
        q = t // n1
        out.append({"col": (t % n1, t // n1), "r": (t // n1, t % n1),
                    "s": (t % n1, (2 * q) % n1 + (2 * q) // n1)})
    return out


def sr_index(n1, sp, k, j, i):
    """Where s_r (and s_s) hold node (i, j, k)."""
    return k * sp + j * n1 + i


def line_body(x, dhat, xi, w3, variant, geom, lam0, lam1, helmholtz):
    """The kernel's phases in float64: x (E, C, N1^3) -> y, one element
    column at a time, through the padded slabs of s_x, s_r and s_s."""
    e_count, ncols = x.shape[:2]
    n1 = len(xi)
    nc, m = n1 * n1, np.arange(n1)
    sx = sp = slab_stride(n1, 4)
    if variant == "merged":                               # (E, k, j, i, 6)
        _, adj, _, _, _ = column_geometry(geom, xi, w3.reshape((n1,) * 3))
    y = np.empty_like(x)
    for e in range(e_count):
        for c in range(ncols):
            xs = np.zeros(n1 * sx)
            for t in range(nc):          # the Stager: N1 values a thread
                k, at = t * n1 // nc, t * n1 % nc
                xs[k * sx + at:k * sx + at + n1] = x[e, c, t * n1:(t + 1) * n1]
            pr, ps = np.zeros(n1 * sp), np.zeros(n1 * sp)
            xt, yv = {}, {}
            for t, role in enumerate(roles(n1)):          # (A)
                rj, rk = role["r"]
                row = sr_index(n1, sp, rk, rj, m)
                pr[row] = dhat @ xs[rk * sx + rj * n1 + m]
                si, sk = role["s"]
                ps[sk * sp + m * n1 + si] = dhat @ xs[sk * sx + m * n1 + si]
                xt[t] = dhat @ xs[m * sx + t]
            for t, role in enumerate(roles(n1)):          # (B)
                i, j = role["col"]
                yv[t] = np.zeros(n1)
                for k in range(n1):
                    o, node = k * sp + t, k * nc + t
                    orr = sr_index(n1, sp, k, j, i)
                    gr, gs, gt = pr[orr], ps[o], xt[t][k]
                    if variant == "merged":
                        g = adj[e, k, j, i]
                        scale, mass = lam0[e, node], lam1[e, node]
                    elif variant == "precomputed":     # planar (E, 7, N1^3)
                        g = geom[e, :6, node]
                        scale = 1 if lam0 is None else lam0[e, node]
                        mass = geom[e, 6, node] * (
                            1 if lam1 is None else lam1[e, node])
                    else:
                        g = geom[e, :6]
                        scale = w3[node] * (1 if lam0 is None
                                            else lam0[e, node])
                        mass = geom[e, 6] * w3[node] * (
                            1 if lam1 is None else lam1[e, node])
                    gr, gs, gt = gr * scale, gs * scale, gt * scale
                    pr[orr] = g[0] * gr + g[1] * gs + g[2] * gt
                    ps[o] = g[1] * gr + g[3] * gs + g[4] * gt
                    yv[t] += dhat[k] * (g[2] * gr + g[4] * gs + g[5] * gt)
                    if helmholtz:
                        yv[t][k] += mass * xs[k * sx + t]
            for t, role in enumerate(roles(n1)):          # (C)
                rj, rk = role["r"]
                row = sr_index(n1, sp, rk, rj, m)
                pr[row] = dhat.T @ pr[row]
                si, sk = role["s"]
                col = sk * sp + m * n1 + si
                ps[col] = dhat.T @ ps[col]
            for t, role in enumerate(roles(n1)):          # (D)
                k = np.arange(n1)
                y[e, c, k * nc + t] = yv[t] + ps[k * sp + t] + pr[
                    sr_index(n1, sp, k, role["col"][1], role["col"][0])]
    return y


LINE_CASES = [("parallelepiped", False), ("parallelepiped", True),
              ("merged", True), ("precomputed", False), ("precomputed", True)]


@pytest.mark.parametrize("n", [3, 7])
@pytest.mark.parametrize("variant,helm", LINE_CASES)
def test_line_phases_match_reference(x64, variant, helm, n):
    """K1 and K3 with per-node lam0 (and lam1) fields, K4 with the
    reference's Lam2/Lam3 of random lambdas; two columns an element.  K1's
    factors are the reference's discrete ones, laid out in planes for the
    model and packed for the reference."""
    rng = np.random.default_rng(10 * n + helm)
    b = jbasis(n)
    n1 = b.n1
    box = jmesh.box_mesh(2, 1, 2, n)
    ref_geom = None
    if variant == "parallelepiped":
        verts = np.asarray(jmesh.deform_affine(box, seed=2).verts)
        geom = np.asarray(jref.gelem_from_verts(jnp.asarray(verts)))
    elif variant == "precomputed":
        verts = jnp.asarray(jmesh.deform_trilinear(box, seed=3).verts)
        f = jgeom.factors_discrete(jgeom.node_coords(verts, b), b)
        ref_geom = np.concatenate([np.asarray(f.g),
                                   np.asarray(f.gwj)[..., None]], axis=-1)
        geom = np.moveaxis(ref_geom, -1, 1).reshape(len(verts), 7, -1)
    else:
        geom = np.asarray(jmesh.deform_trilinear(box, seed=3).verts)
    e = len(geom)
    x = rng.standard_normal((e, 2, n1 ** 3))
    lam0 = 1 + 0.3 * rng.random((e, n1 ** 3))
    lam1 = 0.5 + 0.2 * rng.random((e, n1 ** 3)) if helm else None
    if variant == "merged":
        node = (e, n1, n1, n1)
        lam2, lam3 = jax_axhelm.setup_merged_lambdas(
            jnp.asarray(geom), b, jnp.asarray(lam0.reshape(node)),
            jnp.asarray(lam1.reshape(node)))
        lam0 = np.asarray(lam2).reshape(e, -1)
        lam1 = np.asarray(lam3).reshape(e, -1)
    ours = line_body(x, np.asarray(b.dhat), np.asarray(b.points),
                     np.asarray(b.w3).reshape(-1), variant, geom, lam0, lam1,
                     helm)
    shape = (e, 2) + (n1,) * 3
    kw = {"lam0": jnp.asarray(lam0.reshape((e,) + (n1,) * 3))}
    if lam1 is not None:
        kw["lam1"] = jnp.asarray(lam1.reshape((e,) + (n1,) * 3))
    ref = jops.reference(jnp.asarray(x.reshape(shape)), b, variant,
                         jnp.asarray(geom if ref_geom is None else ref_geom),
                         helmholtz=helm, **kw)
    assert _rel(ours.reshape(shape), ref) <= RTOL64


@pytest.mark.parametrize("n1", ops.KERNEL_N1)
def test_roles_cover_every_line_and_column_once(n1):
    rs = roles(n1)
    full = sorted((a, b) for a in range(n1) for b in range(n1))
    for role in ("col", "r", "s"):
        assert sorted(r[role] for r in rs) == full


def _wavefronts(addresses, width):
    """Shared-memory wavefronts of one warp instruction: `addresses` the
    lanes' byte addresses, `width` bytes a lane.  A 16-byte access runs in
    phases of 8 lanes, an 8-byte one of 16, narrower ones in one; a phase
    takes as many wavefronts as the most distinct 4-byte words in one of
    the 32 banks."""
    lanes = {16: 8, 8: 16}.get(width, 32)
    total = 0
    for p in range(0, len(addresses), lanes):
        banks = {}
        for a in addresses[p:p + lanes]:
            for w in range(a // 4, (a + max(width, 4) - 1) // 4 + 1):
                banks.setdefault(w % 32, set()).add(w)
        total += max(len(words) for words in banks.values())
    return total


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("access", ["column", "s_line", "stager"])
def test_staged_x_layout_is_free_of_bank_conflicts(access, itemsize):
    """At N1 = 8 each warp instruction on the staged x takes the fewest
    wavefronts its bytes allow -- the owner's column reads at fixed k, the
    s lines' reads at fixed m (and s_s, fp32 with the same stride, as the
    f32 case) -- but the Stager's 16-byte stores (thread t's N1 values at
    offset t N1 % N1^2 of slab t N1 / N1^2), which conflict two ways in
    fp32, as the source note counts."""
    n1 = 8
    sx = slab_stride(n1, itemsize)
    for warp in (0, 1):
        threads = range(32 * warp, 32 * warp + 32)
        lanes = [roles(n1)[t] for t in threads]
        if access == "stager":
            for q in range(n1 * itemsize // 16):
                addr = [((t * n1 // 64) * sx + t * n1 % 64) * itemsize
                        + 16 * q for t in threads]
                assert _wavefronts(addr, 16) == {4: 8, 2: 4}[itemsize]
        elif access == "column":
            for k in range(n1):
                addr = [(k * sx + r["col"][0] + n1 * r["col"][1]) * itemsize
                        for r in lanes]
                assert _wavefronts(addr, itemsize) == 1
        else:
            for m in range(n1):
                addr = [(r["s"][1] * sx + m * n1 + r["s"][0]) * itemsize
                        for r in lanes]
                assert _wavefronts(addr, itemsize) == 1


@pytest.mark.parametrize("access", ["r_line", "column"])
def test_r_components_layout_is_free_of_bank_conflicts(access):
    """s_r (fp32) at N1 = 8: the r lines' 16-byte row accesses, the eight
    lanes of a vector phase k' = 0..7 at fixed j', start 17 k' + 2 j'
    16-byte words apart; the owner reads 32 consecutive words at fixed
    k."""
    n1 = 8
    sp = slab_stride(n1, 4)
    for warp in (0, 1):
        lanes = [roles(n1)[t] for t in range(32 * warp, 32 * warp + 32)]
        if access == "r_line":
            for q in range(2):
                addr = [4 * sr_index(n1, sp, r["r"][1], r["r"][0], 4 * q)
                        for r in lanes]
                assert _wavefronts(addr, 16) == 4
        else:
            for k in range(n1):
                addr = [4 * sr_index(n1, sp, k, r["col"][1], r["col"][0])
                        for r in lanes]
                assert _wavefronts(addr, 4) == 1


@pytest.mark.parametrize("n_sm", [1, 2, 132])
@pytest.mark.parametrize("n_elem", [1, 2, 3, 37, 4096, 4099])
@pytest.mark.parametrize("n1", ops.KERNEL_N1)
def test_line_launch_covers_every_element_once(n1, n_elem, n_sm):
    """The kernel's walk: block b takes groups b, b + grid, ...; group g
    holds elements g * per_block + l, the absent ones of the last group
    masked."""
    per_block, grid = ops.line_launch(n1, n_elem, n_sm)
    groups = -(-n_elem // per_block)
    assert per_block * n1 * n1 == ops.LINE_THREADS
    assert 1 <= grid <= min(groups, n_sm * ops.LINE_BLOCKS_PER_SM)
    seen = []
    for block in range(grid):
        for g in range(block, groups, grid):
            seen += [g * per_block + le for le in range(per_block)
                     if g * per_block + le < n_elem]
    assert sorted(seen) == list(range(n_elem))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [3, 7])
def test_parallelepiped_takes_dhat_xi_by_value_and_w3_on_the_device(
        fake_card, n, dtype):
    """K3's launch: the column body's by-value D-hat and xi, and the w3
    array the plain version computes with, on x's device."""
    b = tbasis(n)
    n1 = b.n1
    x = torch.zeros((3, 1, 1) + (n1,) * 3, dtype=dtype)
    ops._launch(x, b, "parallelepiped", torch.zeros((3, 7), dtype=dtype),
                None, None, False)
    (name, args), = fake_card.calls
    dhat, xi, w3 = ops._constants(n, dtype, torch.device("cpu"))
    assert name == ops.entry_point("parallelepiped", dtype)
    assert args[5] == w3.data_ptr()
    assert args[6] == ops._column_consts(n, dtype).data_ptr()
    assert w3.dtype == torch.float32 and w3.is_contiguous()
    assert w3.shape == (n1, n1, n1)


def test_bf16_w3_holds_the_rounded_products():
    """At bf16 storage w3 is the bf16 rounding of the products w_i w_j w_k,
    as the plain version holds it -- not the fp32 products."""
    b = tbasis(7)
    _, _, w3 = ops._constants(7, torch.bfloat16, torch.device("cpu"))
    assert torch.equal(w3, w3.bfloat16().float())
    exact = torch.as_tensor(np.asarray(b.w3))
    assert torch.equal(w3, exact.bfloat16().float())
    assert not torch.equal(w3, exact.float())


def _line_call(variant, dtype, x):
    e = x.shape[0]
    geom = _meta((e, 7) if variant == "parallelepiped" else (e, 8, 3), dtype)
    kw = {}
    if variant == "merged":
        kw = {name: _meta((e, 8, 8, 8), dtype) for name in ("lam0", "lam1")}
    return geom, kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ops.LINE_VARIANTS)
def test_wrapper_passes_line_entry_points_their_arguments(fake_card, variant,
                                                          dtype):
    b = tbasis(7)
    e, helm = 37, variant == "merged"
    x = _meta((e, 2, 3, 8, 8, 8), dtype)
    geom, kw = _line_call(variant, dtype, x)
    before = dict(ops.launch_counts)
    ops.axhelm(x, b, variant, geom, helmholtz=helm, **kw)
    (name, args), = fake_card.calls
    assert name == ops.entry_point(variant, dtype) == build.symbol(
        variant, ops.KERNEL_DTYPES[dtype])
    assert len(args) == len(build.SIGNATURES[variant])
    assert ops.launch_counts[name] == before[name] + 1
    assert args[-1] == 7                                   # the stream
    assert args[-3:-1] == ops.line_launch(8, e, 132)
    # parallelepiped passes w3 before the constants, helmholtz after the
    # sizes
    at = 6 if variant == "parallelepiped" else 5
    assert args[at] == ops._column_consts(7, dtype).data_ptr()
    assert args[at + 1:at + 4] == (8, e, 6)
    if variant == "parallelepiped":
        assert args[at + 4] == 0                           # helmholtz


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ops.LINE_VARIANTS)
def test_misaligned_staged_operand_raises(fake_card, variant, dtype):
    """A contiguous x one value into its storage is not 16-byte aligned:
    the wrapper raises before any launch, and counts none."""
    b = tbasis(7)
    x = _meta((5 * 512 + 1,), dtype)[1:].view(5, 8, 8, 8)
    assert x.is_contiguous() and x.data_ptr() % 16
    geom, kw = _line_call(variant, dtype, x)
    before = dict(ops.launch_counts)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        ops.axhelm(x, b, variant, geom, helmholtz=variant == "merged", **kw)
    assert fake_card.calls == [] and ops.launch_counts == before


@pytest.mark.parametrize("slot", ["lam0", "lam1"])
def test_misaligned_merged_lambda_raises(fake_card, slot):
    b = tbasis(7)
    x = _meta((5, 8, 8, 8))
    geom, kw = _line_call("merged", torch.float32, x)
    kw[slot] = _meta((5 * 512 + 1,))[1:].view(5, 8, 8, 8)
    with pytest.raises(ValueError, match=f"stages {slot}"):
        ops.axhelm(x, b, "merged", geom, helmholtz=True, **kw)
    assert fake_card.calls == []


def test_rowwise_of_line_variants_skips_the_alignment_check(fake_card):
    """The timing-only node body reads x with plain loads."""
    x = _meta((5 * 512 + 1,))[1:].view(5, 8, 8, 8)
    ops.rowwise(x, tbasis(7), "parallelepiped", _meta((5, 7)))
    (name, _), = fake_card.calls
    assert name == "axhelm_parallelepiped_f32_rowwise"


_LINE_REPORT = """\
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__2b1c9d31_14_axhelm_line_cu_5e0a51b118axhelm_line_kernelILi8ELN13axhelm_detail10GeomSourceE3E13__nv_bfloat16EEvPKT1_PS4_S6_S6_S6_NS_10LineConstsIXT_EEEiii' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__2b1c9d31_14_axhelm_line_cu_5e0a51b118axhelm_line_kernelILi8ELN13axhelm_detail10GeomSourceE3E13__nv_bfloat16EEvPKT1_PS4_S6_S6_S6_NS_10LineConstsIXT_EEEiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, used 1 barriers, 21248 bytes smem, 2736 bytes cmem[0]
"""


def test_ptxas_report_names_the_line_body():
    (line,) = chip_smoke.ptxas_instantiations(_LINE_REPORT)
    assert line == {"variant": "merged", "body": "line", "n1": 8,
                    "dtype": "bf16", "spill_stores": 0, "spill_loads": 0,
                    "registers": 90, "smem_bytes": 21248}


def test_chip_smoke_names_the_line_source():
    assert {v for v, body in chip_smoke.BODY.items() if body == "line"} \
        == set(ops.LINE_VARIANTS)
    assert chip_smoke.SOURCE["line"].endswith("csrc/axhelm_line.cu")
    assert (chip_smoke.ROOT / chip_smoke.SOURCE["line"]).is_file()
    assert set(ops.ROWWISE_VARIANTS) == set(ops.COLUMN_VARIANTS) | set(
        ops.LINE_VARIANTS)


def test_sweep_finds_the_shipped_stager():
    """scripts/line_staging_sweep.py swaps the Stager of the shipped source
    (vector loads) for its bulk-copy one: exactly one matches, and the swap
    leaves the rest of the source as it was."""
    text = (ROOT / chip_smoke.SOURCE["line"]).read_text()
    found = line_staging_sweep._STAGER.findall(text)
    assert len(found) == 1 and "bulk_copy" not in found[0]
    swapped = line_staging_sweep._STAGER.sub(
        lambda _: line_staging_sweep.BULK_STAGER, text, count=1)
    assert swapped.replace(line_staging_sweep.BULK_STAGER, found[0]) == text
    assert "cp.async.bulk" in swapped and "\\n.reg" in swapped
    for name in ("kLineThreads = ", "kLineMinBlocks = ", "kStages = "):
        assert text.count(name) == 1


def test_launch_constants_follow_the_source():
    """The wrapper's launch arithmetic mirrors the line body's constants:
    threads a block and blocks an SM (the sweep changes both sides)."""
    text = (ROOT / chip_smoke.SOURCE["line"]).read_text()

    def const(name):
        return re.search(rf"{name} = (\w+);", text).group(1)
    assert int(const("kLineThreads")) == ops.LINE_THREADS
    assert int(const("kLineMinBlocks")) == ops.LINE_BLOCKS_PER_SM


@pytest.mark.parametrize("stager", ["loads", "bulk"])
def test_sweep_patches_in_bulk_copied_factors(stager):
    """The sweep's K1 bulk-factor option, which the shipped source does not
    hold: every anchor of `with_bulk_factors` is in the line body once (with
    either stager), its one set of mbarrier primitives lands before the
    kernel, and the owners read the staged buffer in place of device
    memory."""
    text = (ROOT / chip_smoke.SOURCE["line"]).read_text()
    assert "mbar_init" not in text and "bulk_copy(" not in text
    if stager == "bulk":
        text = line_staging_sweep._STAGER.sub(
            lambda _: line_staging_sweep.BULK_STAGER, text, count=1)
    patched = line_staging_sweep.with_bulk_factors(text)
    assert patched.count("void mbar_init(") == 1
    assert patched.count("void fetch_factors(") == 1
    assert patched.index("void bulk_copy(") < \
        patched.index("void fetch_factors(") < \
        patched.index("__global__ void")
    assert "fp = geom + ev * 7 * NP + t;" not in patched
    assert "fp = sm.f[fbuf][le] + t;" in patched
    assert "(SRC == kPrecomputed && misaligned(geom))" in patched
    with pytest.raises(ValueError, match="anchor"):
        line_staging_sweep.with_bulk_factors(patched)
