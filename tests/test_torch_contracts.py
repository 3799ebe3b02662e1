"""Negative controls for `repro_torch.analysis.contracts`.

Every contract is run against a DELIBERATELY violated record — built from
real ops and collectives where the CPU can run them, else written out as
the reference's tests write HLO text — and must fire with a message naming
what it found; the same contract stays silent on a conforming record.  The
capstone is the crossed-suite control of the reference's
test_psum_solve_fails_neighbour_contract_on_real_hlo, on real recordings
of both exchanges on two gloo ranks: each passes its own suite, and the
psum application fails the neighbour suite on exactly the census, naming
the interface all_reduce.
"""

import numpy as np
import pytest
import torch

import _torch_sharded_ranks as ranks
from repro_torch.analysis import record
from repro_torch.analysis.contracts import (AccumulationDtype,
                                            CollectiveCensus, EntryArtifacts,
                                            NoF64Leak, NoHostTransfer,
                                            NoRetrace, ResourceBudget,
                                            WireWidth, check_suite,
                                            interface_allreduce)
from repro_torch.core import mesh_gen, nekbone
from repro_torch.core.graphs import GraphCache
from repro_torch.core.pcg import pcg
from repro_torch.distributed.launch import spawn
from repro_torch.kernels.axhelm import ops

Collective = record.Collective

# a psum-style exchange: one interface-sized all_reduce, no messages
_PSUM = [Collective("all_reduce", (169,), "float32", where="gs.py:260")]
# a neighbour-style exchange of offset 1: the +1 and the -1 shift
_NEIGHBOUR = [Collective("send", (14,), "float32", 1, 0, 0),
              Collective("recv", (14,), "float32", 1, 4, 0)]


def _art(**kw):
    return EntryArtifacts(name="test-entry", **kw)


def _neighbour_suite(ns, shifts):
    """The suite the neighbour entries run: shifts exact, ZERO interface
    all_reduces."""
    return [CollectiveCensus(exact={"permute": shifts},
                             matchers=[interface_allreduce(ns, exact=0)]),
            NoF64Leak()]


def _psum_suite(ns):
    return [CollectiveCensus(exact={"p2p": 0},
                             matchers=[interface_allreduce(ns, exact=1)]),
            NoF64Leak()]


def _ops(fn, *args):
    with record.OpRecorder() as rec:
        fn(*args)
    return rec.ops


# -------------------------------------------------- census / matchers ------


def test_census_exact_count_fires_with_counts_in_message():
    c = CollectiveCensus(exact={"permute": 2, "all_reduce": 0})
    v = c.check(_art(collectives=_PSUM, ops=[]))
    assert len(v) == 2
    msgs = "\n".join(str(x) for x in v)
    assert "expected exactly 2 permute an application, recorded 0" in msgs
    assert "expected exactly 0 all_reduce an application, recorded 1" \
        in msgs
    assert c.check(_art(collectives=_NEIGHBOUR)) == []


def test_census_counts_per_application():
    """Records over a captured chunk hold 8 applications: the bound is an
    application's, times 8."""
    chunk = _PSUM * 8
    c = CollectiveCensus(matchers=[interface_allreduce(169, exact=1)])
    assert c.check(_art(collectives=chunk, meta={"applications": 8})) == []
    v = c.check(_art(collectives=chunk + _PSUM, meta={"applications": 8}))
    assert len(v) == 1 and "(8 recorded), found 9" in v[0].message


def test_interface_matcher_names_an_extra_allreduce():
    """An extra interface all_reduce: the violation names it and the line
    of the port that issued it."""
    c = CollectiveCensus(matchers=[interface_allreduce(169, exact=1)])
    v = c.check(_art(collectives=_PSUM * 2))
    assert len(v) == 1
    assert "expected exactly 1 x interface all_reduce float32[169,...]" \
        in v[0].message
    assert "found 2" in v[0].message and "gs.py:260" in v[0].message


def test_interface_matcher_nrhs_discriminates():
    m1 = interface_allreduce(169, nrhs=1, exact=1)
    m4 = interface_allreduce(169, nrhs=4, exact=1)
    assert CollectiveCensus(matchers=[m1]).check(
        _art(collectives=_PSUM)) == []
    v = CollectiveCensus(matchers=[m4]).check(_art(collectives=_PSUM))
    assert len(v) == 1 and "found 0" in v[0].message
    batch = [Collective("all_reduce", (169, 4), "float32")]
    assert CollectiveCensus(matchers=[m4]).check(
        _art(collectives=batch)) == []
    # a bf16 buffer of the interface's size is not the fp32 exchange
    assert CollectiveCensus(matchers=[m1]).check(_art(collectives=[
        Collective("all_reduce", (169,), "bfloat16")]))


def test_min_counts_fires_when_wire_disappears():
    c = CollectiveCensus(min_counts={"p2p": 1})
    v = c.check(_art(collectives=_PSUM))
    assert len(v) == 1 and "at least 1 p2p" in v[0].message
    assert c.check(_art(collectives=_NEIGHBOUR)) == []


def test_census_reads_the_shift_of_each_tag():
    """An int8 wire sends codes and scales as two messages of one shift:
    two messages, one permute."""
    codec = [Collective("send", (14,), "int8", 1, 0, 0),
             Collective("send", (14,), "float32", 1, 1, 0)]
    assert record.census(codec)["p2p"] == 2
    assert record.census(codec)["permute"] == 1
    # the same shift in the next application's batch is another permute
    again = [Collective(c.kind, c.shape, c.dtype, c.peer, c.tag, 1)
             for c in codec]
    assert record.census(codec + again)["permute"] == 2


# ------------------------------------------------------------ wire width ---


def test_wire_width_fires_when_reduced_wire_lost():
    c = WireWidth(require={"int8"})
    v = c.check(_art(collectives=_NEIGHBOUR))
    assert len(v) == 1 and v[0].contract == "wire-width"
    assert "no point-to-point message ships int8" in v[0].message
    assert "float32" in v[0].message          # observed dtypes listed
    codec = [Collective("send", (14,), "int8", 1, 0, 0),
             Collective("recv", (14,), "float32", 1, 1, 0)]
    assert c.check(_art(collectives=codec)) == []


def test_wire_width_allowed_set_fires_on_full_width():
    v = WireWidth(allowed={"bfloat16"}).check(_art(collectives=_NEIGHBOUR))
    assert len(v) == 1 and "ships float32" in v[0].message


# ---------------------------------------------------- accumulation dtype ---


def test_accumulation_dtype_fires_on_bf16_mm_and_sum():
    a = torch.ones((4, 4), dtype=torch.bfloat16)
    v = AccumulationDtype().check(_art(ops=_ops(torch.mm, a, a)))
    assert len(v) == 1
    assert "mm accumulates in bfloat16" in v[0].message
    assert "test_torch_contracts.py" in v[0].message
    v = AccumulationDtype().check(_art(ops=_ops(torch.sum, a)))
    assert len(v) == 1 and "sum sums into bfloat16" in v[0].message
    # a float16 batched product too
    h = torch.ones((2, 4, 4), dtype=torch.float16)
    assert AccumulationDtype().check(_art(ops=_ops(torch.bmm, h, h)))


def test_accumulation_dtype_fires_on_bf16_scatter_adds():
    y = torch.zeros(5, dtype=torch.bfloat16)
    ids = torch.tensor([0, 1, 1, 4])
    src = torch.ones(4, dtype=torch.bfloat16)
    v = AccumulationDtype().check(_art(ops=_ops(
        lambda: y.index_add_(0, ids, src))))
    assert len(v) == 1 and "index_add_" in v[0].message
    v = AccumulationDtype().check(_art(ops=_ops(
        lambda: y.index_put_((ids,), src, accumulate=True))))
    assert len(v) == 1 and "index_put_" in v[0].message
    # a plain write is no accumulation
    assert AccumulationDtype().check(_art(ops=_ops(
        lambda: y.index_put_((ids,), src, accumulate=False)))) == []


def test_accumulation_dtype_passes_the_ports_bf16_plain_operator():
    """The port's bf16 operator (the kernels' plain version: widened to
    fp32, rounded once) and an explicitly fp32-accumulated product stay
    silent."""
    mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(2, 2, 1, 3), seed=3)
    prob = nekbone.setup_problem(mesh, variant="trilinear",
                                 dtype=torch.bfloat16, backend="reference",
                                 device="cpu")
    x = torch.ones(mesh.n_global, dtype=torch.bfloat16)
    prob.op(x)
    recorded = _ops(prob.op, x)
    assert any(o.op == "bmm" for o in recorded)
    assert AccumulationDtype().check(_art(ops=recorded)) == []
    a = torch.ones((4, 4), dtype=torch.bfloat16)
    assert AccumulationDtype().check(_art(ops=_ops(
        lambda: torch.mm(a.float(), a.float()).bfloat16()))) == []


# -------------------------------------------------------------- f64 / host -


def test_no_f64_leak_fires_on_a_float64_op():
    x = torch.ones(8)
    v = NoF64Leak().check(_art(ops=_ops(lambda: x.double() + 1)))
    assert v and "float64 output: aten._to_copy.default -> float64[8]" \
        in v[0].message
    assert NoF64Leak().check(_art(ops=_ops(lambda: x * 2))) == []


def test_no_host_transfer_fires_on_item_in_the_scoped_loop_body():
    """An operator that reads a device value on the host inside the loop
    body: the recorded chunk names the read and the line that made it."""
    n = 16
    diag = torch.linspace(1.0, 2.0, n)

    def a_op(x):
        float(x.abs().max())              # the host read under test
        return diag * x

    def clean(x):
        return diag * x

    for op, fires in ((a_op, True), (clean, False)):
        graphs = GraphCache()
        pcg(op, torch.ones(n), tol=1e-6, graphs=graphs)
        ops_, _, apps = record.record_chunks(graphs)
        assert apps == 8
        v = NoHostTransfer().check(_art(ops=ops_))
        assert bool(v) == fires
        if fires:
            assert "host read: aten._local_scalar_dense.default" \
                in v[0].message
            assert "test_torch_contracts.py" in v[0].message
    v = NoHostTransfer().check(_art(ops=[], meta={
        "replay_error": "RuntimeError: called a synchronizing op"}))
    assert len(v) == 1 and "sync debug mode" in v[0].message


# -------------------------------------------------------- resource budget --


def test_resource_budget_fires_on_shared_memory_over_the_block():
    """The generic body cannot hold an N1 = 40 element in a block's shared
    memory; the message gives the bytes and the card's limit."""
    v = ResourceBudget("trilinear", 40, torch.float32, body="any").check(
        _art())
    assert len(v) == 2        # over the block, and so over the SM
    need = ops.generic_smem_bytes(40)
    assert f"asks {need} B of shared memory a block" in v[0].message
    assert f"{ops.SMEM_PER_BLOCK} B a block may use" in v[0].message
    assert "promises 1 blocks an SM" in v[1].message
    assert ResourceBudget("trilinear", 8, torch.float32,
                          device="cpu").check(_art()) == []


def test_resource_budget_fires_on_promised_blocks_over_the_sm():
    """The slab body holds the factors for several columns: at N1 = 24 and
    four columns two promised blocks no longer fit an SM."""
    v = ResourceBudget("trilinear", 24, torch.float32, ncols=4,
                       device="cpu").check(_art())
    assert len(v) == 1 and "promises 2 blocks an SM" in v[0].message
    assert ResourceBudget("trilinear", 24, torch.float32,
                          device="cpu").check(_art()) == []


def test_resource_budget_reads_registers_and_spills_on_the_card():
    """With the build's ptxas report in meta (on the card): registers x
    threads x promised blocks over the SM's 65,536, and any spill, fire; a
    missing instantiation is reported, not passed."""
    key = dict(variant="trilinear", body="column", n1=8, dtype="f32")
    threads = ops.column_threads(8)
    fits = 65536 // (threads * ops.column_min_blocks(8))
    ok = [{**key, "registers": fits, "smem_bytes": 0}]
    art = _art(meta={"ptxas": ok})
    assert ResourceBudget("trilinear", 8, torch.float32,
                          device="cpu").check(art) == []
    over = [{**key, "registers": fits + 1, "spill_stores": 8}]
    v = ResourceBudget("trilinear", 8, torch.float32, device="cpu").check(
        _art(meta={"ptxas": over}))
    assert len(v) == 2
    assert "over the SM's 65536" in v[0].message
    assert "spills 8 B stored" in v[1].message
    v = ResourceBudget("trilinear", 8, torch.float32, device="cpu").check(
        _art(meta={"ptxas": []}))
    assert len(v) == 1 and "no ptxas report" in v[0].message


# -------------------------------------------------------------- no-retrace -


def test_no_retrace_fires_when_a_capture_counter_moved():
    assert NoRetrace.counts(5, 5, "warm") == []
    v = NoRetrace.counts(5, 7, "cold")
    assert len(v) == 1
    assert "5 -> 7" in v[0].message and "2 capture(s)" in v[0].message
    assert v[0].entry == "cold"
    # a real counter: a block solver builds a loop at a width it has not
    # seen, and replays (on the CPU: reuses) it after
    mesh = mesh_gen.box_mesh(2, 2, 1, 3)
    prob = nekbone.setup_problem(mesh, variant="trilinear", device="cpu")
    solve_block = nekbone.make_block_solver(prob, tol=1e-6)
    b = torch.ones((mesh.n_global, 2))
    solve_block(b, torch.zeros_like(b))
    warm = prob.graphs.builds
    solve_block(b, torch.zeros_like(b))
    assert NoRetrace.counts(warm, prob.graphs.builds) == []
    b3 = torch.ones((mesh.n_global, 3))
    solve_block(b3, torch.zeros_like(b3))
    assert NoRetrace.counts(warm, prob.graphs.builds)


# ------------------------------------------------------- missing artifacts -


def test_missing_artifact_is_a_violation_not_a_pass():
    for c in (CollectiveCensus(exact={"all_reduce": 0}),
              WireWidth(require={"int8"}), AccumulationDtype(),
              NoF64Leak(), NoHostTransfer(), NoRetrace()):
        v = c.check(_art())
        assert len(v) == 1, c.name
        assert "missing" in v[0].message, c.name


# ------------------------------------- crossed suites on real recordings --


@pytest.fixture(scope="module")
def recorded():
    """Two gloo ranks, each recording one application of the psum, the
    neighbour and the int8 neighbour exchange (`ranks.contract_rows`)."""
    per_rank = spawn(ranks.cases, 2, (None, ("contracts",)), timeout_s=300)
    return [{(r["exchange"], r["compress"]): r for r in rows["contracts"]}
            for rows in per_rank]


def _arts(rows):
    return {k: EntryArtifacts(f"{k[0]}@rank{r['rank']}", ops=r["ops"],
                              collectives=r["events"])
            for k, r in rows.items()}


def test_psum_application_fails_the_neighbour_suite_on_the_census(
        recorded):
    """Each exchange passes its own suite; crossed, exactly the census
    fires — the psum application's message names the interface all_reduce,
    the neighbour application's the shifts the psum suite forbids."""
    for rows in recorded:
        r = rows[("psum", None)]
        ns, offsets = r["n_shared"], r["offsets"]
        assert offsets == [1]
        arts = _arts(rows)
        psum, nbr = arts[("psum", None)], arts[("neighbour", None)]
        assert check_suite(psum, _psum_suite(ns)) == []
        assert check_suite(nbr, _neighbour_suite(ns, 2)) == []
        crossed = check_suite(psum, _neighbour_suite(ns, 2))
        assert {v.contract for v in crossed} == {"collective-census"}
        msgs = "\n".join(v.message for v in crossed)
        assert "interface all_reduce float32" in msgs
        assert "all_reduce float32[%d] at repro_torch/core/" \
            "gather_scatter.py" % ns in msgs
        crossed = check_suite(nbr, _psum_suite(ns))
        assert {v.contract for v in crossed} == {"collective-census"}
        assert "p2p" in "\n".join(v.message for v in crossed)


def test_int8_wire_lost_fires_wire_width(recorded):
    """The neighbour application without its codec (compress=None) fails
    WireWidth(require int8); with it, it passes, and the int8 wire sends
    codes and scales as two messages of each shift."""
    for rows in recorded:
        arts = _arts(rows)
        v = WireWidth(require={"int8"}).check(arts[("neighbour", None)])
        assert len(v) == 1 and "observed wire dtypes: ['float32']" \
            in v[0].message
        assert WireWidth(require={"int8"}).check(
            arts[("neighbour", "int8")]) == []
        census = record.census(rows[("neighbour", "int8")]["events"])
        plain = record.census(rows[("neighbour", None)]["events"])
        assert census["permute"] == plain["permute"] == 2
        assert census["p2p"] == 2 * plain["p2p"]
        assert np.all([NoF64Leak().check(a) == [] for a in arts.values()])
