"""Performance contracts over what an entry point of the port runs.

The counterpart of `repro.analysis.contracts`.  A contract is a small
object with a ``check(EntryArtifacts) -> [Violation]`` method: an empty
list means the invariant holds, and every violation names what it found
(the op or collective, and the line of the port that issued it).  The
lint (`analysis.lint`) binds suites of them to the port's entry points;
the tests assert through the same objects.

The reference reads XLA's HLO and jaxprs; the port reads the records of
`analysis.record` (`EntryArtifacts.ops`: aten ops; `.collectives`:
all_reduce calls and point-to-point messages), scoped to one captured
loop body or one operator application, and `meta` (counters, the number
of operator applications recorded, the build's ptxas report).  Each
contract keeps the reference's class name, except `VmemBudget`, which
becomes `ResourceBudget`:

  * `CollectiveCensus` — counts of all_reduce and point-to-point ops an
    operator application, plus shape matchers (`interface_allreduce`);
  * `WireWidth` — the dtypes handed to `batch_isend_irecv`;
  * `AccumulationDtype` — no accumulating op with a sub-fp32 float output;
  * `NoF64Leak` — no float64 output;
  * `NoHostTransfer` — no host read of a device value (and, on the card,
    no sync in a replay of the captured chunk);
  * `ResourceBudget` — the launch `kernels.axhelm.tune` resolves fits the
    card's shared memory and, on the card, its registers without spills;
  * `NoRetrace` — a capture or build counter did not move.

A contract whose artifact is missing reports that as a violation; it
never passes silently.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

from repro_torch.analysis import record

__all__ = ["Violation", "EntryArtifacts", "Contract", "check_suite",
           "CollectiveCensus", "ShapeCount", "interface_allreduce",
           "WireWidth", "AccumulationDtype", "NoF64Leak", "NoHostTransfer",
           "ResourceBudget", "NoRetrace"]


@dataclass
class Violation:
    contract: str
    entry: str
    message: str

    def __str__(self) -> str:
        return f"[{self.contract}] {self.entry}: {self.message}"


@dataclass
class EntryArtifacts:
    """Everything a contract may inspect for one entry point.

    `ops` (`record.OpRecord`s) and `collectives` (`record.Collective`s)
    may be None — a contract that needs a missing artifact reports that as
    a violation rather than silently passing.  `meta["applications"]` is
    the number of operator applications the records cover (1 when
    absent)."""

    name: str = ""
    ops: Optional[List[Any]] = None
    collectives: Optional[List[Any]] = None
    meta: Dict[str, Any] = field(default_factory=dict)


class Contract:
    name = "contract"

    def check(self, art: EntryArtifacts) -> List[Violation]:
        raise NotImplementedError

    def _v(self, art: EntryArtifacts, message: str) -> Violation:
        return Violation(self.name, art.name, message)

    def _need(self, art: EntryArtifacts, attr: str) -> Optional[Violation]:
        if getattr(art, attr) is None:
            return self._v(art, f"missing artifact '{attr}' "
                                f"(entry did not provide it)")
        return None


def check_suite(art: EntryArtifacts,
                contracts: Iterable[Contract]) -> List[Violation]:
    out: List[Violation] = []
    for c in contracts:
        out.extend(c.check(art))
    return out


# ----------------------------------------------------- collective census ---


@dataclass
class ShapeCount:
    """Count recorded collectives of `kind` that match `pred`, an
    application.  `exact`/`max_count` bound the count; `exact=0` forbids
    the shape outright (violations then name every match)."""

    label: str
    kind: str
    pred: Callable[[Any], bool]
    exact: Optional[int] = None
    max_count: Optional[int] = None


@dataclass(frozen=True)
class _InterfaceShape:
    """The interface buffer's shape: (NS,), (NS, nrhs), or with nrhs None
    any shape whose first axis is NS; in `dtype`.  A class, not a closure,
    so that a suite travels to a spawned rank and back."""

    n_shared: int
    nrhs: Optional[int]
    dtype: str

    def __call__(self, c) -> bool:
        if c.dtype != self.dtype:
            return False
        shape = list(c.shape)
        if self.nrhs is None:
            return bool(shape) and shape[0] == self.n_shared
        if self.nrhs == 1:
            return shape == [self.n_shared]
        return shape == [self.n_shared, self.nrhs]


def interface_allreduce(n_shared: int, nrhs: Optional[int] = None,
                        dtype: str = "float32", exact: Optional[int] = None,
                        max_count: Optional[int] = None) -> ShapeCount:
    """Matcher for all_reduces of interface-sized buffers (the psum
    exchange's, `gather_scatter.exchange_shared`): fp32 (NS,) for nrhs 1,
    (NS, nrhs) for a batch, any (NS, ...) for nrhs None.  The PCG dots'
    scalar all_reduces (`pcg.owned_dot`) and `globalize`'s (Ng[, c]) are
    not interface-shaped."""
    tag = f"{dtype}[{n_shared}" + ("" if nrhs in (None, 1) else f",{nrhs}") \
        + ("]" if nrhs is not None else ",...]")
    return ShapeCount(f"interface all_reduce {tag}", "all_reduce",
                      _InterfaceShape(n_shared, nrhs, dtype), exact=exact,
                      max_count=max_count)


class CollectiveCensus(Contract):
    """Counts of the recorded collectives by kind (`record.census`:
    "all_reduce", "send", "recv", "p2p" messages, "permute" shifts of the
    neighbour exchange), and shape matchers — each a bound an operator
    application: the recorded totals are held to the bound times
    ``meta["applications"]``, the applications the records cover (8 for
    one captured chunk of 8 iterations, 1 for an operator entry)."""

    name = "collective-census"

    def __init__(self, exact: Optional[Dict[str, int]] = None,
                 max_counts: Optional[Dict[str, int]] = None,
                 min_counts: Optional[Dict[str, int]] = None,
                 matchers: Sequence[ShapeCount] = ()):
        self.exact = dict(exact or {})
        self.max_counts = dict(max_counts or {})
        self.min_counts = dict(min_counts or {})
        self.matchers = list(matchers)

    def check(self, art: EntryArtifacts) -> List[Violation]:
        miss = self._need(art, "collectives")
        if miss:
            return [miss]
        n = int(art.meta.get("applications", 1))
        per = f"an application ({n} recorded)" if n != 1 \
            else "an application"
        census = record.census(art.collectives)
        out: List[Violation] = []
        for kind, want in self.exact.items():
            got = census[kind]
            if got != want * n:
                out.append(self._v(art, f"expected exactly {want} {kind} "
                                        f"{per}, recorded {got}"))
        for kind, cap in self.max_counts.items():
            got = census[kind]
            if got > cap * n:
                out.append(self._v(art, f"expected at most {cap} {kind} "
                                        f"{per}, recorded {got}"))
        for kind, floor in self.min_counts.items():
            got = census[kind]
            if got < floor * n:
                out.append(self._v(art, f"expected at least {floor} {kind} "
                                        f"{per}, recorded {got}"))
        for m in self.matchers:
            hits = [c for c in art.collectives
                    if c.kind == m.kind and m.pred(c)]
            names = "; ".join(str(c) for c in hits[:4])
            if m.exact is not None and len(hits) != m.exact * n:
                detail = f" — offending: {names}" if hits else ""
                out.append(self._v(
                    art, f"expected exactly {m.exact} x {m.label} {per}, "
                         f"found {len(hits)}{detail}"))
            elif m.max_count is not None and len(hits) > m.max_count * n:
                out.append(self._v(
                    art, f"expected at most {m.max_count} x {m.label} "
                         f"{per}, found {len(hits)} — offending: {names}"))
        return out


# ------------------------------------------------------------ wire width ---


class WireWidth(Contract):
    """The dtypes of the tensors handed to `batch_isend_irecv` (sends and
    receives), in torch's spelling ("bfloat16", "int8").

    `require`: dtypes that MUST appear; `allowed`: if given, every observed
    dtype must be in it."""

    name = "wire-width"

    def __init__(self, require: Iterable[str] = (),
                 allowed: Optional[Iterable[str]] = None):
        self.require = set(require)
        self.allowed = None if allowed is None else set(allowed)

    def check(self, art: EntryArtifacts) -> List[Violation]:
        miss = self._need(art, "collectives")
        if miss:
            return [miss]
        got = {c.dtype for c in art.collectives
               if c.kind in ("send", "recv")}
        out: List[Violation] = []
        for dt in sorted(self.require - got):
            out.append(self._v(
                art, f"no point-to-point message ships {dt} (observed wire "
                     f"dtypes: {sorted(got) or 'none'}) — the reduced-width "
                     f"wire was lost before batch_isend_irecv"))
        if self.allowed is not None:
            for dt in sorted(got - self.allowed):
                out.append(self._v(
                    art, f"a point-to-point message ships {dt}, outside the "
                         f"allowed wire set {sorted(self.allowed)}"))
        return out


# ---------------------------------------------------- accumulation dtype ---


_LOW_FLOATS = ("bfloat16", "float16", "float8_e4m3fn", "float8_e5m2",
               "float8_e4m3fnuz", "float8_e5m2fnuz")


def _base(op: str) -> str:
    """An op's packet name without its in-place and private underscores:
    ``index_add_`` -> ``index_add``, ``_index_put_impl_`` ->
    ``index_put_impl``."""
    return op.strip("_")


class AccumulationDtype(Contract):
    """No sub-fp32 float accumulation in the recorded ops.

    Flags matrix products (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
    ``addmv``, ``mv``, ``dot``, ``vdot``), sums (``sum``, ``nansum``) and
    scatter-adds (``index_add``, ``scatter_add``, and ``index_put`` with
    ``accumulate=True``) whose accumulating output is a float narrower
    than 32 bits.  Storage in bf16 is fine; *summing* in bf16 is the bug
    class this forbids (the reference's PR 8 root fix)."""

    name = "accumulation-dtype"
    _PRODUCTS = frozenset(("mm", "bmm", "addmm", "baddbmm", "addmv", "mv",
                           "dot", "vdot"))
    _SUMS = frozenset(("sum", "nansum", "index_add", "scatter_add"))
    _ACCUMULATE = frozenset(("index_put", "index_put_impl"))

    def check(self, art: EntryArtifacts) -> List[Violation]:
        miss = self._need(art, "ops")
        if miss:
            return [miss]
        out: List[Violation] = []
        for o in art.ops:
            op = _base(o.op)
            acc = op in self._PRODUCTS or op in self._SUMS or (
                op in self._ACCUMULATE and o.flags.get("accumulate"))
            if not acc or not o.out_dtypes or \
                    o.out_dtypes[0] not in _LOW_FLOATS:
                continue
            if op in self._PRODUCTS:
                operands = " x ".join(f"{d}{list(shape)}" for d, shape in
                                      zip(o.in_dtypes, o.in_shapes))
                out.append(self._v(
                    art, f"{o.op} accumulates in {o.out_dtypes[0]} "
                         f"({operands}) at {o.where} — multiply in float32 "
                         f"and round the result once"))
            else:
                out.append(self._v(
                    art, f"{o.op} sums into {o.out_dtypes[0]}"
                         f"{list(o.out_shapes[0])} at {o.where} — promote "
                         f"to float32 for the sum and round once"))
        return out


# ------------------------------------------------------------- f64 / host --


class NoF64Leak(Contract):
    """No float64 output anywhere in the recorded ops — a double sneaking
    into the loop runs at a fraction of the card's float32 rate."""

    name = "no-f64-leak"

    def check(self, art: EntryArtifacts) -> List[Violation]:
        miss = self._need(art, "ops")
        if miss:
            return [miss]
        out = [self._v(art, f"float64 output: {o}") for o in art.ops
               if "float64" in o.out_dtypes or "complex128" in o.out_dtypes]
        return out[:4]


class NoHostTransfer(Contract):
    """No host read of a device value in the recorded ops
    (``_local_scalar_dense``, behind ``.item()``, ``bool()``, ``int()``
    and ``float()`` of a tensor; ``is_nonzero``; ``item``): each waits for
    the device.  On the card the lint also replays the captured chunk
    under ``torch.cuda.set_sync_debug_mode("error")`` and stores what a
    replay raised in ``meta["replay_error"]`` (None when it ran clean)."""

    name = "no-host-transfer"
    _OPS = frozenset(("local_scalar_dense", "is_nonzero", "item"))

    def check(self, art: EntryArtifacts) -> List[Violation]:
        miss = self._need(art, "ops")
        if miss:
            return [miss]
        out = [self._v(art, f"host read: {o}") for o in art.ops
               if _base(o.op) in self._OPS][:4]
        err = art.meta.get("replay_error")
        if err is not None:
            out.append(self._v(art, f"a replay of the captured chunk under "
                                    f"sync debug mode 'error' raised: {err}"))
        return out


# -------------------------------------------------------- resource budget --


class ResourceBudget(Contract):
    """The launch that `kernels.axhelm.tune` resolves for (variant, N1,
    dtype, Helmholtz, ncols) fits the card (`tune.launch_resources`: each
    CUDA kernel of the resolved body, its threads, dynamic shared memory
    and the blocks an SM its ``__launch_bounds__`` promises):

      * a block's shared memory <= `ops.SMEM_PER_BLOCK`;
      * the blocks an SM it promises, times (shared memory +
        `ops.SMEM_RESERVED`), <= `ops.SMEM_PER_SM` — for a body whose
        persistent grid is sized from the occupancy calculator at run time
        (the staged body), one block;
      * on the card, where the build's ptxas report is in
        ``meta["ptxas"]`` (`build.ptxas_instantiations`): registers x
        threads x promised blocks <= 65,536, and no spill.

    The counterpart of the reference's `VmemBudget`.  `body` pins a body
    instead of the resolved one; `device` is where the route is resolved
    (`tune.get_body`)."""

    name = "resource-budget"
    REGISTERS_PER_SM = 65536

    def __init__(self, variant: str, n1: int, dtype, helmholtz: bool = False,
                 ncols: int = 1, body: Optional[str] = None, device=None):
        self.variant = variant
        self.n1 = n1
        self.dtype = dtype
        self.helmholtz = helmholtz
        self.ncols = ncols
        self.body = body
        self.device = device

    def check(self, art: EntryArtifacts) -> List[Violation]:
        from repro_torch.kernels.axhelm import ops, tune

        body = self.body or tune.get_body(self.variant, self.n1, self.dtype,
                                          self.helmholtz, self.ncols,
                                          device=self.device)
        what = (f"axhelm[{self.variant}] {body} body (n1={self.n1}, "
                f"{str(self.dtype).removeprefix('torch.')}, helmholtz="
                f"{self.helmholtz}, ncols={self.ncols})")
        out: List[Violation] = []
        ptxas = art.meta.get("ptxas")
        for k in tune.launch_resources(body, self.variant, self.n1,
                                       self.dtype, self.ncols,
                                       self.helmholtz):
            if k.smem_bytes > ops.SMEM_PER_BLOCK:
                out.append(self._v(
                    art, f"{what}: {k.kernel} asks {k.smem_bytes} B of "
                         f"shared memory a block, over the "
                         f"{ops.SMEM_PER_BLOCK} B a block may use"))
            need = k.resident * (k.smem_bytes + ops.SMEM_RESERVED)
            if need > ops.SMEM_PER_SM:
                out.append(self._v(
                    art, f"{what}: {k.kernel} promises {k.resident} blocks "
                         f"an SM of {k.smem_bytes} B (+{ops.SMEM_RESERVED} "
                         f"reserved): {need} B, over the SM's "
                         f"{ops.SMEM_PER_SM} B"))
            if ptxas is None:
                continue
            hits = [c for c in ptxas if "registers" in c and
                    (c.get("variant"), c.get("body"), c.get("n1"),
                     c.get("dtype"), c.get("pass")) == k.ptxas_key]
            if not hits:
                out.append(self._v(art, f"{what}: no ptxas report for "
                                        f"{k.kernel} {k.ptxas_key}"))
                continue
            for c in hits:
                regs = c["registers"] * k.threads * k.min_blocks
                if regs > self.REGISTERS_PER_SM:
                    out.append(self._v(
                        art, f"{what}: {k.kernel} takes {c['registers']} "
                             f"registers x {k.threads} threads x "
                             f"{k.min_blocks} blocks = {regs}, over the "
                             f"SM's {self.REGISTERS_PER_SM}"))
                if c.get("spill_stores", 0) or c.get("spill_loads", 0):
                    out.append(self._v(
                        art, f"{what}: {k.kernel} spills "
                             f"{c.get('spill_stores', 0)} B stored, "
                             f"{c.get('spill_loads', 0)} B loaded"))
        return out


# -------------------------------------------------------------- no-retrace --


class NoRetrace(Contract):
    """A capture or build counter did not move: `meta['traces_before']`
    == `meta['traces_after']` — `serving.bucket_cache.BucketedSolveCache.
    traces` after the warm-up (graphs captured on a card, loops and
    operators built on the CPU), or `core.graphs.GraphCache.captures`
    after a solve's first capture."""

    name = "no-retrace"

    def check(self, art: EntryArtifacts) -> List[Violation]:
        before = art.meta.get("traces_before")
        after = art.meta.get("traces_after")
        if before is None or after is None:
            return [self._v(art, "missing meta: needs traces_before and "
                                 "traces_after")]
        if after != before:
            return [self._v(
                art, f"trace counter moved {before} -> {after}: "
                     f"{after - before} capture(s) or build(s) after the "
                     f"warm-up — a request pattern or solve missed the "
                     f"warmed loops")]
        return []

    @classmethod
    def counts(cls, before: int, after: int,
               entry: str = "") -> List[Violation]:
        """One-liner for test gates: violations iff the counter moved."""
        art = EntryArtifacts(name=entry, meta={"traces_before": before,
                                               "traces_after": after})
        return cls().check(art)
