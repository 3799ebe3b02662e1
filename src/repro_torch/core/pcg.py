"""Preconditioned conjugate gradients (Nekbone's PCG, Figure 2).

The operator is supplied as a closure `A(x)` over global dofs (gather o
axhelm o scatter), or as `A(x, it)` when it advertises
``takes_iteration = True``: it then receives the loop's iteration counter,
a tensor on the device (-1 for the initial residual), which is how the
fault harness of `resilience.inject` strikes one chosen iteration.
Preconditioners: none and Jacobi (inverse diagonal).  `pcg_block` solves
nrhs stacked right-hand sides (trailing axis) with per-column alpha/beta
and a freeze mask; `refine` is the mixed-precision solve: fp32 outer
residual and correction around reduced-precision inner `pcg`/`pcg_block`
sweeps.  `owned_dot` is the inner product of an element-sharded field: each
rank sums the dofs it owns and one `all_reduce` adds the ranks' partials.

The reference runs each loop as one `jax.lax.while_loop`, compiled once.
The port keeps a loop's state on the device in fixed tensors — the
iterates, the carried scalars, and the loop's inputs, the squared
tolerance and the iteration budget — and runs the loop in chunks of
``_CHECK_EVERY`` bodies that update that state in place.  An ``active``
flag — the while_loop's ``cond`` — is computed on the device at the top of
every body and gates every update with ``torch.where``, exactly as the
reference body gates on ``bad``/``hurt``: an inactive body changes nothing,
and a converged solve reports the reference's iteration count.  After each
chunk the host reads the flag (one device sync), so up to
``_CHECK_EVERY - 1`` gated bodies may run after the solve stops; they cost
operator applications, not correctness.

On a CUDA device a loop's chunk runs once eagerly as the warm-up, is
captured as a CUDA graph and is replayed for every later chunk
(`core.graphs`); a `GraphCache` passed as ``graphs`` keeps the loop for
the next solve of the same operator, preconditioner, inner product,
shape, dtype and stagnation window.  A chunk holds no Python number that
changes between solves (the tolerance and budget are device scalars of
the state), so a replay with another tolerance is exact.  On the CPU, and
on a card where the caller passes ``capture=False``, the same chunk runs
eagerly; ``capture=True`` on the CPU raises.  `prepare` builds a loop, and
on a card captures it, without solving, so that the first solve of a
shape replays a graph captured before it.

Health monitoring lives INSIDE the loop, on the scalars it already
reduces: the carried ``rr`` going NaN/Inf rolls the step back and flags
DIVERGED, ``p.Ap <= 0`` freezes the iterate and flags BREAKDOWN, and an
optional stagnation window flags STAGNATED (see `resilience.status`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.core.graphs import GraphCache
from repro_torch.resilience.status import classify

__all__ = ["PCGResult", "pcg", "pcg_block", "refine", "prepare", "owned_dot"]

# Bodies a chunk runs between host reads of the device-side `active` flag:
# each read drains the queue once, so rarer reads keep the card busier
# while costing at most this many minus one gated bodies after convergence.
_CHECK_EVERY = 8

# `refine`'s fixed settings, the reference's defaults: the floor of the
# adaptive inner tolerance, the most refinement sweeps, and the sweeps in a
# row without a lower true residual that make a column STAGNATED.
_INNER_TOL = 0.03
_MAX_OUTER = 40
_STALL_LIMIT = 1

_INIT_ITER = -1  # the iteration index of the initial-residual application


def _up(u: torch.Tensor) -> torch.Tensor:
    """Upcast sub-fp32 floats for reduction accumulation; fp32 and wider
    pass through untouched."""
    if u.dtype.is_floating_point and torch.finfo(u.dtype).bits < 32:
        return u.float()
    return u


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.dot(_up(u).reshape(-1), _up(v).reshape(-1))


def _fold_buffer(n: int, cols: int, dtype: torch.dtype,
                 device) -> torch.Tensor:
    """The buffer of `_fold`: a power of two rows of `cols` columns, zero
    past row n; the caller writes its (n, cols) products into the first n
    rows."""
    rows = 1 << max(n - 1, 0).bit_length()
    s = torch.empty((rows, cols), dtype=dtype, device=device)
    s[n:].zero_()
    return s


def _fold(s: torch.Tensor) -> torch.Tensor:
    """The column sums of a `_fold_buffer`, folded in half until one row is
    left: a pairwise sum in one fixed tree of elementwise adds, each
    exactly rounded, the same for every column on every device."""
    rows = s.shape[0]
    while rows > 1:
        rows //= 2
        s = s[:rows] + s[rows:]
    return s[0]


def _column_dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-column dots of stacked fields: every axis but the last.

    Column j's dot has the same bits whatever the block's width, wherever
    the column sits in it and whatever the other columns hold, so that a
    zero-padded column changes no bit of a real one.  A torch reduction
    over several columns does not give that: its split of the work
    follows the number of outputs (on the CPU a one-output sum splits its
    input over the threads and a several-output one does not; on the card
    the block shape, the warps and the blocks per output follow the
    outputs).  So the products go, dof-major, into a `_fold_buffer`,
    which `_fold` sums.
    """
    u2, v2 = _up(u), _up(v)
    cols = u.shape[-1]
    n = u.numel() // cols
    s = _fold_buffer(n, cols, torch.result_type(u2, v2), u.device)
    torch.mul(u2.reshape(n, cols), v2.reshape(n, cols), out=s[:n])
    return _fold(s)


def owned_dot(weight: torch.Tensor, group, batched: bool = False
              ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """A `dot` for `pcg`/`pcg_block`/`refine` on element-sharded fields.

    `weight` is the shard's ownership mask (True where this shard owns the
    dof; False on ghost, padding and trash slots), so an interface dof,
    held by every shard that touches it, counts once.  The partial sum is
    fp32 for reduced-precision operands (`_up`), and one `all_reduce` over
    `group` adds the shards' partials: a scalar, or with `batched=True`
    the (nrhs,) per-column dots over every axis but the last, each summed
    by `_column_dot`'s fold, so that a column's partial (and dot) has the
    same bits at every block width.
    """

    def dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        w = weight if u.ndim == weight.ndim else weight.reshape(
            tuple(weight.shape) + (1,) * (u.ndim - weight.ndim))
        prod = _up(u) * _up(v)
        if batched:
            cols = u.shape[-1]
            n = u.numel() // cols
            s = _fold_buffer(n, cols, prod.dtype, u.device)
            torch.where(w, prod, prod.new_zeros(()),
                        out=s[:n].view(prod.shape))
            part = _fold(s)
        else:
            part = torch.where(w, prod, 0.0).sum()
        dist.all_reduce(part, group=group)
        return part

    return dot


def _identity(r: torch.Tensor) -> torch.Tensor:
    return r


def _iter_op(a_op):
    """`a_op` in the (x, iteration) calling convention: an operator that
    advertises ``takes_iteration = True`` as it is, any other one wrapped
    to ignore the counter."""
    if getattr(a_op, "takes_iteration", False):
        return a_op

    def wrapped(x, it):
        return a_op(x)

    return wrapped


class PCGResult(NamedTuple):
    """Outcome of a PCG solve; every field is a tensor on the solve's device
    (a scalar for `pcg`, one value per column for `pcg_block`).

    ``status`` is a `resilience.status.SolveStatus` code saying WHY the
    solve stopped; ``breakdown`` is the boolean view of the BREAKDOWN case.
    In every non-CONVERGED case the solve is frozen at its last *finite*
    iterate, so `x` is always a valid restart point and ``residual``
    reports where it stalled.
    """

    x: torch.Tensor
    iterations: torch.Tensor       # int32 scalar
    residual: torch.Tensor         # final sqrt(r.r) (last finite iterate)
    initial_residual: torch.Tensor
    breakdown: torch.Tensor        # bool scalar
    status: torch.Tensor           # int32 SolveStatus code


def _pcg_body(a2, precond, dot, window: int):
    """`pcg`'s gated body and its cond over a state dict `s`, with the
    loop's inputs and constants in `c`."""

    def cond(s, c):
        return ((s["it"] < c["max_iter"]) & (s["rr"] > c["tol2"])
                & ~s["brk"] & ~s["div"] & ~s["stag"])

    def body(s, c):
        x, r, z, p, rz, rr, it = (s[k] for k in ("x", "r", "z", "p", "rz",
                                                 "rr", "it"))
        zero, one, tol2 = c["zero"], c["one"], c["tol2"]
        active = cond(s, c)
        ap = a2(p, it)
        pap = dot(p, ap)
        # Lanczos breakdown: p.Ap <= 0 with the residual still above
        # tolerance means A is not SPD along p — freeze and flag.
        bad = pap <= 0.0
        alpha = torch.where(bad, zero, rz / torch.where(bad, one, pap))
        step_len = alpha.to(x.dtype)
        x_new = x + step_len * p
        r_new = r - step_len * ap
        z_new = precond(r_new)
        rz_new = dot(r_new, z_new)
        rr_new = dot(r_new, r_new)
        # divergence: the carried rr went non-finite THIS iteration — roll
        # the whole step back so x stays the last finite iterate.
        hurt = ~torch.isfinite(rr_new)
        keep = hurt | ~active
        rz2 = torch.where(keep, rz, rz_new)
        rr2 = torch.where(keep, rr, rr_new)
        beta = torch.where(bad | hurt, zero,
                           rz_new / torch.where(rz != 0, rz, one))
        advanced = active & ~bad & ~hurt
        # stagnation: iterations since the last new rr minimum
        improved = rr2 < s["best"]
        stall = torch.where(improved, 0,
                            s["stall"] + advanced.to(torch.int32))
        stag = s["stag"]
        if window > 0:
            stag = stag | (advanced & (stall >= window) & (rr2 > tol2))
        return {"x": torch.where(keep, x, x_new),
                "r": torch.where(keep, r, r_new),
                "z": torch.where(keep, z, z_new),
                "p": torch.where(bad | keep, p, z_new + beta.to(p.dtype) * p),
                "rz": rz2, "rr": rr2,
                "it": it + advanced.to(torch.int32),
                "brk": torch.where(active, bad, s["brk"]),
                "div": s["div"] | (active & hurt), "stag": stag,
                "stall": stall, "best": torch.minimum(s["best"], rr2)}

    return body, cond


def _block_body(a2, precond, dot, window: int):
    """`pcg_block`'s gated body and its cond: ``nb`` counts the bodies run,
    the reference's trailing global counter, and caps them at the budget
    as its cond does (``it[-1] < max_iter``)."""

    def live_of(s, c):
        return (s["rr"] > c["tol2"]) & ~s["brk"] & ~s["div"] & ~s["stag"]

    def cond(s, c):
        return live_of(s, c).any() & (s["nb"] < c["max_iter"])

    def body(s, c):
        x, r, z, p, rz, rr, nb = (s[k] for k in ("x", "r", "z", "p", "rz",
                                                 "rr", "nb"))
        zero, one, tol2 = c["zero"], c["one"], c["tol2"]
        live = live_of(s, c)                              # (nrhs,)
        on = live.any() & (nb < c["max_iter"])
        active = live & on
        ap = a2(p, nb)
        pap = dot(p, ap)
        # Lanczos breakdown on an active column: freeze it and flag it; the
        # healthy columns go on
        bad = active & (pap <= 0.0)
        active = active & ~bad
        alpha = torch.where(active, rz / torch.where(pap > 0, pap, one),
                            zero)
        step_len = alpha.to(x.dtype)     # fp32 per column -> iterate dtype
        x_new = x + step_len * p
        r_new = r - step_len * ap
        z_new = precond(r_new)
        rz_new = dot(r_new, z_new)
        rr_new = dot(r_new, r_new)
        # divergence: an active column's rr went non-finite; roll THAT
        # column's step back and flag it
        hurt = active & ~torch.isfinite(rr_new)
        keep = hurt | ~on
        rr2 = torch.where(keep, rr, rr_new)
        advanced = active & ~hurt
        beta = torch.where(advanced,
                           rz_new / torch.where(rz != 0, rz, one), zero)
        # stagnation: per-column iterations since a new rr minimum
        improved = rr2 < s["best"]
        stall = torch.where(improved, 0,
                            s["stall"] + advanced.to(torch.int32))
        stag = s["stag"]
        if window > 0:
            stag = stag | (advanced & (stall >= window) & (rr2 > tol2))
        z = torch.where(keep, z, z_new)
        return {"x": torch.where(keep, x, x_new),
                "r": torch.where(keep, r, r_new), "z": z,
                "p": torch.where(advanced, z + beta.to(p.dtype) * p, p),
                "rz": torch.where(keep, rz, rz_new), "rr": rr2,
                "it": s["it"] + advanced.to(torch.int32),
                "brk": s["brk"] | bad, "div": s["div"] | hurt,
                "stag": stag, "stall": stall,
                "best": torch.minimum(s["best"], rr2),
                "nb": nb + on.to(torch.int32)}

    return body, cond


_BODIES = {"pcg": _pcg_body, "pcg_block": _block_body}


def _set(t: torch.Tensor, value) -> None:
    """Write a Python number or a device scalar into `t` (no host sync)."""
    if isinstance(value, torch.Tensor):
        t.copy_(value)
    else:
        t.fill_(value)


class _Loop:
    """One loop's state in fixed tensors — the storage every replay of its
    graph reads and writes — and its chunk of ``_CHECK_EVERY`` bodies."""

    def __init__(self, body, cond, state: dict) -> None:
        self.body, self.cond = body, cond
        self.state = {k: torch.empty_like(v) for k, v in state.items()}
        rr = state["rr"]
        self.consts = {
            "tol2": torch.zeros((), dtype=rr.dtype, device=rr.device),
            "max_iter": torch.zeros((), dtype=torch.int32, device=rr.device),
            "zero": torch.zeros((), dtype=rr.dtype, device=rr.device),
            "one": torch.ones((), dtype=rr.dtype, device=rr.device)}
        self.flag = torch.zeros((), dtype=torch.bool, device=rr.device)
        self.graph = None

    def load(self, state: dict, tol2, max_iter) -> None:
        """Copy a solve's first state and inputs in; set the flag."""
        for k, v in state.items():
            self.state[k].copy_(v)
        _set(self.consts["tol2"], tol2)
        _set(self.consts["max_iter"], max_iter)
        self.flag.copy_(self.cond(self.state, self.consts))

    def chunk(self) -> None:
        """``_CHECK_EVERY`` bodies, written back into the fixed state."""
        s = dict(self.state)
        for _ in range(_CHECK_EVERY):
            s = self.body(s, self.consts)
        for k, v in s.items():
            self.state[k].copy_(v)
        self.flag.copy_(self.cond(s, self.consts))

    def run(self, chunks: int, capture: bool, cache: GraphCache) -> None:
        """Up to `chunks` chunks, reading the flag on the host before each:
        replayed from the graph when `capture`, else eagerly."""
        for _ in range(chunks):
            if not bool(self.flag):
                break
            if not capture:
                self.chunk()
            elif self.graph is None:
                self.graph = cache.capture(self.chunk)
            else:
                cache.replay(self.graph)


def _start(kind: str, a_op, b: torch.Tensor, x0, precond, dot, tol2,
           max_iter, window: int, graphs: Optional[GraphCache],
           capture: Optional[bool]):
    """The loop of `graphs` for this key, loaded with the first state of a
    `pcg` (kind "pcg") or `pcg_block` solve of `b` from `x0`; `tol2` and
    `max_iter` are the loop's inputs (Python numbers or device scalars).
    Returns the loop, its cache, whether it captures, and the initial
    residual."""
    dev = b.device
    if capture is None:
        capture = dev.type == "cuda"
    elif capture and dev.type != "cuda":
        raise ValueError(f"capture=True needs a CUDA tensor; b is on {dev}")
    precond = _identity if precond is None else precond
    if dot is None:
        dot = _dot if kind == "pcg" else _column_dot
    a2 = _iter_op(a_op)

    x = torch.zeros_like(b) if x0 is None else x0
    r = b - a2(x, torch.full((), _INIT_ITER, dtype=torch.int32, device=dev))
    z = precond(r)
    rz = dot(r, z)
    rr = dot(r, r)
    ints = torch.zeros(rr.shape, dtype=torch.int32, device=dev)
    flags = torch.zeros(rr.shape, dtype=torch.bool, device=dev)
    state = {"x": x, "r": r, "z": z, "p": z, "rz": rz, "rr": rr, "it": ints,
             "brk": flags, "div": flags, "stag": flags, "stall": ints,
             "best": rr}
    if kind == "pcg_block":
        state["nb"] = torch.zeros((), dtype=torch.int32, device=dev)
    cache = GraphCache() if graphs is None else graphs
    key = (kind, a_op, precond, dot, tuple(b.shape), b.dtype, dev, window)
    loop = cache.loop(key, lambda: _Loop(*_BODIES[kind](a2, precond, dot,
                                                         window), state))
    loop.load(state, tol2, max_iter)
    return loop, cache, capture, torch.sqrt(rr)


def _solve(kind: str, a_op, b: torch.Tensor, x0, precond, dot, tol2,
           max_iter, budget: int, window: int,
           graphs: Optional[GraphCache], capture: Optional[bool]
           ) -> PCGResult:
    """Run `pcg` (kind "pcg") or `pcg_block` on the loop of `graphs` for
    this key (`_start`); `budget` is the host's bound on the bodies."""
    loop, cache, capture, r0 = _start(kind, a_op, b, x0, precond, dot, tol2,
                                      max_iter, window, graphs, capture)
    loop.run(-(-budget // _CHECK_EVERY), capture, cache)
    s = loop.state
    status = classify(s["rr"], loop.consts["tol2"], s["brk"], s["div"],
                      s["stag"])
    return PCGResult(s["x"].clone(), s["it"].clone(), torch.sqrt(s["rr"]),
                     r0, s["brk"].clone(), status)


def prepare(a_op: Callable, b: torch.Tensor, *, batched: bool,
            precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
            stagnation_window: int = 0,
            graphs: Optional[GraphCache] = None) -> None:
    """Build the loop that :func:`pcg_block` (`batched`) or :func:`pcg`
    would run, with the default inner product, on a block of b's shape,
    dtype and device, and on a CUDA device capture its chunk — without
    solving (b's values are not read).  A later solve of that shape finds
    the loop, and its graph, in `graphs`.

    The loop is loaded with a zero right-hand side at tolerance 0 and no
    budget: a converged state, on which every body is gated off, so the
    capture's warm-up chunk leaves the state as it found it.  For
    :func:`refine`'s inner loop pass its bfloat16 block, its ``precond``
    and ``inner_window`` as the stagnation window.
    """
    loop, cache, capture, _ = _start(
        "pcg_block" if batched else "pcg", a_op, torch.zeros_like(b), None,
        precond, None, 0.0, 0, stagnation_window, graphs, None)
    if capture and loop.graph is None:
        loop.graph = cache.capture(loop.chunk)


def pcg(a_op: Callable,
        b: torch.Tensor,
        x0: Optional[torch.Tensor] = None,
        precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        tol: float = 1e-8,
        max_iter: int = 200,
        stagnation_window: int = 0,
        dot: Optional[Callable[[torch.Tensor, torch.Tensor],
                               torch.Tensor]] = None,
        graphs: Optional[GraphCache] = None,
        capture: Optional[bool] = None,
        ) -> PCGResult:
    """Solve A x = b with (preconditioned) CG; stop when ``r.r <= tol^2``.

    Inner products are full contractions (or `dot`), accumulated in fp32
    even for reduced-precision iterates; the iterates stay in b's dtype.
    `stagnation_window` > 0 additionally stops the solve with
    ``SolveStatus.STAGNATED`` when ``rr`` makes no new minimum for that
    many counted iterations (0, the default, disables the check).
    `graphs` keeps the loop (and on a card its graph) for later solves;
    `capture` (default: on a CUDA device) replays the chunk as a CUDA
    graph, ``False`` runs it eagerly (see the module docstring).
    """
    return _solve("pcg", a_op, b, x0, precond, dot, tol * tol, max_iter,
                  max_iter, stagnation_window, graphs, capture)


def pcg_block(a_op: Callable,
              b: torch.Tensor,
              x0: Optional[torch.Tensor] = None,
              precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
              tol: float = 1e-8,
              max_iter: int = 200,
              dot: Optional[Callable[[torch.Tensor, torch.Tensor],
                                     torch.Tensor]] = None,
              stagnation_window: int = 0,
              graphs: Optional[GraphCache] = None,
              capture: Optional[bool] = None,
              ) -> PCGResult:
    """Solve A X = B for nrhs stacked right-hand sides (trailing axis).

    Each column runs the iteration of :func:`pcg` with its own alpha/beta;
    the operator is applied once per iteration to the whole block.  A
    column whose carried ``rr`` met the tolerance, or that broke down
    (``p.Ap <= 0`` while active), diverged (its step rolled back) or
    stagnated, is frozen (alpha 0, search direction kept) with its own
    `SolveStatus` code, while the other columns go on; the solve ends when
    no column is live or after ``max_iter`` bodies (an iteration-aware
    operator receives that body count).  `dot` must return per-column
    values of shape (nrhs,) (default: every axis but the last, in fp32).
    ``iterations``, ``residual``, ``initial_residual``, ``breakdown`` and
    ``status`` are per column; ``iterations`` counts the iterations each
    column advanced.  `graphs` and `capture` as in :func:`pcg`.
    """
    return _solve("pcg_block", a_op, b, x0, precond, dot, tol * tol,
                  max_iter, max_iter, stagnation_window, graphs, capture)


def refine(a_hi, a_lo, b: torch.Tensor,
           x0: Optional[torch.Tensor] = None,
           precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
           tol: float = 1e-8,
           max_iter: int = 200,
           dot: Optional[Callable[[torch.Tensor, torch.Tensor],
                                  torch.Tensor]] = None,
           batched: bool = False,
           inner_window: int = 5,
           graphs: Optional[GraphCache] = None,
           capture: Optional[bool] = None) -> PCGResult:
    """Mixed-precision iterative refinement: fp32 outer, bfloat16 inner.

    The outer loop keeps ``x``, the TRUE residual ``r = b - a_hi(x)`` and
    the accumulated correction in fp32; each sweep solves ``A d = r/||r||``
    (normalised per column) with an inner :func:`pcg` / :func:`pcg_block`
    on the bfloat16 operator ``a_lo``, iterates in bfloat16 and reductions
    in fp32 (full contractions, per column when `batched`), and adds
    ``d * ||r||`` in fp32.  The inner target is adaptive,
    ``clip(0.5 tol / max ||r||, _INNER_TOL, 0.3)`` over the active columns,
    with ``inner_window`` as the inner stagnation window.  Acceptance is
    monotone: a sweep that does not lower a column's true ``rr`` is rolled
    back for that column, and after ``_STALL_LIMIT`` such sweeps in a row
    the column is STAGNATED; a non-finite ``rr`` rolls back
    and flags DIVERGED.  A converged or flagged column gets a zero inner
    RHS and its fp32 state stops moving.  ``iterations`` counts the total
    inner iterations (reduced-precision operator applications) per column,
    and the loop stops at ``max_iter`` of them, after ``_MAX_OUTER`` sweeps,
    or when no column is live.  `dot` serves the outer residuals and the
    inner sweeps alike (default: full contractions in fp32, per column
    when `batched`; `owned_dot` on a sharded field).

    As in the reference, the inner tolerance and budget are computed on
    the device, in float32, and enter the inner loop as device scalars, so
    every sweep replays the one captured inner chunk (`graphs`,
    `capture` as in :func:`pcg`).  The outer loop runs eagerly and reads
    one small tensor on the host per sweep: whether a column is live, and
    the iterations spent.
    """
    if dot is None:
        dot = _column_dot if batched else _dot
    b32 = b.to(torch.float32)
    kind = "pcg_block" if batched else "pcg"
    cache = GraphCache() if graphs is None else graphs

    x = torch.zeros_like(b32) if x0 is None else x0.to(torch.float32)
    r = (b32 - a_hi(x)).to(torch.float32)
    rr = dot(r, r)
    r0 = torch.sqrt(rr)
    tol2 = tol * tol
    dev = b.device
    it = torch.zeros(rr.shape, dtype=torch.int32, device=dev)
    div = torch.zeros(rr.shape, dtype=torch.bool, device=dev)
    stag = torch.zeros_like(div)
    stall = torch.zeros_like(it)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    # the inner target's numerator, 0.5 tol, in float32 as the reference
    # computes it
    half_tol = 0.5 * torch.sqrt(torch.full((), tol2, dtype=torch.float32,
                                           device=dev))

    for _ in range(_MAX_OUTER):
        active = (rr > tol2) & ~div & ~stag
        rnorm = torch.sqrt(rr)
        maxr = torch.where(active, rnorm, zero).max()
        # the sweep's one host read
        live, spent = torch.stack([active.any().to(torch.int32),
                                   it.max()]).tolist()
        if not live or spent >= max_iter:
            break
        safe = torch.where(active & (rnorm > 0), rnorm, one)
        # a frozen column gets a zero inner RHS: its inner column converges
        # at iteration 0 and the block freeze keeps it out of the others
        r_hat = torch.where(active, r / safe, zero).to(torch.bfloat16)
        itol = torch.clamp(half_tol / torch.where(maxr > 0, maxr, one),
                           _INNER_TOL, 0.3)
        res = _solve(kind, a_lo, r_hat, None, precond, dot, itol * itol,
                     torch.clamp(max_iter - it.max(), min=1),
                     max_iter - spent, inner_window, cache, capture)
        d = res.x.to(torch.float32) * torch.where(active, rnorm, zero)
        x_new = x + d
        r_new = (b32 - a_hi(x_new)).to(torch.float32)
        rr_new = dot(r_new, r_new)
        hurt = active & ~torch.isfinite(rr_new)
        div = div | hurt
        # a finite sweep that did not improve its column is rolled back
        # too: the sweep is a deterministic function of (r, a_lo), so
        # keeping the worse iterate would only compound — count the stall
        worse = active & ~hurt & (rr_new >= rr)
        keep = hurt | worse
        x = torch.where(keep, x, x_new)
        r = torch.where(keep, r, r_new)
        rr = torch.where(keep, rr, rr_new)
        stall = torch.where(active & ~keep, 0,
                            stall + worse.to(torch.int32))
        stag = stag | (worse & (stall >= _STALL_LIMIT))
        it = it + torch.where(active, res.iterations, 0).to(torch.int32)

    brk = torch.zeros_like(div)
    status = classify(rr, tol2, brk, div, stag)
    return PCGResult(x, it, torch.sqrt(rr), r0, brk, status)
