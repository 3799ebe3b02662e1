"""Recorders of what an entry point runs: its aten ops and its collectives.

The reference's contracts read the programs XLA compiles, through a parser
of HLO text (`repro.analysis.hlo_ir`).  PyTorch compiles no such program,
so the port records what runs instead:

  * `OpRecorder`, a `TorchDispatchMode`: every aten op that reaches the
    dispatcher, with its input and output dtypes and shapes, its boolean
    arguments (`index_put_`'s ``accumulate``) and the line of the port
    that issued it (`OpRecord`);
  * `CollectiveRecorder`: every `torch.distributed.all_reduce` and every
    message of `torch.distributed.batch_isend_irecv`, with its kind,
    shape, dtype, peer and tag, and the batch it was posted in
    (`Collective`).

Recording is scoped to what the reference compiles into one program.  A
solve entry is recorded over the loop body that `core.pcg._Loop` captures
as a CUDA graph — one chunk of ``_CHECK_EVERY`` (8) gated iterations, run
eagerly after one warm-up solve has built the loop (`record_chunks`) — as
the reference scopes its contracts to the jitted solve; the host read of
the loop's flag between chunks (`_Loop.run`) and the setup's first call of
`kernels.axhelm.ops._constants`, which wraps float64 arrays once, lie
outside it.  An operator entry is recorded over one application
(`nekbone._global_op`, or a sharded problem's `op`).  On a card the chunk
also runs eagerly under the recorders: a graph's replay runs no Python.

The kernels launch through ctypes (`kernels.axhelm.ops._launch`), below
the dispatcher, so the op recorder does not see them: on the card a solve
through the kernels records the PCG body and the gather around them.
The kernels' own accumulation is held by `chip_smoke.py` phases 3 and 3b
(every kernel against its plain version, and bf16 against the correctly
rounded result), not by this recorder.  Nor does it see a wait on a CUDA
event that is not an aten op: the host staging of gloo's point-to-point
messages on a card (`gather_scatter.neighbour_start`), the documented wire
of the sharded solve on one card.
"""

from __future__ import annotations

import functools
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.gather_scatter import shift_of_tag
from repro_torch.core.pcg import _CHECK_EVERY

__all__ = ["OpRecord", "Collective", "OpRecorder", "CollectiveRecorder",
           "record_chunks", "replay_sync_error", "census"]

_PORT = Path(__file__).resolve().parents[1]        # src/repro_torch
_TORCH = Path(torch.__file__).resolve().parent
_HERE = Path(__file__).resolve()


@functools.lru_cache(maxsize=None)
def _shown(filename: str) -> Optional[str]:
    """How `_where` shows a frame's file: None for torch's and this
    module's own, relative to the port's parent directory in the port."""
    path = Path(filename).resolve()
    if path == _HERE or _TORCH in path.parents:
        return None
    return str(path.relative_to(_PORT.parent)) if _PORT in path.parents \
        else str(path)


def _where() -> str:
    """The innermost frame of the caller's stack outside torch and this
    module, as ``path:line (function)``."""
    frame = sys._getframe(1)
    while frame is not None:
        shown = _shown(frame.f_code.co_filename)
        if shown is not None:
            return f"{shown}:{frame.f_lineno} ({frame.f_code.co_qualname})"
        frame = frame.f_back
    return "<unknown>"


def _dtype(t: torch.dtype) -> str:
    return str(t).removeprefix("torch.")


@dataclass
class OpRecord:
    """One aten op as it reached the dispatcher: its packet name (``mm``,
    ``index_put_``), the full overload (``aten.mm.default``), the dtypes
    and shapes of its tensor inputs and outputs, its boolean arguments by
    schema name, and the line of the port that issued it."""

    op: str
    overload: str
    in_dtypes: tuple
    in_shapes: tuple
    out_dtypes: tuple
    out_shapes: tuple
    flags: dict = field(default_factory=dict)
    where: str = ""

    def __str__(self) -> str:
        outs = ", ".join(f"{d}{list(s)}" for d, s in
                         zip(self.out_dtypes, self.out_shapes))
        return f"{self.overload} -> {outs or 'nothing'} at {self.where}"


@dataclass
class Collective:
    """One collective call, or one message of a `batch_isend_irecv`:
    `kind` is "all_reduce", "send" or "recv"; `peer` and `tag` are a
    message's (None for an all_reduce); `batch` numbers the
    `batch_isend_irecv` call a message was posted in."""

    kind: str
    shape: tuple
    dtype: str
    peer: Optional[int] = None
    tag: Optional[int] = None
    batch: Optional[int] = None
    where: str = ""

    def __str__(self) -> str:
        peer = "" if self.peer is None else \
            f" peer {self.peer} tag {self.tag}"
        return (f"{self.kind} {self.dtype}{list(self.shape)}{peer} at "
                f"{self.where}")


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)


class OpRecorder(TorchDispatchMode):
    """Records every aten op run inside its ``with`` block (`ops`)."""

    def __init__(self) -> None:
        super().__init__()
        self.ops: list[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in _tensors(list(args) + list(kwargs.values()))]
        outs = list(_tensors(out))
        flags = {}
        for i, arg in enumerate(func._schema.arguments):
            value = kwargs.get(arg.name, args[i] if i < len(args) else None)
            if isinstance(value, bool):
                flags[arg.name] = value
        self.ops.append(OpRecord(
            func.overloadpacket.__name__, str(func),
            tuple(_dtype(t.dtype) for t in ins),
            tuple(tuple(t.shape) for t in ins),
            tuple(_dtype(t.dtype) for t in outs),
            tuple(tuple(t.shape) for t in outs), flags, _where()))
        return out


class CollectiveRecorder:
    """Records every `torch.distributed.all_reduce` and every message of
    `torch.distributed.batch_isend_irecv` made inside its ``with`` block
    (`events`), and makes them: the two functions are wrapped on the
    `torch.distributed` module for the block's duration, so code that
    calls them through the module (``dist.all_reduce``) is seen."""

    def __init__(self) -> None:
        self.events: list[Collective] = []
        self._batches = 0

    def __enter__(self) -> "CollectiveRecorder":
        self._real = dist.all_reduce, dist.batch_isend_irecv
        real_reduce, real_batch = self._real

        def all_reduce(tensor, *args, **kwargs):
            self.events.append(Collective("all_reduce", tuple(tensor.shape),
                                          _dtype(tensor.dtype),
                                          where=_where()))
            return real_reduce(tensor, *args, **kwargs)

        def batch_isend_irecv(p2p_op_list):
            where = _where()
            for op in p2p_op_list:
                self.events.append(Collective(
                    "send" if op.op is dist.isend else "recv",
                    tuple(op.tensor.shape), _dtype(op.tensor.dtype), op.peer,
                    op.tag, self._batches, where))
            self._batches += 1
            return real_batch(p2p_op_list)

        dist.all_reduce, dist.batch_isend_irecv = all_reduce, \
            batch_isend_irecv
        return self

    def __exit__(self, *exc) -> None:
        dist.all_reduce, dist.batch_isend_irecv = self._real

    def batches(self) -> list[list[Collective]]:
        """The messages, one list a `batch_isend_irecv` call."""
        out = [[] for _ in range(self._batches)]
        for c in self.events:
            if c.batch is not None:
                out[c.batch].append(c)
        return out


def census(events) -> dict:
    """Counts by kind: "all_reduce", "send", "recv", "p2p" (every message)
    and "permute" — the +k or -k shifts of the neighbour exchange that the
    rank took part in, as sender, receiver or both (the counterpart of an
    HLO collective-permute): distinct (batch, shift) pairs, the shift read
    from the message tag (`gather_scatter.shift_of_tag`)."""
    out = dict.fromkeys(("all_reduce", "send", "recv", "p2p", "permute"), 0)
    shifts = set()
    for c in events:
        out[c.kind] += 1
        if c.kind in ("send", "recv"):
            out["p2p"] += 1
            shifts.add((c.batch, shift_of_tag(c.tag)))
    out["permute"] = len(shifts)
    return out


def record_chunks(graphs):
    """Run one chunk of every loop that `graphs` (a
    `core.graphs.GraphCache`) holds, eagerly, under both recorders;
    returns (ops, collectives, operator applications).  The loops must
    have been built by a solve (the warm-up); a loop whose solve ended
    runs gated bodies, which issue the same ops."""
    loops = list(graphs.loops.values())
    if not loops:
        raise ValueError("record_chunks: the cache holds no loop; run a "
                         "solve first (the warm-up)")
    with CollectiveRecorder() as rec, OpRecorder() as ops:
        for loop in loops:
            loop.chunk()
    return ops.ops, rec.events, len(loops) * _CHECK_EVERY


def replay_sync_error(graphs) -> Optional[str]:
    """On a card: replay each captured chunk of `graphs` (a
    `core.graphs.GraphCache`) three times under
    ``torch.cuda.set_sync_debug_mode("error")``, in which an operation that
    waits for the device raises; returns what a replay raised, or None.
    A loop without a graph is reported too."""
    loops = list(graphs.loops.values())
    if not loops or any(loop.graph is None for loop in loops):
        return "no captured chunk to replay"
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for loop in loops:
            for _ in range(3):
                graphs.replay(loop.graph)
    except RuntimeError as exc:
        return f"{type(exc).__name__}: {exc}"
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return None
