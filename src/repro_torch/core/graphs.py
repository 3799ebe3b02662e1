"""CUDA graphs of the solver's loops, and the cache that replays them.

The reference compiles each PCG loop into one XLA program and replays it
(`jax.lax.while_loop` under `jit`).  The port's counterpart is a CUDA
graph of one chunk of the loop (`core.pcg`): the chunk runs once eagerly
on a side stream (the warm-up, which is the solve's real first chunk), is
captured once, and is replayed for every later chunk of that solve and of
every later solve of the same problem and shape.  A `GraphCache` keeps the
loops of one problem — their fixed state tensors, their graphs and one
memory pool for all of them — so a repeat solve captures nothing.

Launch counts stay exact under replay: a counted call (`count`) made while
a chunk is being captured launches nothing then, so it is recorded with the
graph and added once for every replay of it.
"""

from __future__ import annotations

import time
from typing import Callable, Hashable, Optional

import torch

__all__ = ["GraphCache", "ChunkGraph", "count"]

# the tally of the chunk being captured by this module, if any
_capturing: Optional[dict] = None


def count(counter: dict, key) -> None:
    """Add one to ``counter[key]`` for a launch made now; inside a capture
    made here, for every replay of the captured graph instead."""
    if _capturing is None:
        counter[key] += 1
    else:
        slot = (id(counter), key)
        _, _, n = _capturing.get(slot, (counter, key, 0))
        _capturing[slot] = (counter, key, n + 1)


class ChunkGraph:
    """`fn` (work on fixed tensors) warmed up once, then captured."""

    def __init__(self, fn: Callable[[], None], pool) -> None:
        global _capturing
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()                      # the warm-up runs the chunk for real
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        self.tally: dict = {}
        t0 = time.perf_counter()
        _capturing = self.tally
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                fn()
        finally:
            _capturing = None
        self.capture_seconds = time.perf_counter() - t0

    def replay(self) -> None:
        self.graph.replay()
        for counter, key, n in self.tally.values():
            counter[key] += n


class GraphCache:
    """The loops of one problem, keyed by what a captured chunk bakes in:
    the operator, preconditioner and inner product (the functions
    themselves, held here), the field's shape, dtype and device, and the
    stagnation window.  Also memoizes the functions a solve makes from the
    problem (`memo`), so that a repeat solve finds the same key.

    ``builds`` counts loops built, ``captures`` graphs captured (one per
    loop, on a card), ``replays`` graph replays and ``capture_seconds``
    each capture's host time.
    """

    def __init__(self) -> None:
        self.loops: dict = {}
        self.memos: dict = {}
        self.pool = None
        self.builds = 0
        self.captures = 0
        self.replays = 0
        self.capture_seconds: list = []

    def memo(self, key: Hashable, make: Callable[[], object]):
        if key not in self.memos:
            self.memos[key] = make()
        return self.memos[key]

    def loop(self, key: Hashable, make: Callable[[], object]):
        if key not in self.loops:
            self.loops[key] = make()
            self.builds += 1
        return self.loops[key]

    def capture(self, fn: Callable[[], None]) -> ChunkGraph:
        """Warm `fn` up and capture it in this cache's memory pool."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = ChunkGraph(fn, self.pool)
        self.captures += 1
        self.capture_seconds.append(graph.capture_seconds)
        return graph

    def replay(self, graph: ChunkGraph) -> None:
        graph.replay()
        self.replays += 1
