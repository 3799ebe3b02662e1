"""LM serving engine: continuous batching over fixed decode slots (the
reference's `serving/engine.py`).

A fixed batch of `slots` decodes in lock-step; requests are admitted into
free slots, finished sequences (EOS or length budget) are evicted and their
slot refilled — steady-state utilisation instead of head-of-line blocking.
Prefill runs per admission at batch 1 and is spliced into its slot; decode
is one ragged step for the whole batch, which writes the cache in place.
Idle slots decode too (token 0 at their stale length), as in the
reference.  The step runs eagerly.

Each cache leaf is (L, slots, n, ...): a KV leaf's axis 2 runs over
positions up to max_len, a recurrent state's (the hybrid family's ssm and
conv states, the xLSTM family's mLSTM memory and sLSTM cell states) over
its own width.  Admission copies the prefill's leaf along its own axis 2
and zeroes the rest, so a slot's whole state is overwritten.  The
reference's splice pads every leaf's axis 2 to max_len and fails on the
recurrent states (ROADMAP Queue 3).  A model with patch inputs (the VLM
family) or frame inputs (the enc-dec/audio family) is refused: the
reference's engine passes only tokens to `prefill`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

__all__ = ["Request", "ServeEngine"]


@dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 32
    output: List[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Serves `model` (a `DecoderLM`, a `HybridLM` or an `XLSTMLM`) on the
    device its parameters are on."""

    def __init__(self, model, max_len: int, slots: int, eos_id: int = 0):
        for field, what in (("vision_patches", "patches"),
                            ("encoder_layers", "frames")):
            if getattr(model.cfg, field):
                raise NotImplementedError(
                    f"{model.cfg.name}: the engine serves token prompts "
                    f"only; the reference's engine passes no {what} to "
                    f"prefill, and the port adds no such requests")
        self.model = model
        self.max_len = max_len
        self.slots = slots
        self.eos_id = eos_id
        self.device = model.device
        self.cache = {part: {name: torch.zeros(sd.shape, dtype=sd.dtype,
                                               device=self.device)
                             for name, sd in leaves.items()}
                      for part, leaves in model.cache_spec(slots,
                                                           max_len).items()}
        self.lengths = np.zeros(slots, np.int32)
        self.active: List[Optional[Request]] = [None] * slots
        self.queue: List[Request] = []

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for slot in range(self.slots):
            if self.active[slot] is None and self.queue:
                req = self.queue.pop(0)
                # per-request prefill at batch 1, then splice into the slot
                tokens = torch.as_tensor(req.prompt[None, :].astype(np.int64),
                                         device=self.device)
                logits1, cache1 = self.model.prefill({"tokens": tokens})
                # the prefill already scores the next token; emitting it here
                # (not re-feeding prompt[-1]) keeps the cache write-once
                first = int(torch.argmax(logits1[0, -1]))
                req.output.append(first)
                for part, leaves in cache1.items():
                    for name, small in leaves.items():
                        # (L, 1, n, ...) into the slot along axis 2
                        big = self.cache[part][name]
                        n = small.shape[2]
                        big[:, slot, :n] = small[:, 0]
                        big[:, slot, n:] = 0
                self.active[slot] = req
                self.lengths[slot] = len(req.prompt)

    def step(self) -> int:
        """One decode step for all active slots; returns #active."""
        self._admit()
        if not any(r is not None for r in self.active):
            return 0
        # finished requests may have been evicted mid-flight: drain first
        for slot, req in enumerate(self.active):
            if req is not None and req.done:
                self.active[slot] = None
        last = np.array([
            (r.output[-1] if r and r.output else 0) for r in self.active],
            np.int64)[:, None]
        cur_len = torch.as_tensor(self.lengths.astype(np.int64),
                                  device=self.device)   # ragged positions
        logits, self.cache = self.model.decode_step(
            torch.as_tensor(last, device=self.device), self.cache, cur_len)
        next_ids = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        n_active = 0
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            tok = int(next_ids[slot])
            req.output.append(tok)
            self.lengths[slot] += 1
            if (tok == self.eos_id
                    or len(req.output) >= req.max_new_tokens
                    or self.lengths[slot] >= self.max_len - 1):
                req.done = True
                self.active[slot] = None
            else:
                n_active += 1
        return n_active

    def run_until_drained(self, max_steps: int = 10_000) -> int:
        steps = 0
        while (self.queue or any(self.active)) and steps < max_steps:
            self.step()
            steps += 1
        return steps
