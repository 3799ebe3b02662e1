"""Data pipeline: deterministic, resumable synthetic token stream (the
reference's `data/pipeline.py`).

Every batch is a pure function of (seed, step) — the property fault-tolerant
restarts rely on (no replayed or skipped data after restore).  The tokens
are the reference's, bit for bit: they are drawn with numpy from the same
seeds, then put on the device as int32.  `host_prefetch` wraps any batch_fn
with a background prefetch thread.  A packed-document mode mimics real LM
pretraining batches (documents of random length packed to full sequences
with EOS = 0).  The VLM family's batches carry the reference's bf16
`patches` (B, P, vision_dim), drawn after the tokens from the same stream,
and tokens cut to S - P; the enc-dec/audio family's carry its bf16
`frames` (B, S, audio_dim), drawn the same way, beside S tokens.  Both are
the reference's bits.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator

import numpy as np
import torch

from repro_torch.core.nekbone import resolve_device
from repro_torch.models.config import ModelConfig

__all__ = ["SyntheticLM", "host_prefetch"]


class SyntheticLM:
    """Synthetic next-token data with a learnable structure (bigram-ish),
    so small models measurably improve.  Batches land on `device` (the CUDA
    device unless the caller names another; raises without one)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 seed: int = 0, packed: bool = True, device=None):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.packed = packed
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)
        # fixed random bigram transition: next ~ (perm[cur] +/- noise)
        self._perm = rng.permutation(cfg.vocab_size)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng((self.seed, step))
        v = self.cfg.vocab_size
        b, s = self.batch, self.seq
        toks = np.empty((b, s), np.int64)
        toks[:, 0] = rng.integers(0, v, b)
        noise = rng.integers(0, 16, (b, s))
        for t in range(1, s):
            toks[:, t] = (self._perm[toks[:, t - 1]] + noise[:, t]) % v
        if self.packed:  # insert document breaks (EOS = 0)
            eos = rng.random((b, s)) < (1.0 / 256)
            toks = np.where(eos, 0, toks)
        out = {"tokens": torch.from_numpy(toks.astype(np.int32))}
        if self.cfg.family == "vlm":
            p = self.cfg.vision_patches
            out["patches"] = torch.from_numpy(rng.standard_normal(
                (b, p, self.cfg.vision_dim))).to(torch.bfloat16)
            out["tokens"] = out["tokens"][:, :s - p].contiguous()
        if self.cfg.family == "audio":
            out["frames"] = torch.from_numpy(rng.standard_normal(
                (b, s, self.cfg.audio_dim))).to(torch.bfloat16)
        return {k: v.to(self.device) for k, v in out.items()}

    __call__ = batch_at


def host_prefetch(batch_fn: Callable[[int], Dict], start_step: int,
                  depth: int = 2) -> Iterator:
    """Background-thread prefetch of batch_fn(step), resumable at any step."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            try:
                q.put((step, batch_fn(step)), timeout=0.1)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
