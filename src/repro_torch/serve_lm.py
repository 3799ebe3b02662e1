"""Serve a small LM with continuous batching (fixed decode slots): the
port's twin of the reference's `examples/serve_lm.py`.

Submits a burst of variable-length requests, drains them through the engine,
and reports slot utilisation + per-request outputs.  The model is the
architecture's reduced config (a dense, MoE, hybrid or xLSTM one; the
engine refuses the VLM and enc-dec/audio families, whose prompts carry
patches or frames) with random weights (`torch.Generator` seed 0).  It
runs on the card unless --device cpu is given; with no card it raises.

Run:  PYTHONPATH=src python -m repro_torch.serve_lm [--arch qwen3-0.6b]
          [--slots 4] [--requests 10] [--max-new 16] [--max-len 128]
          [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.nekbone import resolve_device
from repro_torch.launch.serve import build_served_model
from repro_torch.models.config import reduced_config
from repro_torch.serving.engine import Request, ServeEngine


def _parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    return ap.parse_args(argv)


def main(argv=None):
    args = _parse_args(argv)
    device = resolve_device(args.device)
    cfg = reduced_config(configs.get(args.arch))
    model = build_served_model(cfg, device)
    engine = ServeEngine(model, max_len=args.max_len, slots=args.slots,
                         eos_id=-1)

    rng = np.random.default_rng(0)
    reqs = []
    for uid in range(args.requests):
        n = int(rng.integers(4, 24))
        req = Request(uid=uid,
                      prompt=rng.integers(1, cfg.vocab_size,
                                          size=n).astype(np.int32),
                      max_new_tokens=args.max_new)
        reqs.append(req)
        engine.submit(req)

    t0 = time.perf_counter()
    steps = engine.run_until_drained()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total_new = sum(len(r.output) for r in reqs)
    print(f"served {len(reqs)} requests / {total_new} tokens in {steps} "
          f"decode steps, {dt:.2f}s on {device} "
          f"({total_new / dt:.1f} tok/s, slot-util="
          f"{total_new / max(steps * args.slots, 1):.0%})")
    for r in reqs[:3]:
        print(f"  req {r.uid}: prompt[{len(r.prompt)}] -> {r.output}")
    return reqs, steps


if __name__ == "__main__":
    main()
