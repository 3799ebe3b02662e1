"""LM serving launcher: the continuous-batching engine on one device (the
reference's `launch/serve.py`).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      [--preset demo|full] [--slots 8] [--requests 16] [--max-len 256] \
      [--device cuda]

--preset full serves the architecture at its full width, demo its reduced
config; the weights are random, from `torch.Generator` seed 0.  The dense,
MoE, hybrid (zamba2-2.7b) and xLSTM (xlstm-350m) families serve; a VLM
architecture (phi-3-vision-4.2b) and an enc-dec/audio one
(seamless-m4t-medium) are refused by the engine, which takes token
prompts only, as the reference's does.  The
traffic is the reference's: `--requests` prompts of 4-31 tokens from
`np.random.default_rng(0)`, 16 new tokens each, no EOS.  It runs on the
card unless --device cpu is given; with no card it raises.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.nekbone import resolve_device
from repro_torch.models.config import reduced_config
from repro_torch.models.params import fill_from_specs
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import Request, ServeEngine

__all__ = ["build_served_model", "make_requests", "main"]


def build_served_model(cfg, device=None, seed: int = 0):
    """`build_model(cfg)` on `device` with the weights `init_from_specs`
    draws from a `torch.Generator` on that device seeded `seed`, written
    into the model's parameters in place (`fill_from_specs`): the build
    holds one copy of the weights."""
    device = resolve_device(device)
    model = build_model(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    fill_from_specs(model.param_specs(), model.param_tree(), gen)
    return model


def make_requests(vocab_size: int, n: int, max_new_tokens: int = 16,
                  seed: int = 0):
    """The reference launcher's traffic: prompts of 4-31 tokens in
    [1, vocab_size) from `np.random.default_rng(seed)`."""
    rng = np.random.default_rng(seed)
    return [Request(uid=uid,
                    prompt=rng.integers(1, vocab_size,
                                        size=int(rng.integers(4, 32))).astype(
                        np.int32),
                    max_new_tokens=max_new_tokens)
            for uid in range(n)]


def _parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", default="demo", choices=["demo", "full"])
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    return ap.parse_args(argv)


def main(argv=None):
    args = _parse_args(argv)
    device = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.preset == "demo":
        cfg = reduced_config(cfg)
    model = build_served_model(cfg, device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"model: {cfg.name} preset={args.preset} layers={cfg.num_layers} "
          f"d_model={cfg.d_model} vocab={cfg.vocab_size} dtype={cfg.dtype} "
          f"device={device} ({name})", flush=True)
    engine = ServeEngine(model, max_len=args.max_len, slots=args.slots,
                         eos_id=-1)
    reqs = make_requests(cfg.vocab_size, args.requests)
    for req in reqs:
        engine.submit(req)
    t0 = time.perf_counter()
    steps = engine.run_until_drained()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total_new = sum(len(r.output) for r in reqs)
    print(f"drained {args.requests} requests in {steps} steps: "
          f"{total_new} tokens in {dt:.2f}s ({total_new / dt:.1f} tok/s, "
          f"slot-util={total_new / max(steps * args.slots, 1):.0%})",
          flush=True)
    return reqs, steps


if __name__ == "__main__":
    main()
