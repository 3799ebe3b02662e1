"""Training launcher: the dense, MoE, VLM, hybrid, xLSTM and enc-dec/audio
LMs on one device (the reference's `launch/train.py`).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      [--shape train_4k] [--preset demo|full] [--steps N] [--layers L] \\
      [--ckpt-dir DIR] [--device cuda]

--preset demo trains the reduced config at batch 8, seq 64.  --preset full
trains the architecture at its full width on one card: the shape's
sequence length (4096 for train_4k) and its global batch (256) cut to
FULL_BATCH = 4 at FULL_GRAD_ACCUM = 2 microbatches, which one H100 80GB
holds with remat "full"; the cut is printed.  --layers L cuts the depth
to L layers (the MoE family's dense layers kept first): moonshot-v1-16b-a3b
at full width trains on one card only so cut.  The hybrid family's L must
be a multiple of its `attn_every` (6 for zamba2-2.7b) and the xLSTM
family's even (mLSTM, sLSTM pairs), else the model raises, as the
reference's asserts.  The VLM family's batches carry their patches inside
the shape's sequence (phi-3-vision-4.2b: 144 patches and 3952 tokens at
train_4k); the enc-dec/audio family's carry as many frames as tokens.
The reference runs the full preset on its production mesh; --multi-pod
raises here (the mesh is ROADMAP Queue 1, item 5, slice 8).  The weights
are random, from `torch.Generator` seed 0; the data is `SyntheticLM`.  It
runs on the card unless --device cpu is given; with no card it raises.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Callable, NamedTuple

import torch
from torch import nn

from repro_torch import configs
from repro_torch.core.nekbone import resolve_device
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.serve import build_served_model
from repro_torch.models.config import (SHAPE_CASES, ModelConfig,
                                       reduced_config)
from repro_torch.training.fault_tolerance import run_resilient
from repro_torch.training.train_loop import (TrainConfig, init_state,
                                             make_train_step)

__all__ = ["FULL_BATCH", "FULL_GRAD_ACCUM", "TrainRun", "build_run", "main"]

FULL_BATCH = 4
FULL_GRAD_ACCUM = 2


class TrainRun(NamedTuple):
    """What the launcher trains."""

    cfg: ModelConfig
    model: nn.Module                # the family's model
    tcfg: TrainConfig
    state: dict
    step: Callable
    data: SyntheticLM


def build_run(arch: str, preset: str = "demo", shape: str = "train_4k",
              steps: int = 100, device=None, seed: int = 0,
              layers: int | None = None, seq: int | None = None,
              **tcfg_fields) -> TrainRun:
    """The launcher's run on `device` (the CUDA device unless the caller
    names another): `preset`'s config (cut to `layers` layers when given)
    and batch, its sequence cut to `seq` when given (no flag sets it: a
    caller's cut, as chip_smoke.py's of the families whose step is slow
    per position), weights drawn by `launch.serve.build_served_model` from
    a `torch.Generator` seeded `seed`, and `TrainConfig(total_steps=steps,
    grad_accum=..., **tcfg_fields)`."""
    device = resolve_device(device)
    case = SHAPE_CASES[shape]
    cfg = configs.get(arch)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    if preset == "demo":
        cfg = reduced_config(cfg)
        batch, seq, accum = 8, seq or 64, 1
    else:
        batch, seq = (min(case.global_batch, FULL_BATCH),
                      seq or case.seq_len)
        accum = FULL_GRAD_ACCUM
    model = build_served_model(cfg, device, seed=seed)
    tcfg = TrainConfig(**{"total_steps": steps, "grad_accum": accum,
                          **tcfg_fields})
    state = init_state(model, tcfg)
    data = SyntheticLM(cfg, batch=batch, seq=seq, device=device)
    return TrainRun(cfg, model, tcfg, state, make_train_step(model, tcfg),
                    data)


def _parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--preset", default="demo", choices=["demo", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    return ap.parse_args(argv)


def main(argv=None):
    args = _parse_args(argv)
    if args.multi_pod:
        raise NotImplementedError(
            "--multi-pod needs the mesh, which is not ported yet (ROADMAP "
            "Queue 1, item 5, slice 8)")
    run = build_run(args.arch, args.preset, args.shape, args.steps,
                    args.device, layers=args.layers)
    cfg, data = run.cfg, run.data
    device = run.model.device
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    if args.layers is not None:
        print(f"depth cut from {configs.get(args.arch).num_layers} to "
              f"{cfg.num_layers} layers", flush=True)
    print(f"model: {cfg.name} preset={args.preset} layers={cfg.num_layers} "
          f"d_model={cfg.d_model} vocab={cfg.vocab_size} dtype={cfg.dtype} "
          f"remat={cfg.remat} device={device} ({name})", flush=True)
    if args.preset == "full":
        case = SHAPE_CASES[args.shape]
        print(f"{args.shape}: seq {data.seq}; global batch cut from "
              f"{case.global_batch} to {data.batch} on one card, "
              f"grad_accum {run.tcfg.grad_accum}", flush=True)
    state, hist = run_resilient(
        run.step, run.state, data.batch_at, num_steps=args.steps,
        ckpt_dir=args.ckpt_dir, ckpt_every=max(args.steps // 5, 10),
        on_metrics=lambda s, m: s % 10 == 0 and print(
            f"step {s}: loss={float(m['loss']):.4f}", flush=True))
    print("history:", hist, flush=True)
    return state, hist


if __name__ == "__main__":
    main()
