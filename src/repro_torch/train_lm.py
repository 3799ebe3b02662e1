"""Train an LM with the training substrate: checkpoints, fault tolerance,
any --arch of the pool: dense, MoE, VLM, hybrid, xLSTM or enc-dec/audio
(the port's twin of the reference's `examples/train_lm.py`).

Presets:
  demo (default) — the reduced config, a few hundred steps in minutes.
  full           — the architecture at its full width, at --batch/--seq.

The weights are random (`torch.Generator` seed 0).  It runs on the card
unless --device cpu is given; with no card it raises.

Run:  PYTHONPATH=src python -m repro_torch.train_lm --arch smollm-360m \\
          [--steps 200] [--batch 8] [--seq 64] [--inject-failure 50] \\
          [--eight-bit] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch import configs
from repro_torch.core.nekbone import resolve_device
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.serve import build_served_model
from repro_torch.models.config import reduced_config
from repro_torch.training.fault_tolerance import (FailureInjector,
                                                  run_resilient)
from repro_torch.training.train_loop import (TrainConfig, init_state,
                                             make_train_step)


def _parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--preset", default="demo", choices=["demo", "full"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-failure", type=int, default=None,
                    help="simulate a failure at this step")
    ap.add_argument("--eight-bit", action="store_true")
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
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} preset={args.preset} params={n_params / 1e6:.1f}M "
          f"device={device}", flush=True)

    tcfg = TrainConfig(lr=args.lr, warmup=20, total_steps=args.steps,
                       eight_bit_optimizer=args.eight_bit)
    state = init_state(model, tcfg)
    step = make_train_step(model, tcfg)
    data = SyntheticLM(cfg, batch=args.batch, seq=args.seq, device=device)

    injector = None
    if args.inject_failure is not None:
        injector = FailureInjector(fail_at=(args.inject_failure,))

    def log(s, m):
        if s % 20 == 0 or s == args.steps:
            print(f"step {s:4d}: loss={float(m['loss']):.4f} "
                  f"lr={float(m['lr']):.2e} "
                  f"gnorm={float(m['grad_norm']):.2f}", flush=True)

    state, hist = run_resilient(step, state, data.batch_at,
                                num_steps=args.steps,
                                ckpt_dir=args.ckpt_dir,
                                ckpt_every=args.ckpt_every,
                                injector=injector, on_metrics=log)
    print(f"done: {hist}", flush=True)
    return state, hist


if __name__ == "__main__":
    main()
