"""Quickstart: the paper's pipeline end to end in a minute (the port's twin
of the reference's `examples/quickstart.py`).

1. Build a deformed trilinear mesh (the paper's element class).
2. Solve a Poisson problem matrix-free with PCG, once per axhelm variant —
   identical iteration counts (paper Table 6's invariance).
3. Apply the hand-written CUDA axhelm kernel and check it against its
   plain PyTorch version.  With --device cpu there is no kernel to run:
   the plain version runs, and the line says so.
4. Train a tiny LM for 20 steps with the same training substrate the
   launcher uses (which trains every family of the registry).

It runs on the card unless --device cpu is given; with no card it raises.

Run:  PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.nekbone import resolve_device


def nekbone_demo(device):
    from repro_torch.core import mesh_gen, nekbone

    print("== Nekbone (paper pipeline) ==", flush=True)
    mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(3, 3, 3, 5), seed=3)
    rng = np.random.default_rng(0)
    x_np = rng.standard_normal(mesh.n_global)
    for variant in ("precomputed", "trilinear", "partial"):
        prob = nekbone.setup_problem(mesh, variant=variant, device=device)
        x_true = torch.as_tensor(x_np, dtype=torch.float32, device=device)
        b = nekbone.rhs_from_solution(prob, x_true)
        res = nekbone.solve(prob, b, tol=1e-6, max_iter=300)
        err = nekbone.manufactured_error(prob, res.x, x_true)
        print(f"  {variant:>12}: iters={int(res.iterations):3d} "
              f"rel_err={err:.2e}", flush=True)


def kernel_demo(device):
    from repro_torch.core import mesh_gen
    from repro_torch.core.spectral import basis
    from repro_torch.kernels.axhelm import ops

    b = basis(7)
    mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(2, 2, 2, 7), seed=1)
    verts = torch.as_tensor(mesh.verts, dtype=torch.float32, device=device)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((8, 8, 8, 8)),
                        dtype=torch.float32, device=device)
    y = ops.axhelm(x, b, "trilinear", verts)
    y_ref = ops.reference(x, b, "trilinear", verts)
    err = float((y - y_ref).abs().max())
    if device.type == "cuda":
        print("== CUDA axhelm kernel ==", flush=True)
        print(f"  kernel-vs-plain max err: {err:.2e} (N=7, 8 elements)",
              flush=True)
    else:
        print("== axhelm on the CPU: no CUDA kernel runs ==", flush=True)
        print(f"  plain version (the kernel's CPU path) against itself: max "
              f"err {err:.2e} (N=7, 8 elements); the kernel needs a card",
              flush=True)


def train_demo(device):
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.serve import build_served_model
    from repro_torch.models.config import reduced_config
    from repro_torch.training.train_loop import (TrainConfig, init_state,
                                                 make_train_step)

    print("== tiny LM training (same substrate as the launcher) ==",
          flush=True)
    cfg = reduced_config(configs.get("qwen3-0.6b")).replace(vocab_size=128)
    model = build_served_model(cfg, device)
    tcfg = TrainConfig(lr=5e-3, warmup=5, total_steps=50)
    state = init_state(model, tcfg)
    step = make_train_step(model, tcfg)
    data = SyntheticLM(cfg, batch=8, seq=32, device=device)
    losses = []
    for i in range(20):
        state, metrics = step(state, data.batch_at(i))
        losses.append(metrics["loss"])
        if i % 5 == 0 or i == 19:
            print(f"  step {i:2d}: loss={float(metrics['loss']):.3f}",
                  flush=True)
    return [float(v) for v in losses]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    device = resolve_device(ap.parse_args(argv).device)
    nekbone_demo(device)
    kernel_demo(device)
    losses = train_demo(device)
    print("quickstart OK", flush=True)
    return losses


if __name__ == "__main__":
    main()
