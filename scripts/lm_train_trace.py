#!/usr/bin/env python3
"""Where the time of the port's full-width LM train step goes, on one CUDA
device: a step of `launch/train.py --preset full`'s run (qwen3-0.6b, bf16,
remat "full", seq 4096, batch 4 in 2 microbatches, float32 AdamW) under
torch.profiler, after a warm-up step and an unprofiled step.

Prints one JSON line: the step's host wall unprofiled and profiled (each
ending in a synchronize); the device's kernel time by class — matrix
products by the input type in the kernel's name (bf16, float32, other),
elementwise, reductions, softmax, indexing, copies, the rest — with each
class's kernel count; the top kernels by device time; the device's busy
share of the profiled step's span; the kernels and the CUDA launch calls a
step.  Then the card's nvidia-smi name and power limit.  Needs a CUDA
device; imports neither jax nor the reference package.

Run:  python3 scripts/lm_train_trace.py
"""

import json
import re
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
# kernel classes by name, in the order they are tried
CLASSES = [
    ("gemm_bf16", re.compile(r"(gemm|nvjet|xmma|cutlass).*bf16|bf16.*gemm",
                             re.I)),
    ("gemm_f32", re.compile(r"sgemm|(gemm|xmma|cutlass).*f32f32|"
                            r"(gemm|xmma).*tf32|gemm.*_f32_", re.I)),
    ("gemm_other", re.compile(r"gemm|nvjet|xmma|cutlass", re.I)),
    ("softmax", re.compile(r"softmax", re.I)),
    ("reduce", re.compile(r"reduce", re.I)),
    ("index", re.compile(r"index|gather|scatter", re.I)),
    ("copy", re.compile(r"copy|cat_|CatArray|memcpy|memset", re.I)),
    ("elementwise", re.compile(r"elementwise", re.I)),
]


def kernel_class(name: str) -> str:
    for cls, pat in CLASSES:
        if pat.search(name):
            return cls
    return "other"


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("lm_train_trace: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.train import build_run

    run = build_run("qwen3-0.6b", "full", steps=10, device="cuda")
    state = run.state

    def one(i):
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = run.step(state, run.data.batch_at(i))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, float(m["loss"])

    one(0)                                   # warm-up
    plain_ms, _ = one(1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_ms, loss = one(2)
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    launches = [e for e in events if e.device_type == DeviceType.CPU and
                e.name in LAUNCH_CALLS]
    line = {"arch": run.cfg.name, "batch": run.data.batch,
            "seq": run.data.seq, "grad_accum": run.tcfg.grad_accum,
            "remat": run.cfg.remat, "loss": loss,
            "step_ms_unprofiled": plain_ms, "step_ms_profiled": traced_ms,
            "cuda_launch_calls": len(launches)}
    if not kernels:
        line["device"] = "not measured: the profiler saw no CUDA kernels"
    else:
        by_name = defaultdict(lambda: [0, 0.0])
        for e in kernels:
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.time_range.elapsed_us()
        by_class = defaultdict(lambda: [0, 0.0])
        for name, (count, us) in by_name.items():
            cls = by_class[kernel_class(name)]
            cls[0] += count
            cls[1] += us
        busy = sum(us for _, us in by_name.values())
        span = (max(e.time_range.end for e in kernels)
                - min(e.time_range.start for e in kernels))
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:20]
        line.update({
            "kernels": len(kernels), "device_busy_ms": busy / 1e3,
            "device_span_ms": span / 1e3, "device_busy_share": busy / span,
            "by_class": {cls: {"count": c, "ms": us / 1e3,
                               "share": us / busy}
                         for cls, (c, us) in sorted(
                             by_class.items(), key=lambda kv: -kv[1][1])},
            "top_kernels": [{"name": n[:120], "class": kernel_class(n),
                             "count": c, "ms": us / 1e3}
                            for n, (c, us) in top]})
    print(json.dumps(line), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=False)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
