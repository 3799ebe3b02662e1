#!/usr/bin/env python3
"""Where the time of the port's MoE, hybrid or xLSTM decode step goes, on
one CUDA device: moonshot-v1-16b-a3b (or, with --arch zamba2-2.7b, the
hybrid family's zamba2; with --arch xlstm-350m, the xLSTM family's) at full
width and full depth (bf16, weights from
`torch.Generator` seed 0) behind `ServeEngine` with `launch/serve.py
--preset full`'s stream (8 slots, max_len 256, 16 requests), stepped until
every slot holds a request; then a decode step unprofiled and one under
torch.profiler.

Prints one JSON line: the step's host wall unprofiled and profiled (each
ending in a synchronize); the host time inside the MoE layers
(`moe.moe_apply`; for zamba2 the Mamba-2 steps, `mamba2.mamba_step`) and
inside decode attention (`transformer.attn_decode`) -- for xlstm-350m
inside the sLSTM and mLSTM steps (`xlstm.slstm_step`, `xlstm.mlstm_step`)
-- and in the rest of the step, from profiler ranges the script puts
around those functions;
the CUDA launch calls and the kernels a step; the device's kernel time by
class (`scripts/lm_train_trace.py`'s classes), its top kernels and its
busy share of the profiled step's span.  Then the
card's nvidia-smi name and power limit.  Needs a CUDA device; imports
neither jax nor the reference package.

Run:  python3 scripts/lm_serve_trace.py [--arch zamba2-2.7b|xlstm-350m]
"""

import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

from lm_train_trace import LAUNCH_CALLS, kernel_class  # noqa: E402

# the architecture's functions traced, each (module of repro_torch.models,
# function name)
_ATTN = ("transformer", "attn_decode")
LAYER_RANGE = {"moonshot-v1-16b-a3b": (("moe", "moe_apply"), _ATTN),
               "zamba2-2.7b": (("mamba2", "mamba_step"), _ATTN),
               "xlstm-350m": (("xlstm", "slstm_step"),
                              ("xlstm", "mlstm_step"))}


def main() -> None:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="moonshot-v1-16b-a3b",
                    choices=sorted(LAYER_RANGE))
    arch = ap.parse_args().arch
    ranges = tuple(fn for _, fn in LAYER_RANGE[arch])

    if not torch.cuda.is_available():
        sys.exit("lm_serve_trace: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import configs
    from repro_torch.launch.serve import build_served_model, make_requests
    import importlib

    from repro_torch.serving.engine import ServeEngine

    def ranged(fn, name):
        def call(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return call

    cfg = configs.get(arch)
    model = build_served_model(cfg, "cuda", seed=0)
    engine = ServeEngine(model, max_len=256, slots=8, eos_id=-1)
    for req in make_requests(cfg.vocab_size, 16, 16):
        engine.submit(req)
    engine.step()                 # admits 8 requests, one decode step
    decode = model.decode_step
    walls = []

    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = decode(*args)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        return out

    model.decode_step = timed
    engine.step()                 # unprofiled
    for module, fn in LAYER_RANGE[arch]:
        mod = importlib.import_module(f"repro_torch.models.{module}")
        setattr(mod, fn, ranged(getattr(mod, fn), fn))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.step()
    events = prof.events()
    # the ranges show on the device's timeline too: they are not kernels
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and
               e.name not in ranges]
    launches = [e for e in events if e.device_type == DeviceType.CPU and
                e.name in LAUNCH_CALLS]
    host = {name: sum(e.cpu_time_total for e in events
                      if e.name == name) / 1e3 for name in ranges}
    line = {"arch": cfg.name, "layers": cfg.num_layers, "slots": 8,
            "active_slots": sum(r is not None for r in engine.active),
            "step_ms_unprofiled": walls[0], "step_ms_profiled": walls[1],
            "host_ms": {**host, "rest": walls[1] - sum(host.values())},
            "range_calls": {name: sum(e.name == name for e in events)
                            for name in ranges},
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
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
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
