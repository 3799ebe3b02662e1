#!/usr/bin/env python3
"""Where the slab body's time goes, on one GPU: its launches alone and its
steps compiled out.

Builds copies of `csrc/axhelm_slab.cu` (under build/slab_probe/, one `nvcc`
each, all at once), each without one part of an application (the results are wrong by design;
only the times are read): `full` (the source as it is), `launch1` (launch
2 left out), `launch2` (launch 1 left out), `no_X` (the staging of x),
`no_A` (x_r, x_s and x_t), `no_B` (the per-node factors and weighted
components), `no_C` (Ypart's products), `no_ABC` (all three: what is
left is the staging, the barriers, the stores and launch 2) and `bare`
(launch 1 without the staging of x and the three steps: its launch,
D-hat's staging, the barriers and the S_t stores).  Each is
timed on the trilinear and precomputed fp32 entry points and the
trilinear bf16 one at N1 = 17, 20 and 24 (the 6x6x6 box, E = 216, c = 1,
Poisson), a CUDA graph of 50 calls, the median of 5 replays
(`chip_smoke.graph_ms`); a step's cost is `full` less the copy without
it.  Prints one JSON line and writes it to slab_phase_probe.json in the
output directory.

Run:  python3 scripts/slab_phase_probe.py
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "src/repro_torch/kernels/axhelm/csrc"
SOURCE = CSRC / "axhelm_slab.cu"
WORK = ROOT / "build" / "slab_probe"
ORDERS = (16, 19, 23)
BOX = (6, 6, 6)
# (first text, the text after, what stands in their place) of each part an
# application can go without; the second is kept
PARTS = {
    "X": ("stage_x(s_xa, a.x + e * a.ncols * np, np)", ";\n  stage_dhat", "0"),
    "X2": ("stage_x(s_xa, a.x + off, np)", ";\n    }\n    cp_async_wait",
           "shift"),
    "A": ("    if (pv) {  // A. x_r", "    __syncthreads();\n\n    // B.", ""),
    "B": ("    // B. per node column", "    __syncthreads();\n\n    // C.", ""),
    "C": ("    if (pv) {\n      const float* x_p = s_x + (k0 + tp) * nc;\n"
          "      const float* r_p",
          "  }\n}\n\n// Launch 2:",
          ""),
    "launch2": ("  if (err == cudaSuccess) {\n    const int64_t lines",
                "  return static_cast<int>(err);\n}\n\n}  // namespace", ""),
    "launch1": ("    slab<<<", "    err = cudaGetLastError();\n  }\n"
                "  if (err == cudaSuccess) {\n    const int64_t lines", ""),
}
COPIES = {"full": (), "launch1": ("launch2",), "launch2": ("launch1",),
          "no_X": ("X", "X2"), "no_A": ("A",), "no_B": ("B",),
          "no_C": ("C",), "no_ABC": ("A", "B", "C"),
          "bare": ("launch2", "X", "X2", "A", "B", "C")}
ENTRIES = (("trilinear", "f32"), ("precomputed", "f32"), ("trilinear", "bf16"))


def without(src: str, parts) -> str:
    """The source without the given parts of an application."""
    for part in parts:
        start, end, instead = PARTS[part]
        i = src.index(start)
        j = src.index(end, i)
        src = src[:i] + instead + src[j:]
    return src.replace('#include "axhelm_common.cuh"',
                       f'#include "{CSRC / "axhelm_common.cuh"}"')


def main() -> None:
    import torch

    from repro_torch.core import axhelm as core_axhelm
    from repro_torch.core import mesh_gen
    from repro_torch.core.spectral import basis
    from repro_torch.kernels.axhelm import build, ops
    from chip_smoke import graph_ms

    if not torch.cuda.is_available():
        sys.exit("slab_phase_probe: no CUDA device")
    WORK.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    src = SOURCE.read_text()
    procs = {}
    for name, parts in COPIES.items():
        (WORK / f"{name}.cu").write_text(without(src, parts))
        cmd = [nvcc, *build.NVCC_FLAGS, "-shared", "-o",
               str(WORK / f"lib{name}.so"), str(WORK / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"{name}: nvcc failed\n{err[-3000:]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    dev = torch.device("cuda")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    box = mesh_gen.box_mesh(*BOX, 1)
    mesh = mesh_gen.deform_trilinear(box, seed=3)
    verts = torch.as_tensor(mesh.verts, dtype=torch.float32, device=dev)
    e = len(mesh.verts)
    out = {"card": smi, "E": e, "ncols": 1, "us": {}}
    for order in ORDERS:
        b = basis(order)
        x32 = torch.randn((e, 1, 1) + (b.n1,) * 3, device=dev,
                          generator=torch.Generator(dev).manual_seed(order))
        scratch = torch.empty(ops.slab_launch(b.n1, e, 1).scratch_bytes // 4,
                              device=dev)
        for variant, dt in ENTRIES:
            dtype = dtypes[dt]
            x = x32.to(dtype)
            y = torch.empty_like(x)
            dhat, xi, w3 = ops._constants(order, dtype, dev)
            elem_ops, _, _ = core_axhelm.make_axhelm_elem_ops(
                variant, b, verts, dtype=dtype, backend="cuda", device=dev)
            geom = elem_ops.pop("geom")
            row = {}
            for name in COPIES:
                fn = getattr(ctypes.CDLL(str(WORK / f"lib{name}.so")),
                             f"axhelm_{variant}_{dt}_slab")
                fn.argtypes = [ptr] * 9 + [i32] * 4 + [ptr]

                def call():
                    rc = fn(x.data_ptr(), y.data_ptr(), geom.data_ptr(),
                            None, None, dhat.data_ptr(), xi.data_ptr(),
                            w3.data_ptr(), scratch.data_ptr(), b.n1, e, 1, 0,
                            torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"{name}: CUDA error {rc}")
                row[name] = 1e3 * graph_ms(call)
            out["us"][f"{variant}_{dt}/N1={b.n1}"] = row
    print(json.dumps(out), flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "slab_phase_probe.json").write_text(
        json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
