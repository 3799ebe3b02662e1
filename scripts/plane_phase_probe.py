#!/usr/bin/env python3
"""Where the plane body's time goes, on one GPU: its phases compiled out.

Builds copies of `csrc/axhelm_plane.cu` (under build/plane_probe/, one
`nvcc` each, all at once), each with one step of the plane kernel left out
(the results are wrong by design; only the times are read): `full` (the
source as it is), `no_A` (x_r and x_s), `no_B` (the per-node factors and
weighted components), `no_C` (Ypart's products) and `no_ABC` (all three:
what is left is the two line launches and the plane kernel's staging,
barriers and stores).  Each is timed on the trilinear and precomputed fp32
entry points at N1 = 25, 32 and 48 (the 4x4x4 box, E = 64, c = 1, Poisson),
a CUDA graph of 50 calls, the median of 5 replays (`chip_smoke.graph_ms`);
a phase's cost is `full` less the copy without it.  Prints one JSON line
and writes it to plane_phase_probe.json in the output directory.

Run:  python3 scripts/plane_phase_probe.py
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCE = ROOT / "src/repro_torch/kernels/axhelm/csrc/axhelm_plane.cu"
WORK = ROOT / "build" / "plane_probe"
# (first line, the line after) of each step of the plane kernel
STEPS = {
    "A": ("    {  // A. x_r(j, i)", "    __syncthreads();\n\n    // B. per node"),
    "B": ("#pragma unroll 2\n    for (int q = threadIdx.x; q < nc; "
          "q += blockDim.x) {\n      const int j = q / n1, i = q % n1, at",
          "    __syncthreads();\n\n    // C. s_t over T"),
    "C": ("#pragma unroll 2\n    for (int m = 0; m < n1; ++m) {\n"
          "      float rj[kReg]",
          "#pragma unroll\n    for (int u = 0; u < kReg; ++u) {\n"
          "#pragma unroll\n      for (int v = 0; v < kReg; ++v) {\n"
          "        if (jv[u] && iv[v]) a.ypart"),
}
COPIES = {"full": "", "no_A": "A", "no_B": "B", "no_C": "C", "no_ABC": "ABC"}


def without(src: str, steps: str) -> str:
    """The source with the given steps of the plane kernel left out."""
    for step in steps:
        start, end = STEPS[step]
        i = src.index(start)
        j = src.index(end, i)
        src = src[:i] + src[j:]
    return src.replace('#include "axhelm_common.cuh"',
                       f'#include "{SOURCE.parent / "axhelm_common.cuh"}"')


def main() -> None:
    import torch

    from repro_torch.core import axhelm as core_axhelm
    from repro_torch.core import mesh_gen
    from repro_torch.core.spectral import basis
    from repro_torch.kernels.axhelm import build, ops
    from chip_smoke import graph_ms

    if not torch.cuda.is_available():
        sys.exit("plane_phase_probe: no CUDA device")
    WORK.mkdir(parents=True, exist_ok=True)
    src = SOURCE.read_text()
    procs = {}
    for name, steps in COPIES.items():
        (WORK / f"{name}.cu").write_text(without(src, steps))
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
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
    out = {"card": smi, "E": 64, "ncols": 1, "us": {}}
    for order in (24, 31, 47):
        b = basis(order)
        box = mesh_gen.box_mesh(4, 4, 4, order)
        mesh = mesh_gen.deform_trilinear(box, seed=3)
        verts = torch.as_tensor(mesh.verts, dtype=torch.float32, device=dev)
        dhat, xi, w3 = ops._constants(order, torch.float32, dev)
        x = torch.randn((len(mesh.verts), 1, 1) + (b.n1,) * 3, device=dev,
                        generator=torch.Generator(dev).manual_seed(order))
        y = torch.empty_like(x)
        scratch = torch.empty(
            ops.plane_launch(b.n1, len(mesh.verts), 1).scratch_bytes // 4,
            device=dev)
        for variant in ("trilinear", "precomputed"):
            elem_ops, _, _ = core_axhelm.make_axhelm_elem_ops(
                variant, b, verts, backend="cuda", device=dev)
            geom = elem_ops.pop("geom")
            row = {}
            for name in COPIES:
                fn = getattr(ctypes.CDLL(str(WORK / f"lib{name}.so")),
                             f"axhelm_{variant}_f32_plane")
                fn.argtypes = [ptr] * 9 + [i32] * 4 + [ptr]

                def call():
                    rc = fn(x.data_ptr(), y.data_ptr(), geom.data_ptr(),
                            None, None, dhat.data_ptr(), xi.data_ptr(),
                            w3.data_ptr(), scratch.data_ptr(), b.n1,
                            len(mesh.verts), 1, 0,
                            torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"{name}: CUDA error {rc}")
                row[name] = 1e3 * graph_ms(call)
            out["us"][f"{variant}/N1={b.n1}"] = row
    print(json.dumps(out), flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "plane_phase_probe.json").write_text(
        json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
