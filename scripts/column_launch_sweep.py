#!/usr/bin/env python3
"""Launch settings of the K2/K5 column body on one GPU: for each (threads a
block, blocks an SM) it builds `csrc/axhelm_column.cu` with those two
constants (kColumnThreads, kColumnMinBlocks) into `build/column_sweep/`,
reads the -Xptxas -v registers and spills, checks K2 and K5 against their
plain version, and times them (fp32 and bf16, E=4096 and E=32768, N1=8,
c=1 and 3) from a replayed CUDA graph, in turns with the shipped setting.
The shipped source is not changed.  Prints one JSON line per setting and
per timing; writes them all to chiprun_out/column_launch_sweep.json.

Run:  python3 scripts/column_launch_sweep.py [--settings 128:4,256:2,...]
"""

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("column_launch_sweep: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke
    from repro_torch.core import axhelm as core_axhelm
    from repro_torch.core import mesh_gen
    from repro_torch.core.spectral import basis
    from repro_torch.kernels.axhelm import build, ops

    csrc = ROOT / "src/repro_torch/kernels/axhelm/csrc"
    text = (csrc / "axhelm_column.cu").read_text()
    shipped = (int(re.search(r"kColumnThreads = (\d+);", text).group(1)),
               int(re.search(r"kColumnMinBlocks = (\d+);", text).group(1)))
    ap = argparse.ArgumentParser()
    ap.add_argument("--settings", default="128:4,128:3,128:5,256:2,256:1,"
                                          "64:8")
    args = ap.parse_args()
    settings = [tuple(map(int, s.split(":")))
                for s in args.settings.split(",")]
    if shipped not in settings:
        settings.insert(0, shipped)
    out_dir = ROOT / "build" / "column_sweep"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    for path in build.SOURCES + build.HEADERS:
        if path.name != "axhelm_column.cu":
            shutil.copy(path, out_dir / path.name)
    others = tuple(out_dir / p.name for p in build.SOURCES
                   if p.name != "axhelm_column.cu")
    headers = tuple(out_dir / p.name for p in build.HEADERS)
    lines = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    emit({"card": smi, "shipped": shipped})

    def use(setting):
        threads, blocks = setting
        path = out_dir / f"axhelm_column_t{threads}b{blocks}.cu"
        path.write_text(text.replace(
            f"kColumnThreads = {shipped[0]};", f"kColumnThreads = {threads};")
            .replace(f"kColumnMinBlocks = {shipped[1]};",
                     f"kColumnMinBlocks = {blocks};"))
        build.SOURCES = others + (path,)
        build.PARTS[path.name] = build.PARTS["axhelm_column.cu"]
        build.HEADERS = headers
        build.build.cache_clear()
        build.library.cache_clear()
        ops.COLUMN_THREADS = threads

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def operands(variant, mesh, e, ncols, dt, n=7):
        b = basis(n)
        verts = torch.as_tensor(mesh.verts[:e], dtype=torch.float32,
                                device=dev)
        x = torch.as_tensor(rng.standard_normal((e, ncols) + (b.n1,) * 3),
                            dtype=torch.float32, device=dev).to(dt)
        elem_ops, _, _ = core_axhelm.make_axhelm_elem_ops(
            variant, b, verts, dtype=dt, backend="cuda", device=dev)
        geom = elem_ops.pop("geom")
        return b, x, geom, elem_ops

    small = {n: mesh_gen.deform_trilinear(mesh_gen.box_mesh(17, 17, 15, n),
                                          seed=3) for n in (3, 7)}
    for setting in settings:
        use(setting)
        build.build()
        build.library()
        inst = [c for c in build.ptxas_instantiations(
            build.ptxas_report()) if c.get("body") == "column"]
        worst = {}
        for n in (3, 7):
            for e in (37, 4099):
                for variant in ops.COLUMN_VARIANTS:
                    for dt in (torch.float32, torch.bfloat16):
                        for ncols in (1, 3):
                            b, x, geom, kw = operands(variant, small[n], e,
                                                      ncols, dt, n)
                            y = ops.axhelm(x, b, variant, geom, **kw).float()
                            y_p = ops.reference(x, b, variant, geom,
                                                **kw).float()
                            key = ops.entry_point(variant, dt)
                            worst[key] = max(worst.get(key, 0.0), float(
                                (y - y_p).abs().max() / y_p.abs().max()))
        emit({"threads": setting[0], "min_blocks": setting[1],
              "instantiations": inst, "worst_rel_err": worst})

    for nx in (16, 32):
        mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(nx, nx, nx, 7),
                                         seed=3)
        e = len(mesh.verts)
        for dt in (torch.float32, torch.bfloat16):
            for variant in ops.COLUMN_VARIANTS:
                for ncols in (1, 3):
                    b, x, geom, kw = operands(variant, mesh, e, ncols, dt)
                    times = {}
                    # in turns: the settings forward, then backward
                    for setting in settings + settings[::-1]:
                        use(setting)
                        key = f"{setting[0]}:{setting[1]}"
                        times.setdefault(key, []).append(chip_smoke.graph_ms(
                            lambda: ops.axhelm(x, b, variant, geom, **kw)))
                    emit({"E": e, "entry_point": ops.entry_point(variant,
                                                                 dt),
                          "ncols": ncols,
                          "ms": {k: sum(v) / len(v) for k, v in
                                 times.items()}})
                    del x, geom
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "column_launch_sweep.json").write_text(
        json.dumps(lines, indent=1))


if __name__ == "__main__":
    main()
