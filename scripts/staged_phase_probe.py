#!/usr/bin/env python3
"""Where the staged body's time goes, on one GPU: each launch alone.

For each source tree given (default: this one), builds copies of the tree's
`csrc/axhelm_staged.cu` (under build/staged_probe/, one `nvcc` each, all at
once): `full` (the source as it is) and, for each launch of an application
(each `contract<...>(...)` call of the launcher, and the pointwise
`axhelm_staged_factors_kernel` launch where the source has one), a copy in
which the launcher issues that launch alone (the others replaced by a
success code; the results are wrong by design, only the times are read),
and, where the source's products sit behind the marker `PRODUCTS`, the
same copies with the products compiled out (`<launch>_no_products`): a
launch's products cost its time less that copy's.
Each copy's trilinear (K2) and precomputed (K1) fp32 entry points are
called through the tree's own `ops.axhelm` (its operands, scratch and
constants), Poisson, c = 1, on the 2x2x2 box (E = 8) at orders 48, 63 and
95 (N1 = 49, 64, 96), and timed as a CUDA graph of 50 calls, the median of
5 replays (`chip_smoke.graph_ms` of that tree).  A launch's time is its
copy's; `full` less the sum of the launches is what the gaps between them
cost.  Each tree runs in a process of its own with its `src` first on the
path.  Prints one JSON line a tree and writes them all to
staged_phase_probe.json in the output directory.

Run:  python3 scripts/staged_phase_probe.py [TREE ...]
      (e.g. build/parent . after `git archive <commit> | tar -x -C
      build/parent`)
"""

import json
import re
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = "src/repro_torch/kernels/axhelm/csrc"
ORDERS = (48, 63, 95)
BOX = (2, 2, 2)
VARIANTS = ("trilinear", "precomputed")
# a launch of the launcher: a contraction, or the pointwise pass of a
# source that has one (its whole statement)
CONTRACT = re.compile(r"\bcontract<([^;<>]*?)>\([^;]*?\)")
FACTORS = re.compile(r"axhelm_staged_factors_kernel<SRC, T>\s*<<<[^;]*;")
# the guard of the tensor-core products in the source; made false, it
# compiles them out
PRODUCTS = "      if (mt0 < m_tiles) {"
DIRS = {"kDirR": "r", "kDirS": "s", "kDirT": "t"}
MODES = {"kGrad": "grad", "kFirst": "first", "kAccumulate": "accumulate",
         "kLast": "last"}


def launches(src: str) -> list:
    """(label, span) of each launch in the source, in order."""
    found = [(m.start(), m.end(), m.group(1)) for m in CONTRACT.finditer(src)]
    found += [(m.start(), m.end(), None) for m in FACTORS.finditer(src)]
    out = []
    for start, end, args in sorted(found):
        if args is None:
            label = "factors"
        else:
            words = [w.strip() for w in args.split(",")]
            label = f"{MODES[words[1]]}_{DIRS[words[0]]}"
        out.append((label, (start, end)))
    return out


def alone(src: str, keep: int, header: Path) -> str:
    """The source with every launch but number `keep` replaced by a success
    code."""
    spans = launches(src)
    for i, (label, (start, end)) in reversed(list(enumerate(spans))):
        if i == keep:
            continue
        stub = "(void)0;" if label == "factors" else "cudaSuccess"
        src = src[:start] + stub + src[end:]
    return src.replace('#include "axhelm_common.cuh"',
                       f'#include "{header}"')


def worker(tree: Path) -> dict:
    """The split of one tree, in this process."""
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(tree))
    import torch

    from chip_smoke import graph_ms
    from repro_torch.core import axhelm as core_axhelm
    from repro_torch.core import mesh_gen
    from repro_torch.core.spectral import basis
    from repro_torch.kernels.axhelm import build, ops

    source = tree / CSRC / "axhelm_staged.cu"
    header = (tree / CSRC / "axhelm_common.cuh").resolve()
    src = source.read_text()
    labels = [label for label, _ in launches(src)]
    work = ROOT / "build" / "staged_probe" / tree.resolve().name
    work.mkdir(parents=True, exist_ok=True)
    copies = {"full": src.replace('#include "axhelm_common.cuh"',
                                  f'#include "{header}"')}
    copies.update({label: alone(src, i, header)
                   for i, label in enumerate(labels)})
    if PRODUCTS in src:
        without = src.replace(PRODUCTS, PRODUCTS.replace(
            "m_tiles)", "m_tiles && n1 < 0)"))
        copies.update({f"{label}_no_products": alone(without, i, header)
                       for i, label in enumerate(labels)})
    procs = {}
    for name, text in copies.items():
        (work / f"{name}.cu").write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
               str(work / f"lib{name}.so"), str(work / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"{name}: nvcc failed\n{err[-3000:]}")
    import ctypes

    dev = torch.device("cuda")
    out = {"tree": str(tree), "launches": labels, "E": 8, "ncols": 1,
           "us": {}}
    for order in ORDERS:
        b = basis(order)
        mesh = mesh_gen.deform_trilinear(mesh_gen.box_mesh(*BOX, order),
                                         seed=3)
        verts = torch.as_tensor(mesh.verts, dtype=torch.float32, device=dev)
        x = torch.randn((len(mesh.verts),) + (b.n1,) * 3, device=dev,
                        generator=torch.Generator(dev).manual_seed(order))
        for variant in VARIANTS:
            elem_ops, _, _ = core_axhelm.make_axhelm_elem_ops(
                variant, b, verts, backend="cuda", device=dev)
            geom = elem_ops.pop("geom")
            symbol = f"axhelm_{variant}_f32_staged"
            row = {}
            for name in copies:
                fn = getattr(ctypes.CDLL(str(work / f"lib{name}.so")),
                             symbol)
                fn.argtypes = build.SIGNATURES[f"{variant}_staged"]
                fn.restype = ctypes.c_int
                build.library = lambda _fn=fn: types.SimpleNamespace(
                    **{symbol: _fn})
                ops.axhelm(x, b, variant, geom, **elem_ops)
                torch.cuda.synchronize()
                row[name] = 1e3 * graph_ms(
                    lambda: ops.axhelm(x, b, variant, geom, **elem_ops))
            row["gaps"] = row["full"] - sum(row[k] for k in labels)
            out["us"][f"{variant}/N1={b.n1}"] = row
            del geom, elem_ops
        del x, verts
        torch.cuda.empty_cache()
    return out


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        print(json.dumps(worker(Path(sys.argv[2]).resolve())), flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("staged_phase_probe: no CUDA device")
    trees = [Path(t) for t in sys.argv[1:]] or [ROOT]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    lines = [{"card": smi, "trees": [str(t) for t in trees]}]
    print(json.dumps(lines[0]), flush=True)
    for tree in trees:
        run = subprocess.run([sys.executable, __file__, "--worker",
                              str(tree)], capture_output=True, text=True,
                             check=False)
        if run.returncode != 0:
            sys.exit(f"tree {tree} failed:\n{run.stderr[-3000:]}")
        lines.append(json.loads(run.stdout.strip().splitlines()[-1]))
        print(json.dumps(lines[-1]), flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "staged_phase_probe.json").write_text(
        json.dumps(lines, indent=1))


if __name__ == "__main__":
    main()
