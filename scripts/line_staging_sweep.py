#!/usr/bin/env python3
"""Staging and launch settings of the K1/K3/K4 line body on one GPU.

For each K3/K4 setting, `<stager>:<threads a block>:<blocks an SM>:
<stages>`, it builds the three kernel sources into `build/line_sweep/`
with `csrc/axhelm_line.cu` changed in four places: the `Stager` (how a
stage's x, and K4's Lam2 and Lam3, reach shared memory), `kLineThreads`
(also `ops.LINE_THREADS`), `kLineMinBlocks` (the `__launch_bounds__` blocks
an SM, also `ops.LINE_BLOCKS_PER_SM`, the persistent grid's blocks an SM)
and `kStages` (the x buffers; a stage is fetched kStages - 1 ahead).  Two
stagers: `loads`, the shipped one (16-byte vector loads into registers one
stage ahead, stored to the buffer at the top of the stage; 2 stages only),
and `bulk`, held here (1-D bulk copies with an mbarrier a buffer: TMA).
A K1 setting, `<stager>:<threads>:<blocks>:<stages>:<factors>`, adds how
K1's factor planes arrive: `loads`, the shipped way (coalesced loads from
device memory where they are used), or `bulk`, held here (one 1-D bulk
copy an element into a shared buffer a group ahead, kStages buffers with
an mbarrier each), which `with_bulk_factors` patches into the source.  The
shipped source is not changed.

Per setting: the -Xptxas -v registers and spills of the line body, and its
kernels against their plain version (fp32 and bf16, N1 in {4, 8}, E in
{37, 4099}, c in {1, 3}): K3 and K4 for a K3/K4 setting, K1 Poisson and
Helmholtz for a K1 setting.  Then each kernel's time (K3 Poisson, K4
Helmholtz and K1 Poisson, fp32 and bf16, E=4096 and E=32768, N1=8, c=1)
from a replayed CUDA graph, the settings in turns (forward, then
backward), beside the one-thread-per-node body.  A setting that does not
build is reported and left out of the timings.  Prints one JSON line per
setting and per timing;
writes them all to chiprun_out/line_staging_sweep.json.

Run:  python3 scripts/line_staging_sweep.py [--settings bulk:64:8:2,...]
          [--k1-settings loads:64:8:2:bulk,...]
"""

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# The stager with bulk copies: the lanes of warp 0 issue a stage's 1-D bulk
# copies (cp.async.bulk, the TMA unit without a tensor map; N1 k-slabs of x an
# element, and K4's two fields), one each, kStages - 1 stages ahead, into
# buffers whose mbarrier every thread waits on; the primitives as CUTLASS's
# ClusterTransactionBarrier and SM90_BULK_COPY_G2S issue them.
BULK_STAGER = """\
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One arrival completes a phase.  Visible to the async proxy (the bulk
// copies) after the fence and a __syncthreads.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The one arrival of a phase, expecting `bytes` from bulk copies.
__device__ __forceinline__ void mbar_expect_bytes(uint64_t* bar,
                                                  uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// dst (shared) <- src (global), `bytes` a multiple of 16, both addresses
// 16-byte aligned; completes `bytes` on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\\n.reg .pred p;\\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\\n"
        "selp.u32 %0, 1, 0, p;\\n}" : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

template <int N1, GeomSource SRC, typename T>
struct Stager {
  using Smem = LineShared<N1, SRC, T>;
  static constexpr int NC = N1 * N1, NP = Smem::NP, EPB = Smem::EPB;

  // the mbarrier of each x buffer
  __device__ static uint64_t* bar() {
    __shared__ uint64_t b[kStages];
    return b;
  }

  // before the kernel's first __syncthreads
  __device__ void init(Smem& sm) {
    if (threadIdx.x < kStages) mbar_init(&bar()[threadIdx.x]);
  }

  // stage (group g, column c) into x buffer buf and field buffer fbuf
  __device__ void fetch(Smem& sm, const T* x, const T* lam0, const T* lam1,
                        int n_elem, int ncols, int g, int c, int buf,
                        int fbuf) {
    if (threadIdx.x >= 32) return;
    constexpr uint32_t kSlab = NC * sizeof(T), kField = NP * sizeof(T);
    // copies an element: its N1 k-slabs of x, and K4's two fields
    constexpr int kParts = N1 + (SRC == kMerged ? 2 : 0);
    const bool fields = SRC == kMerged && c == 0;
    if (threadIdx.x == 0) {
      mbar_expect_bytes(&bar()[buf],
                        EPB * (N1 * kSlab + (fields ? 2 * kField : 0)));
    }
    __syncwarp();
    for (int q = threadIdx.x; q < EPB * kParts; q += 32) {
      const int l = q / kParts, part = q % kParts;
      const int64_t el = static_cast<int64_t>(g) * EPB + l;
      const int64_t ev = el < n_elem ? el : n_elem - 1;
      if (part < N1) {
        bulk_copy(&sm.x[buf][l][part * Smem::SX],
                  x + (ev * ncols + c) * NP + part * NC, kSlab,
                  &bar()[buf]);
      } else if constexpr (SRC == kMerged) {
        if (fields) {
          bulk_copy(sm.lam[fbuf][l][part - N1],
                    (part == N1 ? lam0 : lam1) + ev * NP, kField,
                    &bar()[buf]);
        }
      }
    }
  }

  // the block's stage number `stage`, column c, is in buffers buf, fbuf
  __device__ void land(Smem& sm, int stage, int c, int buf, int fbuf) {
    mbar_wait(&bar()[buf], (stage / kStages) & 1);
  }
};
"""
_STAGER = re.compile(r"template <int N1, GeomSource SRC, typename T>\n"
                     r"struct Stager \{.*?\n\};\n", re.S)

# K1's factor planes by bulk copies: group g's planes (six, seven for
# Helmholtz: one contiguous span an element) into factor buffer fb, one
# copy an element issued by warp 0 with the group's first column, completing
# on the buffer's mbarrier, which the owners wait on at (B).  Each entry is
# (anchor in the shipped source, the text that replaces it).
_FACTOR_BUFFERS = """\
  static constexpr int F_BUFS = SRC == kPrecomputed ? kStages : 1;
  static constexpr int F_NODES = SRC == kPrecomputed ? NP : 1;
  alignas(16) T f[F_BUFS][EPB][7 * F_NODES];  // K1's factor planes
  uint64_t fbar[F_BUFS];  // the mbarrier of each factor buffer
"""
_FETCH_FACTORS = """\
template <int N1, GeomSource SRC, typename T>
__device__ __forceinline__ void fetch_factors(LineShared<N1, SRC, T>& sm,
                                              const T* geom, int n_elem,
                                              int g, int fb, int helmholtz) {
  using Smem = LineShared<N1, SRC, T>;
  if (threadIdx.x >= 32) return;
  const uint32_t bytes = (helmholtz ? 7 : 6) * Smem::NP * sizeof(T);
  if (threadIdx.x == 0) mbar_expect_bytes(&sm.fbar[fb], Smem::EPB * bytes);
  __syncwarp();
  if (threadIdx.x < Smem::EPB) {
    const int64_t el = static_cast<int64_t>(g) * Smem::EPB + threadIdx.x;
    const int64_t ev = el < n_elem ? el : n_elem - 1;
    bulk_copy(sm.f[fb][threadIdx.x], geom + ev * 7 * Smem::NP, bytes,
              &sm.fbar[fb]);
  }
}

"""
_KERNEL = "template <int N1, GeomSource SRC, typename T>\n__global__ void"
BULK_FACTORS = [
    ("  alignas(16) T lam[LAM_BUFS][EPB][2][LAM_NODES];\n",
     "  alignas(16) T lam[LAM_BUFS][EPB][2][LAM_NODES];\n" + _FACTOR_BUFFERS),
    (_KERNEL, _FETCH_FACTORS + _KERNEL),
    ("  stager.init(sm);\n",
     "  stager.init(sm);\n"
     "  if constexpr (SRC == kPrecomputed) {\n"
     "    if (threadIdx.x < kStages) mbar_init(&sm.fbar[threadIdx.x]);\n"
     "  }\n"),
    ("                   s % kStages, lg % kStages);\n",
     "                   s % kStages, lg % kStages);\n"
     "      if constexpr (SRC == kPrecomputed) {\n"
     "        if (s % ncols == 0) {\n"
     "          fetch_factors<N1, SRC, T>(sm, geom, n_elem, g, lg % kStages,\n"
     "                                    helmholtz);\n"
     "        }\n"
     "      }\n"),
    ("      if constexpr (SRC == kPrecomputed) fp = geom + ev * 7 * NP + t;\n",
     "      if constexpr (SRC == kPrecomputed) {\n"
     "        mbar_wait(&sm.fbar[fbuf], (lg / kStages) & 1);\n"
     "        fp = sm.f[fbuf][le] + t;\n"
     "      }\n"),
    ("(Smem::STAGES_LAM && (misaligned(lam0, kVec) ||\n"
     "                            misaligned(lam1, kVec)))",
     "(Smem::STAGES_LAM && (misaligned(lam0, kVec) ||\n"
     "                            misaligned(lam1, kVec))) ||\n"
     "      (SRC == kPrecomputed && misaligned(geom, 16))"),
]


def with_bulk_factors(text: str) -> str:
    """The line body's source (its Stager already chosen) with K1's factor
    planes staged by bulk copies; the mbarrier and bulk-copy primitives are
    BULK_STAGER's, added before the kernel where the Stager brought none.
    Each anchor must occur exactly once."""
    if "mbar_init" not in text:
        prims = BULK_STAGER[:BULK_STAGER.index(
            "template <int N1, GeomSource SRC, typename T>")]
        text = text.replace(_KERNEL, prims + _KERNEL, 1)
    for anchor, new in BULK_FACTORS:
        if text.count(anchor) != 1:
            raise ValueError(f"anchor found {text.count(anchor)} times in "
                             f"the line body: {anchor!r}")
        text = text.replace(anchor, new)
    return text


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("line_staging_sweep: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke
    from repro_torch.core import axhelm as core_axhelm
    from repro_torch.core import mesh_gen
    from repro_torch.core.spectral import basis
    from repro_torch.kernels.axhelm import build, ops

    csrc = ROOT / "src/repro_torch/kernels/axhelm/csrc"
    text = (csrc / "axhelm_line.cu").read_text()
    shipped_stager = _STAGER.search(text).group(0)
    stagers = {"loads": shipped_stager, "bulk": BULK_STAGER}
    shipped_threads = int(re.search(r"kLineThreads = (\d+);",
                                    text).group(1))
    shipped_blocks = int(re.search(r"kLineMinBlocks = (\d+);",
                                   text).group(1))
    shipped_stages = int(re.search(r"kStages = (\d+);", text).group(1))
    shipped = f"loads:{shipped_threads}:{shipped_blocks}:{shipped_stages}"
    shipped_k1 = shipped + ":loads"
    ap = argparse.ArgumentParser()
    ap.add_argument("--settings", default="bulk:64:8:2,bulk:64:8:3,"
                    "loads:128:4:2,loads:64:8:2,loads:64:10:2,loads:64:12:2")
    ap.add_argument("--k1-settings", default="loads:64:8:2:loads,"
                    "loads:64:10:2:loads,loads:64:12:2:loads,"
                    "loads:128:4:2:loads,loads:64:5:2:bulk,loads:64:6:2:bulk,"
                    "bulk:64:6:2:bulk,bulk:64:8:2:loads")
    args = ap.parse_args()
    settings = [s for s in args.settings.split(",") if s]
    if shipped not in settings:
        settings.insert(0, shipped)
    k1_settings = [s for s in args.k1_settings.split(",") if s]
    if shipped_k1 not in k1_settings:
        k1_settings.insert(0, shipped_k1)
    out_dir = ROOT / "build" / "line_sweep"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    for path in build.SOURCES + build.HEADERS:
        if path.name != "axhelm_line.cu":
            shutil.copy(path, out_dir / path.name)
    others = tuple(out_dir / p.name for p in build.SOURCES
                   if p.name != "axhelm_line.cu")
    headers = tuple(out_dir / p.name for p in build.HEADERS)
    lines = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    emit({"card": smi, "shipped": shipped, "settings": settings,
          "shipped_k1": shipped_k1, "k1_settings": k1_settings})

    def use(setting):
        name, threads, blocks, stages, *factors = setting.split(":")
        source = _STAGER.sub(lambda _: stagers[name], text, count=1).replace(
            f"kLineThreads = {shipped_threads};",
            f"kLineThreads = {threads};").replace(
            f"kLineMinBlocks = {shipped_blocks};",
            f"kLineMinBlocks = {blocks};").replace(
            f"kStages = {shipped_stages};", f"kStages = {stages};")
        if factors == ["bulk"]:
            source = with_bulk_factors(source)
        path = out_dir / ("axhelm_line_" + setting.replace(":", "_") + ".cu")
        path.write_text(source)
        build.SOURCES = others + (path,)
        build.PARTS[path.name] = build.PARTS["axhelm_line.cu"]
        build.HEADERS = headers
        build.build.cache_clear()
        build.library.cache_clear()
        ops.LINE_THREADS = int(threads)
        ops.LINE_BLOCKS_PER_SM = int(blocks)

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    cases = [("parallelepiped", False), ("parallelepiped", True),
             ("merged", True)]

    def operands(variant, mesh, e, ncols, dt, helm, n=7, lams=False):
        b = basis(n)
        n1 = b.n1
        verts = torch.as_tensor(mesh.verts[:e], dtype=torch.float32,
                                device=dev)
        x = torch.as_tensor(rng.standard_normal((e, ncols) + (n1,) * 3),
                            dtype=torch.float32, device=dev).to(dt)
        kw = {}
        if lams:    # random per-node lambda fields (merged: Lam2/Lam3 of them)
            node = (e, n1, n1, n1)
            kw = {"lam0": torch.as_tensor(1 + 0.3 * rng.random(node),
                                          dtype=torch.float32, device=dev),
                  "lam1": torch.as_tensor(0.5 + 0.2 * rng.random(node),
                                          dtype=torch.float32, device=dev)}
        elem_ops, _, _ = core_axhelm.make_axhelm_elem_ops(
            variant, b, verts, helmholtz=helm, dtype=dt, backend="cuda",
            device=dev, **kw)
        geom = elem_ops.pop("geom")
        return b, x, geom, dict(elem_ops, helmholtz=helm)

    def mesh_for(variant, box):
        if variant == "parallelepiped":
            return mesh_gen.deform_affine(box, seed=2)
        return mesh_gen.deform_trilinear(box, seed=3)

    k1_cases = [("precomputed", False), ("precomputed", True)]
    small = {n: mesh_gen.box_mesh(17, 17, 15, n) for n in (3, 7)}
    built = []
    for setting in settings + k1_settings:
        use(setting)
        try:
            build.build()
        except RuntimeError as exc:   # e.g. static shared memory over 48 KB
            emit({"setting": setting, "build_error": str(exc)[-600:]})
            continue
        built.append(setting)
        build.library()
        inst = [c for c in build.ptxas_instantiations(
            build.ptxas_report()) if c.get("body") == "line"]
        worst = {}
        for n in (3, 7):
            for e in (37, 4099):
                for variant, helm in (k1_cases if setting in k1_settings
                                      else cases):
                    mesh = mesh_for(variant, small[n])
                    for dt in (torch.float32, torch.bfloat16):
                        for ncols in (1, 3):
                            b, x, geom, kw = operands(variant, mesh, e, ncols,
                                                      dt, helm, n, lams=helm)
                            y = ops.axhelm(x, b, variant, geom, **kw).float()
                            y_p = ops.reference(x, b, variant, geom,
                                                **kw).float()
                            key = ops.entry_point(variant, dt)
                            worst[key] = max(worst.get(key, 0.0), float(
                                (y - y_p).abs().max() / y_p.abs().max()))
        emit({"setting": setting, "instantiations": inst,
              "worst_rel_err": worst})

    for nx in (16, 32):
        box = mesh_gen.box_mesh(nx, nx, nx, 7)
        for variant, helm in (("parallelepiped", False), ("merged", True),
                              ("precomputed", False)):
            mesh = mesh_for(variant, box)
            e = len(mesh.verts)
            cells = [c for c in (k1_settings if variant == "precomputed"
                                 else settings) if c in built]
            for dt in (torch.float32, torch.bfloat16):
                b, x, geom, kw = operands(variant, mesh, e, 1, dt, helm)
                times = {}
                # in turns: the settings forward, then backward
                for setting in cells + cells[::-1]:
                    use(setting)
                    times.setdefault(setting, []).append(chip_smoke.graph_ms(
                        lambda: ops.axhelm(x, b, variant, geom, **kw)))
                rowwise = chip_smoke.graph_ms(
                    lambda: ops.rowwise(x, b, variant, geom, **kw))
                emit({"E": e, "entry_point": ops.entry_point(variant, dt),
                      "ncols": 1,
                      "ms": {k: sum(v) / len(v) for k, v in times.items()},
                      "turns_ms": times, "ms_rowwise": rowwise})
                del x, geom, kw
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "line_staging_sweep.json").write_text(
        json.dumps(lines, indent=1))


if __name__ == "__main__":
    main()
