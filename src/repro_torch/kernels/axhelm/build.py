"""Build the axhelm CUDA kernels with ``nvcc`` and bind them with ctypes.

The sources under ``csrc/`` have a plain C interface (no PyTorch headers;
``<cuda_bf16.h>`` for the bf16 storage type): ``axhelm.cu`` holds the
generic body of every variant at any N1 (``*_any`` entry points) and the
one-thread-per-node body (K1-K5 as timing-only ``*_rowwise`` entry
points), ``axhelm_column.cu`` the one-thread-per-column body (K2, K5),
``axhelm_line.cu`` the one-thread-per-line body (K1, K3, K4),
``axhelm_plane.cu`` the body that runs an element's contractions as
register-tiled products, its t-planes a block each (every variant above the
generic body's N1, ``*_plane`` entry points), ``axhelm_slab.cu`` the body
that runs them as register-tiled products a slab of t-planes a block,
with the whole element staged (N1 = 17 to 24, ``*_slab`` entry points;
its last launch is a kernel of its own, a thread a line, for the plane
body's transposed t contraction), ``axhelm_staged.cu`` the body
that stages an element's contractions through device memory, on the tensor
cores (every variant above the plane body's N1, ``*_staged`` entry points),
all six including
``axhelm_common.cuh``.  One ``nvcc -c`` per
source, or per part of a source that ``PARTS`` splits (the column and line
bodies' instantiations at N1 = 2 to 16, ``-DAXHELM_PART=p``), runs at the
same time, then one link makes the shared library,
``build/kernels/libaxhelm_<hash>.so`` at the repository root, keyed by every
source and header and the flags; a build takes seconds and happens at first
use: nothing here runs at import.  A missing ``nvcc`` or a failed build
raises; nothing falls back.  The ``-Xptxas -v`` report (registers, shared
memory and spills of every instantiation) is kept beside the library, see
:func:`ptxas_report`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["SOURCES", "HEADERS", "PARTS", "NVCC_FLAGS", "LINK_FLAGS",
           "SIGNATURES", "QUERIES", "units", "symbol", "library_path", "build",
           "library", "ptxas_report", "ptxas_instantiations",
           "STAGED_SHARED_PASSES", "STAGED_VARIANT_PASSES",
           "PLANE_SHARED_PASSES", "PLANE_VARIANT_PASSES",
           "SLAB_SHARED_PASSES", "SLAB_VARIANT_PASSES"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "axhelm.cu", _CSRC / "axhelm_column.cu",
           _CSRC / "axhelm_line.cu", _CSRC / "axhelm_plane.cu",
           _CSRC / "axhelm_slab.cu", _CSRC / "axhelm_staged.cu")
HEADERS = (_CSRC / "axhelm_common.cuh",)
# Sources compiled in several parts, by file name: each part instantiates
# some of the N1 (the AXHELM_*_PART<p> lists in the source), so that the
# parts compile at the same time; part 0 holds the entry points.
PARTS = {"axhelm_column.cu": 5, "axhelm_line.cu": 5}
_BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
_TARGET = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_TARGET, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
LINK_FLAGS = (*_TARGET, "-shared")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (searched PATH, $CUDA_HOME and "
                       "/usr/local/cuda): the axhelm CUDA kernels cannot be "
                       "built")


def units() -> list[tuple[Path, list[str], str]]:
    """Each `nvcc -c` of a build: (source, its extra flags, object stem)."""
    out = []
    for src in SOURCES:
        parts = PARTS.get(src.name, 1)
        if parts == 1:
            out.append((src, [], src.stem))
        else:
            out += [(src, [f"-DAXHELM_PART={p}"], f"{src.stem}_p{p}")
                    for p in range(parts)]
    return out


def library_path() -> Path:
    """Where the library for the current source, parts and flags lives."""
    h = hashlib.sha256()
    for path in SOURCES + HEADERS:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    h.update(repr(sorted(PARTS.items())).encode())
    digest = h.hexdigest()[:16]
    return _BUILD_DIR / f"libaxhelm_{digest}.so"


def _report_path() -> Path:
    return library_path().with_suffix(".ptxas.txt")


def _run(procs) -> str:
    """Wait for every nvcc process; raise on the first failure."""
    outs = [(cmd, *p.communicate(), p.returncode) for cmd, p in procs]
    for cmd, out, err, rc in outs:
        if rc != 0:
            raise RuntimeError(f"nvcc failed with exit code {rc}:\n"
                               f"{' '.join(cmd)}\n{out}{err}")
    return "".join(out + err for _, out, err, _ in outs)


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


@functools.cache
def build() -> Path:
    """Compile the kernels unless these sources are already built; return
    the library path.  Every source (every part of one) compiles at the
    same time, into a
    scratch directory that is removed afterwards; the library and the
    ptxas report are written under temporary names and moved into place,
    so a concurrent build (ranks building at the same moment) never
    exposes a partial file."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(prefix=f".{out.stem}.", dir=out.parent))
    try:
        jobs = [(src, flags, work / f"{stem}.o")
                for src, flags, stem in units()]
        objs = [obj for _, _, obj in jobs]
        report = _run([_start([nvcc, *NVCC_FLAGS, *flags, "-c", "-o",
                               str(obj), str(src)])
                       for src, flags, obj in jobs])
        tmp = work / out.name
        _run([_start([nvcc, *LINK_FLAGS, "-o", str(tmp),
                      *map(str, objs)])])
        tmp_report = work / _report_path().name
        tmp_report.write_text(report)
        os.replace(tmp_report, _report_path())
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
_VARIANTS = ("precomputed", "trilinear", "parallelepiped", "merged",
             "partial")
# The C argument types of each entry point, axhelm_<name>_<suffix> with the
# "_rowwise" of a timing-only twin moved behind the suffix.
SIGNATURES = {
    # x, y, geom (planar), lam0, lam1, consts (host) | n1, n_elem, ncols,
    # helmholtz, elems_per_block, grid | stream
    "precomputed": [_PTR] * 6 + [_I32] * 6 + [_PTR],
    # x, y, verts, lam0, lam1, w3, consts (host) | n1, n_elem, ncols,
    # helmholtz, elems_per_block, grid | stream
    "trilinear": [_PTR] * 7 + [_I32] * 6 + [_PTR],
    # x, y, gelem, lam0, lam1, w3, consts (host) | n1, n_elem, ncols,
    # helmholtz, elems_per_block, grid | stream
    "parallelepiped": [_PTR] * 7 + [_I32] * 6 + [_PTR],
    # x, y, verts, lam2, lam3, consts (host) | n1, n_elem, ncols,
    # elems_per_block, grid | stream
    "merged": [_PTR] * 6 + [_I32] * 5 + [_PTR],
    # x, y, verts, gscale, consts (host) | n1, n_elem, ncols,
    # elems_per_block, grid | stream
    "partial": [_PTR] * 5 + [_I32] * 5 + [_PTR],
    # the one-thread-per-node body, timing only:
    # x, y, geom (planar), lam0, lam1, dhat | n1, n_elem, ncols, helmholtz |
    # stream
    "precomputed_rowwise": [_PTR] * 6 + [_I32] * 4 + [_PTR],
    # x, y, verts, lam0, lam1, dhat, xi, w3 | n1, n_elem, ncols, helmholtz |
    # stream
    "trilinear_rowwise": [_PTR] * 8 + [_I32] * 4 + [_PTR],
    # x, y, gelem, lam0, lam1, dhat, w3 | n1, n_elem, ncols, helmholtz |
    # stream
    "parallelepiped_rowwise": [_PTR] * 7 + [_I32] * 4 + [_PTR],
    # x, y, verts, lam2, lam3, dhat, xi | n1, n_elem, ncols | stream
    "merged_rowwise": [_PTR] * 7 + [_I32] * 3 + [_PTR],
    # x, y, verts, gscale, dhat, xi | n1, n_elem, ncols | stream
    "partial_rowwise": [_PTR] * 6 + [_I32] * 3 + [_PTR],
    # the generic body, any N1 up to ops.N1_MAX, one signature for all five:
    # x, y, geom, lam0, lam1, dhat, xi, w3 | n1, n_elem, ncols, helmholtz |
    # stream (merged: Lam2, Lam3 in the lambda slots; partial: gScale in
    # lam0)
    **{f"{variant}_any": [_PTR] * 8 + [_I32] * 4 + [_PTR]
       for variant in _VARIANTS},
    # the staged body, N1 above ops.N1_PLANE_MAX, the generic body's
    # arguments, D-hat's split in the dhat slot, plus the fp32 scratch: x,
    # y, geom, lam0, lam1, fragments (ops.staged_fragments), xi, w3,
    # scratch | n1, n_elem, ncols, helmholtz | stream
    **{f"{variant}_staged": [_PTR] * 9 + [_I32] * 4 + [_PTR]
       for variant in _VARIANTS},
    # the plane body, N1 above ops.N1_MAX up to ops.N1_PLANE_MAX, the staged
    # body's arguments: x, y, geom, lam0, lam1, dhat, xi, w3, scratch | n1,
    # n_elem, ncols, helmholtz | stream
    **{f"{variant}_plane": [_PTR] * 9 + [_I32] * 4 + [_PTR]
       for variant in _VARIANTS},
    # the slab body, N1 from ops.N1_TUNED_MAX + 1 up to ops.N1_SLAB_MAX,
    # the plane body's arguments
    **{f"{variant}_slab": [_PTR] * 9 + [_I32] * 4 + [_PTR]
       for variant in _VARIANTS},
}


# Entry points with one symbol for both storage types: the line body's blocks
# an SM at an instantiation (geometry source, bf16, n1), from the occupancy
# calculator
QUERIES = {"axhelm_line_blocks_per_sm": [_I32] * 3}


def symbol(name: str, suffix: str) -> str:
    """The C symbol of SIGNATURES entry `name` for storage `suffix`, e.g.
    ``axhelm_partial_bf16_rowwise``."""
    variant, _, body = name.partition("_")
    return f"axhelm_{variant}_{suffix}" + (f"_{body}" if body else "")


@functools.cache
def library() -> ctypes.CDLL:
    """The built library with the C signature of every entry point,
    ``axhelm_<variant>_f32`` and ``axhelm_<variant>_bf16``, of the generic
    body's ``axhelm_<variant>_<suffix>_any``, of the plane body's
    ``axhelm_<variant>_<suffix>_plane``, of the slab body's
    ``axhelm_<variant>_<suffix>_slab``, of the staged body's
    ``axhelm_<variant>_<suffix>_staged``, of the timing-only
    ``axhelm_<variant>_<suffix>_rowwise`` and of `QUERIES`, declared."""
    lib = ctypes.CDLL(str(build()))
    for suffix in ("f32", "bf16"):
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, symbol(name, suffix))
            fn.argtypes = argtypes
            fn.restype = _I32
    for name, argtypes in QUERIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I32
    return lib


def ptxas_report() -> str:
    """The ``-Xptxas -v`` output of the build (builds first if needed)."""
    build()
    path = _report_path()
    return path.read_text() if path.exists() else ""


# the staged body's kernels (ptxas_instantiations' "pass"): the five
# contractions every variant shares, and each variant's t gradient with its
# factors
STAGED_SHARED_PASSES = ("grad_r", "grad_s", "first_r", "accumulate_s",
                        "last_t")
STAGED_VARIANT_PASSES = ("grad_t",)
# the plane body's kernels (ptxas_instantiations' "pass"): the two line
# contractions every variant shares, and each variant's plane pass
PLANE_SHARED_PASSES = ("line_first", "line_last")
PLANE_VARIANT_PASSES = ("plane",)
# the slab body's kernels: the transposed t contraction every variant
# shares, and each variant's pass over its slabs
SLAB_SHARED_PASSES = ("last",)
SLAB_VARIANT_PASSES = ("slab",)


def ptxas_instantiations(report: str):
    """Per kernel instantiation of a `-Xptxas -v` report: its variant, body
    ("node": axhelm_kernel, "column": axhelm_column_kernel, "line":
    axhelm_line_kernel, "any": the generic axhelm_any_kernel, "slab":
    axhelm_slab_kernel and axhelm_slab_last_kernel, "plane":
    axhelm_plane_kernel and axhelm_plane_line_kernel, "staged":
    axhelm_staged_contract_kernel and axhelm_staged_grad_t_kernel), N1
    (None for the generic, slab, plane and staged bodies, whose N1 is a
    runtime argument), storage dtype, registers, shared memory and spill
    bytes; a slab, plane or staged kernel also its "pass" (see
    SLAB_SHARED_PASSES, PLANE_SHARED_PASSES and STAGED_SHARED_PASSES, whose
    kernels have variant None); {"kernel": name} for an entry function of
    another name."""
    inst, cur = [], None
    dirs, modes = "rst", ("grad", "first", "accumulate", "last")
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            # axhelm_kernel<N1, GeomSource, T>, axhelm_column_kernel<...> and
            # axhelm_line_kernel<...> mangle as
            # ILi<N1>E...GeomSourceE<n>E<T>E, T = f or 13__nv_bfloat16, and
            # axhelm_any_kernel<GeomSource, T>, axhelm_slab_kernel<...> and
            # axhelm_plane_kernel<...> as I...GeomSourceE<n>E<T>E;
            # axhelm_slab_last_kernel<T> as I<T>E;
            # axhelm_plane_line_kernel<LAST, T> as ILb<LAST>E<T>E;
            # axhelm_staged_contract_kernel<DIR, MODE, T> as
            # ILi<DIR>ELi<MODE>E<T>E and axhelm_staged_grad_t_kernel<
            # GeomSource, T> as the generic's
            k = re.search(r"axhelm_(column_|line_|any_|slab_|plane_)?kernelI"
                          r"(?:Li(\d+)E)?"
                          r".*?GeomSourceE?(\d+)E(f|\d+__nv_bfloat16)E",
                          m.group(1))
            st = re.search(r"axhelm_staged_(contract|grad_t)_kernelI"
                           r"(?:Li(\d)ELi(\d)E)?"
                           r"(?:.*?GeomSourceE?(\d+)E)?(f|\d+__nv_bfloat16)E",
                           m.group(1))
            pl = re.search(r"axhelm_plane_line_kernelILb([01])E"
                           r"(f|\d+__nv_bfloat16)E", m.group(1))
            sl = re.search(r"axhelm_slab_last_kernelI(f|\d+__nv_bfloat16)E",
                           m.group(1))
            cur = {"kernel": m.group(1)}
            if sl:
                cur = {"variant": None, "body": "slab",
                       "pass": SLAB_SHARED_PASSES[0], "n1": None,
                       "dtype": "f32" if sl.group(1) == "f" else "bf16"}
            elif pl:
                cur = {"variant": None, "body": "plane",
                       "pass": PLANE_SHARED_PASSES[int(pl.group(1))],
                       "n1": None,
                       "dtype": "f32" if pl.group(2) == "f" else "bf16"}
            elif k:
                cur = {"variant": _VARIANTS[int(k.group(3))],
                       "body": (k.group(1) or "node_").rstrip("_"),
                       "n1": int(k.group(2)) if k.group(2) else None,
                       "dtype": "f32" if k.group(4) == "f" else "bf16"}
                if cur["body"] in ("plane", "slab"):
                    cur["pass"] = cur["body"]
            elif st:
                step = "grad_t" if st.group(1) == "grad_t" else \
                    f"{modes[int(st.group(3))]}_{dirs[int(st.group(2))]}"
                cur = {"variant": None if step in STAGED_SHARED_PASSES
                       else _VARIANTS[int(st.group(4))],
                       "body": "staged", "pass": step, "n1": None,
                       "dtype": "f32" if st.group(5) == "f" else "bf16"}
            inst.append(cur)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem_bytes"] = int(m.group(1)) if m else 0
    return inst
