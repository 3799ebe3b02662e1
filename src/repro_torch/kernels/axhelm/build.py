"""Build the axhelm CUDA kernels with ``nvcc`` and bind them with ctypes.

The source ``csrc/axhelm.cu`` has a plain C interface (no PyTorch headers),
so one ``nvcc`` call builds it in seconds.  The shared library lands in
``build/kernels/libaxhelm_<hash>.so`` at the repository root, keyed by the
source and the flags, and is built at first use: nothing here runs at
import.  A missing ``nvcc`` or a failed build raises; nothing falls back.
The ``-Xptxas -v`` report (registers, shared memory and spills of every
instantiation) is kept beside the library, see :func:`ptxas_report`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCE", "NVCC_FLAGS", "library_path", "build", "library",
           "ptxas_report"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "axhelm.cu"
_BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"libaxhelm_{digest}.so"


def _report_path() -> Path:
    return library_path().with_suffix(".ptxas.txt")


@functools.cache
def build() -> Path:
    """Compile the kernels unless this source is already built; return the
    library path.  The library is written under a temporary name and moved
    into place, so a concurrent build never exposes a partial file."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    _report_path().write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The built library with every entry point's C signature declared."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # x, y, geom, lam0, lam1, dhat | n1, n_elem, ncols, helmholtz | stream
    lib.axhelm_precomputed_f32.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
    lib.axhelm_precomputed_f32.restype = i32
    # x, y, verts, lam0, lam1, dhat, xi, w3 | n1, n_elem, ncols, helmholtz | stream
    lib.axhelm_trilinear_f32.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
    lib.axhelm_trilinear_f32.restype = i32
    return lib


def ptxas_report() -> str:
    """The ``-Xptxas -v`` output of the build (builds first if needed)."""
    build()
    path = _report_path()
    return path.read_text() if path.exists() else ""
