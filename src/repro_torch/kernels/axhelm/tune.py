"""Per-configuration launch tuner for the axhelm CUDA kernels.

The counterpart of `repro.kernels.axhelm.tune`.  The reference tunes one
knob, ``block_elems``, the elements a Pallas grid step holds in VMEM.  The
port compiles its launch shapes into each body as constants
(`ops.COLUMN_ELEMS`, `ops.LINE_ELEMS`, every body's ``__launch_bounds__``),
so its knob at run time is which built body launches an entry point at a
given N1 (`candidates`):

  * N1 2-16 (`ops.KERNEL_N1`): the tuned body (column or line), the
    generic, slab, plane and staged bodies;
  * N1 17-24: the slab, generic, plane and staged bodies;
  * N1 25-48: the plane and staged bodies;
  * above 48: the staged body only, so nothing to sweep.

It keeps the reference's structure:

  1. `autotune` times every candidate body of a (variant, N1, dtype,
     Helmholtz, ncols) configuration on the card — CUDA events around the
     replays of a CUDA graph of repeated calls — and caches the winner,
  2. in-process *and* in a JSON file keyed by backend: the card's name and
     compute capability and the digest of the built sources
     (`build.library_path`), so a rebuilt body misses,
  3. resolution (`get_body`) is in-process cache -> JSON cache ->
     `ops.body_of`'s static route, so an untuned process runs exactly the
     static route and never pays for a sweep.  A miss is remembered in
     process (the JSON file is read once a configuration, not at every
     launch); `clear` forgets both.

The cache file is `cache_path()`: ``$REPRO_TORCH_AXHELM_TUNE_CACHE``, else
``build/kernels/axhelm_tune.json`` at the repository root.  Its format:
``{backend: {key: {"body": ..., "timings_s": {body: seconds}, ...}}}``
with key ``v1/<variant>/n1=<N1>/<dtype>/helm=<0|1>/ncols=<c>``.  A
corrupt file, a non-mapping file or a malformed entry (no body, or a body
that cannot run the configuration) warns and counts as a miss; writes go
to a pid-unique temporary file and `os.replace`; a read-only cache
directory never breaks a solve.

The reference clamps a tuned block to the caller's element count
(`_clamp_to_elems`); the port has no counterpart, because every body takes
any E (ragged tiles are masked).

`launch_resources` is the port's resource model of a launch — each CUDA
kernel of a body, its threads, shared memory and the blocks an SM it
promises — which `analysis.contracts.ResourceBudget` holds to the card, as
the reference's `VmemBudget` holds `block_vmem_bytes` to its VMEM.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import threading
import warnings
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.axhelm import build, ops

__all__ = ["CACHE_ENV", "SCHEMA", "candidates", "cache_path", "backend_tag",
           "get_body", "autotune", "clear", "KernelResources",
           "launch_resources"]

CACHE_ENV = "REPRO_TORCH_AXHELM_TUNE_CACHE"
# the key's schema version: a change of what a key means bumps it, so that
# older entries miss instead of resolving
SCHEMA = "v1"

# (backend, key) -> the body resolved in this process, or _STATIC for a
# configuration no cache held (the static route, remembered)
_MEM_CACHE: Dict[Tuple[str, str], str] = {}
_STATIC = "static"
_LOCK = threading.Lock()


def candidates(variant: str, n1: int) -> Tuple[str, ...]:
    """The bodies that can launch `variant` at N1, `ops.body_of`'s static
    route first: the tuned body up to `ops.N1_TUNED_MAX`, the generic body
    up to `ops.N1_MAX`, the slab body up to `ops.N1_SLAB_MAX`, the plane
    body up to `ops.N1_PLANE_MAX`, the staged body up to
    `ops.N1_STAGED_MAX`."""
    ops.check_variant(variant)
    if n1 < 2 or n1 > ops.N1_STAGED_MAX:
        return ()
    static = ops.body_of(variant, n1)
    out = [static]
    if n1 <= ops.N1_TUNED_MAX:
        out.append("column" if variant in ops.COLUMN_VARIANTS else "line")
    if n1 <= ops.N1_MAX:
        out.append("any")
    if n1 <= ops.N1_SLAB_MAX:
        out.append("slab")
    if n1 <= ops.N1_PLANE_MAX:
        out.append("plane")
    out.append("staged")
    return tuple(dict.fromkeys(out))


def cache_path() -> str:
    return os.environ.get(CACHE_ENV,
                          str(build._BUILD_DIR / "axhelm_tune.json"))


@functools.lru_cache(maxsize=None)
def _digest() -> str:
    """The built sources' digest, as the library's name carries it."""
    return build.library_path().stem.removeprefix("libaxhelm_")


@functools.lru_cache(maxsize=None)
def _device_tag(device: torch.device) -> str:
    if device.type != "cuda":
        return device.type
    major, minor = torch.cuda.get_device_capability(device)
    return f"{torch.cuda.get_device_name(device)}/sm_{major}{minor}"


def backend_tag(device=None) -> str:
    """The JSON cache's backend key: the device (a card's name and compute
    capability; "cpu" for the CPU, where nothing launches and only the
    cache's logic runs) and the built sources' digest."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return f"{_device_tag(device)}/{_digest()}"


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _config_key(variant: str, n1: int, dtype, helmholtz: bool,
                ncols: int = 1) -> str:
    return (f"{SCHEMA}/{variant}/n1={n1}/{_dtype_name(dtype)}/"
            f"helm={int(bool(helmholtz))}/ncols={ncols}")


def _load_json() -> dict:
    """Read the JSON cache; a missing file is an empty cache, and an
    unreadable, truncated or otherwise corrupt one degrades to an EMPTY
    cache with a warning — the caller runs the static route and the next
    tuning run overwrites the wreck atomically.  The cache is an
    accelerator, never a correctness input, so it must not be able to
    raise into a solve."""
    path = cache_path()
    try:
        with open(path) as f:
            data = json.load(f)
    except FileNotFoundError:
        return {}
    except (OSError, ValueError) as e:
        warnings.warn(
            f"launch tuner cache {path} is unreadable or corrupt ({e}); "
            f"ignoring it — the next tuning run rewrites it atomically",
            RuntimeWarning, stacklevel=2)
        return {}
    if not isinstance(data, dict):
        warnings.warn(
            f"launch tuner cache {path} holds {type(data).__name__}, not "
            f"the expected backend->config mapping; ignoring it",
            RuntimeWarning, stacklevel=2)
        return {}
    return data


def _cache_entry(backend: str, key: str, variant: str,
                 n1: int) -> Optional[str]:
    """One cache entry's body, or None: a malformed level of a corrupt but
    valid JSON file (wrong nesting, no body, or a body that cannot launch
    the configuration) warns and is a miss."""
    level = _load_json().get(backend)
    entry = level.get(key) if isinstance(level, dict) else None
    if entry is None:
        return None
    body = entry.get("body") if isinstance(entry, dict) else None
    if not isinstance(body, str) or body not in candidates(variant, n1):
        warnings.warn(
            f"launch tuner cache entry {backend}/{key} is malformed "
            f"({entry!r}); treating it as a miss", RuntimeWarning,
            stacklevel=2)
        return None
    return body


def _save_json(backend: str, key: str, entry: dict) -> None:
    path = cache_path()
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        data = _load_json()
        level = data.get(backend)
        if not isinstance(level, dict):
            level = data[backend] = {}
        level[key] = entry
        # atomic publish: a pid-unique sibling, then os.replace — readers
        # see the old file or the new one, never a torn half-write
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass  # a read-only cache directory must never break the solve


def clear() -> None:
    """Forget every route resolved or tuned in this process."""
    with _LOCK:
        _MEM_CACHE.clear()


def get_body(variant: str, n1: int, dtype, helmholtz: bool = False,
             ncols: int = 1, device=None, autotune_now: bool = False) -> str:
    """The body that launches `variant` at N1: in-process cache -> JSON
    cache -> `autotune` when `autotune_now` -> `ops.body_of`'s static
    route.  `device` names the card (default: the current CUDA device);
    above N1_PLANE_MAX the staged body is the one candidate, and nothing is
    looked up."""
    static = ops.body_of(variant, n1)
    if n1 > ops.N1_PLANE_MAX:
        return static
    backend = backend_tag(device)
    key = _config_key(variant, n1, dtype, helmholtz, ncols)
    with _LOCK:
        hit = _MEM_CACHE.get((backend, key))
    if hit is not None and (hit != _STATIC or not autotune_now):
        return static if hit == _STATIC else hit
    body = _cache_entry(backend, key, variant, n1)
    if body is None and autotune_now:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"launch='auto': {variant} at N1={n1} ({key}) is not tuned "
                f"and a CUDA graph is being captured; tune it before the "
                f"capture (setup_problem(launch='auto') does, or "
                f"tune.autotune)")
        body, _ = autotune(variant, n1 - 1, dtype=dtype, helmholtz=helmholtz,
                           ncols=ncols, device=device)
    with _LOCK:
        _MEM_CACHE[(backend, key)] = body or _STATIC
    return body or static


# ------------------------------------------------------------- the sweep --


def _synthetic_inputs(variant: str, n: int, dtype, helmholtz: bool, e: int,
                      ncols: int, device):
    """(basis, x, geom, lam0, lam1) of a timing run: E elements near a
    unit-spaced row of cubes (trilinear with random vertex offsets; for
    parallelepiped one affine map), seed 0, assembled by the entry points'
    own `make_axhelm_elem_ops` in `dtype`."""
    import numpy as np

    from repro_torch.core import axhelm as core_axhelm
    from repro_torch.core import geometry
    from repro_torch.core.spectral import basis as make_basis

    b = make_basis(n)
    rng = np.random.default_rng(0)
    cube = geometry.reference_cube().numpy()
    shift = np.zeros((e, 1, 3))
    shift[:, 0, 0] = 2.2 * np.arange(e)
    if variant == "parallelepiped":
        affine = np.array([[1.0, 0.2, 0.1], [0.0, 0.9, 0.15],
                           [0.05, 0.0, 1.1]])
        verts = cube @ affine.T + shift
    else:
        verts = cube + shift + 0.15 * rng.standard_normal((e, 8, 3))
    node = (e,) + (b.n1,) * 3
    lams = {}
    if helmholtz or variant == "merged":
        lams = {"lam0": torch.ones(node), "lam1": torch.full(node, 0.1)}
    elem_ops, _, _ = core_axhelm.make_axhelm_elem_ops(
        variant, b, torch.as_tensor(verts, dtype=torch.float32),
        helmholtz=helmholtz, dtype=dtype, backend="cuda", device=device,
        **lams)
    x = torch.as_tensor(rng.standard_normal((e, ncols, 1) + (b.n1,) * 3),
                        dtype=torch.float32).to(dtype=dtype, device=device)
    return (b, x, elem_ops["geom"], elem_ops.get("lam0"),
            elem_ops.get("lam1"))


def _time_candidate(body: str, inputs, variant: str, helmholtz: bool,
                    reps: int, iters: int) -> float:
    """Seconds a call of `body`: `reps` calls captured in one CUDA graph,
    replayed `iters` times between CUDA events, the median replay over
    `reps` (the wrapper's host time, ctypes and checks, is not in a
    replay)."""
    b, x, geom, lam0, lam1 = inputs

    def run():
        ops._launch(x, b, variant, geom, lam0, lam1, helmholtz, twin=body)

    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            run()
    graph.replay()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / 1e3 / reps)
    del graph
    return statistics.median(times)


def autotune(variant: str, n: int, dtype=torch.float32,
             helmholtz: Optional[bool] = None, e: int = 216, ncols: int = 1,
             iters: int = 5, reps: int = 20,
             bodies: Optional[Sequence[str]] = None, device=None,
             save: bool = True) -> Tuple[str, Dict[str, float]]:
    """Time every candidate body of order `n` (or those of `bodies`) on
    the card; cache and return the winner: ``(body, {body: seconds a
    call})``.

    The sweep runs on E synthetic elements, ncols columns: what wins there
    wins on any mesh of the same (variant, N1, dtype, Helmholtz, ncols)
    shape, which is the paper's per-N tuning.  It times the kernels only,
    never the plain versions: a CPU device raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise ValueError(f"autotune times the CUDA kernels on a card; got "
                         f"device {device}")
    if helmholtz is None:
        helmholtz = variant == "merged"
    n1 = n + 1
    cand = list(bodies) if bodies else list(candidates(variant, n1))
    for body in cand:
        if body not in candidates(variant, n1):
            raise ValueError(f"body {body!r} cannot launch {variant} at "
                             f"N1={n1}; candidates: "
                             f"{candidates(variant, n1)}")
    inputs = _synthetic_inputs(variant, n, dtype, helmholtz, e, ncols,
                               device)
    timings = {body: _time_candidate(body, inputs, variant, helmholtz, reps,
                                     iters) for body in cand}
    winner = min(timings, key=timings.get)
    backend = backend_tag(device)
    key = _config_key(variant, n1, dtype, helmholtz, ncols)
    with _LOCK:
        _MEM_CACHE[(backend, key)] = winner
    if save:
        _save_json(backend, key, {"body": winner, "timings_s": timings,
                                  "e": e, "iters": iters, "reps": reps})
    return winner, timings


# --------------------------------------------------- the resource model --


class KernelResources(NamedTuple):
    """One CUDA kernel of a body's launch: its name, threads a block,
    shared memory a block (dynamic and static), the blocks an SM its
    ``__launch_bounds__`` promise (the register cap), the blocks an SM its
    launch relies on (`resident`), and its key in the build's ptxas report
    (`build.ptxas_instantiations`: variant, body, N1, storage, pass)."""

    kernel: str
    threads: int
    smem_bytes: int
    min_blocks: int
    resident: int
    ptxas_key: tuple


def launch_resources(body: str, variant: str, n1: int, dtype,
                     ncols: int = 1,
                     helmholtz: bool = False) -> List[KernelResources]:
    """The CUDA kernels one application of `body` launches for `variant`
    at N1 with ncols columns, from `ops`' model of each source.  The staged
    body promises 4 blocks an SM to bound its registers
    (``__launch_bounds__(kStagedThreads, 4)``) but sizes its persistent
    grid from the occupancy calculator at each launch, so it relies on one
    resident block, not four."""
    dt = ops.KERNEL_DTYPES[dtype]
    hold = ncols > 1
    if body == "column":
        return [KernelResources(
            "axhelm_column_kernel", ops.column_threads(n1),
            ops.column_smem_bytes(n1), ops.column_min_blocks(n1),
            ops.column_min_blocks(n1), (variant, "column", n1, dt, None))]
    if body == "line":
        blocks = ops.line_min_blocks(n1, variant)
        return [KernelResources(
            "axhelm_line_kernel", ops.line_threads(n1),
            ops.line_smem_bytes(n1, variant, torch.finfo(dtype).bits // 8),
            blocks, blocks, (variant, "line", n1, dt, None))]
    if body == "any":
        threads, _, smem = ops.generic_launch(n1, 1)
        return [KernelResources("axhelm_any_kernel", threads, smem, 1, 1,
                                (variant, "any", None, dt, None))]
    if body == "slab":
        s = ops.slab_launch(n1, 1, ncols)
        return [KernelResources("axhelm_slab_kernel", s.threads,
                                s.smem_bytes + ops.SLAB_STATIC_SMEM,
                                ops.SLAB_MIN_BLOCKS, ops.SLAB_MIN_BLOCKS,
                                (variant, "slab", None, dt, "slab")),
                KernelResources("axhelm_slab_last_kernel", s.last_threads,
                                0, 1, 1, (None, "slab", None, dt, "last"))]
    if body == "plane":
        p = ops.plane_launch(n1, 1, ncols)
        return [KernelResources(f"axhelm_plane_line_kernel<{last}>",
                                p.line_threads, p.line_smem_bytes, 1, 1,
                                (None, "plane", None, dt, step))
                for last, step in ((0, "line_first"), (1, "line_last"))] + [
            KernelResources("axhelm_plane_kernel", p.plane_threads,
                            p.plane_smem_bytes + ops.PLANE_STATIC_SMEM,
                            ops.PLANE_MIN_BLOCKS, ops.PLANE_MIN_BLOCKS,
                            (variant, "plane", None, dt, "plane"))]
    if body == "staged":
        lines = ops.staged_lines(n1)
        # each launch's epilogue operands (extras_of in the source)
        steps = (("grad_r", None, 0), ("grad_s", None, 0),
                 ("grad_t", variant, 2), ("first_r", None, 0),
                 ("accumulate_s", None, 1),
                 ("last_t", None, 1 + 2 * int(helmholtz)))
        return [KernelResources(
            f"axhelm_staged_{'grad_t' if step == 'grad_t' else 'contract'}"
            f"_kernel[{step}]", ops.STAGED_THREADS,
            ops.staged_smem_bytes(n1, lines, extras), ops.STAGED_MIN_BLOCKS,
            1, (v, "staged", None, dt, step)) for step, v, extras in steps]
    raise ValueError(f"unknown body {body!r}")
