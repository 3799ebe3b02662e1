"""Public wrapper for the axhelm CUDA kernels.

Counterpart of `repro.kernels.axhelm.ops`: it normalizes the field layouts
((E, N1^3) scalar, (E, d, N1^3) vector, (E, nrhs, d, N1^3) RHS-batched) to
the kernel's (E, nrhs, d, N1^3), keeps the reference package's geometry
layouts at its signature, and dispatches on the device of the tensors it is
given:

  * a CPU tensor goes to the plain PyTorch version (`ref.py`);
  * a CUDA tensor launches the hand-written kernel or raises — there is no
    fallback to the plain version.

Storage is float32 or bfloat16 (the reference kernel's two storage types).
At bfloat16 every operand, the constants D-hat, xi and w3 included, holds
bf16-rounded values; the kernel and its plain version widen them to
float32, compute in float32 and round the output once.

Bodies.  At N1 in `KERNEL_N1`, every N1 from 2 to `N1_TUNED_MAX` (orders
1 to 15), each entry point runs a tuned body.  K2 and K5
(`COLUMN_VARIANTS`) run one thread per node column, several elements a
block (`csrc/axhelm_column.cu`), and take their grid (`column_launch`) and
D-hat and xi by value (`_column_consts`, a host array) from here.  K1, K3
and K4 (`LINE_VARIANTS`) run one thread per node line in each direction,
in persistent blocks that stage the next element's x (and, up to N1 =
`LINE_HOLD_MAX`, K4's Lam2, Lam3) with vector loads while they compute
the current one (`csrc/axhelm_line.cu`); they take their grid
(`line_launch`, from the card's SM count) and D-hat and xi by value as the
column body does, and refuse a staged operand that is not aligned to
their vectors (`staged_alignment`: 16 bytes at N1 = 4 in fp32 and at 8,
one value at odd N1).  K1 reads its factors from the planar (E, 7,
N1,N1,N1) operand (`ref.planar_factors`).  The launch shape of both at
each N1 (`column_elems`, `column_min_blocks`, `line_elems`,
`line_min_blocks`) mirrors the CUDA source's.
From N1_TUNED_MAX + 1 to `N1_SLAB_MAX` (orders 16 to 23) each entry
point runs the slab body (`csrc/axhelm_slab.cu`, the `*_slab` symbols),
the fastest of the three bodies that can run these orders in the
measured turns (`PERF.md`; K1 at N1 = 17 the one exception, ~2 us behind
the generic body).  Its application is `SLAB_KERNELS` launches -- a pass
of one block per (element, slab of SLAB_PLANES t-planes) that copies the
element's whole x into shared memory, runs the slab's r, s and t
contractions (each a register tile of PLANE_REG x PLANE_REG outputs a
thread), the factors and the transposed r and s contractions, writing s_t
and the partial y into fp32 scratch, then the transposed t contraction
into y, a thread a line -- over 2 E ncols N1^3 words of scratch
(`slab_launch`).  The generic body (`csrc/axhelm.cu`, the `*_any`
symbols: one block an element walks its N1^3 nodes, with D-hat, x and
the weighted gradient in dynamic shared memory, `generic_smem_bytes`,
which above N1_MAX does not fit in a block) runs only as the timing twin
`generic`, and the plane body can run these orders too.  From N1_SLAB_MAX + 1 to `N1_PLANE_MAX` (orders 24
to 47) each entry
point runs the plane body (`csrc/axhelm_plane.cu`, the `*_plane`
symbols): one application is `PLANE_KERNELS` launches -- the t
contraction of x into fp32 scratch T, a pass of one block per (element,
t-plane) that runs the plane's r and s contractions, the factors and the
transposed r and s contractions, writing s_t over T and the partial y into
a second scratch field, and the transposed t contraction into y -- each
product a register tile of PLANE_REG x PLANE_REG outputs a thread, over
2 E ncols N1^3 words of scratch (`plane_launch`).  Above N1_PLANE_MAX
(orders 48 and up) each entry point runs the staged body
(`csrc/axhelm_staged.cu`, the `*_staged` symbols): one application is
`STAGED_KERNELS` launches, the six contractions, each a persistent grid
whose blocks walk items of `staged_lines` whole lines of one batch row
through a ring of two cp.async panel slots in shared memory and multiply
them on the tensor cores in 3xTF32 (D-hat's split made here once a basis,
`staged_fragments`), the t gradient fused with the factors, over fp32
scratch of 3 E ncols N1^3 words (and E N1^3 more for the Helmholtz mass)
(`staged_launch`).  The plane and staged
bodies' scratch (and the slab body's) is allocated by the wrapper with
`torch.empty` at every call (under a CUDA graph's capture it comes from
the graph's pool, the same memory at every replay); the staged body runs
N1 up to
`N1_STAGED_MAX`; a scratch the card cannot hold
is refused by that `torch.empty`, which raises `torch.OutOfMemoryError`
with the size.  None needs element padding: the column and line bodies
mask their ragged last group, the plane, slab and staged bodies their
ragged tiles.  `launch_counts` counts one launch of each entry point
(`entry_point(variant, dtype)`, the C symbol) per application, whichever
body it ran, so a run can show that a solve went through the kernels it
expects (`KERNELS_PER_APPLICATION` records the CUDA kernels one
application of each body launches: 2 for the slab body, 3 for the plane
body, 6 for the staged body, 1 for every other; a design fact, not
counted); a launch captured
into a solver loop's CUDA graph counts once for every replay of the graph
(`core.graphs.count`).  `body_of` is the static route; an entry point's
launch runs the body the launch tuner resolves (`tune.get_body`: its
in-process cache, its JSON cache, else `body_of`), so a process that
tuned nothing runs the static route.  Five timing-only twins count nothing
and run their body whatever `axhelm` routes: `rowwise` launches a
variant on the one-thread-per-node body at N1 in ROWWISE_N1 (4 and 8),
beside the bodies that replaced it, `generic` the generic body at any N1 up to N1_MAX,
beside the tuned and slab bodies, `slab` the slab body at any N1 up to
N1_SLAB_MAX, `plane` the plane body at any N1 up to N1_PLANE_MAX, beside
the generic and slab bodies, and `staged` the staged body at any N1 up
to N1_STAGED_MAX, beside the plane body.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.core import graphs
from repro_torch.core.spectral import SpectralBasis, basis as make_basis
from repro_torch.kernels.axhelm import build
from repro_torch.kernels.axhelm import ref as ref_mod
from repro_torch.kernels.axhelm import tune

__all__ = ["KERNEL_VARIANTS", "COLUMN_VARIANTS", "LINE_VARIANTS",
           "ROWWISE_VARIANTS", "KERNEL_N1", "N1_TUNED_MAX", "ROWWISE_N1",
           "N1_MAX", "KERNEL_DTYPES", "COLUMN_THREADS", "COLUMN_ELEMS",
           "COLUMN_PADS", "COLUMN_MIN_BLOCKS", "LINE_THREADS",
           "LINE_BLOCKS_PER_SM", "LINE_ELEMS", "LINE_HOLD_MAX",
           "LINE_ONE_BLOCK_FROM", "LINE_ROLL_FROM", "STAGED_ALIGNMENT",
           "column_elems", "column_threads", "column_min_blocks",
           "column_smem_bytes", "line_elems", "line_threads", "line_rolls",
           "line_min_blocks", "line_smem_bytes", "staged_alignment",
           "GENERIC_THREADS", "SMEM_PER_SM", "SMEM_RESERVED", "PLANE_REG",
           "PLANE_LINE_LANES", "PLANE_LINE_TILE", "PLANE_MIN_BLOCKS",
           "PLANE_FACTOR_WORDS", "PLANE_ARRAYS", "PLANE_STATIC_SMEM",
           "PLANE_KERNELS", "N1_PLANE_MAX", "SLAB_PLANES", "SLAB_MIN_BLOCKS",
           "SLAB_ARRAYS", "SLAB_STATIC_SMEM", "SLAB_LAST_THREADS",
           "SLAB_KERNELS", "N1_SLAB_MAX",
           "STAGED_THREADS", "STAGED_TILE",
           "STAGED_NARROW_LINES", "STAGED_STAGES", "STAGED_MAX_EXTRAS",
           "STAGED_KERNELS", "STAGED_MIN_BLOCKS", "LAUNCHES",
           "N1_STAGED_WIDE_MAX", "N1_STAGED_MAX",
           "KERNELS_PER_APPLICATION",
           "entry_point", "column_launch", "line_launch", "generic_launch",
           "generic_smem_bytes", "plane_lanes", "plane_pitch",
           "plane_smem_bytes", "plane_line_smem_bytes", "plane_launch",
           "PlaneLaunch", "slab_smem_bytes", "slab_launch", "SlabLaunch",
           "staged_lines", "staged_smem_bytes", "staged_launch",
           "StagedLaunch", "tf32_rna", "staged_fragments",
           "launch_counts", "reset_launch_counts",
           "axhelm", "rowwise", "generic", "slab", "plane", "staged",
           "reference",
           "unrounded"]

KERNEL_VARIANTS = ("precomputed", "trilinear", "parallelepiped", "merged",
                   "partial")
# the variants whose entry points run the one-thread-per-column body
COLUMN_VARIANTS = ("trilinear", "partial")
# the variants whose entry points run the one-thread-per-line body
LINE_VARIANTS = ("precomputed", "parallelepiped", "merged")
# the variants with a timing-only twin on the one-thread-per-node body:
# every one
ROWWISE_VARIANTS = KERNEL_VARIANTS
N1_TUNED_MAX = 16    # the tuned bodies run every N1 from 2 to this
KERNEL_N1 = tuple(range(2, N1_TUNED_MAX + 1))  # the N1 = N + 1 they run
ROWWISE_N1 = (4, 8)   # the N1 of the one-thread-per-node timing twin
# The tuned bodies' launch shapes (csrc/axhelm_column.cu, axhelm_line.cu):
# at N1 = 4 and 8 a block has COLUMN_THREADS (LINE_THREADS) threads and an
# SM holds COLUMN_MIN_BLOCKS (LINE_BLOCKS_PER_SM) of them; at every other N1
# the elements a block come from COLUMN_ELEMS (LINE_ELEMS), chosen so that
# N1^2 threads an element leave few lanes of the last warp idle, the
# column body's __launch_bounds__ promise as many blocks an SM as give 16
# warps, and the line body's persistent grid takes as many as the card
# holds at once (`_line_blocks`).
COLUMN_THREADS = 128  # threads a block of the column body at N1 = 4, 8
COLUMN_MIN_BLOCKS = 4  # its blocks an SM there (kColumnMinBlocks)
COLUMN_ELEMS = {2: 32, 3: 14, 5: 5, 6: 7, 7: 5, 9: 3, 10: 2, 11: 2, 12: 1,
                13: 1, 14: 1, 15: 1, 16: 1}
# words after each element's N1^3 in the column body's shared arrays
COLUMN_PADS = {2: 4, 3: 14, 4: 0, 5: 28, 6: 2, 7: 26, 8: 0, 9: 24, 10: 2,
               11: 6, 12: 0, 13: 0, 14: 0, 15: 0, 16: 0}
LINE_THREADS = 64     # threads a block of the line body at N1 = 4, 8
LINE_BLOCKS_PER_SM = 8  # resident line blocks an SM there (kLineMinBlocks)
LINE_ELEMS = {2: 16, 3: 7, 5: 5, 6: 7, 7: 5, 9: 3, 10: 2, 11: 1, 12: 1,
              13: 1, 14: 1, 15: 1, 16: 1}
# up to this N1 the line body holds K3's w3 column in registers and stages
# K4's Lam2, Lam3 (kLineHoldMax); above, it reads them where it uses them
LINE_HOLD_MAX = 8
# from this N1 the line body promises one block an SM where its lines'
# products stay unrolled, so that a thread may take up to 255 registers
# (kLineOneBlockFrom)
LINE_ONE_BLOCK_FROM = 11
# from which N1 a line variant rolls its lines' products over n
# (line_roll_from; parallelepiped never)
LINE_ROLL_FROM = {"precomputed": 12, "merged": 11}
STAGED_ALIGNMENT = 16  # bytes: the most any line instantiation's vectors need
GENERIC_THREADS = 512  # most threads a block of the generic body
# shared memory a block may use on the H100 (227 KB), which bounds the
# generic body's N1: generic_smem_bytes(N1_MAX) fits, N1_MAX + 1 does not
SMEM_PER_BLOCK = 232448
N1_MAX = 24
# shared memory an SM has on the H100 (228 KB), and what the runtime
# reserves of it for each resident block
SMEM_PER_SM = 233472
SMEM_RESERVED = 1024
# The plane body (csrc/axhelm_plane.cu): PLANE_REG x PLANE_REG outputs a
# thread in every product; its line kernel (launches 1 and 3)
# PLANE_LINE_LANES lanes along the lines, PLANE_LINE_TILE lines a block;
# its plane kernel ceil(N1 / PLANE_REG)^2 threads in whole warps,
# PLANE_MIN_BLOCKS blocks an SM promised (kPlaneMinBlocks), PLANE_ARRAYS
# arrays of a plane's size in shared memory, the node's factors held there
# too (PLANE_FACTOR_WORDS words a node) when an application has several
# columns, PLANE_STATIC_SMEM bytes of static shared memory (the element's
# geometry words); PLANE_KERNELS launches an application
PLANE_REG = 4
PLANE_LINE_LANES = 32
PLANE_LINE_TILE = PLANE_REG * PLANE_LINE_LANES
PLANE_MIN_BLOCKS = 3
PLANE_FACTOR_WORDS = 7
PLANE_ARRAYS = 5
PLANE_STATIC_SMEM = 128
PLANE_KERNELS = 3
# the entry points run the plane body up to this N1 (orders 24 to 47), the
# largest its tiles' threads and registers are sized for (kPlaneN1Max); the
# staged body's range starts above it
N1_PLANE_MAX = 48
# The slab body (csrc/axhelm_slab.cu): SLAB_PLANES t-planes a block of
# launch 1 (kSlabPlanes, the depth of x_t's register tile), its threads
# SLAB_PLANES ceil(N1 / PLANE_REG)^2 in whole warps, SLAB_MIN_BLOCKS blocks
# an SM its registers are bounded for (kSlabMinBlocks), D-hat, the copy of
# x and SLAB_ARRAYS arrays of a slab's size in shared memory, the factors
# held there (PLANE_FACTOR_WORDS words a slab node) when an application has
# several columns, SLAB_STATIC_SMEM bytes of static shared memory (the
# element's geometry words and Alg. 3's edge differences); launch 2
# SLAB_LAST_THREADS threads a block (kLastThreads), a thread a line;
# SLAB_KERNELS launches an application; N1 up to N1_SLAB_MAX (kSlabN1Max),
# where a block still holds the element's x beside its slab
SLAB_PLANES = 4
SLAB_MIN_BLOCKS = 2
SLAB_ARRAYS = 3
SLAB_STATIC_SMEM = 4 * (32 + 36)
SLAB_LAST_THREADS = 128
SLAB_KERNELS = 2
N1_SLAB_MAX = 24
# The staged body (csrc/axhelm_staged.cu): STAGED_THREADS threads a block
# (four warps, two rows of two), its tile (output rows a pass over the
# panel: two m16 tiles a warp; lines an item, half a warp; the depth of an
# mma k-step), STAGED_NARROW_LINES
# lines an item above N1_STAGED_WIDE_MAX, STAGED_STAGES panel slots in the
# ring, STAGED_MAX_EXTRAS operands an epilogue stages a pass at most,
# STAGED_KERNELS launches an application (the r and s gradients, the t
# gradient with the factors, three transposed contractions)
STAGED_THREADS = 128
STAGED_TILE = (64, 32, 8)
STAGED_NARROW_LINES = 16
STAGED_STAGES = 2
STAGED_MAX_EXTRAS = 3
STAGED_KERNELS = 6
# the blocks an SM its __launch_bounds__ promise (a register cap: the
# persistent grid takes the blocks the occupancy calculator allows)
STAGED_MIN_BLOCKS = 4
# CUDA kernels one application of each body launches
KERNELS_PER_APPLICATION = {"column": 1, "line": 1, "any": 1,
                           "slab": SLAB_KERNELS, "plane": PLANE_KERNELS,
                           "rowwise": 1, "staged": STAGED_KERNELS}
# the values of `axhelm`'s `launch`: resolve the body through the tuner's
# caches (None), or tune it on a miss ("auto")
LAUNCHES = (None, "auto")
# storage dtype -> the suffix of its entry points in csrc/axhelm.cu
KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def entry_point(variant: str, dtype: torch.dtype) -> str:
    """The C symbol of one kernel, e.g. ``axhelm_trilinear_bf16``."""
    return f"axhelm_{variant}_{KERNEL_DTYPES[dtype]}"


launch_counts = {entry_point(v, dt): 0 for dt in KERNEL_DTYPES
                 for v in KERNEL_VARIANTS}


def generic_smem_bytes(n1: int) -> int:
    """Dynamic shared memory of one generic-body block (kernel
    `axhelm_any_kernel`): D-hat (N1^2 floats), 32 floats of element
    geometry, and x and the three weighted gradient components (4 N1^3
    floats)."""
    return 4 * (n1 * n1 + 32 + 4 * n1 ** 3)


def generic_launch(n1: int, n_elem: int) -> tuple[int, int, int]:
    """(threads, grid, shared-memory bytes) of the generic body: one block
    an element of at most GENERIC_THREADS threads, whole warps, each
    thread walking the nodes t, t + threads, ... of its element."""
    threads = min(GENERIC_THREADS, -(-n1 ** 3 // 32) * 32)
    return threads, n_elem, generic_smem_bytes(n1)


def plane_lanes(n1: int) -> int:
    """Threads along each axis of a plane-body tile: N1 rounded up to
    PLANE_REG, over PLANE_REG (`lanes_of` in the source)."""
    return -(-n1 // PLANE_REG)


def plane_pitch(n1: int) -> int:
    """The plane kernel's row pitch in floats (`pitch_of` in the source):
    N1 | 1, odd, so that the rows a warp reads at once meet in no bank."""
    return n1 | 1


def plane_smem_bytes(n1: int, hold: bool) -> int:
    """Dynamic shared memory of one plane-kernel block: PLANE_ARRAYS arrays
    of N1 rows of `plane_pitch` floats (D-hat, s_r, s_s, the planes of T
    and x), and, when the block holds the factors for several columns
    (`hold`), PLANE_FACTOR_WORDS floats a node."""
    return 4 * (PLANE_ARRAYS * n1 * plane_pitch(n1)
                + (PLANE_FACTOR_WORDS * n1 * n1 if hold else 0))


def plane_line_smem_bytes(n1: int) -> int:
    """Dynamic shared memory of one line-kernel block of the plane body:
    D-hat or its transpose over N1 rows of PLANE_REG * plane_lanes(N1)
    outputs, and a panel of PLANE_LINE_TILE lines of the whole contracted
    axis, fp32."""
    return 4 * n1 * (PLANE_REG * plane_lanes(n1) + PLANE_LINE_TILE)


class PlaneLaunch(NamedTuple):
    """The launches of one plane-body application (`plane_launch`)."""

    line_threads: int                  # a block of launches 1 and 3
    line_grid: tuple[int, int]         # (E ncols batch rows, line tiles)
    line_smem_bytes: int               # its dynamic shared memory
    plane_threads: int                 # a block of launch 2
    plane_grid: int                    # E N1: one block per (element, k)
    plane_smem_bytes: int              # its dynamic shared memory
    scratch_bytes: int                 # fp32 T and Ypart
    kernels: int                       # launches an application


def plane_launch(n1: int, n_elem: int, ncols: int) -> PlaneLaunch:
    """The plane body's launches for E = n_elem elements of ncols columns:
    launches 1 and 3 one block per batch row (element, column) and tile of
    PLANE_LINE_TILE lines, PLANE_LINE_LANES x plane_lanes(N1) threads (a
    warp one output row); launch 2 one block per (element, t-plane), the
    plane's tiles in whole warps, holding the factors when ncols > 1; the
    scratch, two fp32 fields of E ncols N1^3 words."""
    lanes = plane_lanes(n1)
    return PlaneLaunch(
        line_threads=PLANE_LINE_LANES * lanes,
        line_grid=(n_elem * ncols, -(-n1 * n1 // PLANE_LINE_TILE)),
        line_smem_bytes=plane_line_smem_bytes(n1),
        plane_threads=-(-lanes * lanes // 32) * 32,
        plane_grid=n_elem * n1,
        plane_smem_bytes=plane_smem_bytes(n1, ncols > 1),
        scratch_bytes=4 * 2 * ncols * n_elem * n1 ** 3,
        kernels=PLANE_KERNELS)


def slab_smem_bytes(n1: int, hold: bool) -> int:
    """Dynamic shared memory of one slab-body block of launch 1: D-hat in
    N1 rows of `plane_pitch` floats, rounded up to 16 bytes; the copy of the
    element's x, N1^3 floats behind a shift of up to 7 in whole 16-byte
    units (`x_words` in the source); SLAB_ARRAYS arrays of SLAB_PLANES
    planes (s_r, s_s, s_t) in rows of `plane_pitch` floats; and, when the
    block holds the factors for several columns (`hold`),
    PLANE_FACTOR_WORDS floats a slab node."""
    dhat = -(-n1 * plane_pitch(n1) // 4) * 4
    x = (n1 ** 3 + 14) // 8 * 8
    return 4 * (dhat + x
                + SLAB_ARRAYS * SLAB_PLANES * n1 * plane_pitch(n1)
                + (PLANE_FACTOR_WORDS * SLAB_PLANES * n1 * n1 if hold else 0))


class SlabLaunch(NamedTuple):
    """The launches of one slab-body application (`slab_launch`)."""

    threads: int                       # a block of launch 1
    slabs: int                         # slabs of SLAB_PLANES planes an element
    grid: int                          # E slabs: one block per (element, slab)
    smem_bytes: int                    # its dynamic shared memory
    last_threads: int                  # a block of launch 2
    last_grid: int                     # its blocks: a thread a line
    scratch_bytes: int                 # fp32 S_t and Ypart
    kernels: int                       # launches an application


def slab_launch(n1: int, n_elem: int, ncols: int) -> SlabLaunch:
    """The slab body's launches for E = n_elem elements of ncols columns:
    launch 1 one block per (element, slab of SLAB_PLANES t-planes; the last
    may be ragged), SLAB_PLANES plane_lanes(N1)^2 threads in whole warps,
    holding the factors when ncols > 1; launch 2 one thread per line (j, i)
    of each of the E ncols batch rows, SLAB_LAST_THREADS a block; the
    scratch, two fp32 fields of E ncols N1^3 words."""
    lanes = plane_lanes(n1)
    slabs = -(-n1 // SLAB_PLANES)
    lines = n_elem * ncols * n1 * n1
    return SlabLaunch(
        threads=-(-SLAB_PLANES * lanes * lanes // 32) * 32, slabs=slabs,
        grid=n_elem * slabs, smem_bytes=slab_smem_bytes(n1, ncols > 1),
        last_threads=SLAB_LAST_THREADS,
        last_grid=-(-lines // SLAB_LAST_THREADS),
        scratch_bytes=4 * 2 * ncols * n_elem * n1 ** 3,
        kernels=SLAB_KERNELS)


def _staged_slot_floats(n1: int, lines: int) -> int:
    """Floats of one panel slot (`slot_floats` in the source): the larger
    of the row-major panel (N1 padded to 8 rows of lines + 8) and the
    line-major one (lines rows of N1 padded to 8, + 4)."""
    kp = -(-n1 // 8) * 8
    return max(kp * (lines + 8), lines * (kp + 4))


def staged_smem_bytes(n1: int, lines: Optional[int] = None,
                      extras: int = 0) -> int:
    """Dynamic shared memory of one staged-body block (kernels
    `axhelm_staged_contract_kernel` and `axhelm_staged_grad_t_kernel`):
    STAGED_STAGES panel slots, the epilogue tile (64 rows of lines + 8, or
    lines rows of 64 + 4), `extras` operands of the epilogue staged a pass
    (64 rows of lines + 8 each: S0 and S1 in the t gradient, S0 in the
    accumulating pass, S0 and for Helmholtz the mass and x in the last;
    up to STAGED_MAX_EXTRAS) and 32 words of element geometry, fp32;
    `lines` defaults to `staged_lines(n1)`."""
    rows = STAGED_TILE[0]
    lines = staged_lines(n1) if lines is None else lines
    tile = max(rows * (lines + 8), lines * (rows + 4))
    return 4 * (STAGED_STAGES * _staged_slot_floats(n1, lines) + tile
                + extras * rows * (lines + 8) + 32)


# the largest N1 at which two blocks of STAGED_TILE[1] lines an item fit an
# SM (kWideMax in the source); above it an item has STAGED_NARROW_LINES
# lines
N1_STAGED_WIDE_MAX = max(n for n in range(2, 2048)
                         if 2 * (staged_smem_bytes(n, STAGED_TILE[1])
                                 + SMEM_RESERVED) <= SMEM_PER_SM)


def staged_lines(n1: int) -> int:
    """Lines a staged-body item at N1 (`staged_lines` in the source)."""
    return STAGED_TILE[1] if n1 <= N1_STAGED_WIDE_MAX else STAGED_NARROW_LINES


# the staged body's range (kStagedMax in the source, whose entry points
# refuse above it too): every N1 of the seven-launch body it replaced, the
# largest its checks have run.  Shared memory does not set it: a narrow
# block, the epilogue's operands included, would fit up to N1 = 1080.
N1_STAGED_MAX = 878


class StagedLaunch(NamedTuple):
    """The launches of one staged-body application (`staged_launch`)."""

    threads: int                       # a block
    tile: tuple[int, int, int]         # output rows, lines, k-step depth
    lines: int                         # lines an item at this N1
    items: int                         # (batch row, line tile) items
    passes: int                        # passes of 64 output rows an item
    k_steps: int                       # mma k-steps of a pass
    smem_bytes: int                    # a block's, without the extras
    scratch_bytes: int                 # fp32 S0, S1, S2 (and the mass)
    fragment_bytes: int                # D-hat's split (staged_fragments)
    kernels: int                       # launches an application


def staged_launch(n1: int, n_elem: int, ncols: int,
                  helmholtz: bool = False) -> StagedLaunch:
    """The staged body's launches for E = n_elem elements of ncols columns:
    every launch one item per batch row (element, column) and tile of
    `staged_lines(N1)` lines, ceil(N1^2 / lines) tiles (the last may be
    ragged), walked by a persistent grid (on the card: the SMs times the
    blocks an SM the occupancy calculator allows, or the items if fewer);
    an item's outputs in ceil(N1 / 64) passes of 64 rows, each summed over
    ceil(N1 / 8) k-steps; the scratch, three fp32 components of E ncols
    N1^3 words, and for Helmholtz the mass of each node, E N1^3 words
    more."""
    lines = staged_lines(n1)
    rows, _, depth = STAGED_TILE
    np_ = n1 ** 3
    m_tiles, k_steps = -(-n1 // 16), -(-n1 // depth)
    return StagedLaunch(
        threads=STAGED_THREADS, tile=STAGED_TILE, lines=lines,
        items=n_elem * ncols * -(-n1 * n1 // lines),
        passes=-(-n1 // rows), k_steps=k_steps,
        smem_bytes=staged_smem_bytes(n1, lines),
        scratch_bytes=4 * (3 * ncols + int(helmholtz)) * n_elem * np_,
        fragment_bytes=4 * 2 * m_tiles * k_steps * 256,
        kernels=STAGED_KERNELS)


def tf32_rna(a):
    """float32 values rounded to tf32 as `cvt.rna.tf32.f32` rounds them:
    to 10 mantissa bits, to nearest, ties away from zero (a numpy array of
    float32 in, float32 out, the low 13 bits zero)."""
    import numpy as np

    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def staged_fragments(dhat) -> "numpy.ndarray":
    """D-hat's 3xTF32 split in the order the staged body's products read it
    (the dhat slot of its entry points): for A = D-hat, then A = its
    transpose, zero-padded to N1 rounded up to 16 rows and 8 columns, each
    (m16 tile, k-step) as 32 lanes x 4 values of hi = tf32_rna(A), then 32
    x 4 of lo = tf32_rna(A - hi), lane l = 4 g + t holding A[16 mt + g][8
    ks + t], A[.. + g + 8][..], A[..][.. + t + 4], A[.. + 8][.. + 4] (the
    A fragment of mma.m16n8k8.tf32).  `dhat` is a float32 (N1, N1)
    array."""
    import numpy as np

    d = np.asarray(dhat, dtype=np.float32)
    n1 = d.shape[0]
    mp, kp = -(-n1 // 16) * 16, -(-n1 // 8) * 8
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    rows = g[:, None] + 8 * (np.arange(4) % 2)[None, :]      # (32, 4)
    cols = t[:, None] + 4 * (np.arange(4) // 2)[None, :]
    out = []
    for a_mat in (d, d.T):
        pad = np.zeros((mp, kp), np.float32)
        pad[:n1, :n1] = a_mat
        hi = tf32_rna(pad)
        lo = tf32_rna(pad - hi)
        for mt in range(mp // 16):
            for ks in range(kp // 8):
                for half in (hi, lo):
                    out.append(half[16 * mt + rows, 8 * ks + cols])
    return np.stack(out).reshape(-1)


def _min_blocks(threads: int) -> int:
    """Blocks an SM that give 16 warps (at least one)."""
    warps = -(-threads // 32)
    return 1 if warps >= 16 else 16 // warps


def _align16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def column_elems(n1: int) -> int:
    """Elements a block of the column body (`column_elems` in the
    source)."""
    return COLUMN_THREADS // (n1 * n1) if n1 in (4, 8) else COLUMN_ELEMS[n1]


def column_threads(n1: int) -> int:
    return column_elems(n1) * n1 * n1


def column_min_blocks(n1: int) -> int:
    """The column body's blocks an SM (its __launch_bounds__)."""
    return COLUMN_MIN_BLOCKS if n1 in (4, 8) else _min_blocks(
        column_threads(n1))


def column_smem_bytes(n1: int) -> int:
    """Shared memory of one column-body block (`ColumnShared`): x and the
    three weighted components, N1^3 + pad words an element each, 16-byte
    aligned; 36 edge words an element; two copies of D-hat."""
    epb, nc = column_elems(n1), n1 * n1
    arrays = 4 * _align16(4 * epb * (nc * n1 + COLUMN_PADS[n1]))
    return _align16(arrays + 4 * (36 * epb + 2 * nc))


def column_launch(n1: int, n_elem: int) -> tuple[int, int]:
    """(elements per block, grid) of the column body: N1^2 threads an
    element, `column_elems` a block, and as many blocks as cover n_elem
    elements (the last one may be ragged)."""
    per_block = column_elems(n1)
    return per_block, -(-n_elem // per_block)


def line_elems(n1: int) -> int:
    """Elements a block of the line body (`line_elems` in the source)."""
    return LINE_THREADS // (n1 * n1) if n1 in (4, 8) else LINE_ELEMS[n1]


def line_threads(n1: int) -> int:
    return line_elems(n1) * n1 * n1


def line_rolls(variant: str, n1: int) -> bool:
    """Whether the line body rolls the variant's line products at N1."""
    return n1 >= LINE_ROLL_FROM.get(variant, N1_TUNED_MAX + 1)


def line_min_blocks(n1: int, variant: str) -> int:
    """The line body's blocks an SM its __launch_bounds__ promises:
    LINE_BLOCKS_PER_SM at N1 = 4 and 8 (also the persistent grid's there),
    one where the products stay unrolled from LINE_ONE_BLOCK_FROM, else as
    many as give 16 warps."""
    if n1 in (4, 8):
        return LINE_BLOCKS_PER_SM
    if n1 >= LINE_ONE_BLOCK_FROM and not line_rolls(variant, n1):
        return 1
    return _min_blocks(line_threads(n1))


def line_smem_bytes(n1: int, variant: str, itemsize: int) -> int:
    """Shared memory of one line-body block (`LineShared`): two x buffers
    and s_r, s_s of k-slabs padded by 16 bytes, K4's two Lam buffers where
    it stages them, and s_t above LINE_HOLD_MAX; members 16-byte
    aligned."""
    epb, np_ = line_elems(n1), n1 ** 3
    sx, sp = n1 * n1 + 16 // itemsize, n1 * n1 + 4
    held = n1 <= LINE_HOLD_MAX
    lam = variant == "merged" and held
    return (_align16(2 * epb * n1 * sx * itemsize)
            + 2 * _align16(4 * epb * n1 * sp)
            + _align16((2 if lam else 1) * epb * 2 * (np_ if lam else 1)
                       * itemsize)
            + _align16(4 * epb * (1 if held else n1 * sp)))


def staged_alignment(n1: int, itemsize: int) -> int:
    """Bytes the line body's staged operands must be aligned to at N1 (its
    vectors, `stage_vec_bytes`): the widest of 16, 8 and 4 that divides a
    thread's N1 values, else one value."""
    row = n1 * itemsize
    return next((v for v in (16, 8, 4) if row % v == 0), itemsize)


def line_launch(n1: int, n_elem: int, n_sm: int,
                blocks: int) -> tuple[int, int]:
    """(elements per block, grid) of the line body: N1^2 threads an element,
    `line_elems` a block, and persistent blocks, at most `blocks` an SM
    (the wrapper passes `_line_blocks`, what the card holds at once) and at
    most one a group of elements; block b walks the groups b, b + grid, ...
    (the last group may be ragged)."""
    per_block = line_elems(n1)
    groups = -(-n_elem // per_block)
    return per_block, min(groups, n_sm * blocks)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _line_blocks(variant: str, dtype: torch.dtype, n1: int,
                 device: torch.device) -> int:
    """Blocks of the line body's instantiation that one SM of `device` holds
    at once: LINE_BLOCKS_PER_SM at N1 = 4 and 8 (the measured setting), the
    CUDA occupancy calculator's answer at every other N1 (C entry point
    `axhelm_line_blocks_per_sm`), which can exceed the one block
    `line_min_blocks` promises there."""
    if n1 in (4, 8):
        return LINE_BLOCKS_PER_SM
    with torch.cuda.device(device):
        blocks = build.library().axhelm_line_blocks_per_sm(
            KERNEL_VARIANTS.index(variant), int(dtype == torch.bfloat16), n1)
    if blocks < 1:
        raise RuntimeError(f"axhelm {variant} line body at N1={n1}: the "
                           f"occupancy query returned {blocks}")
    return blocks


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def check_variant(variant: str) -> None:
    """Raise for a variant the port has no kernel for."""
    if variant not in KERNEL_VARIANTS:
        raise ValueError(f"unknown axhelm variant {variant!r}")


def _pin_equation(variant: str, lam0, lam1, helmholtz: bool) -> bool:
    """merged is Helmholtz with Lam2/Lam3 in the lambda slots, partial is
    Poisson with gScale in the lam0 slot: the equation they solve."""
    if variant == "merged":
        if lam0 is None or lam1 is None:
            raise ValueError("merged requires lam0=Lam2 and lam1=Lam3 "
                             "(see core.axhelm.setup_merged_lambdas)")
        return True
    if variant == "partial":
        if lam0 is None or lam1 is not None:
            raise ValueError("partial requires lam0=gScale and lam1=None "
                             "(see core.axhelm.setup_partial_gscale)")
        return False
    return helmholtz


def _as_batched(x: torch.Tensor) -> torch.Tensor:
    """(E, N1^3) / (E, d, N1^3) / (E, nrhs, d, N1^3) -> (E, nrhs, d, N1^3)."""
    if x.ndim == 4:
        return x[:, None, None]
    if x.ndim == 5:
        return x[:, None]
    if x.ndim == 6:
        return x
    raise ValueError(
        f"axhelm: x must be (E, N1,N1,N1), (E, d, N1,N1,N1) or "
        f"(E, nrhs, d, N1,N1,N1), got shape {tuple(x.shape)}")


def axhelm(x: torch.Tensor, basis: SpectralBasis, variant: str,
           geom: torch.Tensor,
           lam0: Optional[torch.Tensor] = None,
           lam1: Optional[torch.Tensor] = None,
           helmholtz: bool = False,
           launch: Optional[str] = None) -> torch.Tensor:
    """Apply axhelm: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.

    On a CUDA tensor the body that launches is `tune.get_body`'s: the
    tuner's in-process cache, then its JSON cache, then `body_of`'s
    static route; ``launch="auto"`` tunes a configuration neither cache
    holds (`tune.autotune`) first, as the reference's
    ``block_elems="auto"`` does.  Whichever body runs, the launch counts
    as the entry point's.  A CPU tensor runs the plain version whatever
    `launch` says.

    x:    (E, N1,N1,N1), (E, d, N1,N1,N1) or (E, nrhs, d, N1,N1,N1) — every
          column reuses the element's single factor set.
    geom: precomputed:    (E, 7, N1,N1,N1)   planes g00..g22, gwj
                          (`ref.planar_factors`)
          trilinear:      (E, 8, 3)          vertices
          parallelepiped: (E, 7)             per-element scalars
          merged:         (E, 8, 3)          vertices; lam0=Lam2, lam1=Lam3
                          (setup_merged_lambdas, paper §4.1.1; Helmholtz)
          partial:        (E, 8, 3)          vertices; lam0=gScale
                          (setup_partial_gscale, paper §4.1.2; Poisson)
    lam0, lam1: optional per-node (E, N1,N1,N1) fields.
    """
    check_variant(variant)
    if launch not in LAUNCHES:
        raise ValueError(f"launch must be one of {LAUNCHES}, got "
                         f"{launch!r}")
    helmholtz = _pin_equation(variant, lam0, lam1, helmholtz)
    xb = _as_batched(x)
    if xb.device.type == "cpu":
        y = reference(xb, basis, variant, geom, lam0, lam1, helmholtz)
    else:
        y = _launch(xb, basis, variant, geom, lam0, lam1, helmholtz,
                    launch=launch)
    return y.reshape(x.shape)


def rowwise(x: torch.Tensor, basis: SpectralBasis, variant: str,
            geom: torch.Tensor, lam0: Optional[torch.Tensor] = None,
            lam1: Optional[torch.Tensor] = None,
            helmholtz: bool = False) -> torch.Tensor:
    """A variant on the one-thread-per-node body of `csrc/axhelm.cu` (the
    entry points' body before the column and line ones), at N1 in
    ROWWISE_N1, on CUDA tensors: timing only, beside `axhelm`.  Counts no
    launch."""
    if variant not in ROWWISE_VARIANTS:
        raise ValueError(f"rowwise runs {ROWWISE_VARIANTS}, not {variant!r}")
    helmholtz = _pin_equation(variant, lam0, lam1, helmholtz)
    xb = _as_batched(x)
    return _launch(xb, basis, variant, geom, lam0, lam1, helmholtz,
                   twin="rowwise").reshape(x.shape)


def generic(x: torch.Tensor, basis: SpectralBasis, variant: str,
            geom: torch.Tensor, lam0: Optional[torch.Tensor] = None,
            lam1: Optional[torch.Tensor] = None,
            helmholtz: bool = False) -> torch.Tensor:
    """A variant on the generic body of `csrc/axhelm.cu` at any N1 up to
    N1_MAX, KERNEL_N1 included, on CUDA tensors: for tests and timing
    beside `axhelm`, which takes the generic body at no N1.  Counts no
    launch."""
    check_variant(variant)
    helmholtz = _pin_equation(variant, lam0, lam1, helmholtz)
    xb = _as_batched(x)
    return _launch(xb, basis, variant, geom, lam0, lam1, helmholtz,
                   twin="any").reshape(x.shape)


def slab(x: torch.Tensor, basis: SpectralBasis, variant: str,
         geom: torch.Tensor, lam0: Optional[torch.Tensor] = None,
         lam1: Optional[torch.Tensor] = None,
         helmholtz: bool = False) -> torch.Tensor:
    """A variant on the slab body of `csrc/axhelm_slab.cu` at any N1 from
    2 to N1_SLAB_MAX, on CUDA tensors: for tests and timing beside
    `axhelm`, which takes the slab body above N1_TUNED_MAX.  Counts no
    launch."""
    check_variant(variant)
    helmholtz = _pin_equation(variant, lam0, lam1, helmholtz)
    xb = _as_batched(x)
    return _launch(xb, basis, variant, geom, lam0, lam1, helmholtz,
                   twin="slab").reshape(x.shape)


def plane(x: torch.Tensor, basis: SpectralBasis, variant: str,
          geom: torch.Tensor, lam0: Optional[torch.Tensor] = None,
          lam1: Optional[torch.Tensor] = None,
          helmholtz: bool = False) -> torch.Tensor:
    """A variant on the plane body of `csrc/axhelm_plane.cu` at any N1
    from 2 to N1_PLANE_MAX, on CUDA tensors: for tests and timing beside
    `axhelm`, which takes the plane body only above N1_MAX.  Counts no
    launch."""
    check_variant(variant)
    helmholtz = _pin_equation(variant, lam0, lam1, helmholtz)
    xb = _as_batched(x)
    return _launch(xb, basis, variant, geom, lam0, lam1, helmholtz,
                   twin="plane").reshape(x.shape)


def staged(x: torch.Tensor, basis: SpectralBasis, variant: str,
           geom: torch.Tensor, lam0: Optional[torch.Tensor] = None,
           lam1: Optional[torch.Tensor] = None,
           helmholtz: bool = False) -> torch.Tensor:
    """A variant on the staged body of `csrc/axhelm_staged.cu` at any N1
    from 2 to N1_STAGED_MAX, on CUDA tensors: for tests and timing beside
    `axhelm`, which takes the staged body only above N1_PLANE_MAX.
    Counts no launch."""
    check_variant(variant)
    helmholtz = _pin_equation(variant, lam0, lam1, helmholtz)
    xb = _as_batched(x)
    return _launch(xb, basis, variant, geom, lam0, lam1, helmholtz,
                   twin="staged").reshape(x.shape)


def reference(x, basis: SpectralBasis, variant: str, geom, lam0=None,
              lam1=None, helmholtz=False):
    """The plain PyTorch version with the same operand convention
    (including the RHS-batched (E, nrhs, d, N1^3) layout), on any device.

    With bfloat16 storage it has the kernel's semantics: every operand is
    widened to float32, the arithmetic is float32 and the output is rounded
    to bfloat16 once."""
    return unrounded(x, basis, variant, geom, lam0, lam1,
                     helmholtz).to(x.dtype)


def unrounded(x, basis: SpectralBasis, variant: str, geom, lam0=None,
              lam1=None, helmholtz=False,
              compute: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain version before its one rounding to x's storage dtype.

    Every operand, D-hat, xi and w3 as the storage dtype rounds them
    included, is widened to `compute` — by default the kernel's compute
    dtype (float32 for bfloat16 storage, x's own dtype otherwise).  With
    ``compute=torch.float64`` and bfloat16 storage, rounding the result
    gives the correctly rounded output that a kernel's float32 arithmetic
    approximates."""
    check_variant(variant)
    squeeze = x.ndim == 4
    if squeeze:
        x = x[:, None]
    dhat, xi, w3 = _constants(basis.n, x.dtype, x.device)
    if compute is not None:
        dhat, xi, w3 = (t.to(compute) for t in (dhat, xi, w3))
    x, geom, lam0, lam1 = (None if t is None else t.to(dhat.dtype)
                           for t in (x, geom, lam0, lam1))
    if variant == "precomputed":
        g, gwj = ref_mod.factors_of_planes(geom)
        y = ref_mod.axhelm_precomputed(x, g, gwj, dhat, lam0, lam1, helmholtz)
    elif variant == "trilinear":
        y = ref_mod.axhelm_trilinear(x, geom, xi, w3, dhat, lam0, lam1,
                                     helmholtz)
    elif variant == "parallelepiped":
        y = ref_mod.axhelm_parallelepiped(x, geom, w3, dhat, lam0, lam1,
                                          helmholtz)
    elif variant == "merged":
        y = ref_mod.axhelm_merged(x, geom, xi, dhat, lam0, lam1)
    else:  # partial
        y = ref_mod.axhelm_partial(x, geom, xi, dhat, lam0)
    return y[:, 0] if squeeze else y


def _check_kernel_operands(xb, basis, variant, geom, lam0, lam1,
                           twin: Optional[str] = None) -> None:
    """Everything the CUDA kernel does not take raises here: an N1 below 2;
    for the generic body's twin (`twin="any"`) one above N1_MAX, for the
    node body (`twin="rowwise"`) one outside ROWWISE_N1, for the plane
    body's twin (`twin="plane"`) one above N1_PLANE_MAX, for the slab
    body's twin (`twin="slab"`) one above N1_SLAB_MAX; for the staged
    body (above N1_PLANE_MAX, or `twin="staged"`) one above
    N1_STAGED_MAX; a
    storage dtype other than float32 or
    bfloat16, an operand whose dtype is not x's, another device, a shape
    off the layout, or a non-contiguous tensor."""
    n1 = basis.n1
    if n1 < 2:
        raise ValueError(f"axhelm CUDA kernels run N1 from 2 (order 1 and "
                         f"up); got N1={n1} (order {basis.n})")
    if twin == "any" and n1 > N1_MAX:
        raise ValueError(f"the generic body runs N1 up to N1_MAX = {N1_MAX} "
                         f"(orders 1 to {N1_MAX - 1}): a block's shared "
                         f"memory holds no larger element; got N1={n1} "
                         f"(order {basis.n})")
    if twin == "rowwise" and n1 not in ROWWISE_N1:
        raise ValueError(f"the one-thread-per-node body is instantiated for "
                         f"N1 in {ROWWISE_N1}, got N1={n1} (order {basis.n})")
    if twin == "plane" and n1 > N1_PLANE_MAX:
        raise ValueError(f"the plane body runs N1 up to N1_PLANE_MAX = "
                         f"{N1_PLANE_MAX}: its tiles' threads and registers "
                         f"are sized for no larger plane; got N1={n1} "
                         f"(order {basis.n})")
    if twin == "slab" and n1 > N1_SLAB_MAX:
        raise ValueError(f"the slab body runs N1 up to N1_SLAB_MAX = "
                         f"{N1_SLAB_MAX}: a block holds no larger element's "
                         f"x beside its slab; got N1={n1} (order {basis.n})")
    staged_body = body_of(variant, n1, twin) == "staged"
    if staged_body and n1 > N1_STAGED_MAX:
        raise ValueError(f"the staged body runs N1 up to N1_STAGED_MAX = "
                         f"{N1_STAGED_MAX}, the range of the seven-launch "
                         f"body it replaced and of its checks; got N1={n1} "
                         f"(order {basis.n})")
    named = [("x", xb), ("geom", geom), ("lam0", lam0), ("lam1", lam1)]
    named = [(n, t) for n, t in named if t is not None]
    for name, t in named:
        if xb.dtype not in KERNEL_DTYPES or t.dtype != xb.dtype:
            raise TypeError(f"axhelm CUDA kernel takes float32 or bfloat16 "
                            f"storage, every operand in x's dtype; {name} "
                            f"is {t.dtype}, x is {xb.dtype}")
    for name, t in named:
        if t.device.type != "cuda" or t.device != xb.device:
            raise ValueError(f"axhelm CUDA kernel needs every operand on "
                             f"x's CUDA device; {name} is on {t.device}, x on "
                             f"{xb.device}")
    e = xb.shape[0]
    if tuple(xb.shape[3:]) != (n1,) * 3:
        raise ValueError(f"axhelm: x has node axes {tuple(xb.shape[3:])}, "
                         f"expected {(n1,) * 3} for order {basis.n}")
    want = {"precomputed": (e, 7, n1, n1, n1),
            "parallelepiped": (e, 7)}.get(variant, (e, 8, 3))
    if tuple(geom.shape) != want:
        raise ValueError(f"axhelm {variant}: geom must have shape {want}, "
                         f"got {tuple(geom.shape)}")
    for name, lam in (("lam0", lam0), ("lam1", lam1)):
        if lam is not None and tuple(lam.shape) != (e, n1, n1, n1):
            raise ValueError(f"axhelm: {name} must have shape "
                             f"{(e, n1, n1, n1)}, got {tuple(lam.shape)}")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"axhelm CUDA kernel needs contiguous operands; "
                             f"{name} is not")


@functools.lru_cache(maxsize=None)
def _constants(n: int, storage: torch.dtype, device: torch.device):
    """dhat (N1, N1), xi (N1,), w3 (N1, N1, N1), contiguous, on `device`,
    rounded to the storage dtype as the reference rounds them
    (`repro.kernels.axhelm.ops`): in that dtype for float32 and wider, as
    float32 arrays of the bf16-rounded values for bfloat16 storage — the
    kernel's compute dtype.  Made once, not copied from the host at every
    call."""
    b = make_basis(n)
    compute = storage if torch.finfo(storage).bits >= 32 else torch.float32
    return tuple(torch.as_tensor(a, dtype=storage, device=device)
                 .to(compute).contiguous()
                 for a in (b.dhat, b.points, b.w3))


@functools.lru_cache(maxsize=None)
def _staged_fragments(n: int, storage: torch.dtype,
                      device: torch.device) -> torch.Tensor:
    """`staged_fragments` of D-hat as `_constants` rounds it for the
    storage dtype, float32 on `device`: the staged body's dhat slot, made
    once a basis."""
    dhat, _, _ = _constants(n, storage, torch.device("cpu"))
    return torch.as_tensor(staged_fragments(dhat.to(torch.float32).numpy()),
                           device=device)


@functools.lru_cache(maxsize=None)
def _column_consts(n: int, storage: torch.dtype) -> torch.Tensor:
    """The column and line bodies' by-value kernel parameter: D-hat
    row-major (N1^2 values), then xi (N1), float32 on the host, rounded as
    `_constants` rounds them for the plain version.  The C entry point
    copies it into the launch; cached, so the pointer stays valid."""
    dhat, xi, _ = _constants(n, storage, torch.device("cpu"))
    return torch.cat([dhat.reshape(-1), xi]).to(torch.float32).contiguous()


def _check_staged_alignment(variant, xb, lam0, lam1) -> None:
    """Raise for an operand the line body stages with vector loads (x, and
    up to N1 = LINE_HOLD_MAX K4's Lam2 and Lam3) that is not aligned to
    them (`staged_alignment` at x's N1, its last axis, and storage type),
    e.g. a contiguous view at an odd storage offset."""
    n1 = xb.shape[-1]
    need = staged_alignment(n1, xb.element_size())
    operands = [("x", xb)]
    if variant == "merged" and n1 <= LINE_HOLD_MAX:
        operands += [("lam0", lam0), ("lam1", lam1)]
    for name, t in operands:
        if t is not None and t.data_ptr() % need:
            raise ValueError(
                f"axhelm {variant} CUDA kernel stages {name} with vector "
                f"loads, which need a {need}-byte-aligned address at "
                f"N1={n1}; {name} starts at {t.data_ptr():#x}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def body_of(variant: str, n1: int, twin: Optional[str] = None) -> str:
    """The body a launch runs: "column" or "line" (the tuned bodies, at N1
    in KERNEL_N1: 2 to N1_TUNED_MAX), "slab" (N1 above N1_TUNED_MAX up to
    N1_SLAB_MAX), "plane" (N1 above N1_SLAB_MAX up to
    N1_PLANE_MAX), "staged" (N1 above N1_PLANE_MAX), or a twin's own body:
    "any" (the generic body of the `generic` twin), "slab", "plane",
    "staged" or "rowwise" (the node body of the `rowwise` twin)."""
    if twin is not None:
        return twin
    if n1 > N1_PLANE_MAX:
        return "staged"
    if n1 > N1_SLAB_MAX:
        return "plane"
    if n1 > N1_TUNED_MAX:
        return "slab"
    return "column" if variant in COLUMN_VARIANTS else "line"


def _launch(xb, basis, variant, geom, lam0, lam1, helmholtz,
            twin: Optional[str] = None,
            launch: Optional[str] = None) -> torch.Tensor:
    """Launch `variant` on x's current stream, through the body the tuner
    resolves (`tune.get_body`: a tuned route, else `body_of`'s; `launch`
    as in `axhelm`), and count an entry point's launch; a timing-only
    `twin` ("rowwise", "any", "slab", "plane" or "staged", or "column" or
    "line" for the tuner's sweep) runs its own body and counts none.  The
    slab,
    plane and staged bodies' scratch is allocated here, on x's device, at
    every call:
    within a CUDA graph's capture it comes from the graph's pool and the
    graph keeps it, so every replay runs on the same memory."""
    _check_kernel_operands(xb, basis, variant, geom, lam0, lam1, twin)
    e, ncols = xb.shape[0], xb.shape[1] * xb.shape[2]
    body = twin or tune.get_body(variant, basis.n1, xb.dtype, helmholtz,
                                 ncols, device=xb.device,
                                 autotune_now=launch == "auto")
    if body == "line":
        _check_staged_alignment(variant, xb, lam0, lam1)
    y = torch.empty_like(xb)
    if e == 0 or ncols == 0:
        return y
    name = entry_point(variant, xb.dtype)
    symbol = name if body in ("column", "line") else f"{name}_{body}"
    fn = getattr(build.library(), symbol)
    dhat, xi, w3 = _constants(basis.n, xb.dtype, xb.device)
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream(xb.device).cuda_stream
        common = (_ptr(xb), _ptr(y), _ptr(geom), _ptr(lam0), _ptr(lam1),
                  _ptr(dhat))
        sizes = (basis.n1, e, ncols)
        if body == "any":
            rc = fn(*common, _ptr(xi), _ptr(w3), *sizes, int(helmholtz),
                    stream)
        elif body in ("slab", "plane", "staged"):
            if body == "staged":
                nbytes = staged_launch(basis.n1, e, ncols,
                                       helmholtz).scratch_bytes
            else:
                nbytes = (slab_launch if body == "slab" else plane_launch)(
                    basis.n1, e, ncols).scratch_bytes
            scratch = torch.empty(nbytes // 4, dtype=torch.float32,
                                  device=xb.device)
            if body == "staged":     # D-hat's split in the dhat slot
                frag = _staged_fragments(basis.n, xb.dtype, xb.device)
                common = common[:5] + (_ptr(frag),)
            rc = fn(*common, _ptr(xi), _ptr(w3), _ptr(scratch), *sizes,
                    int(helmholtz), stream)
        elif body == "column":
            consts = _ptr(_column_consts(basis.n, xb.dtype))
            grid = column_launch(basis.n1, e)
            if variant == "trilinear":
                rc = fn(*common[:5], _ptr(w3), consts, *sizes,
                        int(helmholtz), *grid, stream)
            else:  # partial: gScale in the lam0 slot, no lam1
                rc = fn(*common[:4], consts, *sizes, *grid, stream)
        elif body == "line":
            consts = _ptr(_column_consts(basis.n, xb.dtype))
            grid = line_launch(basis.n1, e, _sm_count(xb.device),
                               _line_blocks(variant, xb.dtype, basis.n1,
                                            xb.device))
            if variant == "parallelepiped":
                rc = fn(*common[:5], _ptr(w3), consts, *sizes,
                        int(helmholtz), *grid, stream)
            elif variant == "precomputed":
                rc = fn(*common[:5], consts, *sizes, int(helmholtz), *grid,
                        stream)
            else:  # merged: Lam2, Lam3 in the lambda slots, Helmholtz
                rc = fn(*common[:5], consts, *sizes, *grid, stream)
        elif variant == "precomputed":
            rc = fn(*common, *sizes, int(helmholtz), stream)
        elif variant == "trilinear":
            rc = fn(*common, _ptr(xi), _ptr(w3), *sizes, int(helmholtz),
                    stream)
        elif variant == "parallelepiped":
            rc = fn(*common, _ptr(w3), *sizes, int(helmholtz), stream)
        elif variant == "merged":
            rc = fn(*common, _ptr(xi), *sizes, stream)
        else:  # partial: gScale in the lam0 slot, no lam1
            rc = fn(*common[:4], _ptr(dhat), _ptr(xi), *sizes, stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} kernel launch failed with CUDA error "
                           f"{rc}")
    if twin is None:
        graphs.count(launch_counts, name)
    return y
