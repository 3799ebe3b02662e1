"""Mesh generation: box meshes, trilinear deformations, global numbering.

Nekbone divides a box domain into E = nx*ny*nz equal elements.  This module
reproduces that, plus:

  * `deform_trilinear`: a smooth nonlinear warp applied to the *vertex grid*
    only — elements remain trilinear (each is still determined by its 8
    vertices) but are no longer parallelepipeds.  Adjacent elements share
    deformed vertices, so faces match: the mesh stays conforming.  This is
    the paper's target element class.
  * `deform_affine`: a global affine map (shear/stretch) — every element is a
    parallelepiped (paper Algorithm 4's class).
  * global GLL node numbering (the Q / Q^T connectivity of Eq. 2).

Everything is numpy (host-side, setup time); the solver moves the arrays to
its device.  `partition_elements` splits a mesh over the shards of the
element-sharded solve (1-D slabs or Cartesian sub-boxes), bit for bit the
reference package's partition.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["BoxMesh", "MeshPartition", "box_mesh", "deform_affine",
           "deform_trilinear", "partition_elements", "auto_grid",
           "normalize_grid"]


class BoxMesh(NamedTuple):
    """A hexahedral mesh of E = nx*ny*nz trilinear elements.

    verts:      (E, 8, 3) float64 — element vertices, paper Def. 2 ordering.
    global_ids: (E, N1, N1, N1) int32 — node -> unique global dof id
                ((k, j, i) axis order, matching field arrays).
    n_global:   number of unique global dofs ("N-script" in the paper).
    boundary:   (n_global,) bool — True on the domain boundary (for Dirichlet).
    shape:      (nx, ny, nz).
    order:      polynomial order N.
    """

    verts: np.ndarray
    global_ids: np.ndarray
    n_global: int
    boundary: np.ndarray
    shape: tuple
    order: int


def box_mesh(nx: int, ny: int, nz: int, order: int,
             lengths=(1.0, 1.0, 1.0)) -> BoxMesh:
    """Uniform box mesh on [0, Lx] x [0, Ly] x [0, Lz]."""
    n = order
    n1 = n + 1
    lx, ly, lz = lengths
    vx = np.linspace(0.0, lx, nx + 1)
    vy = np.linspace(0.0, ly, ny + 1)
    vz = np.linspace(0.0, lz, nz + 1)
    grid = np.stack(np.meshgrid(vx, vy, vz, indexing="ij"), axis=-1)

    e_idx = np.stack(np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                                 indexing="ij"), axis=-1).reshape(-1, 3)
    verts = np.empty((len(e_idx), 8, 3))
    for vtx in range(8):
        br, bs, bt = vtx & 1, (vtx >> 1) & 1, (vtx >> 2) & 1
        verts[:, vtx] = grid[e_idx[:, 0] + br, e_idx[:, 1] + bs, e_idx[:, 2] + bt]

    # Global GLL node lattice: (nx*N + 1, ny*N + 1, nz*N + 1) unique nodes.
    gx, gy, gz = nx * n + 1, ny * n + 1, nz * n + 1

    def lattice_id(ix, iy, iz):
        return (ix * gy + iy) * gz + iz

    i_loc = np.arange(n1)
    # Node (e,(k,j,i)) sits at lattice (ex*N + i, ey*N + j, ez*N + k).
    ix = e_idx[:, 0, None, None, None] * n + i_loc[None, None, None, :]
    iy = e_idx[:, 1, None, None, None] * n + i_loc[None, None, :, None]
    iz = e_idx[:, 2, None, None, None] * n + i_loc[None, :, None, None]
    global_ids = lattice_id(ix, iy, iz).astype(np.int32)

    n_global = gx * gy * gz
    bx = np.zeros((gx, gy, gz), dtype=bool)
    bx[0], bx[-1] = True, True
    bx[:, 0], bx[:, -1] = True, True
    bx[:, :, 0], bx[:, :, -1] = True, True
    boundary = bx.reshape(-1)
    return BoxMesh(verts, global_ids, n_global, boundary, (nx, ny, nz), n)


class MeshPartition(NamedTuple):
    """An element partition of a :class:`BoxMesh` over ``n_shards`` shards.

    The shards form a Cartesian **shard grid** ``grid = (px, py, pz)`` with
    ``px * py * pz == n_shards``; shard ``(sx, sy, sz)`` has linear index
    ``(sx * py + sy) * pz + sz`` and holds a contiguous sub-box of the
    element index space (a balanced chunk of each axis extent).  The
    degenerate 1-D grid ``(n_shards, 1, 1)`` — also what ``grid=None``
    means — splits the *linear element order* into balanced contiguous
    ranges instead (x-slabs whenever the extents divide evenly), which is
    exactly the original slab partition and needs no per-axis divisibility.
    Shards are padded to a common per-shard count with "dead" elements.
    Every shard gets a *local dof space* of fixed size ``n_local``: the unique
    global dofs its real elements touch, then padding, then one trailing
    **trash slot** (index ``n_local - 1``) that absorbs all dead-element and
    not-present writes.  Dofs living on more than one shard are the *shared*
    (interface) dofs — the only values that ever cross shards.

    Within each shard the real elements are reordered **interface first**:
    an element is *interface* iff any of its dofs is shared with another
    shard, so slots ``[0, iface_counts[s])`` hold every element that can
    contribute to a shared dof and slots from there to ``elem_counts[s]``
    are pure-interior.  ``e_iface = max(iface_counts)`` is the static split
    point the overlapped solver uses: computing slots ``[0, e_iface)`` first
    produces every interface-dof contribution, so the neighbour exchange can
    fly while slots ``[e_iface, EP)`` compute.

    All arrays are numpy (host-side, setup-time); shapes use
    S = n_shards, EP = e_per_shard, L = n_local, NS = n_shared.

    n_shards:       number of shards S.
    e_per_shard:    padded element count per shard (EP).
    n_local:        per-shard local dof count L, incl. the trash slot.
    n_shared:       NS — total interface dofs (>= 1; padded with a dummy).
    elem_counts:    (S,) real (un-padded) elements per shard.
    verts:          (S, EP, 8, 3) element vertices; dead elements hold the
                    reference cube so det(J) != 0.
    local_ids:      (S, EP, N1, N1, N1) int32 — node -> local dof index;
                    dead elements point at the trash slot.
    local_to_global:(S, L) int32 — local slot -> global dof (0 for padding
                    and trash: those slots are masked everywhere they matter).
    owned_mask:     (S, L) bool — True iff this shard owns the dof (each
                    global dof is owned by exactly one shard; padding/trash
                    slots are never owned).
    valid_mask:     (S, L) bool — True on real local dofs (owned or ghost);
                    False on padding and the trash slot.
    shared_idx:     (S, NS) int32 — for every interface dof, its local slot
                    on this shard, or the trash slot when not present here.
    shared_present: (S, NS) bool — interface dof lives on this shard.
    iface_counts:   (S,) interface-element count per shard (those elements
                    occupy the shard's first slots).
    e_iface:        max(iface_counts) — the static interface/interior
                    element split point (0 when S == 1).
    elem_perm:      (S, EP) int64 — original mesh element index held by
                    each shard slot (the interface-first reordering made
                    explicit); -1 on dead padding slots.
    nbr_offsets:    tuple of positive shard-index offsets k such that SOME
                    pair (s, s + k) shares at least one dof — the neighbour
                    adjacency, expressed as point-to-point shift
                    distances (the neighbour exchange, a later slice).  On a
                    box grid these are the linearized shard-grid shifts
                    |(dx * py + dy) * pz + dz| of the face/edge/corner
                    neighbours (two distinct grid shifts may linearize to
                    the same k; their pair sets merge harmlessly because
                    the tables are per source shard).  With 1-D slabs this
                    is a handful of small integers.
    nbr_lo_idx:     per offset k, (S, M_k) int32 — on shard s, the local
                    slots of the dofs shared between s and s + k, sorted by
                    global id (so both sides enumerate them identically);
                    trash-padded to the per-offset max count M_k.  Rows
                    s >= S - k are all-trash.
    nbr_lo_mask:    per offset k, (S, M_k) bool — valid entries above.
    nbr_hi_idx:     per offset k, (S, M_k) int32 — on shard s, the local
                    slots of the dofs shared between s - k and s, in the
                    SAME sorted order the low side uses.  Rows s < k are
                    all-trash.
    nbr_hi_mask:    per offset k, (S, M_k) bool.
    grid:           (px, py, pz) — the shard grid this partition was built
                    on ((n_shards, 1, 1) for the 1-D slab partition).
    """

    n_shards: int
    e_per_shard: int
    n_local: int
    n_shared: int
    elem_counts: np.ndarray
    verts: np.ndarray
    local_ids: np.ndarray
    local_to_global: np.ndarray
    owned_mask: np.ndarray
    valid_mask: np.ndarray
    shared_idx: np.ndarray
    shared_present: np.ndarray
    iface_counts: np.ndarray
    e_iface: int
    elem_perm: np.ndarray
    nbr_offsets: tuple
    nbr_lo_idx: tuple
    nbr_lo_mask: tuple
    nbr_hi_idx: tuple
    nbr_hi_mask: tuple
    grid: tuple = (0, 0, 0)


def _axis_chunks(extent: int, parts: int) -> list:
    """Balanced contiguous index chunks of ``range(extent)`` (first chunks
    take the remainder), as a list of index arrays."""
    base, extra = divmod(extent, parts)
    sizes = [base + (1 if i < extra else 0) for i in range(parts)]
    starts = np.concatenate([[0], np.cumsum(sizes)])
    return [np.arange(starts[i], starts[i + 1]) for i in range(parts)]


def auto_grid(shape: tuple, n_shards: int) -> tuple:
    """Factorize ``n_shards`` into the (px, py, pz) shard grid with the
    smallest cut surface on a mesh of element extents ``shape``.

    The cut surface counts the element faces on shard boundaries —
    ``(px-1)*ny*nz + (py-1)*nx*nz + (pz-1)*nx*ny`` — which is what the
    per-shard shared-dof count scales with, so minimizing it drives the
    sub-boxes toward cubes (the O((E/S)^(2/3)) surface regime).  Only
    factorizations whose per-axis counts fit the extents are considered;
    the 1-D slab ``(n_shards, 1, 1)`` (which needs no divisibility) is
    always a candidate, so a feasible grid always exists for
    ``n_shards <= E``.  Ties break toward splitting earlier (x, then y)
    axes, deterministically.
    """
    nx, ny, nz = shape
    best = None
    for px in range(1, n_shards + 1):
        if n_shards % px:
            continue
        rest = n_shards // px
        for py in range(1, rest + 1):
            if rest % py:
                continue
            pz = rest // py
            cand = (px, py, pz)
            if cand != (n_shards, 1, 1) and (px > nx or py > ny or pz > nz):
                continue  # an axis cannot produce that many nonempty chunks
            score = ((px - 1) * ny * nz + (py - 1) * nx * nz
                     + (pz - 1) * nx * ny)
            key = (score, -px, -py)
            if best is None or key < best[0]:
                best = (key, cand)
    return best[1]


def normalize_grid(grid, shape, n_shards: int) -> tuple:
    """Validate/resolve a shard-grid spec to a concrete (px, py, pz).

    ``None`` -> the 1-D slab grid ``(n_shards, 1, 1)``; ``"auto"`` ->
    :func:`auto_grid`; a 1-/2-/3-tuple is padded with trailing 1s and must
    multiply to ``n_shards``.  Multi-axis grids additionally need each
    per-axis count to fit the element extent (balanced chunks must all be
    nonempty); the 1-D grid has no such constraint (it splits the linear
    element order, not the x axis).

    ``shape=None`` runs only the mesh-independent checks (spec form,
    positivity, shard-count product) — what `make_solver_ctx` validates
    eagerly, before any mesh exists; ``"auto"`` then passes through
    unresolved.  This is the ONE implementation of the grid-spec rules.
    """
    if grid is None:
        return (n_shards, 1, 1)
    if isinstance(grid, str):
        if grid != "auto":
            raise ValueError(f"grid must be a tuple, None or 'auto', "
                             f"got {grid!r}")
        return grid if shape is None else auto_grid(shape, n_shards)
    grid = tuple(int(p) for p in grid)
    if not 1 <= len(grid) <= 3:
        raise ValueError(f"grid must have 1-3 axes, got {grid}")
    grid = grid + (1,) * (3 - len(grid))
    if any(p < 1 for p in grid):
        raise ValueError(f"grid counts must be >= 1, got {grid}")
    px, py, pz = grid
    if px * py * pz != n_shards:
        raise ValueError(f"grid {grid} has {px * py * pz} shards but "
                         f"{n_shards} devices/shards are requested")
    if grid != (n_shards, 1, 1) and shape is not None:
        nx, ny, nz = shape
        if px > nx or py > ny or pz > nz:
            raise ValueError(
                f"grid {grid} does not fit the element extents {shape}: "
                f"each axis needs at least one element per chunk (use the "
                f"1-D slab grid ({n_shards}, 1, 1), or 'auto')")
    return grid


def _shard_element_sets(mesh: BoxMesh, n_shards: int, grid: tuple) -> list:
    """Per-shard element index arrays (ascending mesh-linear order).

    The 1-D grid splits the linear element order into balanced contiguous
    ranges — bit-for-bit the original slab partition.  A multi-axis grid
    gives shard (sx, sy, sz) the sub-box chunk_x[sx] x chunk_y[sy] x
    chunk_z[sz] of the element index space; the element's linear id is
    ``(ex * ny + ey) * nz + ez`` (the `box_mesh` x-major order).
    """
    if grid == (n_shards, 1, 1):
        # the 1-D slab IS balanced chunking of the linear element order —
        # same remainder-first rule, one implementation
        return _axis_chunks(len(mesh.verts), n_shards)
    nx, ny, nz = mesh.shape
    px, py, pz = grid
    cx, cy, cz = (_axis_chunks(nx, px), _axis_chunks(ny, py),
                  _axis_chunks(nz, pz))
    out = []
    for sx in range(px):
        for sy in range(py):
            for sz in range(pz):
                ids = ((cx[sx][:, None, None] * ny + cy[sy][None, :, None])
                       * nz + cz[sz][None, None, :])
                out.append(ids.reshape(-1))
    return out


def _reference_cube_verts() -> np.ndarray:
    """The [-1, 1]^3 cube in paper Def. 2 vertex order (dead-element pad)."""
    v = np.empty((8, 3))
    for vtx in range(8):
        v[vtx] = [2.0 * (vtx & 1) - 1.0, 2.0 * ((vtx >> 1) & 1) - 1.0,
                  2.0 * ((vtx >> 2) & 1) - 1.0]
    return v


def partition_elements(mesh: BoxMesh, n_shards: int,
                       grid=None) -> MeshPartition:
    """Partition mesh elements into ``n_shards`` contiguous sub-boxes.

    ``grid`` selects the shard-grid shape (see :func:`normalize_grid`):
    ``None`` / ``(n_shards,)`` / ``(n_shards, 1, 1)`` give the original 1-D
    slab partition (bit-for-bit — balanced contiguous ranges of the linear
    element order), ``(px, py, pz)`` a Cartesian box decomposition whose
    per-shard interface surface scales as O((E/S)^(2/3)) instead of the
    slab's full cross-section, and ``"auto"`` the smallest-surface
    factorization of ``n_shards``.

    Builds the per-shard local dof spaces, the shared-dof (interface) index
    sets that the all-reduce exchange uses (``exchange_shared``), the
    neighbour-shard adjacency + per-neighbour send/recv index sets of the
    point-to-point exchange (``gather_scatter.exchange_neighbour``) — on a
    box grid
    the offsets are linearized shard-grid shifts covering face, edge AND
    corner neighbours, and a dof on a sub-box edge/corner can be shared by
    4 or 8 shards (each sharer pair gets its own table entry, which is
    exactly what the pairwise exchange needs) — and the interface-first
    element ordering the overlapped solver splits on.  Ownership stays
    lowest-shard-linear-index.  Pure numpy; runs once at setup.
    """
    e_total = len(mesh.verts)
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if n_shards > e_total:
        raise ValueError(f"cannot shard {e_total} elements over "
                         f"{n_shards} shards (need >= 1 element per shard)")
    n1 = mesh.order + 1
    grid = normalize_grid(grid, mesh.shape, n_shards)
    shard_elems = _shard_element_sets(mesh, n_shards, grid)
    counts = np.array([len(se) for se in shard_elems])
    ep = int(counts.max())

    # Per-shard unique dof sets and ownership (the lowest shard-linear-index
    # shard that sees a dof owns it — on a box grid that is well defined at
    # edges/corners too, where 4 or 8 shards meet).
    shard_dofs = []
    for s in range(n_shards):
        ids_s = mesh.global_ids[shard_elems[s]]
        shard_dofs.append(np.unique(ids_s))
    n_local = max(len(d) for d in shard_dofs) + 1        # + trash slot
    trash = n_local - 1

    # Interface dofs: global dofs present on >= 2 shards.
    presence = np.zeros(mesh.n_global, dtype=np.int32)
    for d in shard_dofs:
        presence[d] += 1
    shared_g = np.flatnonzero(presence >= 2)
    n_shared = max(len(shared_g), 1)

    owner = np.full(mesh.n_global, -1, dtype=np.int64)
    for s in range(n_shards - 1, -1, -1):
        owner[shard_dofs[s]] = s

    # Interface ELEMENTS: any of the element's dofs is shared with another
    # shard.  (All such contributions come from these elements, so running
    # them first makes the shared-dof partials complete before the interior
    # elements have even started — the overlap window.)
    elem_iface = (presence[mesh.global_ids] >= 2).any(axis=(1, 2, 3))

    verts = np.broadcast_to(_reference_cube_verts(),
                            (n_shards, ep, 8, 3)).copy()
    local_ids = np.full((n_shards, ep, n1, n1, n1), trash, dtype=np.int32)
    local_to_global = np.zeros((n_shards, n_local), dtype=np.int32)
    owned = np.zeros((n_shards, n_local), dtype=bool)
    valid = np.zeros((n_shards, n_local), dtype=bool)
    shared_idx = np.full((n_shards, n_shared), trash, dtype=np.int32)
    shared_present = np.zeros((n_shards, n_shared), dtype=bool)
    iface_counts = np.zeros(n_shards, dtype=np.int64)
    elem_perm = np.full((n_shards, ep), -1, dtype=np.int64)
    g2l_all = []

    for s in range(n_shards):
        ne = counts[s]
        dofs = shard_dofs[s]
        nl = len(dofs)
        # interface-first stable reorder of this shard's slab/sub-box
        slab = shard_elems[s]
        iface = elem_iface[slab] if n_shards > 1 else np.zeros(ne, bool)
        perm = np.concatenate([slab[iface], slab[~iface]])
        iface_counts[s] = int(iface.sum())
        elem_perm[s, :ne] = perm
        verts[s, :ne] = mesh.verts[perm]
        # global -> local remap of this shard's connectivity
        g2l = np.full(mesh.n_global, trash, dtype=np.int32)
        g2l[dofs] = np.arange(nl, dtype=np.int32)
        g2l_all.append(g2l)
        local_ids[s, :ne] = g2l[mesh.global_ids[perm]]
        local_to_global[s, :nl] = dofs
        owned[s, :nl] = owner[dofs] == s
        valid[s, :nl] = True
        if len(shared_g):
            shared_idx[s] = g2l[shared_g]
            shared_present[s] = shared_idx[s] != trash
            # a shared dof whose local slot happens to be the trash slot is
            # impossible: real slots stop at nl <= trash

    # Neighbour adjacency + per-pair index sets.  For every ordered pair
    # (s, s + k) sharing >= 1 dof: the shared set, sorted by global id so
    # both sides enumerate it identically, remapped to each side's local
    # slots and padded (trash/False) to the per-offset max count.  A dof
    # shared by > 2 shards appears in every pairwise set it belongs to —
    # the pairwise exchange then delivers every other sharer's partial
    # directly, which is exactly what summing to the full value needs.
    # Pair sets come from the (S, NS) presence matrix (a vectorized AND per
    # offset over the interface dofs only), not per-pair set intersections
    # of the full dof arrays.
    pair_dofs = {}
    for k in range(1, n_shards):
        both = shared_present[:-k] & shared_present[k:]      # (S - k, NS)
        if both.any():
            # shared_g is ascending, so each column list is sorted by
            # global id — the order both sides of the exchange rely on
            pair_dofs[k] = [shared_g[both[s]] for s in range(n_shards - k)]
    nbr_offsets = tuple(sorted(pair_dofs))
    nbr_lo_idx, nbr_lo_mask, nbr_hi_idx, nbr_hi_mask = [], [], [], []
    for k in nbr_offsets:
        cols = pair_dofs[k]
        mk = max(len(c) for c in cols)
        lo_i = np.full((n_shards, mk), trash, dtype=np.int32)
        lo_m = np.zeros((n_shards, mk), dtype=bool)
        hi_i = np.full((n_shards, mk), trash, dtype=np.int32)
        hi_m = np.zeros((n_shards, mk), dtype=bool)
        for s, c in enumerate(cols):
            nc = len(c)
            lo_i[s, :nc] = g2l_all[s][c]
            lo_m[s, :nc] = True
            hi_i[s + k, :nc] = g2l_all[s + k][c]
            hi_m[s + k, :nc] = True
        nbr_lo_idx.append(lo_i)
        nbr_lo_mask.append(lo_m)
        nbr_hi_idx.append(hi_i)
        nbr_hi_mask.append(hi_m)
    return MeshPartition(n_shards, ep, n_local, n_shared, counts, verts,
                         local_ids, local_to_global, owned, valid,
                         shared_idx, shared_present, iface_counts,
                         int(iface_counts.max()) if n_shards > 1 else 0,
                         elem_perm, nbr_offsets, tuple(nbr_lo_idx),
                         tuple(nbr_lo_mask), tuple(nbr_hi_idx),
                         tuple(nbr_hi_mask), grid)


def deform_affine(mesh: BoxMesh, matrix: np.ndarray | None = None,
                  seed: int = 0) -> BoxMesh:
    """Apply a global affine map: every element becomes a parallelepiped."""
    if matrix is None:
        rng = np.random.default_rng(seed)
        matrix = np.eye(3) + 0.2 * rng.standard_normal((3, 3))
    verts = mesh.verts @ matrix.T
    return mesh._replace(verts=verts)


def deform_trilinear(mesh: BoxMesh, amplitude: float = 0.08,
                     seed: int = 0) -> BoxMesh:
    """Smoothly warp the shared vertex grid: general trilinear elements.

    The warp is applied per-*vertex* (shared between neighbours), keeping the
    mesh conforming while destroying the parallelepiped property.  Amplitude
    is kept small relative to the element size so det(J) > 0 everywhere.
    `seed` is accepted for signature parity with the reference; the warp is
    deterministic.
    """
    v = mesh.verts.reshape(-1, 3)
    lo, hi = v.min(axis=0), v.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    u = (v - lo) / span  # in [0, 1]^3
    nx, ny, nz = mesh.shape
    h = amplitude * span / np.array([nx, ny, nz])
    # sin warp vanishing on the boundary faces (domain shape preserved) but
    # nowhere in the interior — the frequencies must be pi, not 2*pi, or the
    # warp would vanish on every vertex of evenly-divided grids.
    s = (np.sin(np.pi * u[:, 0]) * np.sin(np.pi * u[:, 1])
         * np.sin(np.pi * u[:, 2]))
    offset = np.stack([h[0] * s * (1.0 + 0.4 * u[:, 1]),
                       h[1] * s * (1.0 + 0.4 * u[:, 2]),
                       h[2] * s * (1.0 + 0.4 * u[:, 0])], axis=-1)
    verts = (v + offset).reshape(mesh.verts.shape)
    return mesh._replace(verts=verts)
