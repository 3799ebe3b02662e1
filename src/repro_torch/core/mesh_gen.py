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
its device.  Element partitioning for the sharded solve is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["BoxMesh", "box_mesh", "deform_affine", "deform_trilinear"]


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
