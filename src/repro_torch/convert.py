"""Carry state across from the reference package: mesh and setup products.

The solver has no weights; its state is the mesh and the per-element setup
products (geometric factors, vertices, lambda fields).  These functions
take them as numpy arrays — what ``np.asarray`` makes of the reference
package's arrays — so the port never imports the reference package and a
test can feed both packages identical setup products.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.mesh_gen import BoxMesh

__all__ = ["mesh_from_numpy", "elem_ops_from_numpy"]

# elem_ops key sets of the reference make_axhelm_elem_ops, per variant:
# its reference backend's operands, then its kernel backend's packed "geom"
_GEOM_KEYS = {
    "precomputed": ({"g", "gwj"}, {"geom"}),
    "trilinear": ({"verts"}, {"geom"}),
}
_LAMBDA_KEYS = {"lam0", "lam1"}


def mesh_from_numpy(mesh) -> BoxMesh:
    """The port's `BoxMesh` from any object with the reference BoxMesh's
    fields (verts, global_ids, n_global, boundary, shape, order)."""
    return BoxMesh(verts=np.array(mesh.verts, dtype=np.float64),
                   global_ids=np.array(mesh.global_ids, dtype=np.int32),
                   n_global=int(mesh.n_global),
                   boundary=np.array(mesh.boundary, dtype=bool),
                   shape=tuple(int(s) for s in mesh.shape),
                   order=int(mesh.order))


def elem_ops_from_numpy(variant: str, elem_ops: dict, device) -> dict:
    """The port's elem_ops {"geom", optional "lam0"/"lam1"} from the numpy
    arrays of the reference `make_axhelm_elem_ops`, whichever backend made
    them: {"g", "gwj"} are packed into the (E, N1,N1,N1, 7) "geom", {"verts"}
    becomes the trilinear "geom", a packed "geom" is kept.

    Each array becomes a contiguous tensor on `device` in the array's own
    dtype.  Key sets the variant does not read raise.  The reference
    backend keeps scalar lambdas out of its elem_ops; the port's `apply`
    then uses the lambdas given to its own `make_axhelm_elem_ops`.
    """
    if variant not in _GEOM_KEYS:
        raise NotImplementedError(f"no elem_ops conversion for variant "
                                  f"{variant!r} yet")
    arrays = {name: np.asarray(arr) for name, arr in elem_ops.items()}
    geom_keys = set(arrays) - _LAMBDA_KEYS
    if geom_keys not in _GEOM_KEYS[variant]:
        raise ValueError(f"{variant} elem_ops need one of the key sets "
                         f"{[sorted(k) for k in _GEOM_KEYS[variant]]} plus "
                         f"optional lam0/lam1, got {sorted(arrays)}")
    if "g" in arrays:
        arrays["geom"] = np.concatenate(
            [arrays.pop("g"), arrays.pop("gwj")[..., None]], axis=-1)
    elif "verts" in arrays:
        arrays["geom"] = arrays.pop("verts")
    return {name: torch.from_numpy(np.array(arr)).to(device).contiguous()
            for name, arr in arrays.items()}
