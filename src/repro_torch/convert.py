"""Carry state across from the reference package: mesh and setup products,
LM weights and LM train states.

The solver has no weights; its state is the mesh and the per-element setup
products (geometric factors, vertices, lambda fields).  The LM's state is
its parameter tree.  These functions take them as numpy arrays — what
``np.asarray`` makes of the reference package's arrays — so the port never
imports the reference package and a test can feed both packages identical
state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.mesh_gen import BoxMesh
from repro_torch.kernels.axhelm.ref import gelem_from_verts, planar_factors

__all__ = ["mesh_from_numpy", "elem_ops_from_numpy", "lm_params_from_numpy",
           "train_state_from_numpy"]

# elem_ops key sets of the reference make_axhelm_elem_ops, per variant:
# its reference backend's operands, then its kernel backend's "geom"
_GEOM_KEYS = {
    "precomputed": ({"g", "gwj"}, {"geom"}),
    "trilinear": ({"verts"}, {"geom"}),
    "parallelepiped": ({"verts"}, {"geom"}),
    "merged": ({"verts", "lam2", "lam3"}, {"geom"}),
    "partial": ({"verts", "gscale"}, {"geom"}),
}
_LAMBDA_KEYS = {"lam0", "lam1"}
# the reference backend's names of the lambda-slot operands
_SLOT_NAMES = {"lam2": "lam0", "lam3": "lam1", "gscale": "lam0"}


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
    them: {"g" (E, N1,N1,N1, 6), "gwj"} become the planar (E, 7, N1,N1,N1)
    "geom" of precomputed (`ref.planar_factors`), and so does the kernel
    backend's packed (E, N1,N1,N1, 7) "geom" of precomputed; {"verts"}
    becomes the "geom" of trilinear, merged and partial, and
    parallelepiped's (E, 7) `gelem_from_verts`; merged's "lam2"/"lam3"
    become "lam0"/"lam1" and partial's "gscale" becomes "lam0"; any other
    kernel backend's "geom" is kept.

    Each array becomes a contiguous tensor on `device` in the array's own
    dtype.  Key sets the variant does not read raise.  The reference
    backend keeps scalar lambdas out of its elem_ops; the port's `apply`
    then uses the lambdas given to its own `make_axhelm_elem_ops`.
    """
    if variant not in _GEOM_KEYS:
        raise NotImplementedError(f"no elem_ops conversion for variant "
                                  f"{variant!r} yet")
    arrays = {name: torch.from_numpy(np.array(arr))
              for name, arr in elem_ops.items()}
    geom_keys = set(arrays) - _LAMBDA_KEYS
    if geom_keys not in _GEOM_KEYS[variant]:
        raise ValueError(f"{variant} elem_ops need one of the key sets "
                         f"{[sorted(k) for k in _GEOM_KEYS[variant]]} plus "
                         f"optional lam0/lam1, got {sorted(arrays)}")
    if "g" in arrays:
        arrays["geom"] = planar_factors(arrays.pop("g"), arrays.pop("gwj"))
    elif variant == "precomputed":          # the packed [g6, gwj]
        packed = arrays["geom"]
        arrays["geom"] = planar_factors(packed[..., :6], packed[..., 6])
    elif "verts" in arrays:
        verts = arrays.pop("verts")
        arrays["geom"] = (gelem_from_verts(verts)
                          if variant == "parallelepiped" else verts)
    for name, slot in _SLOT_NAMES.items():
        if name in arrays:
            arrays[slot] = arrays.pop(name)
    return {name: t.to(device).contiguous() for name, t in arrays.items()}


def _tensor_from_numpy(arr) -> torch.Tensor:
    """A tensor of the array's values; bfloat16 (numpy's ml_dtypes type,
    which torch.from_numpy refuses) goes through float32, exactly."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def lm_params_from_numpy(cfg, params, device=None):
    """The port's model for `cfg` (`build_model`'s: `DecoderLM`,
    `HybridLM`, `XLSTMLM` or `EncDecLM`) on `device`
    (the CUDA device unless the caller names another), holding the
    reference's parameter tree given as numpy arrays
    (``jax.tree.map(np.asarray, params)``).

    The leading 'layers' axis of "layers" (and of the MoE family's
    "dense_layers", the hybrid family's "mamba" stack, the xLSTM family's
    "ln_m", "mlstm", "ln_s" and "slstm" stacks of pairs, and the enc-dec
    family's "enc_layers" and "dec_layers") is unstacked into the model's
    layers, and the (d_in, d_out) weight layout is kept; the MoE layers'
    "moe" subtrees (router, experts, shared experts), the VLM family's
    "vis_proj", the hybrid family's "shared" block, the enc-dec family's
    "audio_proj" and "ln_enc", "ln_f" and an untied "head" come across as
    they are.  The reference's
    `rope_table` leaf (rope_policy="precomputed") is not carried: the
    port's table is a buffer made by `rope.rope_table` (ROADMAP Queue 3).
    """
    from repro_torch.models.registry import build_model

    model = build_model(cfg, device=device)

    def convert(tree):
        return {name: _tensor_from_numpy(v) if not isinstance(v, dict)
                else convert(v) for name, v in tree.items()}

    model.load_params(convert({name: v for name, v in params.items()
                               if name != "rope_table"}))
    return model


def _numpy_leaves(tree) -> list:
    """A numpy tree's arrays in the reference's order (dict keys sorted,
    a NamedTuple's fields in turn)."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _numpy_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [a for v in tree for a in _numpy_leaves(v)]
    return [tree]


def train_state_from_numpy(cfg, state, device=None):
    """(the port's model for `cfg`, its train state) on `device` (the
    CUDA device unless the caller names another), holding the reference's
    whole train state given as numpy arrays (``jax.tree.map(np.asarray,
    state)``): the parameters, the AdamW moments (the 8-bit `QState`s when
    the reference's state has them) and its counters.  The state is the
    port's `train_loop.init_state` filled leaf by leaf, in the reference's
    order; the `rope_table` leaf and its moments are not carried (see
    `lm_params_from_numpy`)."""
    from repro_torch.training.optimizer import tree_fill
    from repro_torch.training.train_loop import TrainConfig, init_state

    def drop_rope(tree):
        return {k: v for k, v in tree.items() if k != "rope_table"}

    params = drop_rope(state["params"])
    model = lm_params_from_numpy(cfg, params, device=device)
    mu = drop_rope(state["opt"]["mu"])
    eight_bit = hasattr(mu["embed"]["table"]["m"], "q")     # a QState
    port = init_state(model, TrainConfig(eight_bit_optimizer=eight_bit))
    ref = {"opt": {"count": state["opt"]["count"], "mu": mu},
           "params": params, "step": state["step"]}
    tree_fill(port, [_tensor_from_numpy(a) for a in _numpy_leaves(ref)])
    return model, port

