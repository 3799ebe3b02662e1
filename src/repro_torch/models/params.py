"""Parameter specs: shapes, dtypes and logical sharding axes before values
exist (the reference's `models/params.py`, single-device part).

Models declare their parameters as a tree of `ParamSpec(shape, axes, dtype,
init_scale)`.  From the spec tree the port derives, without allocating, its
byte count (`spec_bytes`) and the modules that hold the parameters
(`ParamTree`, on the `meta` device when only shapes are wanted); and it
materialises values with `init_from_specs`.  The logical axes are kept for
the sharded LM slice, which brings the mesh functions (`resolve_pspec`,
`specs_to_shardings`, `abstract_params`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

__all__ = ["ParamSpec", "ParamTree", "init_from_specs", "fill_from_specs",
           "spec_bytes", "FILL_CHUNK"]

# the most float32 values `fill_from_specs` draws at once (1 GiB)
FILL_CHUNK = 1 << 28


class ParamSpec:
    """shape + dtype + logical axis names (one per dim; None = replicated)."""

    __slots__ = ("shape", "dtype", "axes", "init_scale")

    def __init__(self, shape: Tuple[int, ...], axes: Tuple[Optional[str], ...],
                 dtype=torch.float32, init_scale: float = 1.0):
        assert len(shape) == len(axes), (shape, axes)
        self.shape = tuple(shape)
        self.dtype = dtype
        self.axes = tuple(axes)
        self.init_scale = init_scale

    def __repr__(self):
        return f"ParamSpec({self.shape}, {self.axes}, {self.dtype})"


def spec_bytes(specs) -> int:
    return sum(math.prod(s.shape) * s.dtype.itemsize
               if isinstance(s, ParamSpec) else spec_bytes(s)
               for s in specs.values())


def init_from_specs(specs, generator: torch.Generator, device):
    """Materialise a spec tree as a dict tree of tensors on `device`.

    The reference's rule: zeros where init_scale is 0; for a leaf of one
    dimension or none, ones where init_scale is -1 and zeros otherwise;
    every other leaf a normal truncated to [-2, 2], times
    init_scale / sqrt(fan_in) with fan_in the product of all dimensions but
    the last, drawn in float32 and cast to the leaf's dtype.  The values
    come from `generator`, leaf after leaf in the tree's order, on the
    generator's device; they cannot match the reference's `jax.random`
    bits, so tests carry the reference's values across
    (`convert.lm_params_from_numpy`) instead.
    """
    device = torch.device(device)

    def make(s: ParamSpec):
        if s.init_scale == 0.0 or (len(s.shape) <= 1 and s.init_scale != -1.0):
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        if len(s.shape) <= 1:
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        fan_in = math.prod(s.shape[:-1])
        std = s.init_scale / math.sqrt(max(fan_in, 1))
        val = torch.empty(s.shape, dtype=torch.float32,
                          device=generator.device)
        nn.init.trunc_normal_(val, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return (val * std).to(device=device, dtype=s.dtype)

    def walk(tree):
        return {name: make(s) if isinstance(s, ParamSpec) else walk(s)
                for name, s in tree.items()}

    return walk(specs)


@torch.no_grad()
def fill_from_specs(specs, params, generator: torch.Generator) -> None:
    """Write `init_from_specs(specs, generator, ...)`'s values into
    `params` in place: a tree of the spec's names whose leaves are tensors,
    where a list of like trees (a model's layers) stands for a spec stacked
    on a leading 'layers' axis (`DecoderLM.param_tree`).

    The leaves are drawn in the spec tree's order, from the same generator
    stream, and a leaf of at most FILL_CHUNK values in one draw, as
    `init_from_specs` draws it: such a leaf gets `init_from_specs`' bits.
    A larger leaf is drawn in pieces of FILL_CHUNK values in its element
    order, so that no leaf is ever held whole in float32 beside the
    parameters: it gets other values of the same distribution (a
    truncated-normal draw depends on the size of the tensor drawn).
    """
    def leaf(s: ParamSpec, tensors):
        if s.init_scale == 0.0 or (len(s.shape) <= 1 and s.init_scale != -1.0):
            for t in tensors:
                t.zero_()
            return
        if len(s.shape) <= 1:
            for t in tensors:
                t.fill_(1)
            return
        std = s.init_scale / math.sqrt(max(math.prod(s.shape[:-1]), 1))
        flat = [t.view(-1) for t in tensors]
        total = sum(t.numel() for t in flat)
        ti = off = 0                   # the tensor and offset written next
        for start in range(0, total, FILL_CHUNK):
            n = min(FILL_CHUNK, total - start)
            val = torch.empty(n, dtype=torch.float32, device=generator.device)
            nn.init.trunc_normal_(val, 0.0, 1.0, -2.0, 2.0,
                                  generator=generator)
            val = val * std
            done = 0
            while done < n:
                m = min(n - done, flat[ti].numel() - off)
                flat[ti][off:off + m].copy_(val[done:done + m])
                done, off = done + m, off + m
                if off == flat[ti].numel():
                    ti, off = ti + 1, 0

    def walk(spec, target):
        for name, s in spec.items():
            sub = [t[name] for t in target] if isinstance(target, list) \
                else target[name]
            if isinstance(s, ParamSpec):
                leaf(s, sub if isinstance(sub, list) else [sub])
            else:
                walk(s, sub)

    walk(specs, params)


class ParamTree(nn.Module):
    """Parameters laid out as a spec tree: a `ParamSpec` leaf becomes an
    (uninitialised) `nn.Parameter` on `device`, a dict a child `ParamTree`.

    Indexing by name (`p["wq"]["w"]`) and `"b" in p` read it as the
    reference's functions read their dict trees.
    """

    def __init__(self, specs, device):
        super().__init__()
        for name, s in specs.items():
            if isinstance(s, ParamSpec):
                self.register_parameter(name, nn.Parameter(
                    torch.empty(s.shape, dtype=s.dtype, device=device),
                    requires_grad=False))
            else:
                self.add_module(name, ParamTree(s, device))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def tree(self):
        """The parameters as a dict tree of the spec's names."""
        return dict(self._parameters) | {
            name: m.tree() for name, m in self._modules.items()}

    @torch.no_grad()
    def load(self, values) -> None:
        """Copy a dict tree of tensors of this tree's shapes into it."""
        if set(values) != set(self._parameters) | set(self._modules):
            raise KeyError(f"parameter names {sorted(values)} do not match "
                           f"{sorted(set(self._parameters) | set(self._modules))}")
        for name, v in values.items():
            if name in self._parameters:
                p = self._parameters[name]
                if tuple(v.shape) != tuple(p.shape):
                    raise ValueError(f"{name}: shape {tuple(v.shape)}, the "
                                     f"parameter is {tuple(p.shape)}")
                p.copy_(v)
            else:
                self._modules[name].load(v)
