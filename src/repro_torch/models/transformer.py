"""Decoder-only LM: GQA blocks, the training loss, prefill and ragged decode
with a KV cache (the reference's `models/transformer.py`, dense, MoE and
VLM paths).

`DecoderLM` is an `nn.Module` whose parameters mirror the reference's tree
(`param_specs`), one `ParamTree` a layer in an `nn.ModuleList`.  The MoE
family's layers carry `models.moe`'s layer in place of the MLP, behind
`cfg.first_dense_layers` dense layers (`dense_layers`, run first; their
KV cache is the cache's "dense" part); each MoE layer's router loss is
summed into the loss's "aux".  The layers run as a Python loop.  `loss`
follows the reference's rematerialisation (`remat_wrap`, `cfg.remat`,
`cfg.scan_group`) with `torch.utils.checkpoint`:
"full" recomputes each layer in the backward, "dots" saves the outputs of
its matrix products without batch dimensions and recomputes the rest, and
`scan_group` > 1 checkpoints groups of layers around per-layer checkpoints.
The reference's `hoist_barrier` has no counterpart: it is a fence for XLA
(stopping hoisted upcasts), not mathematics.  Nor do its `ctx`/`constraint`
sharding hooks: this module is single-device, and `ShardCtx` comes with the
multi-card LM slice.  The VLM family's patch embeddings (a stub frontend:
precomputed (B, P, vision_dim) patches) go through `vis_proj` and are put
before the token embeddings; the loss scores the text positions only.

Parameters are made with requires_grad=False; `training.train_loop.
init_state` switches them on.  `prefill` and `decode_step` run under
`torch.no_grad()` either way.

With rope_policy="precomputed" the (131072, Dh/2, 2) rope table is a
buffer filled by `rope.rope_table` at construction, not a parameter (the
reference declares it a parameter, so its init fills it with random
values and its training updates it; ROADMAP Queue 3).
"""

from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.nekbone import resolve_device
from repro_torch.models import attention, moe as moe_mod, rope
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (embed, embedding_spec, linear,
                                       linear_spec, rms_norm, rms_norm_spec)
from repro_torch.models.losses import chunked_ce, project_logits
from repro_torch.models.params import ParamSpec, ParamTree

__all__ = ["DecoderLM", "stack_specs", "remat_wrap", "ROPE_TABLE_LEN",
           "DECODE_CHUNK"]

# rows of the precomputed rope table (the reference's)
ROPE_TABLE_LEN = 131_072
# the KV block of decode attention's flash-decode walk (`attn_decode`)
DECODE_CHUNK = 4096
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def stack_specs(spec, n: int):
    """Add a leading 'layers' dim of size n to every ParamSpec in a tree."""
    return {name: ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                            dtype=s.dtype, init_scale=s.init_scale)
            if isinstance(s, ParamSpec) else stack_specs(s, n)
            for name, s in spec.items()}


# the products "dots" saves: those without batch dimensions (the linear
# layers; attention's batched products are recomputed), the counterpart of
# jax.checkpoint_policies.dots_with_no_batch_dims_saveable
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_products(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_wrap(fn, mode: str):
    """fn under the reference's remat mode: "none", "dots" or "full"."""
    if mode == "none":
        return fn
    if mode == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _save_products)
        return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                        context_fn=context_fn)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def attn_spec(cfg: ModelConfig, dtype):
    d, h, kv, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    spec = {
        "wq": linear_spec(d, h * dh, ("fsdp", "model"), bias=cfg.qkv_bias,
                          dtype=dtype),
        "wk": linear_spec(d, kv * dh, ("fsdp", "model"), bias=cfg.qkv_bias,
                          dtype=dtype),
        "wv": linear_spec(d, kv * dh, ("fsdp", "model"), bias=cfg.qkv_bias,
                          dtype=dtype),
        "wo": linear_spec(h * dh, d, ("model", "fsdp"), dtype=dtype),
    }
    if cfg.qk_norm:
        spec["q_norm"] = rms_norm_spec(dh)
        spec["k_norm"] = rms_norm_spec(dh)
    return spec


def _qkv(p, x, cfg: ModelConfig, positions, rope_tab):
    b, s, _ = x.shape
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = linear(p["wq"], x).reshape(b, s, h, dh)
    k = linear(p["wk"], x).reshape(b, s, kv, dh)
    v = linear(p["wv"], x).reshape(b, s, kv, dh)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    q, k = rope.apply_rope(q, k, positions, cfg.rope_theta, rope_tab)
    return q, k, v


def attn_apply(p, x, cfg: ModelConfig, positions, rope_tab,
               causal: bool = True):
    """Self-attention over a whole sequence, causal or (the enc-dec
    family's encoder) bidirectional; returns (out, (k, v))."""
    q, k, v = _qkv(p, x, cfg, positions, rope_tab)
    o = attention.causal_attention(q, k, v, chunk=cfg.attn_chunk,
                                   causal=causal)
    b, s = x.shape[:2]
    o = o.reshape(b, s, cfg.num_heads * cfg.resolved_head_dim)
    return linear(p["wo"], o), (k, v)


def attn_decode(p, x, cfg: ModelConfig, k_cache, v_cache, cur_len,
                rope_tab):
    """x: (B, 1, D); caches: (B, Smax, KV, Dh), written in place.

    cur_len is an int (lock-step decode) or a (B,) integer tensor (ragged
    continuous batching): per-slot rope position, per-slot cache write.
    """
    b = x.shape[0]
    ragged = torch.is_tensor(cur_len) and cur_len.ndim == 1
    if ragged:
        cur_len = cur_len.to(device=x.device, dtype=torch.long)
        positions = cur_len[:, None]
    else:
        cur_len = int(cur_len)
        positions = torch.full((b, 1), cur_len, dtype=torch.long,
                               device=x.device)
    q, k, v = _qkv(p, x, cfg, positions, rope_tab)
    if ragged:
        idx = torch.arange(b, device=x.device)
        k_cache[idx, cur_len] = k[:, 0].to(k_cache.dtype)
        v_cache[idx, cur_len] = v[:, 0].to(v_cache.dtype)
        length = cur_len + 1
    else:
        k_cache[:, cur_len] = k[:, 0].to(k_cache.dtype)
        v_cache[:, cur_len] = v[:, 0].to(v_cache.dtype)
        length = torch.full((b,), cur_len + 1, dtype=torch.long,
                            device=x.device)
    o = attention.decode_attention(q, k_cache, v_cache, length,
                                   chunk=DECODE_CHUNK)
    o = o.reshape(b, 1, cfg.num_heads * cfg.resolved_head_dim)
    return linear(p["wo"], o)


def mlp_spec(cfg: ModelConfig, dtype):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": linear_spec(d, f, ("fsdp", "model"), dtype=dtype),
        "w_up": linear_spec(d, f, ("fsdp", "model"), dtype=dtype),
        "w_down": linear_spec(f, d, ("model", "fsdp"), dtype=dtype),
    }


def mlp_apply(p, x):
    h = F.silu(linear(p["w_gate"], x)) * linear(p["w_up"], x)
    return linear(p["w_down"], h)


def layer_spec(cfg: ModelConfig, dtype, use_moe: bool):
    spec = {
        "ln1": rms_norm_spec(cfg.d_model),
        "attn": attn_spec(cfg, dtype),
        "ln2": rms_norm_spec(cfg.d_model),
    }
    if use_moe:
        spec["moe"] = moe_mod.moe_spec(cfg, dtype)
    else:
        spec["mlp"] = mlp_spec(cfg, dtype)
    return spec


def layer_apply(p, x, cfg: ModelConfig, positions, rope_tab):
    """One block over a whole sequence; returns (x, the float32 router
    loss (0 for a dense block), (k, v))."""
    a, kv = attn_apply(p["attn"], rms_norm(p["ln1"], x, cfg.norm_eps), cfg,
                       positions, rope_tab)
    x = x + a
    h = rms_norm(p["ln2"], x, cfg.norm_eps)
    if "moe" in p:
        m, aux = moe_mod.moe_apply(p["moe"], h, cfg)
    else:
        m = mlp_apply(p["mlp"], h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + m, aux, kv


def layer_decode(p, x, cfg: ModelConfig, k_cache, v_cache, cur_len,
                 rope_tab):
    a = attn_decode(p["attn"], rms_norm(p["ln1"], x, cfg.norm_eps), cfg,
                    k_cache, v_cache, cur_len, rope_tab)
    x = x + a
    h = rms_norm(p["ln2"], x, cfg.norm_eps)
    if "moe" in p:
        return x + moe_mod.moe_apply(p["moe"], h, cfg)[0]
    return x + mlp_apply(p["mlp"], h)


def _unstack(tree, i: int):
    return {name: v[i] if torch.is_tensor(v) else _unstack(v, i)
            for name, v in tree.items()}


class DecoderLM(nn.Module):
    """Dense, MoE and VLM decoder LM.

    Its parameters live on `device` (the CUDA device unless the caller
    names another; "meta" gives shapes without allocating) and start
    uninitialised: fill them with `params.fill_from_specs`,
    `load_params` or `convert.lm_params_from_numpy`.
    """

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.dtype]
        spec = self.param_specs()
        self.embed = ParamTree(spec["embed"], device)
        n_dense = self._n_dense()
        self.dense_layers = nn.ModuleList(
            ParamTree(layer_spec(cfg, self.dtype, use_moe=False), device)
            for _ in range(n_dense))
        self.layers = nn.ModuleList(
            ParamTree(layer_spec(cfg, self.dtype, cfg.is_moe), device)
            for _ in range(cfg.num_layers - n_dense))
        self.ln_f = ParamTree(spec["ln_f"], device)
        self.head = ParamTree(spec["head"], device) if "head" in spec \
            else None
        self.vis_proj = ParamTree(spec["vis_proj"], device) \
            if "vis_proj" in spec else None
        self.register_buffer(
            "rope_table", rope.rope_table(ROPE_TABLE_LEN,
                                          cfg.resolved_head_dim,
                                          cfg.rope_theta, device)
            if cfg.rope_policy == "precomputed" else None)

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    def _n_dense(self) -> int:
        return self.cfg.first_dense_layers if self.cfg.is_moe else 0

    # ---------------------------------------------------------- specs ----
    def param_specs(self) -> Dict:
        """The reference's parameter tree, each stack's layers stacked along
        a leading 'layers' axis; the rope table is a buffer, not in it."""
        cfg, dt = self.cfg, self.dtype
        n_dense = self._n_dense()
        spec = {
            "embed": embedding_spec(cfg.padded_vocab, cfg.d_model, dtype=dt),
            "layers": stack_specs(layer_spec(cfg, dt, cfg.is_moe),
                                  cfg.num_layers - n_dense),
            "ln_f": rms_norm_spec(cfg.d_model),
        }
        if n_dense:
            spec["dense_layers"] = stack_specs(
                layer_spec(cfg, dt, use_moe=False), n_dense)
        if not cfg.tie_embeddings:
            spec["head"] = linear_spec(cfg.d_model, cfg.padded_vocab,
                                       ("fsdp", "vocab"), dtype=dt)
        if cfg.vision_patches:
            spec["vis_proj"] = linear_spec(cfg.vision_dim, cfg.d_model,
                                           (None, "fsdp"), dtype=dt)
        return spec

    def param_tree(self) -> Dict:
        """The parameters themselves as `param_specs`' tree, with "layers"
        and "dense_layers" lists of per-layer trees (the reference stacks
        them)."""
        tree = {"embed": self.embed.tree(),
                "layers": [layer.tree() for layer in self.layers],
                "ln_f": self.ln_f.tree()}
        if len(self.dense_layers):
            tree["dense_layers"] = [layer.tree()
                                    for layer in self.dense_layers]
        for name in ("head", "vis_proj"):
            if getattr(self, name) is not None:
                tree[name] = getattr(self, name).tree()
        return tree

    def load_params(self, params) -> None:
        """Copy a tree of `param_specs`' shapes (layers stacked) in."""
        expected = set(self.param_specs())
        if set(params) != expected:
            raise KeyError(f"parameter tree has {sorted(params)}, the model "
                           f"{sorted(expected)}")
        for stack in ("layers", "dense_layers"):
            for i, layer in enumerate(getattr(self, stack)):
                layer.load(_unstack(params[stack], i))
        self.embed.load(params["embed"])
        self.ln_f.load(params["ln_f"])
        for name in ("head", "vis_proj"):
            if getattr(self, name) is not None:
                getattr(self, name).load(params[name])

    def _embed_inputs(self, batch):
        """The token embeddings, behind the projected patches when the
        family has them, and their positions 0 ... P+S-1."""
        x = embed(self.embed, batch["tokens"], self.dtype)
        if self.vis_proj is not None:
            pe = linear(self.vis_proj, batch["patches"].to(self.dtype))
            x = torch.cat([pe, x], dim=1)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device).expand(b, s)
        return x, positions

    # ----------------------------------------------------------- train ----
    def _stack(self, x, positions):
        """The dense layers, then the layers, over a whole sequence under
        `cfg.remat`; returns (x, the router losses summed).  With
        `cfg.scan_group` > 1 dividing the count of `layers`, groups of that
        many are checkpointed around their per-layer checkpoints (the
        reference's two-level scan)."""
        cfg = self.cfg

        def one(xc, lp):
            return layer_apply(lp, xc, cfg, positions, self.rope_table)[:2]

        step = remat_wrap(one, cfg.remat)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in self.dense_layers:
            x, a = step(x, lp)
            aux = aux + a
        layers = list(self.layers)
        g = cfg.scan_group
        if g > 1 and len(layers) % g == 0:
            def group_body(xc, group):
                total = torch.zeros((), dtype=torch.float32,
                                    device=xc.device)
                for lp in group:
                    xc, a = step(xc, lp)
                    total = total + a
                return xc, total

            group_step = remat_wrap(group_body, cfg.remat)
            for i in range(0, len(layers), g):
                x, a = group_step(x, layers[i:i + g])
                aux = aux + a
            return x, aux
        for lp in layers:
            x, a = step(x, lp)
            aux = aux + a
        return x, aux

    def loss(self, batch):
        """batch {"tokens": (B, S) integer tensor[, "patches": (B, P,
        vision_dim)]} -> (loss, {"ce", "aux"}): the mean next-token CE
        (`chunked_ce`) over the text positions plus router_aux_weight times
        the routers' auxiliary losses summed over the layers (0 for the
        dense family)."""
        cfg = self.cfg
        x, positions = self._embed_inputs(batch)
        x, aux = self._stack(x, positions)
        x = rms_norm(self.ln_f, x, cfg.norm_eps)
        if cfg.vision_patches:   # score text positions only
            x = x[:, cfg.vision_patches:]
        ce = chunked_ce(x, batch["tokens"][:, 1:], self.embed, self.head,
                        cfg.vocab_size)
        return ce + cfg.router_aux_weight * aux, {"ce": ce, "aux": aux}

    # ----------------------------------------------------------- serve ----
    def _stacks(self):
        """(cache part, layers) in the order they run."""
        parts = [("dense", self.dense_layers)] if len(self.dense_layers) \
            else []
        return parts + [("main", self.layers)]

    def cache_spec(self, batch: int, max_len: int):
        """{"main": {"k", "v"}} and, with dense layers ahead of the MoE
        ones, {"dense": {"k", "v"}}: (L, B, max_len, KV, Dh) meta tensors,
        L the part's layers."""
        return {part: {name: torch.empty(
            (len(layers), batch, max_len, self.cfg.num_kv_heads,
             self.cfg.resolved_head_dim), dtype=self.dtype, device="meta")
            for name in ("k", "v")} for part, layers in self._stacks()}

    @torch.no_grad()
    def prefill(self, batch):
        """batch {"tokens": (B, S) integer tensor[, "patches": (B, P,
        vision_dim)]} -> (the last position's masked float32 logits (B, 1,
        V_padded), a cache of length P + S)."""
        cfg = self.cfg
        x, positions = self._embed_inputs(batch)
        b, s = x.shape[:2]
        cache = {}
        for part, layers in self._stacks():
            shape = (len(layers), b, s, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
            ks = torch.zeros(shape, dtype=self.dtype, device=x.device)
            vs = torch.zeros(shape, dtype=self.dtype, device=x.device)
            for li, lp in enumerate(layers):
                x, _, (k, v) = layer_apply(lp, x, cfg, positions,
                                           self.rope_table)
                ks[li] = k
                vs[li] = v
            cache[part] = {"k": ks, "v": vs}
        x = rms_norm(self.ln_f, x, cfg.norm_eps)
        lg = project_logits(x[:, -1:], self.embed, self.head, cfg.vocab_size)
        return lg, cache

    @torch.no_grad()
    def decode_step(self, token, cache, cur_len):
        """token: (B, 1) integer tensor; cur_len: int or (B,) tensor.

        Writes each layer's new K/V into `cache` in place and returns
        (masked float32 logits (B, 1, V_padded), cache)."""
        cfg = self.cfg
        x = embed(self.embed, token, self.dtype)
        for part, layers in self._stacks():
            ks, vs = cache[part]["k"], cache[part]["v"]
            for li, lp in enumerate(layers):
                x = layer_decode(lp, x, cfg, ks[li], vs[li], cur_len,
                                 self.rope_table)
        x = rms_norm(self.ln_f, x, cfg.norm_eps)
        lg = project_logits(x, self.embed, self.head, cfg.vocab_size)
        return lg, cache
