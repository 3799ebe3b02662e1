"""Zamba2-style hybrid: a Mamba-2 backbone and one *shared* attention block
(the reference's `models/hybrid.py`).

`num_layers` Mamba-2 blocks run in groups of `attn_every`; after each group
the single shared-parameter attention+MLP block runs (`transformer.
layer_apply` / `layer_decode` with no rope table: 9 applications of one
block for 54/6).  Decode carries an ssm and a conv state a Mamba block and
one KV cache a shared-block site, all written in place.

`loss` follows `cfg.remat` as `DecoderLM.loss` does: each Mamba block, and
each application of the shared block, under its own `torch.utils.
checkpoint` ("full").  The reference checkpoints only the Mamba blocks;
recomputing the shared block too changes no number and keeps its
attention's float32 score blocks from being held at every site for the
backward.  The mesh hooks (`ctx`, `cache_pspec`) come with the multi-card
LM slice (ROADMAP Queue 1, item 5, slice 8).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.core.nekbone import resolve_device
from repro_torch.models import mamba2, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (embed, embedding_spec, linear_spec,
                                       rms_norm, rms_norm_spec)
from repro_torch.models.losses import chunked_ce, project_logits
from repro_torch.models.params import ParamTree
from repro_torch.models.transformer import remat_wrap, stack_specs

__all__ = ["HybridLM"]


class HybridLM(nn.Module):
    """The hybrid LM, with `DecoderLM`'s interface.  Its parameters live
    on `device` (the CUDA device unless the caller names another) and
    start uninitialised, as `DecoderLM`'s do."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if not (cfg.attn_every > 0 and cfg.num_layers % cfg.attn_every == 0):
            raise ValueError(
                f"{cfg.name}: num_layers {cfg.num_layers} must be a positive "
                f"multiple of attn_every {cfg.attn_every}")
        device = resolve_device(device)
        self.cfg = cfg
        self.dtype = transformer._DTYPES[cfg.dtype]
        self.groups = cfg.num_layers // cfg.attn_every
        spec = self.param_specs()
        self.embed = ParamTree(spec["embed"], device)
        self.mamba = nn.ModuleList(
            ParamTree(mamba2.mamba_spec(cfg, self.dtype), device)
            for _ in range(cfg.num_layers))
        self.shared = ParamTree(spec["shared"], device)
        self.ln_f = ParamTree(spec["ln_f"], device)
        self.head = ParamTree(spec["head"], device)

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    # ---------------------------------------------------------- specs ----
    def param_specs(self) -> Dict:
        """The reference's tree: the Mamba blocks stacked along 'layers'."""
        cfg, dt = self.cfg, self.dtype
        return {
            "embed": embedding_spec(cfg.padded_vocab, cfg.d_model, dtype=dt),
            "mamba": stack_specs(mamba2.mamba_spec(cfg, dt), cfg.num_layers),
            "shared": transformer.layer_spec(cfg, dt, use_moe=False),
            "ln_f": rms_norm_spec(cfg.d_model),
            "head": linear_spec(cfg.d_model, cfg.padded_vocab,
                                ("fsdp", "vocab"), dtype=dt),
        }

    def param_tree(self) -> Dict:
        """The parameters as `param_specs`' tree, "mamba" a list of
        per-block trees."""
        return {"embed": self.embed.tree(),
                "mamba": [block.tree() for block in self.mamba],
                "shared": self.shared.tree(), "ln_f": self.ln_f.tree(),
                "head": self.head.tree()}

    def load_params(self, params) -> None:
        """Copy a tree of `param_specs`' shapes (blocks stacked) in."""
        expected = set(self.param_specs())
        if set(params) != expected:
            raise KeyError(f"parameter tree has {sorted(params)}, the model "
                           f"{sorted(expected)}")
        for i, block in enumerate(self.mamba):
            block.load(transformer._unstack(params["mamba"], i))
        for name in ("embed", "shared", "ln_f", "head"):
            getattr(self, name).load(params[name])

    def _is_site(self, li: int) -> bool:
        """Whether the shared block runs after Mamba block li."""
        return (li + 1) % self.cfg.attn_every == 0

    @staticmethod
    def _positions(x):
        b, s = x.shape[:2]
        return torch.arange(s, device=x.device).expand(b, s)

    # ----------------------------------------------------------- train ----
    def _forward(self, tokens):
        cfg = self.cfg
        x = embed(self.embed, tokens, self.dtype)
        positions = self._positions(x)

        def block(xc, lp):
            return xc + mamba2.mamba_apply(lp, xc, cfg)

        def shared(xc):
            return transformer.layer_apply(self.shared, xc, cfg, positions,
                                           None)[0]

        block, shared = (remat_wrap(block, cfg.remat),
                         remat_wrap(shared, cfg.remat))
        for li, lp in enumerate(self.mamba):
            x = block(x, lp)
            if self._is_site(li):
                x = shared(x)
        return rms_norm(self.ln_f, x, cfg.norm_eps)

    def loss(self, batch):
        """batch {"tokens": (B, S) integer tensor} -> (loss, {"ce", "aux"}):
        the mean next-token CE; "aux" is 0."""
        x = self._forward(batch["tokens"])
        ce = chunked_ce(x, batch["tokens"][:, 1:], self.embed, self.head,
                        self.cfg.vocab_size)
        return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                                 device=x.device)}

    # ----------------------------------------------------------- serve ----
    def cache_spec(self, batch: int, max_len: int):
        """{"mamba": {"ssm" (L, B, H, N, P) float32, "conv" (L, B, K-1, C)},
        "attn": {"k", "v"} (G, B, max_len, KV, Dh)} as meta tensors."""
        cfg = self.cfg
        m = mamba2.mamba_cache_spec(cfg, batch, self.dtype)
        kv = (self.groups, batch, max_len, cfg.num_kv_heads,
              cfg.resolved_head_dim)
        return {
            "mamba": {name: torch.empty((cfg.num_layers,) + tuple(t.shape),
                                        dtype=t.dtype, device="meta")
                      for name, t in m.items()},
            "attn": {name: torch.empty(kv, dtype=self.dtype, device="meta")
                     for name in ("k", "v")},
        }

    @torch.no_grad()
    def prefill(self, batch):
        """batch {"tokens": (B, S) integer tensor}, S >= ssm_conv - 1 ->
        (the last position's masked float32 logits (B, 1, V_padded), the
        cache: every block's states and a KV cache of length S a site)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        if tokens.shape[1] < cfg.ssm_conv - 1:
            raise ValueError(
                f"a prompt of {tokens.shape[1]} tokens: the conv state "
                f"holds the last {cfg.ssm_conv - 1} inputs")
        x = embed(self.embed, tokens, self.dtype)
        positions = self._positions(x)
        b, s = x.shape[:2]
        spec = self.cache_spec(b, s)
        cache = {part: {name: torch.zeros(t.shape, dtype=t.dtype,
                                          device=x.device)
                        for name, t in leaves.items()}
                 for part, leaves in spec.items()}
        ssm, conv = cache["mamba"]["ssm"], cache["mamba"]["conv"]
        ks, vs = cache["attn"]["k"], cache["attn"]["v"]
        for li, lp in enumerate(self.mamba):
            y, (h_t, conv_t) = mamba2.mamba_apply(lp, x, cfg,
                                                  return_state=True)
            x = x + y
            ssm[li] = h_t
            conv[li] = conv_t
            if self._is_site(li):
                gi = (li + 1) // cfg.attn_every - 1
                x, _, (k, v) = transformer.layer_apply(
                    self.shared, x, cfg, positions, None)
                ks[gi] = k
                vs[gi] = v
        x = rms_norm(self.ln_f, x, cfg.norm_eps)
        lg = project_logits(x[:, -1:], self.embed, self.head, cfg.vocab_size)
        return lg, cache

    @torch.no_grad()
    def decode_step(self, token, cache, cur_len):
        """token: (B, 1) integer tensor; cur_len: int or (B,) tensor.

        Writes every block's states and each site's new K/V into `cache` in
        place and returns (masked float32 logits (B, 1, V_padded), cache)."""
        cfg = self.cfg
        x = embed(self.embed, token, self.dtype)
        ssm, conv = cache["mamba"]["ssm"], cache["mamba"]["conv"]
        ks, vs = cache["attn"]["k"], cache["attn"]["v"]
        for li, lp in enumerate(self.mamba):
            y, new = mamba2.mamba_step(lp, x, {"ssm": ssm[li],
                                               "conv": conv[li]}, cfg)
            x = x + y
            ssm[li] = new["ssm"]
            conv[li] = new["conv"]
            if self._is_site(li):
                gi = (li + 1) // cfg.attn_every - 1
                x = transformer.layer_decode(self.shared, x, cfg, ks[gi],
                                             vs[gi], cur_len, None)
        x = rms_norm(self.ln_f, x, cfg.norm_eps)
        lg = project_logits(x, self.embed, self.head, cfg.vocab_size)
        return lg, cache
