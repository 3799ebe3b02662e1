"""xLSTM LM: alternating mLSTM / sLSTM blocks (the reference's
`models/xlstm_model.py`; paper arXiv:2405.04517).

The blocks run in (mLSTM, sLSTM) pairs, each behind its own RMSNorm with a
residual; `num_layers` must be even (the reference asserts, this raises
ValueError).  The reference's scan over pairs is a Python loop; `loss`
follows `cfg.remat` with one `torch.utils.checkpoint` a pair
(`transformer.remat_wrap`), and `prefill`, which collects the states,
takes none.  Decode carries each pair's mLSTM matrix memory and sLSTM cell
states -- O(1) in sequence length, so `cache_spec` ignores `max_len` --
and writes them in place.

The cache names its leaves, part -> {name: (pairs, B, ...)}, as the
serving engine walks it: {"mlstm": {"h": (pairs, B, H, dh, dh + 1)},
"slstm": {"c", "n", "h", "m": (pairs, B, D)}}, all float32.  The
reference's cache is {"mlstm": array, "slstm": (c, n, h, m)}: a deviation
of structure, not of numbers.  The mesh hooks (`ctx`, `cache_pspec`) come
with the multi-card LM slice (ROADMAP Queue 1, item 5, slice 8).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.core.nekbone import resolve_device
from repro_torch.models import transformer, xlstm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (embed, embedding_spec, linear_spec,
                                       rms_norm, rms_norm_spec)
from repro_torch.models.losses import chunked_ce, project_logits
from repro_torch.models.params import ParamTree
from repro_torch.models.transformer import remat_wrap, stack_specs

__all__ = ["XLSTMLM", "SLSTM_STATE"]

# the sLSTM state's leaves, in the reference's tuple order
SLSTM_STATE = ("c", "n", "h", "m")
_STACKS = ("ln_m", "mlstm", "ln_s", "slstm")


class XLSTMLM(nn.Module):
    """The xLSTM LM, with `DecoderLM`'s interface.  Its parameters live on
    `device` (the CUDA device unless the caller names another) and start
    uninitialised, as `DecoderLM`'s do."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.num_layers % 2:
            raise ValueError(f"{cfg.name}: num_layers {cfg.num_layers} must "
                             f"be even (mLSTM, sLSTM pairs)")
        device = resolve_device(device)
        self.cfg = cfg
        self.dtype = transformer._DTYPES[cfg.dtype]
        self.pairs = cfg.num_layers // 2
        spec = {"ln_m": rms_norm_spec(cfg.d_model),
                "mlstm": xlstm.mlstm_spec(cfg, self.dtype),
                "ln_s": rms_norm_spec(cfg.d_model),
                "slstm": xlstm.slstm_spec(cfg, self.dtype)}
        for name in _STACKS:
            setattr(self, name, nn.ModuleList(
                ParamTree(spec[name], device) for _ in range(self.pairs)))
        top = self.param_specs()
        for name in ("embed", "ln_f", "head"):
            setattr(self, name, ParamTree(top[name], device))

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    # ---------------------------------------------------------- specs ----
    def param_specs(self) -> Dict:
        """The reference's tree: the four block stacks along 'layers'."""
        cfg, dt = self.cfg, self.dtype
        return {
            "embed": embedding_spec(cfg.padded_vocab, cfg.d_model, dtype=dt),
            "ln_m": stack_specs(rms_norm_spec(cfg.d_model), self.pairs),
            "mlstm": stack_specs(xlstm.mlstm_spec(cfg, dt), self.pairs),
            "ln_s": stack_specs(rms_norm_spec(cfg.d_model), self.pairs),
            "slstm": stack_specs(xlstm.slstm_spec(cfg, dt), self.pairs),
            "ln_f": rms_norm_spec(cfg.d_model),
            "head": linear_spec(cfg.d_model, cfg.padded_vocab,
                                ("fsdp", "vocab"), dtype=dt),
        }

    def param_tree(self) -> Dict:
        """The parameters as `param_specs`' tree, each stack a list of
        per-pair trees."""
        tree = {name: [blk.tree() for blk in getattr(self, name)]
                for name in _STACKS}
        return tree | {name: getattr(self, name).tree()
                       for name in ("embed", "ln_f", "head")}

    def load_params(self, params) -> None:
        """Copy a tree of `param_specs`' shapes (pairs stacked) in."""
        expected = set(self.param_specs())
        if set(params) != expected:
            raise KeyError(f"parameter tree has {sorted(params)}, the model "
                           f"{sorted(expected)}")
        for name in _STACKS:
            for i, blk in enumerate(getattr(self, name)):
                blk.load(transformer._unstack(params[name], i))
        for name in ("embed", "ln_f", "head"):
            getattr(self, name).load(params[name])

    def _pairs(self):
        return zip(self.ln_m, self.mlstm, self.ln_s, self.slstm)

    def _pair(self, x, ln_m, mp, ln_s, sp, collect: bool = False):
        eps = self.cfg.norm_eps
        ym = xlstm.mlstm_apply(mp, rms_norm(ln_m, x, eps), self.cfg,
                               return_state=collect)
        if collect:
            ym, m_state = ym
        x = x + ym
        ys = xlstm.slstm_apply(sp, rms_norm(ln_s, x, eps), self.cfg,
                               return_state=collect)
        if collect:
            ys, s_state = ys
            return x + ys, (m_state, s_state)
        return x + ys

    # ----------------------------------------------------------- train ----
    def loss(self, batch):
        """batch {"tokens": (B, S) integer tensor} -> (loss, {"ce", "aux"}):
        the mean next-token CE through the untied head; "aux" is 0."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = embed(self.embed, tokens, self.dtype)
        pair = remat_wrap(self._pair, cfg.remat)
        for ln_m, mp, ln_s, sp in self._pairs():
            x = pair(x, ln_m, mp, ln_s, sp)
        x = rms_norm(self.ln_f, x, cfg.norm_eps)
        ce = chunked_ce(x, tokens[:, 1:], self.embed, self.head,
                        cfg.vocab_size)
        return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                                 device=x.device)}

    # ----------------------------------------------------------- serve ----
    def cache_spec(self, batch: int, max_len: int):
        """{"mlstm": {"h"}, "slstm": {"c", "n", "h", "m"}} as float32 meta
        tensors (pairs, B, ...); `max_len` is ignored (the state is O(1)
        in sequence length)."""
        del max_len
        m = xlstm.mlstm_cache_spec(self.cfg, batch)
        s = xlstm.slstm_cache_spec(self.cfg, batch)

        def stk(t):
            return torch.empty((self.pairs,) + tuple(t.shape),
                               dtype=t.dtype, device="meta")
        return {"mlstm": {"h": stk(m)},
                "slstm": {name: stk(t) for name, t in zip(SLSTM_STATE, s)}}

    @torch.no_grad()
    def prefill(self, batch):
        """batch {"tokens": (B, S) integer tensor} -> (the last position's
        masked float32 logits (B, 1, V_padded), the cache: every pair's
        states after the prompt)."""
        cfg = self.cfg
        x = embed(self.embed, batch["tokens"], self.dtype)
        cache = {part: {name: torch.zeros(t.shape, dtype=t.dtype,
                                          device=x.device)
                        for name, t in leaves.items()}
                 for part, leaves in self.cache_spec(x.shape[0], 0).items()}
        s_cache = cache["slstm"]
        for i, blocks in enumerate(self._pairs()):
            x, (m_state, s_state) = self._pair(x, *blocks, collect=True)
            cache["mlstm"]["h"][i] = m_state
            for name, t in zip(SLSTM_STATE, s_state):
                s_cache[name][i] = t
        x = rms_norm(self.ln_f, x, cfg.norm_eps)
        lg = project_logits(x[:, -1:], self.embed, self.head, cfg.vocab_size)
        return lg, cache

    @torch.no_grad()
    def decode_step(self, token, cache, cur_len):
        """token: (B, 1) integer tensor; `cur_len` is not read (a recurrent
        state has no positions).  Writes every pair's states into `cache`
        in place and returns (masked float32 logits (B, 1, V_padded),
        cache)."""
        del cur_len
        cfg = self.cfg
        eps = cfg.norm_eps
        x = embed(self.embed, token, self.dtype)
        m_cache, s_cache = cache["mlstm"]["h"], cache["slstm"]
        for i, (ln_m, mp, ln_s, sp) in enumerate(self._pairs()):
            ym, m_new = xlstm.mlstm_step(mp, rms_norm(ln_m, x, eps),
                                         m_cache[i], cfg)
            x = x + ym
            ys, s_new = xlstm.slstm_step(
                sp, rms_norm(ln_s, x, eps),
                tuple(s_cache[name][i] for name in SLSTM_STATE), cfg)
            x = x + ys
            m_cache[i] = m_new
            for name, t in zip(SLSTM_STATE, s_new):
                s_cache[name][i] = t
        x = rms_norm(self.ln_f, x, cfg.norm_eps)
        lg = project_logits(x, self.embed, self.head, cfg.vocab_size)
        return lg, cache
