"""Encoder-decoder LM (SeamlessM4T-style backbone; the speech frontend is a
stub: precomputed (B, S, audio_dim) frames) -- the reference's
`models/encdec.py`.

Encoder: `audio_proj`, then bidirectional attention + MLP blocks with rope
over 0 ... S-1 (`transformer.attn_apply(causal=False)`), then `ln_enc`.
Decoder: causal self-attention, cross-attention to the encoder output,
MLP; the logits go through the tied embedding.  The reference's scans over
layers are Python loops; `loss` follows `cfg.remat` with one
`torch.utils.checkpoint` a layer (`transformer.remat_wrap`), in the
encoder and in the decoder.

Cross-attention keeps the reference's branch: when the decoder runs as
many positions as the encoder has, the chunked `causal_attention(causal=
False)`; otherwise (decode) `full_attention(causal=False)`.  The two round
differently.  Neither is masked, so the cross K/V that `decode_step`
reads must hold the encoder's length: a cache padded to `max_len` (as
`cache_spec` shapes it) puts its zero keys into the softmax and changes
every logit.  `prefill` returns the cross K/V at the encoder's length;
only the self K/V is widened to `max_len` for decoding.

The serving engine refuses this family (it passes no frames to `prefill`,
as the reference's engine passes none).  The mesh hooks (`ctx`,
`cache_pspec`) come with the multi-card LM slice (ROADMAP Queue 1, item
5, slice 8).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.core.nekbone import resolve_device
from repro_torch.models import attention, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (embed, embedding_spec, linear,
                                       linear_spec, rms_norm, rms_norm_spec)
from repro_torch.models.losses import chunked_ce, project_logits
from repro_torch.models.params import ParamTree
from repro_torch.models.transformer import remat_wrap, stack_specs

__all__ = ["EncDecLM", "cross_attn_spec", "cross_attn_apply", "cross_kv",
           "dec_layer_spec"]


def cross_attn_spec(cfg: ModelConfig, dtype):
    return transformer.attn_spec(cfg, dtype)


def cross_attn_apply(p, x, enc_kv, cfg: ModelConfig):
    """q from the decoder's x (B, S, D); enc_kv = (k, v), each (B, S_enc,
    KV, Dh), from the encoder's output (`cross_kv`)."""
    b, s, _ = x.shape
    h, dh = cfg.num_heads, cfg.resolved_head_dim
    q = linear(p["wq"], x).reshape(b, s, h, dh)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
    k, v = enc_kv
    if s == k.shape[1]:          # prefill-sized: chunked to bound memory
        o = attention.causal_attention(q, k, v, chunk=cfg.attn_chunk,
                                       causal=False)
    else:                        # decode: a short q against the whole K/V
        o = attention.full_attention(q, k, v, causal=False)
    o = o.reshape(b, s, h * dh)
    return linear(p["wo"], o)


def cross_kv(p, enc_out, cfg: ModelConfig):
    b, s, _ = enc_out.shape
    kvh, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    k = linear(p["wk"], enc_out).reshape(b, s, kvh, dh)
    v = linear(p["wv"], enc_out).reshape(b, s, kvh, dh)
    if cfg.qk_norm:
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    return k, v


def dec_layer_spec(cfg: ModelConfig, dtype):
    return {
        "ln1": rms_norm_spec(cfg.d_model),
        "attn": transformer.attn_spec(cfg, dtype),
        "ln_x": rms_norm_spec(cfg.d_model),
        "xattn": cross_attn_spec(cfg, dtype),
        "ln2": rms_norm_spec(cfg.d_model),
        "mlp": transformer.mlp_spec(cfg, dtype),
    }


def _positions(x):
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device).expand(b, s)


class EncDecLM(nn.Module):
    """The enc-dec LM, with `DecoderLM`'s interface; every entry takes the
    batch's "frames" (B, S_enc, audio_dim) beside its "tokens".  Its
    parameters live on `device` (the CUDA device unless the caller names
    another) and start uninitialised, as `DecoderLM`'s do."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.encoder_layers <= 0:
            raise ValueError(f"{cfg.name}: the enc-dec family needs "
                             f"encoder_layers > 0")
        device = resolve_device(device)
        self.cfg = cfg
        self.dtype = transformer._DTYPES[cfg.dtype]
        spec = self.param_specs()
        self.audio_proj = ParamTree(spec["audio_proj"], device)
        self.enc_layers = nn.ModuleList(
            ParamTree(transformer.layer_spec(cfg, self.dtype, use_moe=False),
                      device) for _ in range(cfg.encoder_layers))
        self.ln_enc = ParamTree(spec["ln_enc"], device)
        self.embed = ParamTree(spec["embed"], device)
        self.dec_layers = nn.ModuleList(
            ParamTree(dec_layer_spec(cfg, self.dtype), device)
            for _ in range(cfg.num_layers))
        self.ln_f = ParamTree(spec["ln_f"], device)

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    # ---------------------------------------------------------- specs ----
    def param_specs(self) -> Dict:
        """The reference's tree: both layer stacks along 'layers'; the
        embedding is tied (no head)."""
        cfg, dt = self.cfg, self.dtype
        return {
            "audio_proj": linear_spec(cfg.audio_dim, cfg.d_model,
                                      (None, "fsdp"), dtype=dt),
            "enc_layers": stack_specs(
                transformer.layer_spec(cfg, dt, use_moe=False),
                cfg.encoder_layers),
            "ln_enc": rms_norm_spec(cfg.d_model),
            "embed": embedding_spec(cfg.padded_vocab, cfg.d_model, dtype=dt),
            "dec_layers": stack_specs(dec_layer_spec(cfg, dt),
                                      cfg.num_layers),
            "ln_f": rms_norm_spec(cfg.d_model),
        }

    def param_tree(self) -> Dict:
        """The parameters as `param_specs`' tree, each stack a list of
        per-layer trees."""
        return {"audio_proj": self.audio_proj.tree(),
                "enc_layers": [lp.tree() for lp in self.enc_layers],
                "ln_enc": self.ln_enc.tree(), "embed": self.embed.tree(),
                "dec_layers": [lp.tree() for lp in self.dec_layers],
                "ln_f": self.ln_f.tree()}

    def load_params(self, params) -> None:
        """Copy a tree of `param_specs`' shapes (layers stacked) in."""
        expected = set(self.param_specs())
        if set(params) != expected:
            raise KeyError(f"parameter tree has {sorted(params)}, the model "
                           f"{sorted(expected)}")
        for stack in ("enc_layers", "dec_layers"):
            for i, lp in enumerate(getattr(self, stack)):
                lp.load(transformer._unstack(params[stack], i))
        for name in ("audio_proj", "ln_enc", "embed", "ln_f"):
            getattr(self, name).load(params[name])

    # --------------------------------------------------------- encoder ----
    def encode(self, frames):
        """frames (B, S_enc, audio_dim) -> the encoder's output (B, S_enc,
        D) in the model's dtype."""
        cfg = self.cfg
        x = linear(self.audio_proj, frames.to(self.dtype))
        positions = _positions(x)

        def enc_layer(xc, lp):
            h = rms_norm(lp["ln1"], xc, cfg.norm_eps)
            a, _ = transformer.attn_apply(lp["attn"], h, cfg, positions,
                                          None, causal=False)
            xc = xc + a
            h = rms_norm(lp["ln2"], xc, cfg.norm_eps)
            return xc + transformer.mlp_apply(lp["mlp"], h)

        layer = remat_wrap(enc_layer, cfg.remat)
        for lp in self.enc_layers:
            x = layer(x, lp)
        return rms_norm(self.ln_enc, x, cfg.norm_eps)

    # --------------------------------------------------------- decoder ----
    def _dec_layer(self, x, lp, enc_out, positions):
        """One decoder layer over a whole sequence: (x, (k, v), the cross
        (k, v))."""
        cfg = self.cfg
        h = rms_norm(lp["ln1"], x, cfg.norm_eps)
        a, kv = transformer.attn_apply(lp["attn"], h, cfg, positions, None)
        x = x + a
        h = rms_norm(lp["ln_x"], x, cfg.norm_eps)
        ckv = cross_kv(lp["xattn"], enc_out, cfg)
        x = x + cross_attn_apply(lp["xattn"], h, ckv, cfg)
        h = rms_norm(lp["ln2"], x, cfg.norm_eps)
        return x + transformer.mlp_apply(lp["mlp"], h), kv, ckv

    def loss(self, batch):
        """batch {"frames": (B, S_enc, audio_dim), "tokens": (B, S) integer
        tensor} -> (loss, {"ce", "aux"}): the mean next-token CE through
        the tied embedding; "aux" is 0."""
        cfg = self.cfg
        enc_out = self.encode(batch["frames"])
        tokens = batch["tokens"]
        x = embed(self.embed, tokens, self.dtype)
        positions = _positions(x)
        layer = remat_wrap(
            lambda xc, lp, eo: self._dec_layer(xc, lp, eo, positions)[0],
            cfg.remat)
        for lp in self.dec_layers:
            x = layer(x, lp, enc_out)
        x = rms_norm(self.ln_f, x, cfg.norm_eps)
        ce = chunked_ce(x, tokens[:, 1:], self.embed, None, cfg.vocab_size)
        return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                                 device=x.device)}

    # ----------------------------------------------------------- serve ----
    def cache_spec(self, batch: int, max_len: int):
        """{"self": {"k", "v"}, "cross": {"k", "v"}}: (L, B, max_len, KV,
        Dh) meta tensors, as the reference shapes them.  Decode must be
        given the cross K/V at the encoder's length (see the module's
        docstring)."""
        cfg = self.cfg
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        return {part: {name: torch.empty(shape, dtype=self.dtype,
                                         device="meta")
                       for name in ("k", "v")}
                for part in ("self", "cross")}

    @torch.no_grad()
    def prefill(self, batch):
        """batch {"frames", "tokens"} -> (the last position's masked
        float32 logits (B, 1, V_padded), the cache: "self" K/V of the
        prompt's length S, "cross" K/V of the encoder's length S_enc)."""
        cfg = self.cfg
        enc_out = self.encode(batch["frames"])
        x = embed(self.embed, batch["tokens"], self.dtype)
        positions = _positions(x)
        b, s = x.shape[:2]
        s_enc = enc_out.shape[1]
        kvd = (cfg.num_kv_heads, cfg.resolved_head_dim)
        cache = {part: {name: torch.zeros((cfg.num_layers, b, n) + kvd,
                                          dtype=self.dtype, device=x.device)
                        for name in ("k", "v")}
                 for part, n in (("self", s), ("cross", s_enc))}
        for li, lp in enumerate(self.dec_layers):
            x, (k, v), (ck, cv) = self._dec_layer(x, lp, enc_out, positions)
            cache["self"]["k"][li] = k
            cache["self"]["v"][li] = v
            cache["cross"]["k"][li] = ck
            cache["cross"]["v"][li] = cv
        x = rms_norm(self.ln_f, x, cfg.norm_eps)
        lg = project_logits(x[:, -1:], self.embed, None, cfg.vocab_size)
        return lg, cache

    @torch.no_grad()
    def decode_step(self, token, cache, cur_len):
        """token: (B, 1) integer tensor; cur_len: int or (B,) tensor;
        cache["self"] (L, B, max_len, KV, Dh), cache["cross"] at the
        encoder's length.  Writes each layer's new self K/V in place and
        returns (masked float32 logits (B, 1, V_padded), cache)."""
        cfg = self.cfg
        x = embed(self.embed, token, self.dtype)
        ks, vs = cache["self"]["k"], cache["self"]["v"]
        cks, cvs = cache["cross"]["k"], cache["cross"]["v"]
        for li, lp in enumerate(self.dec_layers):
            h = rms_norm(lp["ln1"], x, cfg.norm_eps)
            x = x + transformer.attn_decode(lp["attn"], h, cfg, ks[li],
                                            vs[li], cur_len, None)
            h = rms_norm(lp["ln_x"], x, cfg.norm_eps)
            x = x + cross_attn_apply(lp["xattn"], h, (cks[li], cvs[li]), cfg)
            h = rms_norm(lp["ln2"], x, cfg.norm_eps)
            x = x + transformer.mlp_apply(lp["mlp"], h)
        x = rms_norm(self.ln_f, x, cfg.norm_eps)
        lg = project_logits(x, self.embed, None, cfg.vocab_size)
        return lg, cache
