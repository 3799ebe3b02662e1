"""The port's enc-dec/audio family (`models/encdec.py::EncDecLM`,
`transformer.attn_apply(causal=False)`, the frames of `SyntheticLM`, its
training) against the reference on the CPU.

The reduced seamless-m4t-medium config in float32 (2 encoder and 2
decoder layers: d_model 64, 4 heads of 16 over 2 KV heads (GQA),
attn_chunk 16, audio_dim 32, vocab 256), weights drawn by the reference's
init rule from numpy seeds (`test_torch_hybrid._numpy_init`) and carried
into the port by `convert`, inputs made from numpy seeds.  Tolerances: in
float32, outputs, logits, caches, loss and gradients within 1e-5 of
max |reference|; the frames bitwise; a train step's parameters by the
two-part rule of `tests/_torch_train_util.py`.

Decode reads the cross K/V at the encoder's length: its attention is
unmasked, so a cross cache padded to max_len changes the logits
(`test_decode_continues_the_prefill` shows both).  The engine refuses the
family, as it refuses the VLM: the reference's engine passes only tokens
to `prefill`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models import encdec as ref_encdec
from repro.models import transformer as ref_transformer
from repro.models.config import reduced_config as ref_reduced_config
from repro.models.registry import build_model as ref_build_model
from repro.training.train_loop import TrainConfig as RefTrainConfig
from repro.training.train_loop import init_state as ref_init_state
from repro.training.train_loop import make_train_step as ref_make_train_step
from repro_torch import configs
from repro_torch.convert import lm_params_from_numpy, train_state_from_numpy
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import encdec, transformer
from repro_torch.models.config import reduced_config
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import ServeEngine
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import TrainConfig, make_train_step
from _torch_train_util import ref_leaves, stacked_leaves, two_part
from test_torch_hybrid import _numpy_init, _rel

ARCH = "seamless_m4t_medium"
RTOL = 1e-5
MOMENT_RTOL = 1e-4


def _cfgs(**kw):
    ref = ref_reduced_config(ref_configs.get(ARCH)).replace(
        dtype="float32", **kw)
    port = reduced_config(configs.get(ARCH)).replace(dtype="float32", **kw)
    return ref, port


@pytest.fixture(scope="module")
def models():
    cfg, port_cfg = _cfgs()
    ref_model = ref_build_model(cfg)
    params = _numpy_init(ref_model.param_specs(), 1)
    port = lm_params_from_numpy(port_cfg, jax.tree.map(np.asarray, params),
                                device="cpu")
    return cfg, ref_model, params, port


def _t(a):
    return torch.from_numpy(np.array(a))


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _positions(b, s):
    return np.broadcast_to(np.arange(s), (b, s))


@functools.lru_cache(maxsize=None)
def _ref_prefill(ref_model):
    return jax.jit(ref_model.prefill)


@functools.lru_cache(maxsize=None)
def _ref_decode(ref_model):
    return jax.jit(ref_model.decode_step)


# -------------------------------------------------------------- blocks ----

@pytest.mark.parametrize("s", [12, 37])
@pytest.mark.parametrize("causal", [False, True])
def test_attn_apply_matches_the_reference(models, s, causal):
    """An encoder layer's attention over s 12 (one full block) and 37
    (chunks of 16, a tail pad the bidirectional mask hides), rope over
    0 ... s-1: the output and (k, v)."""
    cfg, _, params, port = models
    rp = jax.tree.map(lambda a: a[0], params["enc_layers"]["attn"])
    x = _x(s, 2, s, cfg.d_model)
    pos = _positions(2, s)
    out, (k, v) = jax.jit(functools.partial(
        ref_transformer.attn_apply, cfg=cfg, rope_tab=None, ctx=None,
        causal=causal))(rp, jnp.asarray(x), positions=jnp.asarray(pos))
    pout, (pk, pv) = transformer.attn_apply(
        port.enc_layers[0]["attn"], torch.from_numpy(x), cfg,
        torch.from_numpy(pos.copy()), None, causal=causal)
    assert _rel(pout, out) <= RTOL
    assert _rel(pk, k) <= RTOL and _rel(pv, v) <= RTOL


@pytest.mark.parametrize("s_dec,s_enc", [(37, 37), (12, 12), (5, 37),
                                         (1, 37)])
def test_cross_attn_apply_both_branches(models, s_dec, s_enc):
    """The decoder's cross-attention: at s_dec == s_enc the chunked
    bidirectional path (37: chunks of 16 and a pad; 12: one block), else
    the full one (a prompt of 5, a decode step of 1); K/V from
    `cross_kv` over GQA's 2 KV heads."""
    cfg, _, params, port = models
    rp = jax.tree.map(lambda a: a[1], params["dec_layers"]["xattn"])
    pp = port.dec_layers[1]["xattn"]
    x = _x(s_dec, 2, s_dec, cfg.d_model)
    enc = _x(100 + s_enc, 2, s_enc, cfg.d_model)
    kv = jax.jit(functools.partial(ref_encdec.cross_kv, cfg=cfg))(
        rp, jnp.asarray(enc))
    out = jax.jit(functools.partial(ref_encdec.cross_attn_apply, cfg=cfg,
                                    ctx=None))(rp, jnp.asarray(x), kv)
    pkv = encdec.cross_kv(pp, torch.from_numpy(enc), cfg)
    pout = encdec.cross_attn_apply(pp, torch.from_numpy(x), pkv, cfg)
    assert cfg.num_kv_heads < cfg.num_heads
    assert _rel(pkv[0], kv[0]) <= RTOL and _rel(pkv[1], kv[1]) <= RTOL
    assert _rel(pout, out) <= RTOL


# --------------------------------------------------------------- model ----

def test_encode_matches_the_reference(models):
    """The encoder over 37 frames (chunked bidirectional attention)."""
    cfg, ref_model, params, port = models
    frames = _x(5, 2, 37, cfg.audio_dim)
    out = jax.jit(functools.partial(ref_model.encode, ctx=None))(
        params, jnp.asarray(frames))
    assert _rel(port.encode(torch.from_numpy(frames)), out) <= RTOL


def test_loss_and_grads_match_the_reference(models):
    """21 frames and 21 tokens (the chunked paths, as training runs them):
    loss, "ce", "aux" = 0 and every gradient leaf against
    `jax.value_and_grad`."""
    cfg, ref_model, params, port = models
    rng = np.random.default_rng(13)
    toks = rng.integers(0, cfg.vocab_size, (2, 21))
    frames = rng.standard_normal((2, 21, cfg.audio_dim)).astype(np.float32)
    batch = {"tokens": jnp.asarray(toks, jnp.int32),
             "frames": jnp.asarray(frames)}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: ref_model.loss(p, batch), has_aux=True))(params)
    groups = opt.tree_groups(port.param_tree())
    flat = [t for ts, _ in groups for t in ts]
    port.requires_grad_(True)
    try:
        ploss, pm = port.loss({"tokens": torch.from_numpy(toks),
                               "frames": torch.from_numpy(frames)})
        g = dict(zip(map(id, flat), torch.autograd.grad(ploss, flat)))
    finally:
        port.requires_grad_(False)
    got = [torch.stack([g[id(t)] for t in ts]) if st else g[id(ts[0])]
           for ts, st in groups]
    assert abs(float(ploss.detach()) - float(loss)) <= RTOL * abs(float(loss))
    assert abs(float(pm["ce"].detach()) - float(metrics["ce"])) <= \
        RTOL * abs(float(metrics["ce"]))
    assert float(pm["aux"]) == float(metrics["aux"]) == 0.0
    ref_g = [np.asarray(a, np.float32) for a in jax.tree.leaves(grads)]
    assert len(got) == len(ref_g)
    for i, (a, b) in enumerate(zip(got, ref_g)):
        assert _rel(a, b) <= RTOL, (i, _rel(a, b))


def _batch(seed, s_tok, s_enc, cfg):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, cfg.vocab_size, (2, s_tok)),
            rng.standard_normal((2, s_enc, cfg.audio_dim)).astype(np.float32))


@pytest.mark.parametrize("s_tok,s_enc", [(5, 21), (21, 21)])
def test_prefill_logits_and_cache(models, s_tok, s_enc):
    """The logits, the self K/V at the prompt's length and the cross K/V
    at the encoder's."""
    cfg, ref_model, params, port = models
    toks, frames = _batch(s_tok, s_tok, s_enc, cfg)
    lg, cache = _ref_prefill(ref_model)(
        params, {"tokens": jnp.asarray(toks, jnp.int32),
                 "frames": jnp.asarray(frames)})
    plg, pcache = port.prefill({"tokens": torch.from_numpy(toks),
                                "frames": torch.from_numpy(frames)})
    assert _rel(plg, lg) <= RTOL
    for part, n in (("self", s_tok), ("cross", s_enc)):
        for name in ("k", "v"):
            assert pcache[part][name].shape[2] == n
            assert _rel(pcache[part][name], cache[part][name]) <= RTOL, \
                (part, name)


def test_ragged_decode_on_an_unpadded_cross_cache(models):
    """Three decode steps at per-slot lengths (9, 6) after a prefill of 9
    over 21 frames, the self K/V widened to 32 and the cross K/V at 21:
    the logits and the self cache, written in place."""
    cfg, ref_model, params, port = models
    toks, frames = _batch(10, 9, 21, cfg)
    _, cache = _ref_prefill(ref_model)(
        params, {"tokens": jnp.asarray(toks, jnp.int32),
                 "frames": jnp.asarray(frames)})
    pad = [(0, 0), (0, 0), (0, 23), (0, 0), (0, 0)]
    cache["self"] = jax.tree.map(lambda a: jnp.pad(a, pad), cache["self"])
    pcache = jax.tree.map(_t, cache)
    rng = np.random.default_rng(11)
    cur = np.array([9, 6])
    for _ in range(3):
        nxt = rng.integers(1, cfg.vocab_size, (2, 1))
        lg, cache = _ref_decode(ref_model)(
            params, jnp.asarray(nxt, jnp.int32), cache,
            jnp.asarray(cur, jnp.int32))
        before = pcache["self"]["k"]
        plg, pcache = port.decode_step(torch.from_numpy(nxt), pcache,
                                       torch.from_numpy(cur))
        assert pcache["self"]["k"] is before
        assert _rel(plg, lg) <= RTOL
        for name in ("k", "v"):
            assert _rel(pcache["self"][name], cache["self"][name]) <= RTOL
        cur = cur + 1


def test_decode_continues_the_prefill(models):
    """Prefill 6 tokens over 21 frames, then decode 4 teacher-forced ones
    (lock-step cur_len) on the unpadded cross cache: each step's logits are
    the prefill's of the longer sequence.  The same step on a cross cache
    zero-padded to 32 is not."""
    cfg, _, _, port = models
    toks, frames = _batch(12, 10, 21, cfg)
    t, f = torch.from_numpy(toks), torch.from_numpy(frames)
    _, cache = port.prefill({"tokens": t[:, :6], "frames": f})
    wide = port.cache_spec(2, 32)
    for part in ("self", "cross"):
        n = cache[part]["k"].shape[2]
        padded = {name: torch.zeros(wide[part][name].shape)
                  for name in ("k", "v")}
        for name in ("k", "v"):
            padded[name][:, :, :n] = cache[part][name]
        if part == "self":
            cache["self"] = padded
        else:
            cross_padded = padded
    for i in range(6, 10):
        lg, cache = port.decode_step(t[:, i:i + 1], cache, i)
        want, _ = port.prefill({"tokens": t[:, :i + 1], "frames": f})
        assert _rel(lg, want) <= RTOL, i
    bad = {"self": {n: v.clone() for n, v in cache["self"].items()},
           "cross": cross_padded}
    lg_bad, _ = port.decode_step(t[:, 9:10], bad, 9)
    want, _ = port.prefill({"tokens": t[:, :10], "frames": f})
    assert _rel(lg_bad, want) > 100 * RTOL


# ------------------------------------------------------------- inputs ----

def test_frames_are_bitwise_the_references():
    """`SyntheticLM`'s audio batches: the tokens and the bf16 frames (drawn
    after them from the same stream) bitwise the reference's."""
    cfg, port_cfg = _cfgs()
    ref = RefSyntheticLM(cfg, batch=2, seq=24, seed=3)
    port = SyntheticLM(port_cfg, batch=2, seq=24, seed=3, device="cpu")
    for step in (0, 5):
        want, got = ref.batch_at(step), port.batch_at(step)
        assert set(got) == set(want) == {"tokens", "frames"}
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      np.asarray(want["tokens"]))
        assert got["frames"].dtype == torch.bfloat16
        assert tuple(got["frames"].shape) == (2, 24, cfg.audio_dim)
        np.testing.assert_array_equal(
            got["frames"].view(torch.int16).numpy(),
            np.asarray(want["frames"]).view(np.int16))


def test_engine_and_serve_launcher_refuse_the_family(models):
    with pytest.raises(NotImplementedError, match="no frames"):
        ServeEngine(models[3], max_len=32, slots=2)
    with pytest.raises(NotImplementedError, match="no frames"):
        launch_serve.main(["--arch", "seamless-m4t-medium", "--device",
                           "cpu"])


# ------------------------------------------------------------- train ----

def test_train_step_matches_the_reference():
    """Float32 AdamW, two steps (warmup 1) at grad_accum 2 from the
    reference's state carried by `train_state_from_numpy`, on its frames
    and tokens: loss, "ce" and grad_norm within 1e-5 relative at each
    step; the moments after the first within MOMENT_RTOL of each leaf's
    max; the parameters after the second by the two-part rule."""
    kw = dict(lr=1e-2, warmup=1, total_steps=10, grad_accum=2)
    cfg, port_cfg = _cfgs()
    ref_model = ref_build_model(cfg)
    params = _numpy_init(ref_model.param_specs(), 1)
    ref_state = jax.jit(lambda p: ref_init_state(p, RefTrainConfig(**kw)))(
        params)
    model, state = train_state_from_numpy(
        port_cfg, jax.tree.map(np.asarray, ref_state), device="cpu")
    assert isinstance(model, EncDecLM)
    ref_step = jax.jit(ref_make_train_step(ref_model, RefTrainConfig(**kw)))
    step = make_train_step(model, TrainConfig(**kw))
    ref_data = RefSyntheticLM(cfg, batch=4, seq=20, seed=0)
    data = SyntheticLM(port_cfg, batch=4, seq=20, seed=0, device="cpu")
    lr_sum = 0.0
    for i in range(2):
        ref_state, ref_m = ref_step(ref_state, ref_data.batch_at(i))
        state, m = step(state, data.batch_at(i))
        for k in ("loss", "ce", "grad_norm"):
            assert abs(float(m[k]) - float(ref_m[k])) <= 1e-5 * abs(
                float(ref_m[k])), (i, k)
        lr_sum += float(m["lr"])
        if i == 0:
            port_mu = stacked_leaves(state["opt"]["mu"])
            ref_mu = ref_leaves(ref_state["opt"]["mu"])
            assert len(port_mu) == len(ref_mu)
            for j, (p, r) in enumerate(zip(port_mu, ref_mu)):
                assert np.abs(p - r).max() <= MOMENT_RTOL * max(
                    np.abs(r).max(), 1e-30), j
    two_part(stacked_leaves(state["params"]), ref_leaves(ref_state["params"]),
             lr_sum, False, ARCH)


# ------------------------------------------------------------- build ----

def test_full_width_structure():
    """seamless-m4t-medium on the meta device: 12 encoder and 12 decoder
    layers, the tied embedding (no head), the cache's leaves at 8 slots."""
    model = build_model(configs.get(ARCH), device="meta")
    assert isinstance(model, EncDecLM)
    assert len(model.enc_layers) == len(model.dec_layers) == 12
    assert "head" not in model.param_tree()
    spec = model.cache_spec(8, 256)
    assert {p: {n: tuple(t.shape) for n, t in v.items()}
            for p, v in spec.items()} == {
        p: {"k": (12, 8, 256, 16, 64), "v": (12, 8, 256, 16, 64)}
        for p in ("self", "cross")}
    with pytest.raises(ValueError, match="encoder_layers"):
        EncDecLM(configs.get(ARCH).replace(encoder_layers=0), device="meta")


def test_train_launcher_runs_the_family_on_the_cpu(tmp_path):
    state, hist = launch_train.main([
        "--arch", "seamless-m4t-medium", "--steps", "2", "--device", "cpu",
        "--ckpt-dir", str(tmp_path)])
    assert int(state["step"]) == 2 and hist["restarts"] == 0
