"""The port's VLM family (`DecoderLM` with `vis_proj`, the patch inputs of
`SyntheticLM`) against the reference on the CPU.

The reduced phi-3-vision-4.2b config in float32 (2 layers, d_model 64, 4
heads over 2 KV heads, 8 patches of width 32, attn_chunk 16, vocab 256),
weights drawn by the reference's init rule from numpy seeds
(`test_torch_hybrid._numpy_init`) and carried into the port by `convert`,
inputs made from numpy seeds.  Tolerances: in float32, logits, caches,
loss and gradients within 1e-5 of max |reference|; a train step by the
rule of `tests/_torch_train_util.py`; the synthetic batches (tokens and
bf16 patches) bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
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
from repro_torch.models.config import reduced_config
from repro_torch.serving.engine import ServeEngine
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import TrainConfig, make_train_step
from _torch_train_util import ref_leaves, stacked_leaves, two_part
from test_torch_hybrid import _numpy_init, _rel

ARCH = "phi_3_vision_4_2b"
RTOL = 1e-5
MOMENT_RTOL = 1e-4


def _cfgs():
    return (ref_reduced_config(ref_configs.get(ARCH)).replace(
                dtype="float32"),
            reduced_config(configs.get(ARCH)).replace(dtype="float32"))


@pytest.fixture(scope="module")
def models():
    cfg, port_cfg = _cfgs()
    ref_model = ref_build_model(cfg)
    params = _numpy_init(ref_model.param_specs(), 0)
    port = lm_params_from_numpy(port_cfg, jax.tree.map(np.asarray, params),
                                device="cpu")
    return cfg, ref_model, params, port


def _batch(cfg, s, seed):
    """(the reference's batch, the port's) of `s` text tokens behind
    cfg.vision_patches patches."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (2, s))
    pat = rng.standard_normal((2, cfg.vision_patches, cfg.vision_dim)).astype(
        np.float32)
    return ({"tokens": jnp.asarray(toks, jnp.int32),
             "patches": jnp.asarray(pat)},
            {"tokens": torch.from_numpy(toks),
             "patches": torch.from_numpy(pat)})


@pytest.mark.parametrize("packed", [True, False])
def test_synthetic_vlm_batches_are_the_references(packed):
    """Tokens cut to seq - P and bf16 patches drawn after them, bitwise."""
    cfg = reduced_config(configs.get(ARCH))
    ref = RefSyntheticLM(cfg, batch=3, seq=40, seed=2, packed=packed)
    port = SyntheticLM(cfg, batch=3, seq=40, seed=2, packed=packed,
                       device="cpu")
    for step in (0, 5, 1234):
        got, want = port.batch_at(step), ref.batch_at(step)
        assert set(got) == set(want) == {"tokens", "patches"}
        assert got["tokens"].shape == (3, 32)
        assert got["patches"].dtype == torch.bfloat16
        assert tuple(got["patches"].shape) == (3, 8, 32)
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      np.asarray(want["tokens"]))
        np.testing.assert_array_equal(
            got["patches"].float().numpy(),
            np.asarray(want["patches"].astype(jnp.float32)))


def test_loss_and_grads_match_the_reference(models):
    """29 text tokens behind 8 patches (37 positions, three attention
    blocks of 16): loss, "ce" and every gradient leaf, `vis_proj`'s among
    them, against `jax.value_and_grad`; the loss scores text only."""
    cfg, ref_model, params, port = models
    rb, pb = _batch(cfg, 29, 13)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: ref_model.loss(p, rb), has_aux=True))(params)
    groups = opt.tree_groups(port.param_tree())
    flat = [t for ts, _ in groups for t in ts]
    port.requires_grad_(True)
    try:
        ploss, pm = port.loss(pb)
        g = dict(zip(map(id, flat), torch.autograd.grad(ploss, flat)))
    finally:
        port.requires_grad_(False)
    ploss, ce = float(ploss.detach()), float(pm["ce"].detach())
    assert abs(ploss - float(loss)) <= RTOL * abs(float(loss))
    assert abs(ce - float(metrics["ce"])) <= RTOL * abs(float(metrics["ce"]))
    got = [torch.stack([g[id(t)] for t in ts]) if st else g[id(ts[0])]
           for ts, st in groups]
    ref_g = [np.asarray(a, np.float32) for a in jax.tree.leaves(grads)]
    assert len(got) == len(ref_g) == len(jax.tree.leaves(params))
    assert "vis_proj" in port.param_tree()
    for i, (a, b) in enumerate(zip(got, ref_g)):
        assert _rel(a, b) <= RTOL, (i, _rel(a, b))


def test_prefill_with_patches_then_decode_matches_the_reference(models):
    """A prefill of 8 patches and 11 tokens (a cache of 19 positions),
    then three ragged decode steps at lengths (19, 14) rising: the logits
    and the caches at each step."""
    cfg, ref_model, params, port = models
    rb, pb = _batch(cfg, 11, 9)
    lg, cache = jax.jit(ref_model.prefill)(params, rb)
    plg, pcache = port.prefill(pb)
    assert tuple(pcache["main"]["k"].shape)[2] == 19
    assert _rel(plg, lg) <= RTOL
    for name in ("k", "v"):
        assert _rel(pcache["main"][name], cache["main"][name]) <= RTOL
    pad = [(0, 0), (0, 0), (0, 13), (0, 0), (0, 0)]
    cache = jax.tree.map(lambda a: jnp.pad(a, pad), cache)
    pcache = {"main": {n: torch.from_numpy(np.array(c))
                       for n, c in cache["main"].items()}}
    decode = jax.jit(ref_model.decode_step)
    rng = np.random.default_rng(3)
    cur = np.array([19, 14])
    for _ in range(3):
        nxt = rng.integers(1, cfg.vocab_size, (2, 1))
        lg, cache = decode(params, jnp.asarray(nxt, jnp.int32), cache,
                           jnp.asarray(cur, jnp.int32))
        plg, pcache = port.decode_step(torch.from_numpy(nxt), pcache,
                                       torch.from_numpy(cur))
        assert _rel(plg, lg) <= RTOL
        for name in ("k", "v"):
            assert _rel(pcache["main"][name], cache["main"][name]) <= RTOL
        cur = cur + 1


def test_decode_continues_the_prefill_with_patches(models):
    """After a prefill of 8 patches and 6 tokens, each of 4 teacher-forced
    decode steps gives the logits of a prefill of the longer sequence, as
    the reference's model does."""
    cfg, _, _, port = models
    _, pb = _batch(cfg, 10, 4)
    p = cfg.vision_patches
    _, cache = port.prefill({"tokens": pb["tokens"][:, :6],
                             "patches": pb["patches"]})
    big = port.cache_spec(2, 32)["main"]
    for name in ("k", "v"):
        t = torch.zeros(big[name].shape, dtype=port.dtype)
        t[:, :, :p + 6] = cache["main"][name]
        cache["main"][name] = t
    for i in range(6, 10):
        lg, cache = port.decode_step(pb["tokens"][:, i:i + 1], cache, p + i)
        want, _ = port.prefill({"tokens": pb["tokens"][:, :i + 1],
                                "patches": pb["patches"]})
        assert _rel(lg, want) <= RTOL, i


def test_train_step_matches_the_reference():
    """Float32 AdamW, two steps at grad_accum 2 (warmup 1), on
    `SyntheticLM`'s vlm batches: loss, "ce" and grad_norm within 1e-5
    relative; the moments after the first step within MOMENT_RTOL of each
    leaf's max; the parameters by the two-part rule."""
    kw = dict(lr=1e-2, warmup=1, total_steps=10, grad_accum=2)
    cfg, port_cfg = _cfgs()
    ref_model = ref_build_model(cfg)
    params = _numpy_init(ref_model.param_specs(), 1)
    ref_state = jax.jit(lambda p: ref_init_state(p, RefTrainConfig(**kw)))(
        params)
    model, state = train_state_from_numpy(
        port_cfg, jax.tree.map(np.asarray, ref_state), device="cpu")
    ref_step = jax.jit(ref_make_train_step(ref_model, RefTrainConfig(**kw)))
    step = make_train_step(model, TrainConfig(**kw))
    ref_data = RefSyntheticLM(cfg, batch=4, seq=24, seed=0)
    data = SyntheticLM(cfg, batch=4, seq=24, seed=0, device="cpu")
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


def test_engine_refuses_a_vlm_model(models):
    """The reference's engine passes no patches to prefill (it fails with
    KeyError 'patches'); the port's refuses the model up front."""
    with pytest.raises(NotImplementedError, match="passes no patches"):
        ServeEngine(models[3], max_len=32, slots=2)


def test_launchers_on_the_cpu(tmp_path):
    """`launch.train` trains the family at the demo preset; `launch.serve`
    refuses it, through the engine."""
    state, hist = launch_train.main([
        "--arch", "phi-3-vision-4.2b", "--steps", "2", "--device", "cpu",
        "--ckpt-dir", str(tmp_path)])
    assert int(state["step"]) == 2 and hist["restarts"] == 0
    assert "vis_proj" in state["params"]
    with pytest.raises(NotImplementedError, match="passes no patches"):
        launch_serve.main(["--arch", "phi-3-vision-4.2b", "--device", "cpu"])
