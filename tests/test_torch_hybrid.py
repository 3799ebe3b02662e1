"""The port's hybrid family (`models/mamba2.py`, `models/hybrid.py::
HybridLM`, its serving engine and its training) against the reference on
the CPU.

The reduced zamba2-2.7b config in float32 (4 Mamba-2 blocks, the shared
attention block after every 2: d_model 64, ssm_state 16, ssm_head_dim 8,
ssm_chunk 8, attn_chunk 16, vocab 256), weights drawn by the reference's
init rule from numpy seeds (`_numpy_init`: the leaves the rule makes
constant moved off their constants, so that every input is exercised)
and carried into the port by `convert`, as train states are, inputs made
from numpy seeds.  Tolerances: in float32, the
outputs, states, logits, caches, loss and gradients within 1e-5 of
max |reference|; the engine's tokens equal to a greedy loop over the
reference's `HybridLM.prefill`/`decode_step` at batch 1 (the reference's
engine cannot serve the family, ROADMAP Queue 3), up to a near-tie as in
`tests/test_torch_lm_serving.py`; a train step's parameters by the
two-part rule of `tests/_torch_train_util.py` and its float32 moments
within 1e-4 of each leaf's max |reference|.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models import mamba2 as ref_mamba2
from repro.models.config import reduced_config as ref_reduced_config
from repro.models.registry import build_model as ref_build_model
from repro.serving.engine import Request as RefRequest
from repro.training.train_loop import TrainConfig as RefTrainConfig
from repro.training.train_loop import init_state as ref_init_state
from repro.training.train_loop import make_train_step as ref_make_train_step
from repro_torch import configs
from repro_torch.convert import lm_params_from_numpy, train_state_from_numpy
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.launch.serve import build_served_model
from repro_torch.models import mamba2
from repro_torch.models.config import reduced_config
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.params import init_from_specs
from repro_torch.models.registry import build_model
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import TrainConfig, make_train_step
from _torch_train_util import ref_leaves, stacked_leaves, two_part
from test_torch_lm_serving import _assert_same_tokens, _margin, _run_port

ARCH = "zamba2_2_7b"
RTOL = 1e-5
MOMENT_RTOL = 1e-4


def _rel(port, ref):
    ref = np.asarray(ref, np.float32)
    port = port.detach().float().numpy() if torch.is_tensor(port) else \
        np.asarray(port, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max() / np.abs(ref).max())


def _numpy_init(specs, seed):
    """A parameter tree for the reference's spec tree, by its init rule
    with numpy draws (seed `seed`): a normal clipped to [-2, 2] times
    init_scale / sqrt(fan_in) for a leaf of two dimensions or more; for
    one of fewer, the rule's constant (1 where init_scale is -1, else 0)
    plus 0.3 times a normal draw.  Drawing a tree with jax.random on
    the CPU takes seconds; these draws take none."""
    rng = np.random.default_rng(seed)

    def make(s):
        if len(s.shape) <= 1:
            a = (s.init_scale == -1.0) + 0.3 * rng.standard_normal(s.shape)
        else:
            std = abs(s.init_scale) / np.sqrt(max(np.prod(s.shape[:-1]), 1))
            a = np.clip(rng.standard_normal(s.shape), -2, 2) * std
        return jnp.asarray(a, s.dtype)
    return jax.tree.map(make, specs, is_leaf=lambda x: hasattr(x, "axes"))


def _cfgs(**kw):
    ref = ref_reduced_config(ref_configs.get(ARCH)).replace(
        dtype="float32", **kw)
    port = reduced_config(configs.get(ARCH)).replace(dtype="float32", **kw)
    return ref, port


@pytest.fixture(scope="module")
def models():
    cfg, port_cfg = _cfgs()
    ref_model = ref_build_model(cfg)
    params = _numpy_init(ref_model.param_specs(), 0)
    port = lm_params_from_numpy(port_cfg, jax.tree.map(np.asarray, params),
                                device="cpu")
    return cfg, ref_model, params, port


@functools.lru_cache(maxsize=None)
def _ref_prefill(ref_model):
    return jax.jit(ref_model.prefill)


@functools.lru_cache(maxsize=None)
def _ref_decode(ref_model):
    return jax.jit(ref_model.decode_step)


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


# ------------------------------------------------------------ mamba-2 ----

def _block(models, i=1):
    """Block i's parameters: the reference's and the port's."""
    _, _, params, port = models
    return jax.tree.map(lambda a: a[i], params["mamba"]), port.mamba[i]


@pytest.mark.parametrize("s", [5, 19])
@pytest.mark.parametrize("resume", [False, True])
def test_mamba_apply_and_states_match_the_reference(models, s, resume):
    """`mamba_apply` with return_state at s 5 (one short chunk) and 19
    (three chunks, a tail pad), fresh or resumed from an ssm and a conv
    state."""
    cfg = models[0]
    rp, pp = _block(models)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    kw = {}
    if resume:
        _, n_heads, conv_dim = ref_mamba2._dims(cfg)
        kw = {"h0": rng.standard_normal(
                  (2, n_heads, cfg.ssm_state, cfg.ssm_head_dim)).astype(
                  np.float32),
              "conv0": rng.standard_normal(
                  (2, cfg.ssm_conv - 1, conv_dim)).astype(np.float32)}
    out, (h, conv) = jax.jit(functools.partial(
        ref_mamba2.mamba_apply, cfg=cfg, return_state=True))(
        rp, jnp.asarray(x), **{k: jnp.asarray(v) for k, v in kw.items()})
    pout, (ph, pconv) = mamba2.mamba_apply(
        pp, torch.from_numpy(x), cfg, return_state=True,
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert ph.dtype == torch.float32 and pconv.shape == conv.shape
    assert _rel(pout, out) <= RTOL
    assert _rel(ph, h) <= RTOL
    np.testing.assert_array_equal(pconv.numpy(), np.asarray(conv))


def test_mamba_steps_match_the_reference(models):
    """Six `mamba_step`s from a prefill's states: each output and the
    states after it, which the port returns without writing its input."""
    cfg = models[0]
    rp, pp = _block(models)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 13, cfg.d_model)).astype(np.float32)
    _, (h, conv) = jax.jit(functools.partial(
        ref_mamba2.mamba_apply, cfg=cfg, return_state=True))(
        rp, jnp.asarray(x[:, :7]))
    cache = {"ssm": h, "conv": conv}
    pcache = {"ssm": torch.from_numpy(np.array(h)),
              "conv": torch.from_numpy(np.array(conv))}
    step = jax.jit(functools.partial(ref_mamba2.mamba_step, cfg=cfg))
    for t in range(7, 13):
        before = pcache["conv"].clone()
        out, cache = step(rp, jnp.asarray(x[:, t:t + 1]), cache)
        pout, new = mamba2.mamba_step(pp, torch.from_numpy(x[:, t:t + 1]),
                                      pcache, cfg)
        assert torch.equal(pcache["conv"], before)
        pcache = new
        assert _rel(pout, out) <= RTOL, t
        assert _rel(pcache["ssm"], cache["ssm"]) <= RTOL, t
        assert _rel(pcache["conv"], cache["conv"]) <= RTOL, t


def test_mamba_gradients_match_jax_grad(models):
    """The gradient of sum(out * w) through the block's parameters and its
    input, at s 13 (two chunks, a tail pad)."""
    cfg = models[0]
    rp, pp = _block(models)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    ref_gp, ref_gx = jax.jit(jax.grad(
        lambda p, xx: jnp.sum(ref_mamba2.mamba_apply(p, xx, cfg) * w),
        argnums=(0, 1)))(rp, jnp.asarray(x))
    flat = opt.tree_leaves(pp.tree())
    xt = torch.from_numpy(x).requires_grad_(True)
    pp.requires_grad_(True)
    try:
        out = mamba2.mamba_apply(pp, xt, cfg)
        grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                    flat + [xt])
    finally:
        pp.requires_grad_(False)
    ref_g = jax.tree.leaves(ref_gp) + [ref_gx]
    assert len(grads) == len(ref_g)
    for i, (g, r) in enumerate(zip(grads, ref_g)):
        assert _rel(g, r) <= RTOL, i


# -------------------------------------------------------------- loss ----

def test_loss_and_grads_match_the_reference(models):
    """Seq 37 (five SSD chunks of 8, three attention blocks of 16): loss,
    "ce", "aux" = 0 and every gradient leaf against `jax.value_and_grad`."""
    cfg, ref_model, params, port = models
    toks = np.random.default_rng(13).integers(0, cfg.vocab_size, (2, 37))
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: ref_model.loss(p, {"tokens": jnp.asarray(toks, jnp.int32)}),
        has_aux=True))(params)
    groups = opt.tree_groups(port.param_tree())
    flat = [t for ts, _ in groups for t in ts]
    port.requires_grad_(True)
    try:
        ploss, pm = port.loss({"tokens": torch.from_numpy(toks)})
        g = dict(zip(map(id, flat), torch.autograd.grad(ploss, flat)))
    finally:
        port.requires_grad_(False)     # the fixture's model serves on
    got = [torch.stack([g[id(t)] for t in ts]) if st else g[id(ts[0])]
           for ts, st in groups]
    ploss, pm = ploss.detach(), {k: v.detach() for k, v in pm.items()}
    assert abs(float(ploss) - float(loss)) <= RTOL * abs(float(loss))
    assert abs(float(pm["ce"]) - float(metrics["ce"])) <= RTOL * abs(
        float(metrics["ce"]))
    assert float(pm["aux"]) == float(metrics["aux"]) == 0.0
    ref_g = [np.asarray(a, np.float32) for a in jax.tree.leaves(grads)]
    assert len(got) == len(ref_g)
    for i, (a, b) in enumerate(zip(got, ref_g)):
        assert _rel(a, b) <= RTOL, (i, _rel(a, b))


def test_remat_modes_are_bitwise_the_same(models):
    """remat "full" and "dots" (each Mamba block and each shared-block
    site checkpointed) give remat "none"'s loss and gradients bitwise."""
    params = jax.tree.map(np.asarray, models[2])
    toks = torch.from_numpy(np.random.default_rng(14).integers(
        0, 256, (2, 21)))
    runs = []
    for remat in ("none", "full", "dots"):
        model = lm_params_from_numpy(_cfgs(remat=remat)[1], params,
                                     device="cpu")
        model.requires_grad_(True)
        loss, _ = model.loss({"tokens": toks})
        runs.append((loss.detach(), torch.autograd.grad(
            loss, list(model.parameters()))))
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, runs[0][1]))


# ------------------------------------------------------------- serve ----

@pytest.mark.parametrize("s", [11, 23])
def test_prefill_logits_and_cache(models, s):
    """The logits, every block's ssm and conv state, and both sites' KV."""
    cfg, ref_model, params, port = models
    toks = np.random.default_rng(s).integers(1, cfg.vocab_size, (2, s))
    lg, cache = _ref_prefill(ref_model)(
        params, {"tokens": jnp.asarray(toks, jnp.int32)})
    plg, pcache = port.prefill({"tokens": torch.from_numpy(toks)})
    assert set(pcache) == set(cache) == {"mamba", "attn"}
    assert _rel(plg, lg) <= RTOL
    for part, names in (("mamba", ("ssm", "conv")), ("attn", ("k", "v"))):
        for name in names:
            assert pcache[part][name].dtype == {
                "ssm": torch.float32}.get(name, port.dtype)
            assert _rel(pcache[part][name], cache[part][name]) <= \
                RTOL, (part, name)
    spec = port.cache_spec(2, s)
    assert {p: {n: tuple(t.shape) for n, t in v.items()}
            for p, v in spec.items()} == {
        p: {n: tuple(t.shape) for n, t in v.items()}
        for p, v in pcache.items()}


def test_prefill_refuses_a_prompt_shorter_than_the_conv_state(models):
    with pytest.raises(ValueError, match="conv state"):
        models[3].prefill({"tokens": torch.ones((1, 2), dtype=torch.long)})


def test_ragged_decode_step(models):
    """One decode step at per-slot lengths (11, 6) after a prefill of 11:
    the logits and every cache leaf, written in place."""
    cfg, ref_model, params, port = models
    rng = np.random.default_rng(10)
    toks = rng.integers(1, cfg.vocab_size, (2, 11))
    _, cache = _ref_prefill(ref_model)(
        params, {"tokens": jnp.asarray(toks, jnp.int32)})
    pad = [(0, 0), (0, 0), (0, 21), (0, 0), (0, 0)]
    cache["attn"] = jax.tree.map(lambda a: jnp.pad(a, pad), cache["attn"])
    pcache = _torch_tree(cache)
    nxt = rng.integers(1, cfg.vocab_size, (2, 1))
    cur = np.array([11, 6])
    lg, cache2 = _ref_decode(ref_model)(
        params, jnp.asarray(nxt, jnp.int32), cache,
        jnp.asarray(cur, jnp.int32))
    before = {part: {n: t for n, t in c.items()} for part, c in
              pcache.items()}
    plg, pcache2 = port.decode_step(torch.from_numpy(nxt), pcache,
                                    torch.from_numpy(cur))
    assert _rel(plg, lg) <= RTOL
    for part in cache2:
        for name in cache2[part]:
            assert pcache2[part][name] is before[part][name]
            assert _rel(pcache2[part][name], cache2[part][name]) <= \
                RTOL, (part, name)


def test_decode_continues_the_prefill(models):
    """Prefill 8 tokens, then decode 4 teacher-forced ones (lock-step
    cur_len): each step's logits are the prefill's of the longer
    sequence."""
    cfg, _, _, port = models
    toks = np.random.default_rng(11).integers(1, cfg.vocab_size, (2, 12))
    t = torch.from_numpy(toks)
    _, cache = port.prefill({"tokens": t[:, :8]})
    big = port.cache_spec(2, 16)
    for name in ("k", "v"):
        pad = torch.zeros(big["attn"][name].shape, dtype=port.dtype)
        pad[:, :, :8] = cache["attn"][name]
        cache["attn"][name] = pad
    for i in range(8, 12):
        lg, cache = port.decode_step(t[:, i:i + 1], cache, i)
        want, _ = port.prefill({"tokens": t[:, :i + 1]})
        assert _rel(lg, want) <= RTOL, i


def _greedy_reference(ref_model, params, prompts, max_new, max_len):
    """Each prompt alone through the reference's prefill and ragged decode
    steps at batch 1: its tokens and each token's top-2 margin."""
    reqs, margins = [], {}
    for uid, prompt in enumerate(prompts):
        lg, cache = _ref_prefill(ref_model)(
            params, {"tokens": jnp.asarray(prompt[None], jnp.int32)})
        pad = [(0, 0), (0, 0), (0, max_len - len(prompt)), (0, 0), (0, 0)]
        cache["attn"] = jax.tree.map(lambda a: jnp.pad(a, pad),
                                     cache["attn"])
        req = RefRequest(uid=uid, prompt=prompt, max_new_tokens=max_new)
        for i in range(max_new):
            margins[(uid, i)] = _margin(lg[0, -1])
            req.output.append(int(jnp.argmax(lg[0, -1])))
            if i + 1 == max_new:
                break
            lg, cache = _ref_decode(ref_model)(
                params, jnp.asarray([[req.output[-1]]], jnp.int32), cache,
                jnp.asarray([len(prompt) + i], jnp.int32))
        reqs.append(req)
    return reqs, margins


def test_engine_matches_the_reference_greedy_loop(models):
    """3 requests of 5, 9 and 5 tokens over 2 slots, 4 new tokens each:
    the third is admitted into a slot whose states idle decodes have written; every
    request's tokens are the reference model's greedy loop's."""
    cfg, ref_model, params, port = models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 9, 5)]
    ref_reqs, margins = _greedy_reference(ref_model, params, prompts, 4, 32)
    port_reqs, steps = _run_port(port, prompts, 4, 32, 2)
    assert steps == 6
    assert all(r.done and len(r.output) == 4 for r in port_reqs)
    _assert_same_tokens(ref_reqs, margins, port_reqs)


# ------------------------------------------------------------- train ----

def test_train_step_matches_the_reference():
    """Float32 AdamW, two steps (warmup 1: the rate is 0 at step 0, 1e-2
    at step 1) at grad_accum 2: loss, "ce" and grad_norm within 1e-5
    relative at each step; the moments after the first step within
    MOMENT_RTOL of each leaf's max; the parameters after the second by the
    two-part rule.  (8-bit AdamW treats every leaf alike: it is held on
    the dense and MoE trees.)"""
    kw = dict(lr=1e-2, warmup=1, total_steps=10, grad_accum=2)
    cfg, port_cfg = _cfgs()
    ref_model = ref_build_model(cfg)
    params = _numpy_init(ref_model.param_specs(), 0)
    ref_state = jax.jit(lambda p: ref_init_state(p, RefTrainConfig(**kw)))(
        params)
    model, state = train_state_from_numpy(
        port_cfg, jax.tree.map(np.asarray, ref_state), device="cpu")
    assert isinstance(model, HybridLM)
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


# ------------------------------------------------------------- build ----

@pytest.mark.parametrize("arch", [ARCH, "phi_3_vision_4_2b"])
def test_in_place_init_is_init_from_specs(arch):
    """`build_served_model` gives `load_params(init_from_specs(...))`'s
    parameters bit for bit (every leaf of the reduced configs is one
    draw)."""
    cfg = reduced_config(configs.get(arch))
    model = build_served_model(cfg, "cpu", seed=5)
    old = build_model(cfg, device="cpu")
    old.load_params(init_from_specs(old.param_specs(),
                                    torch.Generator().manual_seed(5), "cpu"))
    pairs = list(zip(model.parameters(), old.parameters()))
    assert len(pairs) == len(list(old.parameters())) > 0
    assert all(torch.equal(a, b) for a, b in pairs)


def test_full_width_structure():
    """zamba2-2.7b on the meta device: 54 Mamba blocks, 9 sites of the one
    shared block, an untied head; the cache's leaves at 8 slots."""
    model = build_model(configs.get(ARCH), device="meta")
    assert isinstance(model, HybridLM)
    assert len(model.mamba) == 54 and model.groups == 9
    assert sum(model._is_site(i) for i in range(54)) == 9
    spec = model.cache_spec(8, 256)
    assert tuple(spec["mamba"]["ssm"].shape) == (54, 8, 80, 64, 64)
    assert tuple(spec["mamba"]["conv"].shape) == (54, 8, 3, 5248)
    assert tuple(spec["attn"]["k"].shape) == (9, 8, 256, 32, 80)
    with pytest.raises(ValueError, match="multiple of attn_every"):
        HybridLM(configs.get(ARCH).replace(num_layers=50), device="meta")


def test_launchers_run_the_family_on_the_cpu(tmp_path, capsys):
    """`launch.serve` and `launch.train` at the demo preset; a depth that
    is not a multiple of attn_every raises."""
    reqs, _ = launch_serve.main(["--arch", "zamba2-2.7b", "--requests", "3",
                                 "--device", "cpu"])
    assert all(r.done and len(r.output) == 16 for r in reqs)
    state, hist = launch_train.main([
        "--arch", "zamba2-2.7b", "--steps", "2", "--device", "cpu",
        "--ckpt-dir", str(tmp_path)])
    assert int(state["step"]) == 2 and hist["restarts"] == 0
    assert "drained 3 requests" in capsys.readouterr().out
    with pytest.raises(ValueError, match="multiple of attn_every"):
        launch_train.build_run("zamba2-2.7b", "full", layers=8,
                               device="meta")
