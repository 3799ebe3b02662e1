"""The port's MoE family (`DecoderLM` with MoE layers, its serving engine
and its training) against the reference on the CPU.

The reduced configs of moonshot-v1-16b-a3b and kimi-k2-1t-a32b (a dense
layer, then a MoE layer: d_model 64, 4 experts, top-2, moe_d_ff 32,
capacity factor 4, vocab 256), the reference's weights and train states
carried across by `convert`, inputs made from numpy seeds.  Tolerances:
in float32, the logits, caches, loss and gradients within 1e-5 of
max |reference| and the aux loss within 1e-6 (bfloat16 is held at the
layer, `tests/test_torch_moe.py`); the
engine's tokens equal to the reference engine's (up to a near-tie, as in
`tests/test_torch_lm_serving.py`); a train step's parameters by the
two-part rule of `tests/_torch_train_util.py` and its float32 moments
within 1e-4 of each leaf's max |reference|; checkpoints bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models.config import reduced_config as ref_reduced_config
from repro.models.params import init_from_specs as ref_init
from repro.models.params import spec_bytes as ref_spec_bytes
from repro.models.registry import build_model as ref_build_model
from repro.training import checkpoint as ref_checkpoint
from repro.training.train_loop import TrainConfig as RefTrainConfig
from repro.training.train_loop import init_state as ref_init_state
from repro.training.train_loop import make_train_step as ref_make_train_step
from repro_torch import configs
from repro_torch.convert import lm_params_from_numpy, train_state_from_numpy
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.launch.serve import build_served_model
from repro_torch.models import params as params_mod
from repro_torch.models.config import reduced_config
from repro_torch.models.params import init_from_specs, spec_bytes
from repro_torch.models.registry import PENDING, build_model
from repro_torch.training import checkpoint
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import (TrainConfig, init_state,
                                             make_train_step)
from _torch_train_util import ref_leaves, stacked_leaves, two_part
from test_torch_lm_serving import (_assert_same_tokens, _run_port,
                                   _run_reference)

ARCHS = ["moonshot_v1_16b_a3b", "kimi_k2_1t_a32b"]
RTOL = 1e-5
AUX_TOL = 1e-6
MOMENT_RTOL = 1e-4


def _rel(port, ref):
    ref = np.asarray(ref, np.float32)
    port = port.detach().float().numpy() if torch.is_tensor(port) else \
        np.asarray(port, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max() / np.abs(ref).max())


def _setup(arch):
    cfg = ref_reduced_config(ref_configs.get(arch)).replace(dtype="float32")
    ref_model = ref_build_model(cfg)
    params = ref_init(jax.random.PRNGKey(0), ref_model.param_specs())
    port = lm_params_from_numpy(
        reduced_config(configs.get(arch)).replace(dtype="float32"),
        jax.tree.map(np.asarray, params), device="cpu")
    return cfg, ref_model, params, port


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return _setup(request.param)


# ------------------------------------------------------------- sizes ----

@pytest.mark.parametrize("arch", ARCHS)
def test_full_moe_parameter_count_is_the_references(arch):
    """Full width on the meta device: the reference spec tree's elements
    and bytes, and moonshot's 28,386,592,768 parameters, 26,021,462,016 of
    them in the routed experts."""
    ref_specs = ref_build_model(ref_configs.get(arch)).param_specs()
    leaves = jax.tree.leaves(ref_specs, is_leaf=lambda x: hasattr(x, "axes"))
    ref_count = sum(int(np.prod(s.shape)) for s in leaves)
    model = build_model(configs.get(arch), device="meta")
    assert sum(p.numel() for p in model.parameters()) == ref_count
    assert spec_bytes(model.param_specs()) == ref_spec_bytes(ref_specs)
    assert set(model.param_tree()) == set(ref_specs) - {"rope_table"}
    assert "moe" not in PENDING
    if arch == "moonshot_v1_16b_a3b":
        assert ref_count == 28_386_592_768
        routed = sum(p.numel() for layer in model.layers
                     for p in layer.moe.experts.parameters())
        assert routed == 26_021_462_016
        assert len(model.dense_layers) == 1 and len(model.layers) == 47


# -------------------------------------------------------------- loss ----

def test_loss_and_grads_match_the_reference(models):
    """Seq 37 (three attention blocks of 16): loss, "ce", "aux" and every
    gradient leaf against `jax.value_and_grad` of the reference's loss."""
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
    ploss, pm = ploss.detach(), {k: v.detach() for k, v in pm.items()}
    got = [torch.stack([g[id(t)] for t in ts]) if st else g[id(ts[0])]
           for ts, st in groups]
    assert abs(float(ploss) - float(loss)) <= RTOL * abs(float(loss))
    assert abs(float(pm["ce"]) - float(metrics["ce"])) <= RTOL * abs(
        float(metrics["ce"]))
    assert abs(float(pm["aux"]) - float(metrics["aux"])) <= AUX_TOL
    assert float(pm["aux"]) > 0.9
    ref_g = [np.asarray(a, np.float32) for a in jax.tree.leaves(grads)]
    assert len(got) == len(ref_g)
    for i, (a, b) in enumerate(zip(got, ref_g)):
        assert _rel(a, b) <= RTOL, (i, _rel(a, b))


def test_remat_modes_are_bitwise_the_same():
    """A dense layer and two MoE layers: remat "full", "dots" and
    scan_group 2 give remat "none"'s loss, aux and gradients bitwise (the
    router's aux carried through the checkpoints)."""
    arch = "moonshot_v1_16b_a3b"
    cfg = ref_reduced_config(ref_configs.get(arch)).replace(
        dtype="float32", num_layers=3)
    params = jax.tree.map(np.asarray, ref_init(
        jax.random.PRNGKey(1), ref_build_model(cfg).param_specs()))
    toks = torch.from_numpy(np.random.default_rng(14).integers(
        0, cfg.vocab_size, (2, 29)))
    runs = []
    for remat, group in (("none", 0), ("full", 0), ("dots", 0),
                         ("full", 2), ("dots", 2)):
        model = lm_params_from_numpy(
            reduced_config(configs.get(arch)).replace(
                dtype="float32", num_layers=3, remat=remat,
                scan_group=group), params, device="cpu")
        model.requires_grad_(True)
        loss, m = model.loss({"tokens": toks})
        runs.append((loss.detach(), m["aux"].detach(), torch.autograd.grad(
            loss, list(model.parameters()))))
    for loss, aux, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0]) and torch.equal(aux, runs[0][1])
        assert all(torch.equal(a, b) for a, b in zip(grads, runs[0][2]))


# ------------------------------------------------------------- serve ----

@pytest.mark.parametrize("s", [9, 23])
def test_prefill_logits_and_cache(models, s):
    """Both cache parts, "dense" (the first layer) and "main"."""
    cfg, ref_model, params, port = models
    toks = np.random.default_rng(9).integers(1, cfg.vocab_size, (2, s))
    lg, cache = jax.jit(lambda p, b: ref_model.prefill(p, b))(
        params, {"tokens": jnp.asarray(toks, jnp.int32)})
    plg, pcache = port.prefill({"tokens": torch.from_numpy(toks)})
    assert set(pcache) == set(cache) == {"dense", "main"}
    assert _rel(plg, lg) <= RTOL
    for part in cache:
        for name in ("k", "v"):
            assert pcache[part][name].shape == cache[part][name].shape
            assert _rel(pcache[part][name], cache[part][name]) <= \
                RTOL, (part, name)


def test_ragged_decode_step(models):
    """One decode step at per-slot lengths (11, 6) after a prefill of 11:
    the MoE routes 2 tokens at the capacity of 2 tokens, as the
    reference's does; logits and both caches, written in place."""
    cfg, ref_model, params, port = models
    rng = np.random.default_rng(10)
    toks = rng.integers(1, cfg.vocab_size, (2, 11))
    _, cache = jax.jit(lambda p, b: ref_model.prefill(p, b))(
        params, {"tokens": jnp.asarray(toks, jnp.int32)})
    pad = [(0, 0), (0, 0), (0, 21), (0, 0), (0, 0)]
    cache = jax.tree.map(lambda a: jnp.pad(a, pad), cache)
    pcache = {part: {n: torch.from_numpy(np.array(c[n])) for n in c}
              for part, c in cache.items()}
    nxt = rng.integers(1, cfg.vocab_size, (2, 1))
    cur = np.array([11, 6])
    lg, cache2 = jax.jit(lambda p, t, c, l: ref_model.decode_step(
        p, t, c, l))(params, jnp.asarray(nxt, jnp.int32), cache,
                     jnp.asarray(cur, jnp.int32))
    before = {part: c["k"] for part, c in pcache.items()}
    plg, pcache2 = port.decode_step(torch.from_numpy(nxt), pcache,
                                    torch.from_numpy(cur))
    assert all(pcache2[part]["k"] is before[part] for part in before)
    assert _rel(plg, lg) <= RTOL
    for part in cache2:
        for name in ("k", "v"):
            assert _rel(pcache2[part][name], cache2[part][name]) <= \
                RTOL, (part, name)


def test_engine_matches_reference_engine(models):
    """3 requests of 5-9 tokens over 2 slots, 4 new tokens each: the
    reference engine's tokens and step count (the third request is
    admitted into a freed slot; idle slots decode too)."""
    cfg, ref_model, params, port = models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 9, 7)]
    ref_reqs, margins, ref_steps = _run_reference(ref_model, params, prompts,
                                                  4, 32, 2)
    port_reqs, steps = _run_port(port, prompts, 4, 32, 2)
    assert steps == ref_steps
    assert all(r.done and len(r.output) == 4 for r in port_reqs)
    _assert_same_tokens(ref_reqs, margins, port_reqs)


# ------------------------------------------------------------- train ----

@pytest.mark.parametrize("eight_bit", [False, True])
def test_train_step_matches_the_reference(eight_bit):
    """Two steps (warmup 1: the rate is 0 at step 0, 1e-2 at step 1) at
    grad_accum 2: loss, "ce" and grad_norm within 1e-5 relative, "aux"
    within 1e-6, at each step; the float32 moments after the first step
    (one gradient from the same state) within MOMENT_RTOL of each leaf's
    max; the parameters after the second by the two-part rule.  The 8-bit
    moments are held through the parameters they move: their log-scale
    blocks put a gradient of 0 and one of 1e-12 many steps apart."""
    arch = "moonshot_v1_16b_a3b"
    kw = dict(lr=1e-2, warmup=1, total_steps=10, grad_accum=2,
              eight_bit_optimizer=eight_bit)
    cfg = ref_reduced_config(ref_configs.get(arch)).replace(dtype="float32")
    ref_model = ref_build_model(cfg)
    params = ref_init(jax.random.PRNGKey(0), ref_model.param_specs())
    ref_state = jax.jit(lambda p: ref_init_state(p, RefTrainConfig(**kw)))(
        params)
    model, state = train_state_from_numpy(
        reduced_config(configs.get(arch)).replace(dtype="float32"),
        jax.tree.map(np.asarray, ref_state), device="cpu")
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
        assert abs(float(m["aux"]) - float(ref_m["aux"])) <= \
            AUX_TOL
        lr_sum += float(m["lr"])
        if i == 0 and not eight_bit:
            port_mu = stacked_leaves(state["opt"]["mu"])
            ref_mu = ref_leaves(ref_state["opt"]["mu"])
            assert len(port_mu) == len(ref_mu)
            for j, (p, r) in enumerate(zip(port_mu, ref_mu)):
                assert np.abs(p - r).max() <= MOMENT_RTOL * max(
                    np.abs(r).max(), 1e-30), j
    two_part(stacked_leaves(state["params"]), ref_leaves(ref_state["params"]),
             lr_sum, eight_bit, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_cross_read_both_ways(arch, tmp_path):
    """A reference train state of the family (bf16 parameters, float32
    moments): the port writes, the reference reads; the reference writes,
    the port reads into a fresh state; bitwise."""
    cfg = ref_reduced_config(ref_configs.get(arch))
    params = ref_init(jax.random.PRNGKey(3),
                      ref_build_model(cfg).param_specs())
    rng = np.random.default_rng(4)
    mu = jax.tree.map(lambda p: {
        "m": jnp.asarray(rng.standard_normal(p.shape) * 1e-3, jnp.float32),
        "v": jnp.asarray(rng.random(p.shape) * 1e-6, jnp.float32)}, params)
    state = {"params": params, "step": jnp.asarray(7, jnp.int32),
             "opt": {"mu": mu, "count": jnp.asarray(7, jnp.int32)}}
    want = ref_leaves(state)
    port_cfg = reduced_config(configs.get(arch))
    _, port_state = train_state_from_numpy(
        port_cfg, jax.tree.map(np.asarray, state), device="cpu")
    checkpoint.save(str(tmp_path / "port"), 2, port_state)
    got = ref_checkpoint.restore(str(tmp_path / "port"), 2,
                                 jax.tree.map(jnp.zeros_like, state))
    for g, w in zip(ref_leaves(got), want):
        np.testing.assert_array_equal(g, w)
    ref_checkpoint.save(str(tmp_path / "ref"), 2, state)
    fresh = init_state(build_served_model(port_cfg, "cpu", seed=9),
                       TrainConfig())
    checkpoint.restore(str(tmp_path / "ref"), 2, fresh)
    for g, w in zip(stacked_leaves(fresh), want):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------- build ----

@pytest.mark.parametrize("arch", ["qwen3_0_6b", "moonshot_v1_16b_a3b"])
def test_in_place_init_is_init_from_specs(arch):
    """`build_served_model` (the model's own parameters filled in place)
    gives the parameters of `load_params(init_from_specs(...))`, bit for
    bit: every leaf of the reduced configs is one draw."""
    cfg = reduced_config(configs.get(arch))
    model = build_served_model(cfg, "cpu", seed=5)
    old = build_model(cfg, device="cpu")
    old.load_params(init_from_specs(old.param_specs(),
                                    torch.Generator().manual_seed(5), "cpu"))
    pairs = list(zip(model.parameters(), old.parameters()))
    assert len(pairs) == len(list(old.parameters()))
    assert all(torch.equal(a, b) for a, b in pairs)


def test_in_place_init_draws_large_leaves_in_pieces(monkeypatch):
    """With FILL_CHUNK at 1000 values, pieces end inside a layer and span
    layers: the values repeat from the seed and keep init_from_specs'
    rule (zeros, ones, a normal truncated at 2 std, filled to the last
    value); a leaf drawn in pieces takes other values than its whole
    draw (and moves the stream of the leaves after it)."""
    monkeypatch.setattr(params_mod, "FILL_CHUNK", 1000)
    cfg = reduced_config(configs.get("moonshot_v1_16b_a3b"))
    a, b = (build_served_model(cfg, "cpu", seed=5) for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    old = init_from_specs(a.param_specs(), torch.Generator().manual_seed(5),
                          "cpu")
    groups = opt.tree_groups(a.param_tree())
    assert len(groups) == len(_spec_leaves(a.param_specs()))
    for spec, (ts, stacked), want in zip(_spec_leaves(a.param_specs()),
                                         groups, opt.tree_leaves(old)):
        got = torch.stack(ts) if stacked else ts[0]
        if not want.any() or (want == 1).all():
            assert torch.equal(got, want), spec
            continue
        std = abs(spec.init_scale) / np.sqrt(np.prod(spec.shape[:-1]))
        assert float(got.float().abs().max()) <= 2 * std * 1.01, spec
        assert float(got.float().std()) > 0.5 * std, spec
        if got.numel() > 1000:
            assert not torch.equal(got, want), spec


def _spec_leaves(specs):
    """A spec tree's ParamSpecs in `tree_groups`' order (keys sorted)."""
    return [leaf for k in sorted(specs) for leaf in (
        _spec_leaves(specs[k]) if isinstance(specs[k], dict) else
        [specs[k]])]


def test_launchers_run_the_family_on_the_cpu(tmp_path, capsys):
    """`launch.serve` and `launch.train` at the demo preset."""
    reqs, _ = launch_serve.main(["--arch", "moonshot-v1-16b-a3b",
                                 "--requests", "3", "--device", "cpu"])
    assert all(r.done and len(r.output) == 16 for r in reqs)
    state, hist = launch_train.main([
        "--arch", "kimi-k2-1t-a32b", "--steps", "2", "--device", "cpu",
        "--ckpt-dir", str(tmp_path)])
    assert int(state["step"]) == 2 and hist["restarts"] == 0
    assert "drained 3 requests" in capsys.readouterr().out
