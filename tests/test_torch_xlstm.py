"""The port's xLSTM family (`models/xlstm.py`, `models/xlstm_model.py::
XLSTMLM`, its serving engine and its training) against the reference on
the CPU.

The reduced xlstm-350m config in float32 with 4 layers (2 (mLSTM, sLSTM)
pairs: d_model 64, 4 heads of 16, attn_chunk 16, vocab 256), weights
drawn by the reference's init rule from numpy seeds
(`test_torch_hybrid._numpy_init`) and carried into the port by `convert`,
inputs made from numpy seeds.  Tolerances: in float32, the outputs,
states, logits, loss and gradients within 1e-5 of max |reference|; the
engine's tokens equal to a greedy loop over the reference's
`XLSTMLM.prefill`/`decode_step` at batch 1 (the reference's engine cannot
serve the family: its splice pads the mLSTM state's head axis, ROADMAP
Queue 3), up to a near-tie as in `tests/test_torch_lm_serving.py`; a
train step's parameters by the two-part rule of
`tests/_torch_train_util.py`.

The port names its cache leaves ({"mlstm": {"h"}, "slstm": {"c", "n",
"h", "m"}}); the reference's cache is {"mlstm": array, "slstm": (c, n, h,
m)}, mapped here by `_ref_cache` and `_port_cache`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models import xlstm as ref_xlstm
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
from repro_torch.models import xlstm
from repro_torch.models.config import reduced_config
from repro_torch.models.registry import build_model
from repro_torch.models.xlstm_model import SLSTM_STATE, XLSTMLM
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import TrainConfig, make_train_step
from _torch_train_util import ref_leaves, stacked_leaves, two_part
from test_torch_hybrid import _numpy_init, _rel
from test_torch_lm_serving import _assert_same_tokens, _margin, _run_port

ARCH = "xlstm_350m"
RTOL = 1e-5
MOMENT_RTOL = 1e-4


def _cfgs(**kw):
    kw = {"dtype": "float32", "num_layers": 4, **kw}
    ref = ref_reduced_config(ref_configs.get(ARCH)).replace(**kw)
    port = reduced_config(configs.get(ARCH)).replace(**kw)
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


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_cache(cache):
    """The reference's cache as the port's named leaves."""
    return {"mlstm": {"h": _t(cache["mlstm"])},
            "slstm": {n: _t(a) for n, a in zip(SLSTM_STATE,
                                               cache["slstm"])}}


def _ref_cache(pcache):
    """The port's cache as the reference's tree, each leaf beside its
    name: [(part.name, array)]."""
    return [("mlstm.h", pcache["mlstm"]["h"])] + [
        (f"slstm.{n}", pcache["slstm"][n]) for n in SLSTM_STATE]


def _leaves(cache):
    return [("mlstm.h", cache["mlstm"])] + [
        (f"slstm.{n}", a) for n, a in zip(SLSTM_STATE, cache["slstm"])]


def _pair(models, i=1):
    """Pair i's mLSTM and sLSTM parameters: the reference's and the
    port's."""
    _, _, params, port = models
    take = lambda name: jax.tree.map(lambda a: a[i], params[name])  # noqa
    return (take("mlstm"), port.mlstm[i]), (take("slstm"), port.slstm[i])


# -------------------------------------------------------------- blocks ----

@pytest.mark.parametrize("s", [5, 19])
@pytest.mark.parametrize("resume", [False, True])
def test_mlstm_apply_and_state_match_the_reference(models, s, resume):
    """`mlstm_apply` with return_state at s 5 (one chunk of 5, no pad) and
    19 (chunks of 16, a tail pad), fresh or resumed from a state."""
    cfg = models[0]
    (rp, pp), _ = _pair(models)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    dh = cfg.d_model // cfg.num_heads
    h0 = rng.standard_normal((2, cfg.num_heads, dh, dh + 1)).astype(
        np.float32) if resume else None
    out, h = jax.jit(functools.partial(
        ref_xlstm.mlstm_apply, cfg=cfg, return_state=True))(
        rp, jnp.asarray(x), h0=None if h0 is None else jnp.asarray(h0))
    pout, ph = xlstm.mlstm_apply(pp, torch.from_numpy(x), cfg,
                                 h0=None if h0 is None else _t(h0),
                                 return_state=True)
    assert ph.dtype == torch.float32
    assert tuple(ph.shape) == (2, cfg.num_heads, dh, dh + 1)
    assert _rel(pout, out) <= RTOL
    assert _rel(ph, h) <= RTOL


def test_mlstm_steps_match_the_reference(models):
    """Six `mlstm_step`s from a prefill's state: each output and the state
    after it, which the port returns without writing its input."""
    cfg = models[0]
    (rp, pp), _ = _pair(models)
    x = np.random.default_rng(7).standard_normal(
        (3, 13, cfg.d_model)).astype(np.float32)
    _, h = jax.jit(functools.partial(
        ref_xlstm.mlstm_apply, cfg=cfg, return_state=True))(
        rp, jnp.asarray(x[:, :7]))
    ph = _t(h)
    step = jax.jit(functools.partial(ref_xlstm.mlstm_step, cfg=cfg))
    for t in range(7, 13):
        before = ph.clone()
        out, h = step(rp, jnp.asarray(x[:, t:t + 1]), h)
        pout, new = xlstm.mlstm_step(pp, torch.from_numpy(x[:, t:t + 1]), ph,
                                     cfg)
        assert torch.equal(ph, before)
        ph = new
        assert _rel(pout, out) <= RTOL, t
        assert _rel(ph, h) <= RTOL, t


@pytest.mark.parametrize("resume", [False, True])
def test_slstm_apply_and_state_match_the_reference(models, resume):
    """`slstm_apply` over 11 steps, fresh (m from -1e9) or resumed: the
    output and the state (c, n, h, m) in the reference's order."""
    cfg = models[0]
    _, (rp, pp) = _pair(models)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    state0 = None
    if resume:
        state0 = [rng.standard_normal((2, cfg.d_model)).astype(np.float32)
                  for _ in range(4)]
        state0[1] = np.abs(state0[1])
    out, st = jax.jit(functools.partial(
        ref_xlstm.slstm_apply, cfg=cfg, return_state=True))(
        rp, jnp.asarray(x),
        state0=None if state0 is None else tuple(map(jnp.asarray, state0)))
    pout, pst = xlstm.slstm_apply(
        pp, torch.from_numpy(x), cfg,
        state0=None if state0 is None else tuple(map(_t, state0)),
        return_state=True)
    assert _rel(pout, out) <= RTOL
    assert len(pst) == len(st) == 4
    for name, a, b in zip(SLSTM_STATE, pst, st):
        assert a.dtype == torch.float32
        assert _rel(a, b) <= RTOL, name


def test_slstm_steps_match_the_reference(models):
    """Five `slstm_step`s from a prefill's state, each output and state;
    the input state is not written."""
    cfg = models[0]
    _, (rp, pp) = _pair(models)
    x = np.random.default_rng(4).standard_normal(
        (3, 12, cfg.d_model)).astype(np.float32)
    _, st = jax.jit(functools.partial(
        ref_xlstm.slstm_apply, cfg=cfg, return_state=True))(
        rp, jnp.asarray(x[:, :7]))
    pst = tuple(_t(a) for a in st)
    step = jax.jit(functools.partial(ref_xlstm.slstm_step, cfg=cfg))
    for t in range(7, 12):
        before = [a.clone() for a in pst]
        out, st = step(rp, jnp.asarray(x[:, t:t + 1]), st)
        pout, new = xlstm.slstm_step(pp, torch.from_numpy(x[:, t:t + 1]),
                                     pst, cfg)
        assert all(torch.equal(a, b) for a, b in zip(pst, before))
        pst = new
        assert _rel(pout, out) <= RTOL, t
        for name, a, b in zip(SLSTM_STATE, pst, st):
            assert _rel(a, b) <= RTOL, (t, name)


def test_cache_shapes_are_the_references():
    """The cache's leaves, full width at 8 slots and reduced: the
    reference's shapes and dtypes, whatever max_len."""
    for reduce in (False, True):
        port_cfg, ref_cfg = configs.get(ARCH), ref_configs.get(ARCH)
        if reduce:
            port_cfg = reduced_config(port_cfg)
            ref_cfg = ref_reduced_config(ref_cfg)
        model = build_model(port_cfg, device="meta")
        want = {k: (tuple(a.shape), torch.float32) for k, a in
                _leaves(ref_build_model(ref_cfg).cache_spec(8, 64))}
        assert all(a.dtype == jnp.float32 for _, a in
                   _leaves(ref_build_model(ref_cfg).cache_spec(8, 64)))
        for max_len in (64, 4096):
            got = {k: (tuple(t.shape), t.dtype) for k, t in
                   _ref_cache(model.cache_spec(8, max_len))}
            assert got == want
    full = build_model(configs.get(ARCH), device="meta").cache_spec(8, 256)
    assert tuple(full["mlstm"]["h"].shape) == (12, 8, 4, 256, 257)
    assert tuple(full["slstm"]["m"].shape) == (12, 8, 1024)


# --------------------------------------------------------------- model ----

def test_loss_and_grads_match_the_reference(models):
    """Seq 21 (mLSTM chunks of 16 with a tail pad): loss, "ce", "aux" = 0
    and every gradient leaf against `jax.value_and_grad`."""
    cfg, ref_model, params, port = models
    toks = np.random.default_rng(13).integers(0, cfg.vocab_size, (2, 21))
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
    assert abs(float(ploss.detach()) - float(loss)) <= RTOL * abs(float(loss))
    assert abs(float(pm["ce"].detach()) - float(metrics["ce"])) <= \
        RTOL * abs(float(metrics["ce"]))
    assert float(pm["aux"]) == float(metrics["aux"]) == 0.0
    ref_g = [np.asarray(a, np.float32) for a in jax.tree.leaves(grads)]
    assert len(got) == len(ref_g)
    for i, (a, b) in enumerate(zip(got, ref_g)):
        assert _rel(a, b) <= RTOL, (i, _rel(a, b))


def test_remat_modes_are_bitwise_the_same(models):
    """remat "full" and "dots" (one checkpoint a pair) give remat "none"'s
    loss and gradients bitwise."""
    params = jax.tree.map(np.asarray, models[2])
    toks = torch.from_numpy(np.random.default_rng(14).integers(
        0, 256, (2, 9)))
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


@pytest.mark.parametrize("s", [5, 23])
def test_prefill_logits_and_cache(models, s):
    """The last position's logits and every pair's states."""
    cfg, ref_model, params, port = models
    toks = np.random.default_rng(s).integers(1, cfg.vocab_size, (2, s))
    lg, cache = _ref_prefill(ref_model)(
        params, {"tokens": jnp.asarray(toks, jnp.int32)})
    plg, pcache = port.prefill({"tokens": torch.from_numpy(toks)})
    assert _rel(plg, lg) <= RTOL
    for (name, a), (_, b) in zip(_ref_cache(pcache), _leaves(cache)):
        assert a.dtype == torch.float32
        assert _rel(a, b) <= RTOL, name


def test_decode_steps_match_the_reference(models):
    """Three decode steps after a prefill of 9, at per-slot lengths the
    family does not read: the logits and every state, written in place."""
    cfg, ref_model, params, port = models
    rng = np.random.default_rng(10)
    toks = rng.integers(1, cfg.vocab_size, (2, 9))
    _, cache = _ref_prefill(ref_model)(
        params, {"tokens": jnp.asarray(toks, jnp.int32)})
    pcache = _port_cache(cache)
    cur = np.array([9, 4])
    for _ in range(3):
        nxt = rng.integers(1, cfg.vocab_size, (2, 1))
        lg, cache = _ref_decode(ref_model)(
            params, jnp.asarray(nxt, jnp.int32), cache,
            jnp.asarray(cur, jnp.int32))
        before = [t for _, t in _ref_cache(pcache)]
        plg, pcache = port.decode_step(torch.from_numpy(nxt), pcache,
                                       torch.from_numpy(cur))
        assert _rel(plg, lg) <= RTOL
        for b0, (name, a), (_, b) in zip(before, _ref_cache(pcache),
                                         _leaves(cache)):
            assert a is b0
            assert _rel(a, b) <= RTOL, name
        cur = cur + 1


def test_decode_continues_the_prefill(models):
    """Prefill 8 tokens, then decode 4 teacher-forced ones: each step's
    logits are the prefill's of the longer sequence."""
    cfg, _, _, port = models
    t = torch.from_numpy(np.random.default_rng(11).integers(
        1, cfg.vocab_size, (2, 12)))
    _, cache = port.prefill({"tokens": t[:, :8]})
    for i in range(8, 12):
        lg, cache = port.decode_step(t[:, i:i + 1], cache, i)
        want, _ = port.prefill({"tokens": t[:, :i + 1]})
        assert _rel(lg, want) <= RTOL, i


def _greedy_reference(ref_model, params, prompts, max_new):
    """Each prompt alone through the reference's prefill and decode steps
    at batch 1: its tokens and each token's top-2 margin."""
    reqs, margins = [], {}
    for uid, prompt in enumerate(prompts):
        lg, cache = _ref_prefill(ref_model)(
            params, {"tokens": jnp.asarray(prompt[None], jnp.int32)})
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
    the third is admitted into a slot whose states idle decodes have
    written; every request's tokens are the reference model's greedy
    loop's."""
    cfg, ref_model, params, port = models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 9, 5)]
    ref_reqs, margins = _greedy_reference(ref_model, params, prompts, 4)
    port_reqs, steps = _run_port(port, prompts, 4, 32, 2)
    assert steps == 6
    assert all(r.done and len(r.output) == 4 for r in port_reqs)
    _assert_same_tokens(ref_reqs, margins, port_reqs)


# ------------------------------------------------------------- train ----

def test_train_step_matches_the_reference():
    """Float32 AdamW, two steps (warmup 1) at grad_accum 2 from the
    reference's state carried by `train_state_from_numpy`: loss, "ce" and
    grad_norm within 1e-5 relative at each step; the moments after the
    first within MOMENT_RTOL of each leaf's max; the parameters after the
    second by the two-part rule."""
    kw = dict(lr=1e-2, warmup=1, total_steps=10, grad_accum=2)
    cfg, port_cfg = _cfgs()
    ref_model = ref_build_model(cfg)
    params = _numpy_init(ref_model.param_specs(), 0)
    ref_state = jax.jit(lambda p: ref_init_state(p, RefTrainConfig(**kw)))(
        params)
    model, state = train_state_from_numpy(
        port_cfg, jax.tree.map(np.asarray, ref_state), device="cpu")
    assert isinstance(model, XLSTMLM)
    ref_step = jax.jit(ref_make_train_step(ref_model, RefTrainConfig(**kw)))
    step = make_train_step(model, TrainConfig(**kw))
    ref_data = RefSyntheticLM(cfg, batch=4, seq=12, seed=0)
    data = SyntheticLM(cfg, batch=4, seq=12, seed=0, device="cpu")
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

def test_odd_num_layers_raises():
    with pytest.raises(ValueError, match="must be even"):
        XLSTMLM(configs.get(ARCH).replace(num_layers=23), device="meta")
    with pytest.raises(ValueError, match="must be even"):
        launch_train.build_run("xlstm-350m", "full", layers=5, device="meta")


def test_launchers_run_the_family_on_the_cpu(tmp_path, capsys):
    """`launch.serve` and `launch.train` at the demo preset."""
    reqs, _ = launch_serve.main(["--arch", "xlstm-350m", "--requests", "3",
                                 "--device", "cpu"])
    assert all(r.done and len(r.output) == 16 for r in reqs)
    state, hist = launch_train.main([
        "--arch", "xlstm-350m", "--steps", "2", "--device", "cpu",
        "--ckpt-dir", str(tmp_path)])
    assert int(state["step"]) == 2 and hist["restarts"] == 0
    assert "drained 3 requests" in capsys.readouterr().out
