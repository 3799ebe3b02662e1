"""The port's training substrate (`repro_torch.training`, `repro_torch.data`)
against the reference on the CPU; the train step itself is held in
`tests/test_torch_train_step.py`.

Inputs come from numpy seeds; train states are carried across with
`convert.train_state_from_numpy`.  Tolerances, each stated at its test:

- quantizer: q equal but at ties (one step, on at most 1e-4 of the
  entries), scale and lo within 1e-6 relative, against the reference's
  quantizer as its train step runs it (jitted: eagerly, XLA's float32 log
  moves lo by up to 1.3e-6);
- schedule: bitwise, against the reference's schedule called on each step
  (its jitted form rounds up to a few steps differently from itself);
- parameters after an update: the two-part rule of
  `tests/_torch_train_util.py::two_part`;
- data, checkpoints, restarts: bitwise.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.configs as ref_configs
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models.config import reduced_config as ref_reduced_config
from repro.models.params import init_from_specs as ref_init
from repro.models.registry import build_model as ref_build_model
from repro.training import checkpoint as ref_checkpoint
from repro.training import optimizer as ref_opt
from repro_torch import configs
from repro_torch.convert import train_state_from_numpy
from repro_torch.data.pipeline import SyntheticLM, host_prefetch
from repro_torch.launch.serve import build_served_model
from repro_torch.models.config import reduced_config
from repro_torch.resilience.inject import FaultSpec
from repro_torch.training import checkpoint, optimizer as opt
from repro_torch.training.fault_tolerance import (FailureInjector,
                                                  SimulatedFailure,
                                                  run_resilient)
from repro_torch.training.train_loop import (TrainConfig, init_state,
                                             make_train_step)

from _torch_train_util import (np_of, ref_leaves, stacked_leaves, to_torch,
                               two_part)


# ----------------------------------------------------------- quantizer ----

_ref_quantize = jax.jit(ref_opt._quantize, static_argnames="log")


QUANT_SHAPES = [(64, 300), (3, 256), (2, 64, 128), (1000,), (5, 7),
                (512, 300)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("log", [False, True])
def test_quantize_and_dequantize_match_the_reference(log, seed):
    """Shapes with and without padding of the last axis (blocks of 256),
    the tie share counted over all of them (~191,000 entries)."""
    rng = np.random.default_rng(seed)
    flips = total = 0
    for shape in QUANT_SHAPES:
        x = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
        if log:
            x = x * x
            x.reshape(-1)[::97] = 0.0            # exact zeros: log(EPS0)
        ref = _ref_quantize(jnp.asarray(x), log=log)
        port = opt._quantize(torch.from_numpy(x), log=log)
        assert port.q.dtype == torch.int8 and port.q.shape == x.shape
        dq = np.abs(port.q.numpy().astype(np.int32) -
                    np.asarray(ref.q, np.int32))
        assert dq.max() <= 1, shape
        flips += int((dq > 0).sum())
        total += dq.size
        for name in ("scale", "lo"):
            r, p = np.asarray(getattr(ref, name)), getattr(port, name).numpy()
            assert p.shape == r.shape
            assert np.abs(p - r).max() <= 1e-6 * max(np.abs(r).max(), 1e-30)
        # the port's dequantization of the reference's QState
        qs = opt.QState(*(to_torch(a) for a in ref))
        back = opt._dequantize(qs, x.shape, log=log).numpy()
        want = np.asarray(ref_opt._dequantize(ref, x.shape, log=log))
        assert np.abs(back - want).max() <= 1e-6 * np.abs(want).max()
    assert flips <= 1e-4 * total, (flips, total)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), log=st.booleans())
def test_quantize_roundtrip_error_bound(seed, log):
    """The reference's own bound, on the port's quantizer."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 300)).astype(np.float32)
    if log:
        x = np.abs(x)
    qs = opt._quantize(torch.from_numpy(x), log=log)
    back = opt._dequantize(qs, x.shape, log=log).numpy()
    if log:
        rel = np.abs(back - x) / np.maximum(np.abs(x), 1e-12)
        assert np.median(rel) < 0.2
    else:
        amax = np.abs(x).max(axis=-1, keepdims=True)
        assert np.abs(back - x).max() <= (amax / 127.0).max() * 0.51 + 1e-7


def test_log_quant_preserves_tiny_values():
    v = torch.tensor([[1e-12, 1e-8, 1e-4, 1.0] * 64])
    back = opt._dequantize(opt._quantize(v, log=True), v.shape, log=True)
    assert float(((back - v).abs() / v).max()) < 0.25


def test_adamw_8bit_matches_fp32_on_quadratic():
    traj = {}
    for eight in (False, True):
        p = torch.zeros((4, 300))
        params = {"w": p}
        state = opt.adamw_init(params, eight_bit=eight)
        for _ in range(60):
            g = {"w": 2 * (params["w"] - 3.0)}
            opt.adamw_update(params, g, state, torch.tensor(0.1),
                             weight_decay=0.0, eight_bit=eight)
        traj[eight] = float(((params["w"] - 3.0) ** 2).sum())
    assert traj[True] < 0.1 * 9.0 * 4 * 300
    assert abs(traj[True] - traj[False]) < max(0.2 * abs(traj[False]), 2.0)


# ------------------------------------------------------------ schedule ----

@pytest.mark.parametrize("base_lr,warmup,total", [
    (3e-4, 100, 300), (1e-2, 5, 60), (5e-3, 5, 50), (3e-3, 20, 200),
    (1e-2, 1, 10), (1e-3, 0, 40)])
def test_schedule_is_bitwise_the_references(base_lr, warmup, total):
    ref = ref_opt.cosine_schedule(base_lr, warmup, total)
    port = opt.cosine_schedule(base_lr, warmup, total)
    steps = range(0, total + 6)
    want = np.array([np.asarray(ref(jnp.asarray(s, jnp.int32)))
                     for s in steps])
    got = np.array([port(torch.tensor(s, dtype=torch.int32)).numpy()
                    for s in steps])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_schedule_shape():
    s = opt.cosine_schedule(1e-3, warmup=10, total=100)
    assert float(s(torch.tensor(0))) == 0.0
    np.testing.assert_allclose(float(s(torch.tensor(10))), 1e-3, rtol=1e-5)
    assert float(s(torch.tensor(100))) == pytest.approx(1e-4, rel=1e-3)
    assert float(s(torch.tensor(55))) < 1e-3


def test_cosf_is_glibcs_on_the_schedules_range():
    """`_cosf` against the float32 cos of the reference's CPU backend, on
    every argument the schedule can give it at 100,000 steps and around."""
    prog = np.arange(0, 100_001, dtype=np.float32) / np.float32(100_000)
    y = (np.float32(np.pi) * prog).astype(np.float32)
    y = np.concatenate([y, -y, y + np.float32(3.0)])
    want = np.asarray(jnp.cos(jnp.asarray(y)))
    np.testing.assert_array_equal(opt._cosf(torch.from_numpy(y)).numpy(),
                                  want)


# ------------------------------------------------------------ clipping ----

@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_the_reference(max_norm):
    rng = np.random.default_rng(21)
    arrays = {"a": rng.standard_normal((10, 300)).astype(np.float32),
              "b": {"c": rng.standard_normal((7,)).astype(np.float32),
                    "d": rng.standard_normal((3, 5)).astype(np.float32)}}
    ref_tree = jax.tree.map(jnp.asarray, arrays)
    ref_tree["b"]["d"] = ref_tree["b"]["d"].astype(jnp.bfloat16)
    port_tree = {"a": torch.from_numpy(arrays["a"]),
                 "b": {"c": torch.from_numpy(arrays["b"]["c"]),
                       "d": to_torch(np.asarray(ref_tree["b"]["d"]))}}
    ref_clipped, ref_gn = ref_opt.clip_by_global_norm(ref_tree, max_norm)
    clipped, gn = opt.clip_by_global_norm(port_tree, max_norm)
    assert gn.dtype == torch.float32
    assert abs(float(gn) - float(ref_gn)) <= 1e-6 * float(ref_gn)
    assert clipped["b"]["d"].dtype == torch.bfloat16
    for p, r in zip(stacked_leaves(clipped), ref_leaves(ref_clipped)):
        assert np.abs(p - r).max() <= 1e-6 * np.abs(r).max() + (
            0 if p.size > 20 else 8e-3 * np.abs(r).max())


def test_clip_by_global_norm():
    clipped, gn = opt.clip_by_global_norm({"a": torch.full((10,), 10.0)},
                                          1.0)
    np.testing.assert_allclose(float(gn), np.sqrt(1000.0), rtol=1e-6)
    np.testing.assert_allclose(float(torch.linalg.norm(clipped["a"])), 1.0,
                               rtol=1e-5)


# -------------------------------------------------------------- update ----

_ref_update = jax.jit(ref_opt.adamw_update, static_argnames="eight_bit")


def _update_case(eight_bit, seed=22):
    """A reference tree (a stacked 'layers' leaf, a bf16 leaf, a padded
    last axis), its AdamW state after two updates, and fresh gradients;
    and the port's tree of the same values."""
    rng = np.random.default_rng(seed)
    shapes = {"layers": {"w": (3, 16, 300)}, "e": (40, 64), "n": (7,)}
    ref = jax.tree.map(lambda s: jnp.asarray(rng.standard_normal(s) * 0.1,
                                             jnp.float32), shapes,
                       is_leaf=lambda s: isinstance(s, tuple))
    ref["e"] = ref["e"].astype(jnp.bfloat16)
    state = jax.jit(ref_opt.adamw_init, static_argnames="eight_bit")(
        ref, eight_bit=eight_bit)

    def grads():
        return jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape), p.dtype), ref)

    for _ in range(2):
        ref, state = _ref_update(ref, grads(), state, 1e-2,
                                 eight_bit=eight_bit)
    g = grads()

    def port_of(tree):
        return {"e": to_torch(tree["e"]), "n": to_torch(tree["n"]),
                "layers": [{"w": to_torch(tree["layers"]["w"][i])}
                           for i in range(3)]}

    port = port_of(ref)
    port_state = opt.adamw_init(port, eight_bit=eight_bit)
    opt.tree_fill(port_state, [to_torch(a) for a in jax.tree.leaves(state)])
    return ref, state, g, port, port_state, port_of(g)


@pytest.mark.parametrize("eight_bit", [False, True])
def test_adamw_update_matches_the_reference(eight_bit):
    """One update from the same nonzero state and gradients: the
    parameters by the two-part rule with its 8-bit share; float32 moments
    within 1e-6 relative; 8-bit moments' q equal but at ties (1e-3 of
    the entries, one step), their scales within 1e-6 relative."""
    ref, state, g, port, port_state, port_g = _update_case(eight_bit)
    lr = 3e-3
    new_ref, new_state = _ref_update(ref, g, state, lr, eight_bit=eight_bit)
    same = opt.adamw_update(port, port_g, port_state,
                            torch.tensor(lr, dtype=torch.float32),
                            eight_bit=eight_bit)
    assert same[0] is port and same[1] is port_state
    assert port["e"].dtype == torch.bfloat16
    assert int(port_state["count"]) == int(new_state["count"]) == 3
    two_part(stacked_leaves(port), ref_leaves(new_ref), lr, eight_bit)
    for p, r in zip(stacked_leaves(port_state["mu"]),
                    ref_leaves(new_state["mu"])):
        if r.dtype == np.int8:
            dq = np.abs(p.astype(np.int32) - r)
            assert dq.max() <= 1 and (dq > 0).mean() <= 1e-3
        else:
            assert np.abs(p - r).max() <= 1e-6 * max(np.abs(r).max(), 1e-30)


@pytest.fixture(scope="module")
def tiny_setup():
    """The reference's tiny_setup (reduced smollm, vocab 64), in float32
    (bf16 products are slow on the CPU), weights from a
    `torch.Generator`."""
    return reduced_config(configs.get("smollm_360m")).replace(
        vocab_size=64, dtype="float32")


def _fresh(cfg, tcfg, seed=0):
    model = build_served_model(cfg, "cpu", seed=seed)
    return model, init_state(model, tcfg)


def test_loss_decreases(tiny_setup):
    cfg = tiny_setup
    tcfg = TrainConfig(lr=1e-2, warmup=5, total_steps=60, grad_accum=2)
    model, state = _fresh(cfg, tcfg)
    step = make_train_step(model, tcfg)
    data = SyntheticLM(cfg, batch=8, seq=32, seed=0, device="cpu")
    losses = []
    for i in range(25):
        state, m = step(state, data.batch_at(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses


def test_grad_accum_equivalence(tiny_setup):
    """grad_accum=2 over a batch == grad_accum=1 (same total batch)."""
    cfg = tiny_setup
    batch = SyntheticLM(cfg, batch=8, seq=32, seed=1,
                        device="cpu").batch_at(0)
    outs = {}
    for ga in (1, 2):
        tcfg = TrainConfig(lr=1e-3, warmup=0, total_steps=10, grad_accum=ga)
        model, state = _fresh(cfg, tcfg)
        state, m = make_train_step(model, tcfg)(state, batch)
        outs[ga] = (float(m["loss"]),
                    np_of(opt.tree_leaves(state["params"])[0]).astype(
                        np.float32))
    assert abs(outs[1][0] - outs[2][0]) < 1e-3
    np.testing.assert_allclose(outs[1][1], outs[2][1], rtol=2e-2, atol=2e-4)


# ---------------------------------------------------------------- data ----

@pytest.mark.parametrize("packed", [True, False])
def test_synthetic_batches_are_the_references(packed):
    cfg = reduced_config(configs.get("qwen3_0_6b"))
    ref = RefSyntheticLM(cfg, batch=4, seq=33, seed=3, packed=packed)
    port = SyntheticLM(cfg, batch=4, seq=33, seed=3, packed=packed,
                       device="cpu")
    for step in (0, 5, 6, 1234):
        got = port.batch_at(step)["tokens"]
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(ref.batch_at(step)["tokens"]))
    assert not torch.equal(port(5)["tokens"], port(6)["tokens"])


def test_prefetch_resumes_at_step():
    cfg = reduced_config(configs.get("qwen3_0_6b"))
    data = SyntheticLM(cfg, batch=2, seq=16, seed=0, device="cpu")
    it = host_prefetch(data.batch_at, start_step=7, depth=2)
    for want in (7, 8, 9):
        step, batch = next(it)
        assert step == want
        assert torch.equal(batch["tokens"], data.batch_at(want)["tokens"])
    it.close()


# ---------------------------------------------------------- checkpoint ----

def test_checkpoint_roundtrip_dtypes(tmp_path):
    state = {"a": torch.tensor([1.5, 2.5], dtype=torch.bfloat16),
             "b": {"c": torch.tensor([[1, 2]], dtype=torch.int8),
                   "d": torch.tensor(3, dtype=torch.int32)}}
    checkpoint.save(str(tmp_path), 7, state)
    assert checkpoint.latest_step(str(tmp_path)) == 7
    like = {"a": torch.zeros(2, dtype=torch.bfloat16),
            "b": {"c": torch.zeros((1, 2), dtype=torch.int8),
                  "d": torch.tensor(0, dtype=torch.int32)}}
    restored = checkpoint.restore(str(tmp_path), 7, like)
    assert restored is like and restored["a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(restored["a"].float().numpy(), [1.5, 2.5])
    np.testing.assert_array_equal(restored["b"]["c"].numpy(), [[1, 2]])
    assert int(restored["b"]["d"]) == 3
    # the reference reads it: bf16 logical dtype, int8, int32
    ref = ref_checkpoint.restore(str(tmp_path), 7, {
        "a": jnp.zeros(2, jnp.bfloat16),
        "b": {"c": jnp.zeros((1, 2), jnp.int8), "d": jnp.asarray(0)}})
    assert ref["a"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(ref["a"], np.float32),
                                  [1.5, 2.5])


def test_checkpoint_atomicity(tmp_path):
    """A second save over the same step replaces cleanly; tmp dirs gone."""
    state = {"x": torch.arange(4)}
    checkpoint.save(str(tmp_path), 1, state)
    checkpoint.save(str(tmp_path), 1, {"x": torch.arange(4) + 1})
    restored = checkpoint.restore(str(tmp_path), 1, state)
    np.testing.assert_array_equal(restored["x"].numpy(), [1, 2, 3, 4])
    assert not [d for d in os.listdir(tmp_path) if d.startswith("tmp_")]


def test_restore_refuses_another_structure(tmp_path):
    checkpoint.save(str(tmp_path), 1, {"x": torch.zeros(3)})
    with pytest.raises(ValueError, match="tree structure"):
        checkpoint.restore(str(tmp_path), 1, {"x": torch.zeros(3),
                                              "y": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(str(tmp_path), 1, {"x": torch.zeros(4)})
    with pytest.raises(ValueError, match="dtypes"):
        checkpoint.restore(str(tmp_path), 1,
                           {"x": torch.zeros(3, dtype=torch.bfloat16)})


@pytest.mark.parametrize("eight_bit", [False, True])
def test_checkpoints_cross_read_both_ways(tmp_path, eight_bit):
    """A whole train state (bf16 parameters, float32 or 8-bit moments, the
    counters; random values from a seed in the reference's structure):
    the port writes, the reference's `restore` reads; the reference
    writes, the port's `restore` reads; bitwise."""
    cfg = ref_reduced_config(ref_configs.get("qwen3_0_6b"))
    tcfg = dict(eight_bit_optimizer=eight_bit)
    params = ref_init(jax.random.PRNGKey(3),
                      ref_build_model(cfg).param_specs())
    rng = np.random.default_rng(4)

    def rand(p):
        return jnp.asarray(rng.standard_normal(p.shape) * 1e-3, jnp.float32)

    mu = jax.tree.map(
        lambda p: ({"m": _ref_quantize(rand(p), log=False),
                    "v": _ref_quantize(rand(p) ** 2, log=True)}
                   if eight_bit else {"m": rand(p), "v": rand(p) ** 2}),
        params)
    state = {"params": params, "step": jnp.asarray(7, jnp.int32),
             "opt": {"mu": mu, "count": jnp.asarray(7, jnp.int32)}}
    want = ref_leaves(state)
    port_cfg = reduced_config(configs.get("qwen3_0_6b"))
    _, port_state = train_state_from_numpy(
        port_cfg, jax.tree.map(np.asarray, state), device="cpu")
    # port -> reference
    checkpoint.save(str(tmp_path / "port"), 2, port_state)
    zero = jax.tree.map(jnp.zeros_like, state)
    got = ref_checkpoint.restore(str(tmp_path / "port"), 2, zero)
    for g, w in zip(ref_leaves(got), want):
        np.testing.assert_array_equal(g, w)
    assert [a.dtype for a in jax.tree.leaves(got)] == [
        a.dtype for a in jax.tree.leaves(state)]
    # reference -> port, into a fresh state
    ref_checkpoint.save(str(tmp_path / "ref"), 2, state)
    model = build_served_model(port_cfg, "cpu", seed=9)
    fresh = init_state(model, TrainConfig(**tcfg))
    assert checkpoint.restore(str(tmp_path / "ref"), 2, fresh) is fresh
    for g, w in zip(stacked_leaves(fresh), want):
        np.testing.assert_array_equal(g, w)
    assert opt.tree_leaves(fresh["params"])[0] is model.embed["table"]


def test_async_save_copies_before_it_returns(tmp_path):
    """The state changes in place right after a non-blocking save: the
    checkpoint holds the values at the save."""
    state = {"w": torch.arange(6.0), "step": torch.tensor(4)}
    checkpoint.save(str(tmp_path), 4, state, blocking=False)
    state["w"].add_(100.0)
    state["step"].fill_(5)
    checkpoint.wait_pending()
    like = {"w": torch.zeros(6), "step": torch.tensor(0)}
    checkpoint.restore(str(tmp_path), 4, like)
    np.testing.assert_array_equal(like["w"].numpy(), np.arange(6.0))
    assert int(like["step"]) == 4


# ----------------------------------------------------- fault tolerance ----

@pytest.mark.parametrize("eight_bit", [False, True])
def test_resumed_run_is_bitwise_the_uninterrupted_one(tiny_setup, tmp_path,
                                                      eight_bit):
    """Failures at steps 6 and 11, checkpoints every 5: the run ends at
    step 15 after 2 restarts, in the state of a run without failures."""
    cfg = tiny_setup
    tcfg = TrainConfig(lr=1e-2, warmup=2, total_steps=40,
                       eight_bit_optimizer=eight_bit)
    data = SyntheticLM(cfg, batch=4, seq=32, seed=0, device="cpu")
    finals = []
    for name, inj in (("plain", None),
                      ("faults", FailureInjector(fail_at=(6, 11)))):
        model, state = _fresh(cfg, tcfg)
        final, hist = run_resilient(make_train_step(model, tcfg), state,
                                    data.batch_at, num_steps=15,
                                    ckpt_dir=str(tmp_path / name),
                                    ckpt_every=5, injector=inj)
        assert int(final["step"]) == 15 and final is state
        finals.append((final, hist))
    (plain, h0), (resumed, h1) = finals
    assert h0["restarts"] == 0 and h0["completed_steps"] == 15
    assert h1["restarts"] == 2
    assert h1["completed_steps"] == 15 + 1 + 1   # steps 5 and 10 replayed
    for a, b in zip(opt.tree_leaves(plain), opt.tree_leaves(resumed)):
        assert torch.equal(a, b)


def test_straggler_timeout_aborts_and_resumes(tiny_setup, tmp_path):
    """A step slower than the timeout is abandoned and replayed from the
    last checkpoint.  The injector's straggler sleeps before the timed
    step, as in the reference, so the slow step here is the step itself."""
    cfg = tiny_setup
    tcfg = TrainConfig(lr=1e-2, warmup=2, total_steps=40)
    data = SyntheticLM(cfg, batch=4, seq=32, seed=0, device="cpu")
    model, state = _fresh(cfg, tcfg)
    step = make_train_step(model, tcfg)
    # the timeout: far above a warm step of this machine
    warm_model, warm_state = _fresh(cfg, tcfg)
    warm_step = make_train_step(warm_model, tcfg)
    warm_step(warm_state, data.batch_at(0))
    t0 = time.perf_counter()
    warm_step(warm_state, data.batch_at(1))
    timeout = max(1.0, 20 * (time.perf_counter() - t0))
    calls = []

    def slow_at_4(st, batch):
        calls.append(int(st["step"]))
        if calls.count(4) == 1 and calls[-1] == 4:
            time.sleep(timeout + 0.5)
        return step(st, batch)

    final, hist = run_resilient(slow_at_4, state, data.batch_at,
                                num_steps=6, ckpt_dir=str(tmp_path),
                                ckpt_every=2, step_timeout=timeout)
    assert int(final["step"]) == 6
    assert hist["straggler_aborts"] == 1 and hist["restarts"] == 1
    assert calls == [0, 1, 2, 3, 4, 4, 5]
    model2, plain = _fresh(cfg, tcfg)
    plain, _ = run_resilient(make_train_step(model2, tcfg), plain,
                             data.batch_at, num_steps=6,
                             ckpt_dir=str(tmp_path / "plain"), ckpt_every=2)
    for a, b in zip(opt.tree_leaves(plain), opt.tree_leaves(final)):
        assert torch.equal(a, b)


def test_injector_from_specs_and_too_many_restarts(tiny_setup, tmp_path):
    inj = FailureInjector.from_specs(
        [FaultSpec("nan", iteration=3), FaultSpec("bitflip", iteration=5),
         FaultSpec("drop_exchange", iteration=4)], straggle_seconds=0.0)
    assert inj.fail_at == (3, 5) and inj.straggle_at == (4,)
    inj.check(2)
    with pytest.raises(SimulatedFailure, match="step 3"):
        inj.check(3)
    inj.check(3)                       # once each
    cfg = tiny_setup
    tcfg = TrainConfig(lr=1e-2, warmup=2, total_steps=40)
    model, state = _fresh(cfg, tcfg)
    data = SyntheticLM(cfg, batch=2, seq=16, seed=0, device="cpu")
    with pytest.raises(SimulatedFailure):
        run_resilient(make_train_step(model, tcfg), state, data.batch_at,
                      num_steps=4, ckpt_dir=str(tmp_path), ckpt_every=2,
                      injector=FailureInjector(fail_at=(1, 2)),
                      max_restarts=1)
