"""The port's LM serving engine (`repro_torch.serving.engine`) against the
reference's, on the CPU.

The reduced `qwen3_0_6b` config in float32, the reference's weights carried
across by `convert.lm_params_from_numpy`, the same requests through both
engines (the shapes of `tests/test_serving.py`).  Output tokens must be
equal, except after a token whose reference logits have a top-2 margin
under NEAR_TIE of max |logit|: there the request is compared up to that
token, and the test says so.
"""

import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest

import repro.configs as ref_configs
from repro.models.config import reduced_config as ref_reduced_config
from repro.models.params import init_from_specs as ref_init
from repro.models.registry import build_model as ref_build_model
from repro.serving.engine import Request as RefRequest
from repro.serving.engine import ServeEngine as RefServeEngine
from repro_torch import configs, serve_lm
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models.config import reduced_config
from repro_torch.serving.engine import Request, ServeEngine

ROOT = Path(__file__).resolve().parents[1]
NEAR_TIE = 1e-4


def _margin(logits) -> float:
    """Top-2 margin of one row of logits over its max |logit|."""
    row = np.sort(np.asarray(logits, np.float32).ravel())
    return float((row[-1] - row[-2]) / np.abs(row).max())


class _MarginModel:
    """The reference model, recording each prefill's top-2 margin (a
    callback from inside the engine's jitted prefill) in admission order."""

    def __init__(self, model):
        self._model = model
        self.cfg = model.cfg
        self.prefill_margins = []

    def cache_spec(self, *args):
        return self._model.cache_spec(*args)

    def decode_step(self, *args):
        return self._model.decode_step(*args)

    def prefill(self, params, batch, ctx=None):
        lg, cache = self._model.prefill(params, batch, ctx)
        jax.debug.callback(
            lambda x: self.prefill_margins.append(_margin(x[0, -1])), lg)
        return lg, cache


@pytest.fixture(scope="module")
def setup():
    cfg = ref_reduced_config(ref_configs.get("qwen3_0_6b")).replace(
        dtype="float32")
    ref_model = ref_build_model(cfg)
    params = ref_init(jax.random.PRNGKey(0), ref_model.param_specs())
    port = lm_params_from_numpy(
        reduced_config(configs.get("qwen3_0_6b")).replace(dtype="float32"),
        jax.tree.map(np.asarray, params), device="cpu")
    return cfg, ref_model, params, port


def _run_reference(ref_model, params, prompts, max_new, max_len, slots):
    """The reference engine's outputs, and each output token's top-2
    margin, keyed (uid, index)."""
    model = _MarginModel(ref_model)
    engine = RefServeEngine(model, params, max_len=max_len, slots=slots,
                            eos_id=-1)
    margins = {}
    decode = engine._decode

    def recording_decode(p, t, c, l):
        lg, c = decode(p, t, c, l)
        for slot, req in enumerate(engine.active):
            if req is not None:
                margins[(req.uid, len(req.output))] = _margin(lg[slot, -1])
        return lg, c

    engine._decode = recording_decode
    reqs = [RefRequest(uid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    steps = engine.run_until_drained()
    jax.effects_barrier()
    for r, m in zip(reqs, model.prefill_margins):   # admitted in uid order
        margins[(r.uid, 0)] = m
    return reqs, margins, steps


def _run_port(port, prompts, max_new, max_len, slots):
    engine = ServeEngine(port, max_len=max_len, slots=slots, eos_id=-1)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    return reqs, engine.run_until_drained()


def _assert_same_tokens(ref_reqs, margins, port_reqs):
    for ref, got in zip(ref_reqs, port_reqs):
        n = len(ref.output)
        tie = [j for j in range(n) if margins[(ref.uid, j)] < NEAR_TIE]
        if tie:
            n = tie[0]
            warnings.warn(f"request {ref.uid}: reference margin "
                          f"{margins[(ref.uid, n)]:.2e} < {NEAR_TIE} at "
                          f"token {n}; compared tokens 0-{n - 1} only")
        assert got.output[:n] == ref.output[:n], (ref.uid, got.output,
                                                  ref.output)
        assert len(got.output) == len(ref.output)


def test_engine_matches_reference_engine(setup, rng):
    """2 slots, prompts of 5 and 7 tokens, 4 new tokens each."""
    cfg, ref_model, params, port = setup
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 7)]
    ref_reqs, margins, ref_steps = _run_reference(ref_model, params, prompts,
                                                  4, 32, 2)
    port_reqs, steps = _run_port(port, prompts, 4, 32, 2)
    assert steps == ref_steps
    _assert_same_tokens(ref_reqs, margins, port_reqs)


def test_engine_continuous_batching_matches_reference(setup, rng):
    """5 requests over 2 slots: every request done with 3 tokens, at least
    6 lock-step waves, the reference engine's tokens and step count."""
    cfg, ref_model, params, port = setup
    prompts = [rng.integers(1, cfg.vocab_size, size=4).astype(np.int32)
               for _ in range(5)]
    port_reqs, steps = _run_port(port, prompts, 3, 24, 2)
    assert all(r.done for r in port_reqs)
    assert all(len(r.output) == 3 for r in port_reqs)
    assert steps >= 6
    ref_reqs, margins, ref_steps = _run_reference(ref_model, params, prompts,
                                                  3, 24, 2)
    assert steps == ref_steps
    _assert_same_tokens(ref_reqs, margins, port_reqs)


def test_run_until_drained_respects_max_steps(setup, rng):
    """max_steps bounds the drain loop and a later call resumes the same
    queue to completion."""
    cfg, _, _, port = setup
    engine = ServeEngine(port, max_len=32, slots=1, eos_id=-1)
    reqs = [Request(uid=i, prompt=rng.integers(
        1, cfg.vocab_size, size=4).astype(np.int32), max_new_tokens=6)
        for i in range(2)]
    for r in reqs:
        engine.submit(r)
    assert engine.run_until_drained(max_steps=2) == 2
    assert not all(r.done for r in reqs)
    assert engine.run_until_drained() > 0
    assert all(r.done for r in reqs)
    assert all(len(r.output) == 6 for r in reqs)


def test_engine_stops_at_eos_and_max_len(setup):
    """The stop rules: a decoded EOS token ends a request; a slot whose
    length reaches max_len - 1 ends too."""
    _, _, _, port = setup
    prompt = np.arange(1, 9, dtype=np.int32)
    probe = Request(uid=0, prompt=prompt, max_new_tokens=2)
    engine = ServeEngine(port, max_len=64, slots=1, eos_id=-1)
    engine.submit(probe)
    engine.run_until_drained()
    eos = Request(uid=1, prompt=prompt, max_new_tokens=10)
    engine = ServeEngine(port, max_len=64, slots=1, eos_id=probe.output[1])
    engine.submit(eos)
    assert engine.run_until_drained() == 1
    assert eos.done and eos.output == probe.output
    short = Request(uid=2, prompt=prompt, max_new_tokens=100)
    engine = ServeEngine(port, max_len=12, slots=1, eos_id=-1)
    engine.submit(short)
    engine.run_until_drained()
    # the prefill's token, then decodes until the length reaches 11
    assert short.done and len(short.output) == 1 + (12 - 1 - len(prompt))


def test_launch_serve_demo_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-0.6b", "--preset", "demo", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "drained 16 requests in" in out.stdout
    assert "device=cpu" in out.stdout


def test_serve_lm_twin_on_the_cpu(capsys):
    reqs, steps = serve_lm.main(["--device", "cpu", "--requests", "5",
                                 "--slots", "2", "--max-new", "4"])
    assert all(r.done and len(r.output) == 4 for r in reqs)
    assert steps >= 6
    assert "served 5 requests / 20 tokens" in capsys.readouterr().out


def test_launcher_traffic_is_the_references():
    """make_requests draws the reference launcher's prompts."""
    rng = np.random.default_rng(0)
    reqs = serve.make_requests(151936, 16)
    for r in reqs:
        want = rng.integers(1, 151936, size=int(rng.integers(4, 32)))
        assert np.array_equal(r.prompt, want) and r.max_new_tokens == 16
    assert {len(r.prompt) for r in reqs} <= set(range(4, 32))
