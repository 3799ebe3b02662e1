"""The xLSTM and enc-dec/audio families on the card.

Checks, each against the same code on the CPU from the same weights (a
model built on the CPU, its parameters copied to the card): the reduced
xlstm-350m config (4 layers: 2 (mLSTM, sLSTM) pairs) and the reduced
seamless-m4t-medium config, float32: prefill, decode steps and loss with
gradients within 1e-5 of max |CPU| (seamless's decode on the prefill's
unpadded cross K/V); the engine over an xLSTM stream twice, the same
tokens and logits bitwise; a train step of each family that reads
nothing back to the host (CUDA's sync debug mode).

Every test carries the `cuda` marker and skips without a card, decided in
the `card` fixture at run time.  This file imports neither jax nor the
reference package.  Run on the card:
``python -m pytest -q -m cuda tests/test_torch_lm_families_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.serve import build_served_model
from repro_torch.models.config import reduced_config
from repro_torch.training.train_loop import (TrainConfig, init_state,
                                             make_train_step)
from test_torch_hybrid_cuda import RTOL, _pair, _rel, _serve, _to

pytestmark = pytest.mark.cuda

XLSTM, AUDIO = "xlstm-350m", "seamless-m4t-medium"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _grads_match(cpu, gpu, batch, card):
    for m in (cpu, gpu):
        m.requires_grad_(True)
    loss, _ = cpu.loss(batch)
    lossc, _ = gpu.loss(_to(batch, card))
    assert abs(float(lossc.detach()) - float(loss.detach())) <= \
        RTOL * abs(float(loss.detach()))
    for a, b in zip(torch.autograd.grad(lossc, list(gpu.parameters())),
                    torch.autograd.grad(loss, list(cpu.parameters()))):
        assert _rel(a, b) <= RTOL


def test_xlstm_prefill_decode_and_loss_match_the_cpu(card):
    cfg, cpu, gpu = _pair(XLSTM, card, num_layers=4)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (3, 21)))
    lg, cache = cpu.prefill({"tokens": toks[:, :13]})
    lgc, cachec = gpu.prefill({"tokens": toks[:, :13].to(card)})
    assert _rel(lgc, lg) <= RTOL
    for part in cache:
        for name in cache[part]:
            assert _rel(cachec[part][name], cache[part][name]) <= RTOL
    cur = torch.tensor([13, 9, 11])
    for i in range(13, 17):
        lg, cache = cpu.decode_step(toks[:, i:i + 1], cache, cur)
        lgc, cachec = gpu.decode_step(toks[:, i:i + 1].to(card), cachec,
                                      cur.to(card))
        assert _rel(lgc, lg) <= RTOL, i
        cur = cur + 1
    _grads_match(cpu, gpu, {"tokens": toks}, card)


def test_audio_prefill_decode_and_loss_match_the_cpu(card):
    cfg, cpu, gpu = _pair(AUDIO, card)
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 21)))
    frames = torch.from_numpy(rng.standard_normal(
        (2, 21, cfg.audio_dim)).astype(np.float32))
    lg, cache = cpu.prefill({"tokens": toks[:, :9], "frames": frames})
    lgc, cachec = gpu.prefill(_to({"tokens": toks[:, :9], "frames": frames},
                                  card))
    assert _rel(lgc, lg) <= RTOL
    assert cachec["cross"]["k"].shape[2] == 21
    wide = cpu.cache_spec(2, 32)["self"]
    for c, dev in ((cache, "cpu"), (cachec, card)):
        for name in ("k", "v"):
            t = torch.zeros(wide[name].shape, device=dev)
            t[:, :, :9] = c["self"][name]
            c["self"][name] = t
    cur = torch.tensor([9, 7])
    for i in range(9, 12):
        lg, cache = cpu.decode_step(toks[:, i:i + 1], cache, cur)
        lgc, cachec = gpu.decode_step(toks[:, i:i + 1].to(card), cachec,
                                      cur.to(card))
        assert _rel(lgc, lg) <= RTOL, i
        cur = cur + 1
    _grads_match(cpu, gpu, {"tokens": toks, "frames": frames}, card)


def test_xlstm_engine_repeats_bitwise(card):
    cfg = reduced_config(configs.get(XLSTM))
    model = build_served_model(cfg, card, seed=0)
    tokens, logits = _serve(model, cfg)
    again, logits2 = _serve(model, cfg)
    assert tokens == again and all(len(t) == 6 for t in tokens)
    assert torch.equal(logits, logits2)


@pytest.mark.parametrize("arch", [XLSTM, AUDIO])
def test_train_step_reads_nothing_back_to_the_host(card, arch):
    cfg = reduced_config(configs.get(arch))
    tcfg = TrainConfig(lr=1e-2, warmup=1, total_steps=10, grad_accum=2)
    model = build_served_model(cfg, card, seed=0)
    state = init_state(model, tcfg)
    step = make_train_step(model, tcfg)
    data = SyntheticLM(cfg, batch=4, seq=40, seed=0, device=card)
    batches = [data.batch_at(i) for i in range(2)]
    state, _ = step(state, batches[0])          # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = step(state, batches[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert {v.device.type for v in m.values()} == {"cuda"}
    assert bool(torch.isfinite(m["loss"]))
