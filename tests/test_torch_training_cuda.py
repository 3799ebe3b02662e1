"""LM training on the card against the same work on the CPU.

Checks: train steps of the reduced qwen3 config in float32 (two
microbatches, the chunked attention path) on the card and on the CPU from
the same weights, loss and grad_norm within 1e-4 relative each step and
the parameters within 1e-4 of the rates applied on all but 1e-3 of the
entries; one 8-bit AdamW update of the same parameters, gradients and
quantized state on both, the quantized moments equal but at ties; a
train step that reads nothing back to the host (CUDA's sync debug mode);
the schedule's bits on the card equal the CPU's; a checkpoint written
from the card restores on the CPU bitwise.

Every test carries the `cuda` marker and skips without a card, decided in
the `card` fixture at run time.  This file imports neither jax nor the
reference package.  Run on the card:
``python -m pytest -q -m cuda tests/test_torch_training_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.serve import build_served_model
from repro_torch.models.config import reduced_config
from repro_torch.training import checkpoint, optimizer as opt
from repro_torch.training.train_loop import (TrainConfig, init_state,
                                             make_train_step)

pytestmark = pytest.mark.cuda

RTOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pair(cfg, card, tcfg):
    """The same weights on the CPU and on the card, each with its state."""
    cpu = build_served_model(cfg, "cpu", seed=0)
    gpu = build_served_model(cfg, card, seed=1)
    with torch.no_grad():
        for mine, theirs in zip(gpu.parameters(), cpu.parameters()):
            mine.copy_(theirs)
    return (cpu, init_state(cpu, tcfg)), (gpu, init_state(gpu, tcfg))


def test_train_steps_on_the_card_match_the_cpu(card):
    cfg = reduced_config(configs.get("qwen3-0.6b")).replace(dtype="float32")
    tcfg = TrainConfig(lr=1e-2, warmup=1, total_steps=10, grad_accum=2)
    (cpu, s_cpu), (gpu, s_gpu) = _pair(cfg, card, tcfg)
    step_cpu, step_gpu = make_train_step(cpu, tcfg), make_train_step(gpu,
                                                                     tcfg)
    data = SyntheticLM(cfg, batch=4, seq=40, seed=0, device="cpu")
    lr_sum = 0.0
    for i in range(3):
        batch = data.batch_at(i)
        s_cpu, m_cpu = step_cpu(s_cpu, batch)
        s_gpu, m_gpu = step_gpu(s_gpu, {k: v.to(card) for k, v in
                                        batch.items()})
        assert m_gpu["loss"].device.type == card.type
        for k in ("loss", "grad_norm"):
            assert abs(float(m_gpu[k]) - float(m_cpu[k])) <= RTOL * abs(
                float(m_cpu[k])), (i, k)
        assert torch.equal(m_gpu["lr"].cpu(), m_cpu["lr"])
        lr_sum += float(m_cpu["lr"])
        d = torch.cat([(a.cpu() - b).detach().abs().reshape(-1)
                       for a, b in zip(opt.tree_leaves(s_gpu["params"]),
                                       opt.tree_leaves(s_cpu["params"]))])
        if lr_sum:
            assert float((d > RTOL * lr_sum).float().mean()) <= 1e-3, i
            assert float(d.max()) <= 2 * lr_sum, i


def test_8bit_update_on_the_card_matches_the_cpu(card):
    rng = np.random.default_rng(0)
    shapes = {"w": (64, 300), "e": (40, 64), "layers": [(16, 256)] * 2}

    def tree(fn):
        return {"w": fn(shapes["w"]), "e": fn(shapes["e"]),
                "layers": [{"w": fn(s)} for s in shapes["layers"]]}

    params = tree(lambda s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32) * 0.1))
    params["e"] = params["e"].to(torch.bfloat16)
    state = opt.adamw_init(params, eight_bit=True)
    for _ in range(2):       # a nonzero quantized state
        g = opt.tree_map(lambda p: torch.from_numpy(rng.standard_normal(
            p.shape).astype(np.float32)).to(p.dtype), params)
        opt.adamw_update(params, g, state, torch.tensor(1e-2),
                         eight_bit=True)
    g = opt.tree_map(lambda p: torch.from_numpy(rng.standard_normal(
        p.shape).astype(np.float32)).to(p.dtype), params)
    on_card = [opt.tree_map(lambda t: t.to(card), x)
               for x in (params, g)]
    card_state = {"mu": opt.tree_map(
        lambda p, s: {k: opt.QState(*(f.to(card) for f in s[k]))
                      for k in ("m", "v")}, params, state["mu"]),
        "count": state["count"].to(card)}
    lr = torch.tensor(3e-3)
    opt.adamw_update(params, g, state, lr, eight_bit=True)
    opt.adamw_update(on_card[0], on_card[1], card_state, lr.to(card),
                     eight_bit=True)
    assert int(card_state["count"]) == int(state["count"]) == 3
    d = torch.cat([(a.cpu().float() - b.float()).abs().reshape(-1)
                   for a, b in zip(opt.tree_leaves(on_card[0]),
                                   opt.tree_leaves(params))])
    assert float((d > 1e-3 * 3e-3).float().mean()) <= 5e-2
    assert float(d.max()) <= 2 * 3e-3
    for a, b in zip(opt.tree_leaves(card_state), opt.tree_leaves(state)):
        if b.dtype == torch.int8:
            dq = (a.cpu().int() - b.int()).abs()
            assert int(dq.max()) <= 1 and float((dq > 0).float().mean()) \
                <= 1e-3
        else:
            assert float((a.cpu() - b).abs().max()) <= 1e-6 * max(
                float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("eight_bit", [False, True])
def test_train_step_reads_nothing_back_to_the_host(card, eight_bit):
    """With CUDA's sync debug mode on "error", a train step (two
    microbatches, clip, schedule, update) raises at any device-to-host
    read: its metrics stay on the card."""
    cfg = reduced_config(configs.get("qwen3-0.6b"))
    tcfg = TrainConfig(lr=1e-2, warmup=1, total_steps=10, grad_accum=2,
                       eight_bit_optimizer=eight_bit)
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
    assert int(state["step"]) == 2


def test_schedule_on_the_card_is_the_cpus(card):
    sched = opt.cosine_schedule(3e-4, 100, 10_000)
    steps = torch.arange(0, 10_006, dtype=torch.int32)
    assert torch.equal(sched(steps.to(card)).cpu(), sched(steps))


def test_checkpoint_from_the_card_restores_on_the_cpu(card, tmp_path):
    cfg = reduced_config(configs.get("qwen3-0.6b"))
    tcfg = TrainConfig(lr=1e-2, warmup=1, total_steps=10,
                       eight_bit_optimizer=True)
    model = build_served_model(cfg, card, seed=0)
    state = init_state(model, tcfg)
    data = SyntheticLM(cfg, batch=2, seq=24, seed=0, device=card)
    step = make_train_step(model, tcfg)
    for i in range(2):
        state, _ = step(state, data.batch_at(i))
    checkpoint.save(str(tmp_path), 2, state)
    cpu_model = build_served_model(cfg, "cpu", seed=5)
    like = init_state(cpu_model, tcfg)
    checkpoint.restore(str(tmp_path), 2, like)
    for a, b in zip(opt.tree_leaves(state), opt.tree_leaves(like)):
        assert b.device.type == "cpu" and torch.equal(a.cpu(), b)
