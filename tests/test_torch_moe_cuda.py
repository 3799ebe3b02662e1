"""The MoE family on the card.

Checks: the MoE layer with most assignments dropped (capacity factor 0.1)
runs on the card without a device assert and gives the CPU's output and
aux loss (float32, within 1e-5 of max |y| and 1e-6); the serving engine
run twice on the reduced moonshot config (bf16, a capacity factor at
which prefills drop assignments) gives the same
tokens and the same logits, bitwise; a MoE train step reads nothing back
to the host (CUDA's sync debug mode); `build_served_model` at full width,
cut to 12 layers, peaks at its weights plus the draw's float32 pieces,
not at two copies.

Every test carries the `cuda` marker and skips without a card, decided in
the `card` fixture at run time.  This file imports neither jax nor the
reference package.  Run on the card:
``python -m pytest -q -m cuda tests/test_torch_moe_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.serve import build_served_model, make_requests
from repro_torch.models import moe
from repro_torch.models.config import reduced_config
from repro_torch.models.params import FILL_CHUNK
from repro_torch.serving.engine import ServeEngine
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import (TrainConfig, init_state,
                                             make_train_step)

pytestmark = pytest.mark.cuda

ARCH = "moonshot-v1-16b-a3b"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_dropped_assignments_run_on_the_card(card):
    cfg = reduced_config(configs.get(ARCH)).replace(capacity_factor=0.1)
    model = build_served_model(cfg.replace(dtype="float32"), "cpu", seed=0)
    p = model.layers[0].moe.tree()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 64, cfg.d_model)).astype(np.float32))
    y, aux = moe.moe_apply(p, x, cfg)
    y_card, aux_card = moe.moe_apply(
        opt.tree_map(lambda t: t.to(card), p), x.to(card), cfg)
    torch.cuda.synchronize()
    disp, _, _ = moe._route(x.reshape(-1, cfg.d_model), p["router"]["w"],
                            cfg, moe.capacity_for(256, cfg))
    assert int((~disp.keep).sum()) > 0
    assert float((y_card.cpu() - y).abs().max()) <= 1e-5 * float(
        y.abs().max())
    assert abs(float(aux_card) - float(aux)) <= 1e-6


def _serve(model, cfg):
    """The engine over 12 requests in 4 slots; every decode step's logits
    kept."""
    engine = ServeEngine(model, max_len=64, slots=4, eos_id=-1)
    reqs = make_requests(cfg.vocab_size, 12, max_new_tokens=6)
    for r in reqs:
        engine.submit(r)
    logits, decode = [], model.decode_step

    def keep(*args):
        lg, cache = decode(*args)
        logits.append(lg.clone())
        return lg, cache

    model.decode_step = keep
    try:
        engine.run_until_drained()
    finally:
        del model.decode_step
    return [r.output for r in reqs], torch.stack(logits)


def test_engine_repeats_bitwise(card):
    cfg = reduced_config(configs.get(ARCH)).replace(dtype="bfloat16",
                                                    capacity_factor=1.0)
    model = build_served_model(cfg, card, seed=0)
    tokens, logits = _serve(model, cfg)
    again, logits2 = _serve(model, cfg)
    assert tokens == again and all(len(t) == 6 for t in tokens)
    assert torch.equal(logits, logits2)


def test_moe_train_step_reads_nothing_back_to_the_host(card):
    cfg = reduced_config(configs.get(ARCH)).replace(capacity_factor=1.0)
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
    assert float(m["aux"]) > 0.9


def test_build_peaks_near_one_copy_of_the_weights(card):
    """Full width, 12 layers (7.1e9 parameters): the build's peak above
    its start is the weights plus at most six float32 pieces of FILL_CHUNK
    values (the truncated-normal draw and its temporaries); the old
    build (a whole second tree, then a copy) needed twice the weights."""
    cfg = configs.get(ARCH).replace(num_layers=12)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    model = build_served_model(cfg, card, seed=0)
    torch.cuda.synchronize()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    peak = torch.cuda.max_memory_allocated() - start
    assert weights > 12e9
    assert peak <= weights + 6 * FILL_CHUNK * 4, (peak, weights)
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
