"""The hybrid and VLM families on the card.

Checks, each against the same code on the CPU from the same weights (a
model built on the CPU, its parameters copied to the card): the SSD
engine over 300 positions (chunk 64, a tail pad) and its gradients
(within 1e-5 of max |.| of the float64 recurrence and of the CPU); the
reduced zamba2 config's prefill, ragged decode steps and loss with
gradients (float32, within 1e-5 of max |CPU|); the reduced phi-3-vision config's prefill with patches and a
decode step (float32, within 1e-5); the engine over a zamba2 stream twice,
the same tokens and logits bitwise; a hybrid and a VLM train step that
read nothing back to the host (CUDA's sync debug mode).

Every test carries the `cuda` marker and skips without a card, decided in
the `card` fixture at run time.  This file imports neither jax nor the
reference package.  Run on the card:
``python -m pytest -q -m cuda tests/test_torch_hybrid_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.serve import build_served_model, make_requests
from repro_torch.models import ssd
from repro_torch.models.config import reduced_config
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import ServeEngine
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import (TrainConfig, init_state,
                                             make_train_step)

pytestmark = pytest.mark.cuda

HYBRID, VLM = "zamba2-2.7b", "phi-3-vision-4.2b"
RTOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    assert a.shape == b.shape, (a.shape, b.shape)
    return float((a - b).abs().max() / b.abs().max())


def _pair(arch, card, **kw):
    """(the reduced float32 model on the CPU, a copy of it on the card)."""
    cfg = reduced_config(configs.get(arch)).replace(dtype="float32", **kw)
    cpu = build_served_model(cfg, "cpu", seed=0)
    gpu = build_model(cfg, device=card)
    with torch.no_grad():
        for mine, theirs in zip(gpu.parameters(), cpu.parameters()):
            mine.copy_(theirs)
    return cfg, cpu, gpu


def _to(tree, device):
    return opt.tree_map(lambda t: t.to(device), tree)


def _naive_decay_attention(q, k, v, log_a, beta, h0):
    """The recurrence one step at a time (the reference test's form)."""
    h, ys = h0, []
    for t in range(q.shape[1]):
        h = (h * torch.exp(log_a[:, t])[..., None, None] +
             beta[:, t][..., None, None] * k[:, t][..., :, None] *
             v[:, t][..., None, :])
        ys.append(torch.einsum("bhn,bhnp->bhp", q[:, t], h))
    return torch.stack(ys, dim=1), h


def test_ssd_on_the_card_matches_the_recurrence(card):
    """300 positions in chunks of 64 (a tail pad), an initial state: the
    output, the final state and the gradient of sum(y^2) + sum(h_T) through
    every input, on the card and on the CPU, each within 1e-5 of max |.|
    of the float64 recurrence, and the card within 1e-5 of the CPU."""
    rng = np.random.default_rng(0)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    args = {"q": f(2, 300, 4, 16), "k": f(2, 300, 4, 16),
            "v": f(2, 300, 4, 8), "log_a": -f(2, 300, 4).abs(),
            "beta": f(2, 300, 4).abs(), "h0": f(2, 4, 16, 8)}

    def run(fn, dev, dtype=torch.float32):
        a = {k: v.detach().clone().to(device=dev, dtype=dtype)
             .requires_grad_(True) for k, v in args.items()}
        y, h_t = fn(**a)
        (y.square().sum() + h_t.sum()).backward()
        return [t.detach().double().cpu() for t in
                [y, h_t] + [a[k].grad for k in sorted(a)]]

    want = run(_naive_decay_attention, "cpu", torch.float64)
    got = {dev: run(lambda **a: ssd.chunked_decay_attention(**a, chunk=64),
                    dev) for dev in ("cpu", card)}
    names = ["y", "h_T"] + [f"d{k}" for k in sorted(args)]
    for i, name in enumerate(names):
        for dev in got:
            assert _rel(got[dev][i], want[i]) <= RTOL, (name, dev)
        assert _rel(got[card][i], got["cpu"][i]) <= RTOL, name


def test_hybrid_prefill_decode_and_loss_match_the_cpu(card):
    cfg, cpu, gpu = _pair(HYBRID, card)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (3, 21)))
    lg, cache = cpu.prefill({"tokens": toks[:, :13]})
    lgc, cachec = gpu.prefill({"tokens": toks[:, :13].to(card)})
    assert _rel(lgc, lg) <= RTOL
    for part in cache:
        for name in cache[part]:
            assert _rel(cachec[part][name], cache[part][name]) <= RTOL
    big = cpu.cache_spec(3, 32)["attn"]
    for c, dev in ((cache, "cpu"), (cachec, card)):
        for name in ("k", "v"):
            t = torch.zeros(big[name].shape, device=dev)
            t[:, :, :13] = c["attn"][name]
            c["attn"][name] = t
    cur = torch.tensor([13, 9, 11])
    for i in range(13, 17):
        lg, cache = cpu.decode_step(toks[:, i:i + 1], cache, cur)
        lgc, cachec = gpu.decode_step(toks[:, i:i + 1].to(card), cachec,
                                      cur.to(card))
        assert _rel(lgc, lg) <= RTOL, i
        cur = cur + 1
    for m in (cpu, gpu):
        m.requires_grad_(True)
    loss, _ = cpu.loss({"tokens": toks})
    lossc, _ = gpu.loss({"tokens": toks.to(card)})
    assert abs(float(lossc.detach()) - float(loss.detach())) <= \
        RTOL * abs(float(loss.detach()))
    for a, b in zip(torch.autograd.grad(lossc, list(gpu.parameters())),
                    torch.autograd.grad(loss, list(cpu.parameters()))):
        assert _rel(a, b) <= RTOL


def test_vlm_prefill_and_decode_match_the_cpu(card):
    cfg, cpu, gpu = _pair(VLM, card)
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                                     (2, 9))),
             "patches": torch.from_numpy(rng.standard_normal(
                 (2, cfg.vision_patches, cfg.vision_dim)).astype(np.float32))}
    lg, cache = cpu.prefill(batch)
    lgc, cachec = gpu.prefill(_to(batch, card))
    assert _rel(lgc, lg) <= RTOL
    assert cachec["main"]["k"].shape[2] == cfg.vision_patches + 9
    nxt = torch.tensor([[3], [4]])
    n = cfg.vision_patches + 9
    big = cpu.cache_spec(2, 32)["main"]
    for c, dev in ((cache, "cpu"), (cachec, card)):
        for name in ("k", "v"):
            t = torch.zeros(big[name].shape, device=dev)
            t[:, :, :n] = c["main"][name]
            c["main"][name] = t
    lg, _ = cpu.decode_step(nxt, cache, n)
    lgc, _ = gpu.decode_step(nxt.to(card), cachec, n)
    assert _rel(lgc, lg) <= RTOL


def _serve(model, cfg):
    engine = ServeEngine(model, max_len=64, slots=4, eos_id=-1)
    reqs = make_requests(cfg.vocab_size, 10, max_new_tokens=6)
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


def test_hybrid_engine_repeats_bitwise(card):
    cfg = reduced_config(configs.get(HYBRID))
    model = build_served_model(cfg, card, seed=0)
    tokens, logits = _serve(model, cfg)
    again, logits2 = _serve(model, cfg)
    assert tokens == again and all(len(t) == 6 for t in tokens)
    assert torch.equal(logits, logits2)


@pytest.mark.parametrize("arch", [HYBRID, VLM])
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
