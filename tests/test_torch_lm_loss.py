"""The port's training loss against the reference on the CPU: `chunked_ce`,
`project_logits`' mask under autograd, and `DecoderLM.loss` with its
gradients under every remat mode.

Inputs come from numpy seeds; weights are the reference's, carried across
by `convert.lm_params_from_numpy`.  Tolerances: in float32, max |port -
reference| / max |reference| <= 1e-5 for the loss and for each gradient
leaf; in bfloat16, the loss within 2e-2 and each gradient leaf within 2e-2
in relative L2 norm (|port - reference| / |reference|).  Largest entries
are not the bf16 measure: on a 16-entry norm scale one entry reaches 2.1e-2
of the leaf's largest, as far as the reference's own bf16 gradient lies
from its float32 one (1.97e-2).  The port's remat modes against each
other: bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.configs as ref_configs
from repro.models import losses as ref_losses
from repro.models.config import reduced_config as ref_reduced_config
from repro.models.params import init_from_specs as ref_init
from repro.models.registry import build_model as ref_build_model
from repro_torch import configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import losses
from repro_torch.models.config import reduced_config
from repro_torch.training.optimizer import tree_groups

RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (remat, scan_group) of the port, all held against the reference's and
# against each other
REMATS = [("none", 0), ("full", 0), ("dots", 0), ("none", 2), ("full", 2),
          ("dots", 2)]


def _rel(port, ref, dtype="float32"):
    """max |d| / max |ref| in float32, |d| / |ref| (L2) in bfloat16."""
    ref = np.asarray(ref, np.float32)
    port = port.detach().float().numpy()
    assert port.shape == ref.shape, (port.shape, ref.shape)
    if dtype == "bfloat16":
        return float(np.linalg.norm(port - ref) / np.linalg.norm(ref))
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def _leaf(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32))


# ---------------------------------------------------------- chunked_ce ----

@pytest.mark.parametrize("head", ["tied", "head", "head_bias"])
@pytest.mark.parametrize("s,chunk", [(37, 8), (33, 16), (17, 32), (65, 16)])
def test_chunked_ce_value_and_grads(s, chunk, head):
    """S - 1 a multiple of the chunk or not, one chunk or several; the
    vocabulary 250 padded to 256 (its pad rows carry weights that must not
    count); float32, <= 1e-5 for the value and every gradient."""
    rng = np.random.default_rng(s * 7 + chunk)
    b, d, v, vpad = 2, 16, 250, 256
    x = _leaf(rng, (b, s, d))
    targets = torch.from_numpy(rng.integers(0, v, (b, s - 1)).astype(
        np.int32))
    leaves = {"table": _leaf(rng, (vpad, d), 0.5)}
    if head != "tied":
        leaves["w"] = _leaf(rng, (d, vpad), 0.5)
    if head == "head_bias":
        leaves["b"] = _leaf(rng, (vpad,), 0.5)
    names = sorted(leaves)

    def ref_fn(xj, lv):
        hp = None if head == "tied" else {k: lv[k] for k in ("w", "b")
                                          if k in lv}
        return ref_losses.chunked_ce(xj, jnp.asarray(targets.numpy()),
                                     {"table": lv["table"]}, hp, v,
                                     chunk=chunk)

    ref_val, (ref_gx, ref_gl) = jax.value_and_grad(ref_fn, argnums=(0, 1))(
        jnp.asarray(x.numpy()), {k: jnp.asarray(leaves[k].numpy())
                                 for k in names})
    xt = x.clone().requires_grad_(True)
    lt = {k: leaves[k].clone().requires_grad_(True) for k in names}
    hp = None if head == "tied" else {k: lt[k] for k in ("w", "b")
                                      if k in lt}
    val = losses.chunked_ce(xt, targets, {"table": lt["table"]}, hp, v,
                            chunk=chunk)
    used = ["table"] if head == "tied" else [k for k in names if k != "table"]
    grads = torch.autograd.grad(val, [xt] + [lt[k] for k in used])
    assert val.dtype == torch.float32 and val.shape == ()
    assert abs(float(val.detach()) - float(ref_val)) <= RTOL["float32"] * abs(
        float(ref_val))
    assert _rel(grads[0], ref_gx) <= RTOL["float32"]
    for k, g in zip(used, grads[1:]):
        assert _rel(g, ref_gl[k]) <= RTOL["float32"], k
    # the padded vocabulary passes no gradient back (and a separate head
    # leaves the table out)
    if head == "tied":
        assert not grads[1][v:].any()
    else:
        assert not grads[1 + used.index("w")][:, v:].any()
        assert not np.asarray(ref_gl["table"]).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tied", [True, False])
def test_project_logits_mask_under_autograd(dtype, tied):
    """The in-place mask of `project_logits` is accepted by autograd in
    float32, where `.float()` returns the product itself, and in bfloat16,
    where it copies; the masked columns get exactly zero gradient."""
    rng = np.random.default_rng(11)
    x = _leaf(rng, (2, 5, 16)).to(TORCH[dtype]).requires_grad_(True)
    table = _leaf(rng, (64, 16)).to(TORCH[dtype]).requires_grad_(True)
    w = _leaf(rng, (16, 64)).to(TORCH[dtype]).requires_grad_(True)
    head = None if tied else {"w": w}
    lg = losses.project_logits(x, {"table": table}, head, 60)
    assert lg.dtype == torch.float32 and (lg[..., 60:] == -1e30).all()
    weights = _leaf(rng, (2, 5, 64))
    gx, gw = torch.autograd.grad((lg[..., :60] * weights[..., :60]).sum()
                                 + lg[..., 60:].sum(),
                                 [x, table if tied else w])
    assert torch.isfinite(gx).all()
    masked = gw[60:] if tied else gw[:, 60:]
    assert masked.shape[-1 if not tied else 0] == 4 and not masked.any()
    # the unmasked columns' gradient is the unmasked product's, bitwise
    plain = (x @ (table.t() if tied else w)).float()[..., :60]
    gx_plain, = torch.autograd.grad((plain * weights[..., :60]).sum(), [x])
    assert torch.equal(gx, gx_plain)


def test_chunked_ce_keeps_no_logits_for_the_backward():
    """Each chunk's logits are made again in the backward, not kept: the
    tensors saved for the backward hold no (B, chunk, V) block."""
    rng = np.random.default_rng(12)
    b, s, d, v, chunk = 2, 49, 8, 512, 16
    x = _leaf(rng, (b, s, d)).requires_grad_(True)
    table = _leaf(rng, (v, d)).requires_grad_(True)
    targets = torch.from_numpy(rng.integers(0, v, (b, s - 1)))
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        val = losses.chunked_ce(x, targets, {"table": table}, None, v,
                                chunk=chunk)
    assert not [sh for sh in saved if sh and sh[-1] == v and
                len(sh) == 3], saved
    gx, = torch.autograd.grad(val, [x])
    assert torch.isfinite(gx).all()


# ---------------------------------------------------------- the model ----

@pytest.fixture(scope="module", params=[
    ("qwen3_0_6b", "float32"), ("qwen3_0_6b", "bfloat16"),
    ("smollm_360m", "float32"), ("smollm_360m", "bfloat16")],
    ids=lambda p: f"{p[0]}-{p[1]}")
def reference_loss(request):
    """(arch, dtype, the reference's params, tokens, its loss, aux, grads
    in tree order as float32 numpy) on the reduced config."""
    arch, dtype = request.param
    cfg = ref_reduced_config(ref_configs.get(arch)).replace(dtype=dtype)
    model = ref_build_model(cfg)
    params = ref_init(jax.random.PRNGKey(0), model.param_specs())
    toks = np.random.default_rng(13).integers(0, cfg.vocab_size, (2, 37))
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: model.loss(p, {"tokens": jnp.asarray(toks, jnp.int32)}),
        has_aux=True)(params)
    return (arch, dtype, params, toks, float(loss), float(metrics["aux"]),
            [np.asarray(g, np.float32) for g in jax.tree.leaves(grads)])


def _port_loss(arch, dtype, params, toks, remat, scan_group):
    cfg = reduced_config(configs.get(arch)).replace(
        dtype=dtype, remat=remat, scan_group=scan_group)
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    model.requires_grad_(True)
    groups = tree_groups(model.param_tree())
    flat = [t for ts, _ in groups for t in ts]
    loss, metrics = model.loss({"tokens": torch.from_numpy(toks)})
    grads = dict(zip(map(id, flat), torch.autograd.grad(loss, flat)))
    stacked = [torch.stack([grads[id(t)] for t in ts]) if st
               else grads[id(ts[0])] for ts, st in groups]
    return loss.detach(), metrics, stacked


@pytest.mark.parametrize("remat,scan_group", REMATS)
def test_decoder_loss_and_grads_match_the_reference(reference_loss, remat,
                                                    scan_group):
    """The reduced qwen3 and smollm configs (2 layers, seq 37: three
    attention blocks of 16, one CE chunk): loss, "ce", "aux" and every
    gradient leaf against `jax.value_and_grad` of the reference's loss
    (remat "none"; rematerialisation changes no number there either)."""
    arch, dtype, params, toks, ref_loss, ref_aux, ref_grads = reference_loss
    loss, metrics, grads = _port_loss(arch, dtype, params, toks, remat,
                                      scan_group)
    assert loss.dtype == torch.float32
    assert abs(float(loss) - ref_loss) <= RTOL[dtype] * abs(ref_loss)
    assert torch.equal(metrics["ce"].detach(), loss)
    assert float(metrics["aux"]) == ref_aux == 0.0
    assert len(grads) == len(ref_grads)
    # gradients come out in their parameter's dtype (norm scales float32)
    assert {g.dtype for g in grads} == {TORCH[dtype], torch.float32}
    for i, (g, r) in enumerate(zip(grads, ref_grads)):
        assert _rel(g, r, dtype) <= RTOL[dtype], (i, _rel(g, r, dtype))


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "smollm_360m"])
def test_remat_modes_are_bitwise_the_same(arch):
    rng = np.random.default_rng(14)
    cfg = ref_reduced_config(ref_configs.get(arch)).replace(dtype="float32")
    params = ref_init(jax.random.PRNGKey(1),
                      ref_build_model(cfg).param_specs())
    toks = rng.integers(0, cfg.vocab_size, (2, 29))
    base = _port_loss(arch, "float32", params, toks, "none", 0)
    for remat, group in REMATS[1:]:
        loss, _, grads = _port_loss(arch, "float32", params, toks, remat,
                                    group)
        assert torch.equal(loss, base[0]), (remat, group)
        assert all(torch.equal(a, b) for a, b in zip(grads, base[2])), (
            remat, group)


class _CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0
        self.bmm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        elif func is torch.ops.aten.bmm.default:
            self.bmm += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("scan_group", [0, 2])
def test_remat_modes_recompute_what_the_reference_does(scan_group):
    """In the backward: "none" recomputes no product; "full" every
    product of the forward's layers; "dots" the batched (attention)
    products only, keeping the linear layers' outputs."""
    cfg = ref_reduced_config(ref_configs.get("qwen3_0_6b"))
    params = ref_init(jax.random.PRNGKey(2),
                      ref_build_model(cfg).param_specs())
    toks = torch.from_numpy(np.random.default_rng(15).integers(
        0, cfg.vocab_size, (2, 29)))
    counts = {}
    for remat in ("none", "full", "dots"):
        pcfg = reduced_config(configs.get("qwen3_0_6b")).replace(
            dtype="float32", remat=remat, scan_group=scan_group)
        model = lm_params_from_numpy(pcfg, jax.tree.map(np.asarray, params),
                                     device="cpu")
        model.requires_grad_(True)
        fwd, bwd = _CountProducts(), _CountProducts()
        with fwd:
            loss, _ = model.loss({"tokens": toks})
        with bwd:
            torch.autograd.grad(loss, list(model.parameters()))
        counts[remat] = (fwd.mm, fwd.bmm, bwd.mm, bwd.bmm)
    f_mm, f_bmm, none_mm, none_bmm = counts["none"]
    assert counts["full"][:2] == counts["dots"][:2] == (f_mm, f_bmm)
    # "full" runs each layer's forward products again in the backward
    assert counts["full"][2] > none_mm and counts["full"][3] > none_bmm
    # "dots" recomputes the attention's batched products, no linear layer
    assert counts["dots"][2] == none_mm
    assert counts["dots"][3] == counts["full"][3]
