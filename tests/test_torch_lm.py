"""The port's dense LM (`repro_torch.models`) against the reference on the CPU.

The reduced `qwen3_0_6b` config (2 layers, d_model 64, 4 heads over 2 KV
heads, head_dim 16, attn_chunk 16, vocab 256), in float32 and bfloat16,
with the reference's weights carried across by
`convert.lm_params_from_numpy` and inputs made from a seed with numpy.
Tolerance: max |port - reference| / max |reference| <= 1e-5 in float32 and
<= 2e-2 in bfloat16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.models import attention as ref_attention
from repro.models import layers as ref_layers
from repro.models import losses as ref_losses
from repro.models import rope as ref_rope
from repro.models.config import reduced_config as ref_reduced_config
from repro.models.params import init_from_specs as ref_init
from repro.models.params import spec_bytes as ref_spec_bytes
from repro.models.registry import build_model as ref_build_model
from repro_torch import configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import attention, layers, losses, rope
from repro_torch.models.config import reduced_config
from repro_torch.models.params import ParamSpec, init_from_specs, spec_bytes
from repro_torch.models.registry import FAMILIES, PENDING, build_model

RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = tuple(RTOL)
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DENSE = [a for a in ref_configs.ARCH_IDS
         if ref_configs.get(a).family == "dense"]


def _close(port, ref, dtype, what=""):
    ref = np.asarray(ref, np.float32)
    port = port.float().numpy() if torch.is_tensor(port) else np.asarray(
        port, np.float32)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    rel = np.abs(port - ref).max() / np.abs(ref).max()
    assert rel <= RTOL[dtype], (what, dtype, rel)


def _pair(arr, dtype):
    """The same values as a jax array and a torch tensor of `dtype`."""
    j = jnp.asarray(arr, JNP[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        TORCH[dtype])


# ------------------------------------------------------------ configs ----

@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_configs_match_the_reference(arch):
    full = dataclasses.asdict(configs.get(arch))
    assert full == dataclasses.asdict(ref_configs.get(arch))
    assert dataclasses.asdict(configs.reduced(arch)) == dataclasses.asdict(
        ref_configs.reduced(arch))
    alias = [k for k, v in configs.ALIASES.items() if v == arch]
    assert configs.get(alias[0]) == configs.get(arch)
    assert configs.ALIASES == ref_configs.ALIASES


@pytest.mark.parametrize("arch", DENSE)
def test_full_dense_parameter_count_is_the_references(arch):
    """The port's parameters on the meta device (nothing allocated) count
    exactly the reference spec tree's elements and bytes."""
    ref_specs = ref_build_model(ref_configs.get(arch)).param_specs()
    leaves = jax.tree.leaves(ref_specs, is_leaf=lambda x: hasattr(x, "axes"))
    ref_count = sum(int(np.prod(s.shape)) for s in leaves)
    model = build_model(configs.get(arch), device="meta")
    params = list(model.parameters())
    assert all(p.device.type == "meta" for p in params)
    assert sum(p.numel() for p in params) == ref_count
    assert sum(p.numel() * p.element_size() for p in params) == \
        ref_spec_bytes(ref_specs) == spec_bytes(model.param_specs())


def test_qwen3_full_width_sizes():
    cfg = configs.get("qwen3-0.6b")
    model = build_model(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 596_180_992
    assert spec_bytes(model.param_specs()) == 1_192_493_056
    assert cfg.padded_vocab == 152_064


@pytest.mark.parametrize("arch", ["phi_3_vision_4_2b", "zamba2_2_7b",
                                  "xlstm_350m", "seamless_m4t_medium"])
def test_full_vlm_and_hybrid_parameter_count_is_the_references(arch):
    """The VLM, hybrid, xLSTM and enc-dec/audio families on the meta
    device: the reference spec tree's leaves, elements and bytes
    (phi-3-vision-4.2b 3,825,404,928 parameters, zamba2-2.7b 2,422,532,000,
    xlstm-350m 241,894,400, seamless-m4t-medium 716,503,040)."""
    ref_specs = ref_build_model(ref_configs.get(arch)).param_specs()
    leaves = jax.tree.leaves(ref_specs, is_leaf=lambda x: hasattr(x, "axes"))
    ref_count = sum(int(np.prod(s.shape)) for s in leaves)
    model = build_model(configs.get(arch), device="meta")
    assert all(p.device.type == "meta" for p in model.parameters())
    assert sum(p.numel() for p in model.parameters()) == ref_count == {
        "phi_3_vision_4_2b": 3_825_404_928,
        "zamba2_2_7b": 2_422_532_000,
        "xlstm_350m": 241_894_400,
        "seamless_m4t_medium": 716_503_040}[arch]
    assert spec_bytes(model.param_specs()) == ref_spec_bytes(ref_specs)
    assert set(model.param_tree()) == set(ref_specs)
    assert configs.get(arch).family not in PENDING


def test_a_family_the_registry_lacks_raises():
    """Every family of the reference's registry is ported (PENDING is
    empty); a family the registry lacks raises, naming the registry's."""
    assert PENDING == {}
    assert all(configs.get(a).family in FAMILIES
               for a in ref_configs.ARCH_IDS)
    cfg = configs.get("qwen3_0_6b").replace(family="retnet")
    with pytest.raises(NotImplementedError, match="not in the registry"):
        build_model(cfg, device="meta")


def test_init_from_specs_follows_the_reference_rule():
    specs = {"w": ParamSpec((64, 32), (None, None), dtype=torch.bfloat16),
             "stack": ParamSpec((3, 16, 8), (None, None, None),
                                init_scale=2.0),
             "zero": ParamSpec((4, 4), (None, None), init_scale=0.0),
             "ones": ParamSpec((5,), (None,), init_scale=-1.0),
             "bias": ParamSpec((5,), (None,))}
    vals = init_from_specs(specs, torch.Generator().manual_seed(0), "cpu")
    again = init_from_specs(specs, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(vals[k], again[k]) for k in specs)
    assert vals["w"].dtype == torch.bfloat16
    assert float(vals["w"].float().abs().max()) <= 2 / np.sqrt(64) * 1.004
    assert float(vals["stack"].abs().max()) <= 2 * 2 / np.sqrt(48)
    assert 0.5 < float(vals["w"].float().std() * np.sqrt(64)) < 1.0
    assert not vals["zero"].any() and not vals["bias"].any()
    assert torch.equal(vals["ones"], torch.ones(5))


# ------------------------------------------------------------- layers ----

@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm(dtype):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.standard_normal((2, 5, 64)) * 3, dtype)
    scale = rng.standard_normal(64).astype(np.float32)
    ref = ref_layers.rms_norm({"scale": jnp.asarray(scale)}, xj, 1e-6)
    out = layers.rms_norm({"scale": torch.from_numpy(scale)}, xt, 1e-6)
    assert out.dtype == TORCH[dtype]
    _close(out, ref, dtype)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_linear(dtype, bias):
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng.standard_normal((2, 5, 64)), dtype)
    wj, wt = _pair(rng.standard_normal((64, 48)) / 8, dtype)
    pj, pt = {"w": wj}, {"w": wt}
    if bias:
        pj["b"], pt["b"] = _pair(rng.standard_normal(48), dtype)
    out = layers.linear(pt, xt)
    assert out.dtype == TORCH[dtype]
    _close(out, ref_layers.linear(pj, xj), dtype)


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_project_logits_masks_the_padded_vocab(dtype, tied):
    rng = np.random.default_rng(3)
    xj, xt = _pair(rng.standard_normal((2, 3, 64)), dtype)
    tj, tt = _pair(rng.standard_normal((256, 64)) / 8, dtype)
    hj, ht = _pair(rng.standard_normal((64, 256)) / 8, dtype)
    ref = ref_losses.project_logits(xj, {"table": tj},
                                    None if tied else {"w": hj}, 250)
    out = losses.project_logits(xt, {"table": tt},
                                None if tied else {"w": ht}, 250)
    assert out.dtype == torch.float32
    assert (out[..., 250:] == -1e30).all()
    _close(out[..., :250], np.asarray(ref)[..., :250], dtype)


# --------------------------------------------------------------- rope ----

@pytest.mark.parametrize("policy", ["on_the_fly", "precomputed"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_rope(dtype, policy):
    rng = np.random.default_rng(4)
    qj, qt = _pair(rng.standard_normal((2, 7, 4, 16)), dtype)
    kj, kt = _pair(rng.standard_normal((2, 7, 2, 16)), dtype)
    pos = rng.integers(0, 300, (2, 7))
    tab_j = ref_rope.rope_table(512, 16, 1e6) if policy == "precomputed" \
        else None
    tab_t = rope.rope_table(512, 16, 1e6) if policy == "precomputed" \
        else None
    if tab_t is not None:
        _close(tab_t, tab_j, "float32", "table")
    rq, rk = jax.jit(ref_rope.apply_rope, static_argnames="theta")(
        qj, kj, jnp.asarray(pos), theta=1e6, table=tab_j)
    oq, ok = rope.apply_rope(qt, kt, torch.from_numpy(pos), 1e6, tab_t)
    assert oq.dtype == ok.dtype == TORCH[dtype]
    _close(oq, rq, dtype, "q")
    _close(ok, rk, dtype, "k")


def test_rope_policies_agree():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((1, 9, 4, 16)).astype(
        np.float32))
    pos = torch.from_numpy(rng.integers(0, 4000, (1, 9)))
    a = rope.apply_rope(q, q, pos, 1e6)[0]
    b = rope.apply_rope(q, q, pos, 1e6, rope.rope_table(4096, 16, 1e6))[0]
    _close(a, b.numpy(), "float32")


# ---------------------------------------------------------- attention ----

def _qkv(rng, s, kvh, dtype, sq=None, b=2):
    sq = s if sq is None else sq
    q = _pair(rng.standard_normal((b, sq, 4, 16)), dtype)
    k = _pair(rng.standard_normal((b, s, kvh, 16)), dtype)
    v = _pair(rng.standard_normal((b, s, kvh, 16)), dtype)
    return q, k, v


@pytest.mark.parametrize("kvh", [4, 2])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_full_attention(dtype, causal, kvh):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(np.random.default_rng(6), 11, kvh,
                                        dtype)
    ref = jax.jit(ref_attention.full_attention, static_argnames="causal")(
        qj, kj, vj, causal=causal)
    out = attention.full_attention(qt, kt, vt, causal=causal)
    _close(out, ref, dtype)


@pytest.mark.parametrize("kvh", [4, 2])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [12, 16, 37, 48])
@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_attention_both_paths(dtype, s, causal, kvh):
    """chunk 16: s <= 16 runs full_attention, s > 16 the padded online
    softmax over blocks."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(np.random.default_rng(7), s, kvh,
                                        dtype)
    ref = jax.jit(ref_attention.causal_attention,
                  static_argnames=("chunk", "causal"))(qj, kj, vj, chunk=16,
                                                       causal=causal)
    out = attention.causal_attention(qt, kt, vt, chunk=16, causal=causal)
    assert out.dtype == TORCH[dtype]
    _close(out, ref, dtype)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("kvh", [4, 2])
@pytest.mark.parametrize("s", [20, 32])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_both_paths(dtype, s, kvh, ragged):
    """chunk 8: S = 20 (not a multiple) runs the one-pass path, S = 32 the
    flash-decode walk; with and without per-slot lengths."""
    rng = np.random.default_rng(8)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, s, kvh, dtype, sq=1, b=3)
    lengths = np.array([s, 5, 13]) if ragged else None
    ref = jax.jit(ref_attention.decode_attention, static_argnames="chunk")(
        qj, kj, vj, None if lengths is None else jnp.asarray(lengths),
        chunk=8)
    out = attention.decode_attention(
        qt, kt, vt, None if lengths is None else torch.from_numpy(lengths),
        chunk=8)
    assert out.dtype == TORCH[dtype]
    _close(out, ref, dtype)


def test_gqa_heads_are_kv_major():
    """Query head h reads KV head h // groups (`repeat_interleave`), not
    h % KV (`repeat`): with every KV head's values constant, each query
    head's output is its KV head's constant."""
    q = torch.randn(1, 1, 4, 16, generator=torch.Generator().manual_seed(0))
    k = torch.zeros(1, 5, 2, 16)
    v = torch.arange(2.0).reshape(1, 1, 2, 1).expand(1, 5, 2, 16)
    for out in (attention.full_attention(q, k, v, causal=False),
                attention.decode_attention(q, k, v)):
        assert torch.equal(out[0, 0, :, 0], torch.tensor([0.0, 0, 1, 1]))


# -------------------------------------------------------------- model ----

@pytest.fixture(scope="module", params=DTYPES)
def models(request):
    """(dtype, reference model, its params, the port's model) on the
    reduced qwen3 config, weights carried across."""
    dtype = request.param
    cfg = ref_reduced_config(ref_configs.get("qwen3_0_6b")).replace(
        dtype=dtype)
    ref_model = ref_build_model(cfg)
    params = ref_init(jax.random.PRNGKey(0), ref_model.param_specs())
    port_cfg = reduced_config(configs.get("qwen3_0_6b")).replace(dtype=dtype)
    port = lm_params_from_numpy(port_cfg, jax.tree.map(np.asarray, params),
                                device="cpu")
    return dtype, ref_model, params, port


def _tokens(rng, b, s, vocab=256):
    return rng.integers(1, vocab, (b, s))


@pytest.mark.parametrize("s", [9, 23])
def test_prefill_logits_and_cache(models, s):
    """s = 9 is one attention block (attn_chunk 16), s = 23 two."""
    dtype, ref_model, params, port = models
    toks = _tokens(np.random.default_rng(9), 2, s)
    lg, cache = jax.jit(lambda p, b: ref_model.prefill(p, b))(
        params, {"tokens": jnp.asarray(toks, jnp.int32)})
    plg, pcache = port.prefill({"tokens": torch.from_numpy(toks)})
    assert plg.dtype == torch.float32 and plg.shape == (2, 1, 256)
    _close(plg, lg, dtype, "logits")
    for name in ("k", "v"):
        assert pcache["main"][name].dtype == TORCH[dtype]
        _close(pcache["main"][name], cache["main"][name], dtype, name)


def test_ragged_decode_step(models):
    """One decode step at per-slot lengths (11, 6) after a prefill of 11,
    as the engine calls it: logits and both caches, written in place."""
    dtype, ref_model, params, port = models
    rng = np.random.default_rng(10)
    toks = _tokens(rng, 2, 11)
    _, cache = jax.jit(lambda p, b: ref_model.prefill(p, b))(
        params, {"tokens": jnp.asarray(toks, jnp.int32)})
    pad = [(0, 0), (0, 0), (0, 21), (0, 0), (0, 0)]
    cache = jax.tree.map(lambda a: jnp.pad(a, pad), cache)
    pcache = {"main": {n: torch.from_numpy(np.array(
        cache["main"][n], np.float32)).to(TORCH[dtype]) for n in ("k", "v")}}
    nxt = _tokens(rng, 2, 1)
    cur = np.array([11, 6])
    lg, cache2 = jax.jit(lambda p, t, c, l: ref_model.decode_step(
        p, t, c, l))(params, jnp.asarray(nxt, jnp.int32), cache,
                     jnp.asarray(cur, jnp.int32))
    k_before = pcache["main"]["k"]
    plg, pcache2 = port.decode_step(torch.from_numpy(nxt), pcache,
                                    torch.from_numpy(cur))
    assert pcache2["main"]["k"] is k_before
    _close(plg, lg, dtype, "logits")
    for name in ("k", "v"):
        _close(pcache2["main"][name], cache2["main"][name], dtype, name)


def test_scalar_decode_step_matches_full_forward(models):
    """Prefill, one lock-step decode at an int length, and the prefill of
    the extended sequence agree (the reference's own decode == forward
    check, at the port's tolerance)."""
    dtype, _, _, port = models
    rng = np.random.default_rng(11)
    toks = torch.from_numpy(_tokens(rng, 2, 20))
    _, cache = port.prefill({"tokens": toks})
    cache = {"main": {n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 4))
                      for n, t in cache["main"].items()}}
    nxt = torch.from_numpy(_tokens(rng, 2, 1))
    lg_dec, _ = port.decode_step(nxt, cache, 20)
    lg_full, _ = port.prefill({"tokens": torch.cat([toks, nxt], dim=1)})
    real = port.cfg.vocab_size
    _close(lg_dec[..., :real], lg_full[..., :real].numpy(), dtype)
