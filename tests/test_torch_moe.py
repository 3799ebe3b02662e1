"""The port's MoE layer (`repro_torch.models.moe`) against the reference's
(`repro.models.moe`, `ctx=None`) on the CPU.

The layer config of `tests/test_moe.py` (d_model 16, 8 experts, top-2,
moe_d_ff 32), the reference's weights carried across as numpy arrays and
inputs made from a numpy seed.  Tolerances: the output within 1e-5 of
max |reference| in float32 and 2e-2 in bfloat16 (the experts' products and
SiLU round in another order there); the aux loss within 1e-6; gradients
within 1e-5 of each leaf's max |reference|.  Each token's k expert outputs
are added in the reference's order (ascending expert, each sum rounded to
the dtype), so the combine on the same inputs is bitwise the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import moe as ref_moe
from repro.models.config import ModelConfig as RefModelConfig
from repro.models.params import init_from_specs as ref_init
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig

_FIELDS = dict(name="m", family="moe", num_layers=1, d_model=16,
               num_heads=2, num_kv_heads=2, d_ff=0, vocab_size=32,
               num_experts=8, experts_per_token=2, moe_d_ff=32,
               capacity_factor=2.0)
RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
AUX_TOL = 1e-6
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# name -> (capacity_factor, shared experts, router): "big" drops nothing
# (capacity >= T*k), "drops" drops most assignments, "tie" has expert 5's
# router column equal to expert 2's, so wherever exactly one of the two
# makes the top 2 the lower index must win, "uniform" a zero router: every
# probability ties and every token picks experts 0 and 1
CASES = {"big": (16.0, 0, None), "drops": (0.1, 0, None),
         "shared": (2.0, 1, None), "tie": (2.0, 0, "tie"),
         "uniform": (2.0, 0, "zero")}


def _configs(capacity_factor=2.0, shared=0):
    kw = dict(_FIELDS, capacity_factor=capacity_factor,
              num_shared_experts=shared)
    return RefModelConfig(**kw), ModelConfig(**kw)


def _params(ref_cfg, dtype, router=None, seed=0):
    """(the reference's params in `dtype`, the same as torch tensors)."""
    params = ref_init(jax.random.PRNGKey(seed),
                      ref_moe.moe_spec(ref_cfg, JNP[dtype]))
    w = np.array(params["router"]["w"])
    if router == "tie":
        w[:, 5] = w[:, 2]
    elif router == "zero":
        w[:] = 0.0
    params["router"]["w"] = jnp.asarray(w)
    return params, jax.tree.map(_to_torch, params)


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _inputs(dtype, shape=(2, 32, 16), seed=0):
    x = np.random.default_rng(seed).standard_normal(shape)
    j = jnp.asarray(x, JNP[dtype])
    return j, _to_torch(j)


def _rel(port, ref):
    ref = np.asarray(ref, np.float32)
    port = port.detach().float().numpy()
    assert port.shape == ref.shape
    return float(np.abs(port - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("dtype", list(RTOL))
@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_matches_the_reference(case, dtype):
    cf, shared, router = CASES[case]
    ref_cfg, cfg = _configs(cf, shared)
    params, tp = _params(ref_cfg, dtype, router)
    xj, xt = _inputs(dtype)
    y, aux = ref_moe.moe_apply(params, xj, ref_cfg, None)
    yt, auxt = moe.moe_apply(tp, xt, cfg)
    assert yt.dtype == TORCH[dtype] and auxt.dtype == torch.float32
    assert _rel(yt, y) <= RTOL[dtype], (case, dtype, _rel(yt, y))
    assert abs(float(auxt) - float(aux)) <= AUX_TOL
    # the routes themselves: each token's experts, and which are dropped
    xf = xj.reshape(-1, ref_cfg.d_model)
    cap = ref_moe.capacity_for(xf.shape[0], ref_cfg)
    disp, _, ids = ref_moe._route(xf, params["router"]["w"], ref_cfg, cap)
    mine, _, _ = moe._route(xt.reshape(-1, cfg.d_model), tp["router"]["w"],
                            cfg, moe.capacity_for(xt.shape[0] * xt.shape[1],
                                                  cfg))
    np.testing.assert_array_equal(mine.expert.numpy(),
                                  np.sort(np.asarray(ids), axis=1))
    dropped = int(np.sum(~np.asarray(disp.keep)))
    assert int((~mine.keep).sum()) == dropped
    if case == "drops" or case == "uniform":
        assert dropped > 0
    if case == "big":
        assert dropped == 0
    if case == "uniform":
        assert (mine.expert == torch.tensor([0, 1])).all()


def test_tie_goes_to_the_lower_index():
    """Expert 5's router column is expert 2's: no token holds 5 without
    2, and some hold 2 without 5 (the tie broken as jax.lax.top_k breaks
    it)."""
    ref_cfg, cfg = _configs()
    _, tp = _params(ref_cfg, "float32", "tie")
    _, xt = _inputs("float32", (4, 64, 16), seed=3)
    disp, _, _ = moe._route(xt.reshape(-1, 16), tp["router"]["w"], cfg, 64)
    has = lambda e: (disp.expert == e).any(dim=1)   # noqa: E731
    assert not (has(5) & ~has(2)).any()
    assert (has(2) & ~has(5)).any()


@pytest.mark.parametrize("case", ["drops", "big", "shared"])
def test_gradients_match_jax_grad(case):
    """d/d(x, every weight) of sum(y * r) + aux against `jax.grad`, float32;
    no gradient reaches `keep` or the slots, which are integers."""
    cf, shared, _ = CASES[case]
    ref_cfg, cfg = _configs(cf, shared)
    params, tp = _params(ref_cfg, "float32")
    xj, xt = _inputs("float32")
    r = np.random.default_rng(1).standard_normal(xt.shape).astype(np.float32)

    def ref_obj(p, x):
        y, aux = ref_moe.moe_apply(p, x, ref_cfg, None)
        return jnp.sum(y * r) + aux

    g_p, g_x = jax.grad(ref_obj, argnums=(0, 1))(params, xj)
    leaves = jax.tree.leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    xt.requires_grad_(True)
    y, aux = moe.moe_apply(tp, xt, cfg)
    got = torch.autograd.grad((y * torch.from_numpy(r)).sum() + aux,
                              [xt] + leaves)
    want = [g_x] + jax.tree.leaves(g_p)
    for i, (a, b) in enumerate(zip(got, want)):
        assert _rel(a, b) <= RTOL["float32"], (case, i, _rel(a, b))


def test_combine_adds_in_the_references_order():
    """The same expert outputs (bf16) and routes through both combines:
    bitwise equal, dropped assignments included."""
    ref_cfg, cfg = _configs(0.5)
    params, tp = _params(ref_cfg, "float32")
    xj, xt = _inputs("float32")
    t = 64
    cap = ref_moe.capacity_for(t, ref_cfg)
    rdisp, _, _ = ref_moe._route(xj.reshape(t, 16), params["router"]["w"],
                                 ref_cfg, cap)
    disp, _, _ = moe._route(xt.reshape(t, 16), tp["router"]["w"], cfg, cap)
    assert int((~disp.keep).sum()) > 0
    out = np.random.default_rng(2).standard_normal((8, cap, 16))
    outj = jnp.asarray(out, jnp.bfloat16)
    want = ref_moe._combine(outj, rdisp, t)
    got = moe._combine(_to_torch(outj), disp, t)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


CAPACITY_FACTORS = (0.1, 2.0, 8.0, 16.0)


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_capacity_for_is_the_references(cf):
    """At every capacity factor of tests/test_moe.py, for the token counts
    the layer sees there and around them."""
    ref_cfg, cfg = _configs(cf)
    for tokens in (1, 4, 8, 10, 16, 32, 64, 100, 256, 4096):
        got = moe.capacity_for(tokens, cfg)
        assert got == ref_moe.capacity_for(tokens, ref_cfg), (cf, tokens)
        assert got % 4 == 0 and got >= 4
    if cf == 2.0:
        assert moe.capacity_for(256, cfg) == 128


# ------------------------------------- tests/test_moe.py's invariants ----

def test_moe_forward_shapes_and_aux(rng):
    ref_cfg, cfg = _configs()
    _, tp = _params(ref_cfg, "float32")
    x = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
    y, aux = moe.moe_apply(tp, x, cfg)
    assert y.shape == x.shape and torch.isfinite(y).all()
    assert 0.9 < float(aux) < 4.0     # balanced-ish routing: its minimum is 1


def _explicit_mixture(tp, x, cfg):
    """Each token's kept top-k experts, gate-weighted, one token and one
    expert at a time; an expert keeps its first `capacity` tokens in token
    order."""
    xf = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(xf @ tp["router"]["w"], dim=-1)
    cap = moe.capacity_for(xf.shape[0], cfg)
    filled = [0] * cfg.num_experts
    ex = tp["experts"]
    out = torch.zeros_like(xf)
    for t in range(xf.shape[0]):
        gates, ids = torch.sort(probs[t], descending=True, stable=True)
        gates = gates[:cfg.experts_per_token] / gates[
            :cfg.experts_per_token].sum()
        for g, e in zip(gates, ids[:cfg.experts_per_token].tolist()):
            filled[e] += 1
            if filled[e] > cap:
                continue
            h = F.silu(xf[t] @ ex["w_gate"][e]) * (xf[t] @ ex["w_up"][e])
            out[t] += g * (h @ ex["w_down"][e])
    return out.reshape(x.shape)


@pytest.mark.parametrize("cf", [16.0, 0.1])
def test_moe_equals_the_explicit_mixture(cf, rng):
    """With capacity >= T*k the layer is the gate-weighted expert sum; with
    drops, the same sum over the kept assignments."""
    ref_cfg, cfg = _configs(cf)
    _, tp = _params(ref_cfg, "float32")
    x = torch.from_numpy(rng.standard_normal((1, 8, 16)).astype(np.float32))
    y, _ = moe.moe_apply(tp, x, cfg)
    torch.testing.assert_close(y, _explicit_mixture(tp, x, cfg), rtol=2e-5,
                               atol=2e-5)


def test_capacity_drops_tokens(rng):
    """capacity_factor << 1 drops assignments: the output changes but stays
    finite."""
    ref_cfg, cfg = _configs(0.1)
    _, tp = _params(ref_cfg, "float32")
    x = torch.from_numpy(rng.standard_normal((2, 32, 16)).astype(np.float32))
    y, _ = moe.moe_apply(tp, x, cfg)
    y_big, _ = moe.moe_apply(tp, x, cfg.replace(capacity_factor=8.0))
    assert torch.isfinite(y).all()
    assert float((y - y_big).abs().max()) > 1e-3


def test_shared_expert_added(rng):
    ref_cfg, cfg = _configs(2.0, 1)
    _, tp = _params(ref_cfg, "float32")
    x = torch.from_numpy(rng.standard_normal((1, 4, 16)).astype(np.float32))
    y_with, _ = moe.moe_apply(tp, x, cfg)
    tp["shared"] = {k: torch.zeros_like(v) for k, v in tp["shared"].items()}
    y_zero, _ = moe.moe_apply(tp, x, cfg)
    assert float((y_with - y_zero).abs().max()) > 1e-4


def test_a_mesh_context_raises_naming_its_slice():
    ref_cfg, cfg = _configs()
    _, tp = _params(ref_cfg, "float32")
    with pytest.raises(NotImplementedError, match="slice 8"):
        moe.moe_apply(tp, torch.zeros(1, 2, 16), cfg, ctx=object())
