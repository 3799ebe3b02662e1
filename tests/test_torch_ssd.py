"""The port's SSM engine (`repro_torch.models.ssd`) against the reference's
`models/ssd.py` and against the reference test's naive float64
recurrence, on the CPU.

Inputs are made from numpy seeds (the shapes of `tests/test_ssm.py`).
Tolerances: max |port - reference| <= 1e-5 of max |reference| in float32
(outputs, states and gradients through `jax.grad`), and within 1e-4
(rtol and atol) of the naive recurrence, the reference test's own bound;
with bfloat16 scores within 2e-2 of max |reference|, as
`tests/test_torch_lm.py` holds bfloat16.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssd as ref_ssd
from repro_torch.models import ssd

RTOL = 1e-5
BF16_RTOL = 2e-2
NAIVE_TOL = 1e-4


def _naive(q, k, v, log_a, beta, h0=None):
    """The reference test's float64 recurrence."""
    b, s, h, n = q.shape
    p = v.shape[-1]
    hst = np.zeros((b, h, n, p)) if h0 is None else np.asarray(h0, np.float64)
    ys = []
    for t in range(s):
        a = np.exp(log_a[:, t].astype(np.float64))[..., None, None]
        kv = (beta[:, t].astype(np.float64)[..., None, None]
              * k[:, t].astype(np.float64)[..., :, None]
              * v[:, t].astype(np.float64)[..., None, :])
        hst = hst * a + kv
        ys.append(np.einsum("bhn,bhnp->bhp", q[:, t].astype(np.float64), hst))
    return np.stack(ys, axis=1), hst


def _inputs(seed, b=1, s=16, h=2, n=4, p=4, h0=False):
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    out = {"q": f(b, s, h, n), "k": f(b, s, h, n), "v": f(b, s, h, p),
           "log_a": -np.abs(f(b, s, h)),
           "beta": rng.random((b, s, h)).astype(np.float32)}
    if h0:
        out["h0"] = f(b, h, n, p)
    return out


def _rel(port, ref):
    ref = np.asarray(ref, np.float32)
    port = port.detach().float().numpy() if torch.is_tensor(port) else \
        np.asarray(port, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max() / np.abs(ref).max())


@functools.lru_cache(maxsize=None)
def _ref_chunked(chunk, score_dtype="float32"):
    return jax.jit(functools.partial(ref_ssd.chunked_decay_attention,
                                     chunk=chunk,
                                     score_dtype=jnp.dtype(score_dtype)))


def _port_args(x):
    return {k: torch.from_numpy(v) for k, v in x.items()}


def _ref_args(x):
    return {k: jnp.asarray(v) for k, v in x.items()}


@pytest.mark.parametrize("s", [13, 24])
@pytest.mark.parametrize("chunk", [4, 8])
@pytest.mark.parametrize("with_h0", [False, True])
def test_chunked_matches_reference_and_recurrence(s, chunk, with_h0):
    """s 13 pads the tail with identity steps, 24 is whole chunks; with
    or without an initial state carried in."""
    x = _inputs(10 * s + chunk, b=2, s=s, h0=with_h0)
    y, h_t = ssd.chunked_decay_attention(**_port_args(x), chunk=chunk)
    ry, rh = _ref_chunked(chunk)(**_ref_args(x))
    assert y.dtype == torch.float32 and h_t.dtype == torch.float32
    assert _rel(y, ry) <= RTOL and _rel(h_t, rh) <= RTOL
    ny, nh = _naive(x["q"], x["k"], x["v"], x["log_a"], x["beta"],
                    x.get("h0"))
    np.testing.assert_allclose(y.numpy(), ny, rtol=NAIVE_TOL, atol=NAIVE_TOL)
    np.testing.assert_allclose(h_t.numpy(), nh, rtol=NAIVE_TOL,
                               atol=NAIVE_TOL)


@pytest.mark.parametrize("s", [8, 17])
def test_bf16_inputs_and_scores_match_the_reference(s):
    """bfloat16 inputs (y in bfloat16, the state float32) with float32
    and bfloat16 intra-chunk scores."""
    x = _inputs(s, b=2, s=s, h=3)
    for sd in ("float32", "bfloat16"):
        y, h_t = ssd.chunked_decay_attention(
            **{k: v.to(torch.bfloat16) for k, v in _port_args(x).items()},
            chunk=8, score_dtype=sd)
        ry, rh = _ref_chunked(8, sd)(
            **{k: v.astype(jnp.bfloat16) for k, v in _ref_args(x).items()})
        assert y.dtype == torch.bfloat16 and h_t.dtype == torch.float32
        assert _rel(y, ry.astype(jnp.float32)) <= BF16_RTOL, sd
        assert _rel(h_t, rh) <= BF16_RTOL, sd


def test_gradients_match_jax_grad():
    """The gradient of sum(y * w) + sum(h_T * u) through every input, the
    masked decay matrix's -inf included: finite and within RTOL of
    `jax.grad` of the reference's."""
    x = _inputs(3, b=2, s=13, h0=True)
    rng = np.random.default_rng(4)
    w = rng.standard_normal((2, 13, 2, 4)).astype(np.float32)
    u = rng.standard_normal((2, 2, 4, 4)).astype(np.float32)
    names = sorted(x)

    def ref_f(*args):
        y, h_t = ref_ssd.chunked_decay_attention(**dict(zip(names, args)),
                                                 chunk=4)
        return jnp.sum(y * w) + jnp.sum(h_t * u)

    ref_g = jax.jit(jax.grad(ref_f, argnums=tuple(range(len(names)))))(
        *(jnp.asarray(x[k]) for k in names))
    args = {k: torch.from_numpy(x[k]).requires_grad_(True) for k in names}
    y, h_t = ssd.chunked_decay_attention(**args, chunk=4)
    (y * torch.from_numpy(w)).sum().add((h_t * torch.from_numpy(u)).sum()) \
        .backward()
    for k, rg in zip(names, ref_g):
        assert torch.isfinite(args[k].grad).all(), k
        assert _rel(args[k].grad, rg) <= RTOL, k


def test_step_matches_the_reference():
    rng = np.random.default_rng(5)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    x = {"q": f(3, 2, 4), "k": f(3, 2, 4), "v": f(3, 2, 5),
         "log_a": -np.abs(f(3, 2)), "beta": np.abs(f(3, 2)),
         "h_prev": f(3, 2, 4, 5)}
    y, h = ssd.decay_attention_step(**_port_args(x))
    ry, rh = jax.jit(ref_ssd.decay_attention_step)(**_ref_args(x))
    assert _rel(y, ry) <= RTOL and _rel(h, rh) <= RTOL


@pytest.mark.parametrize("s", [9, 17])
def test_step_continues_a_chunked_prefill(s):
    """A decode step after a chunked prefill of s - 1 gives the chunked
    run's last output and final state."""
    x = _inputs(s + 100, b=2, s=s)
    t = _port_args(x)
    y_full, h_full = ssd.chunked_decay_attention(**t, chunk=8)
    _, h_pre = ssd.chunked_decay_attention(
        **{k: v[:, :-1] for k, v in t.items()}, chunk=8)
    y_t, h_t = ssd.decay_attention_step(
        *(t[k][:, -1] for k in ("q", "k", "v", "log_a", "beta")), h_pre)
    np.testing.assert_allclose(y_t.numpy(), y_full[:, -1].numpy(),
                               rtol=NAIVE_TOL, atol=NAIVE_TOL)
    np.testing.assert_allclose(h_t.numpy(), h_full.numpy(), rtol=NAIVE_TOL,
                               atol=NAIVE_TOL)
