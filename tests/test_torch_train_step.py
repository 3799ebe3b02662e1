"""The port's train step (`training.train_loop.make_train_step`) against
the reference's on the CPU, and the train state carried across by
`convert.train_state_from_numpy`.

The reduced qwen3 config in float32; weights and AdamW states are the
reference's, carried across.  Tolerances: loss, "ce" and grad_norm within
1e-5 relative at every step; the parameters by the two-part rule of
`tests/_torch_train_util.py` (`two_part`); the carried state bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.configs as ref_configs
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models.config import reduced_config as ref_reduced_config
from repro.models.params import init_from_specs as ref_init
from repro.models.registry import build_model as ref_build_model
from repro.training.train_loop import TrainConfig as RefTrainConfig
from repro.training.train_loop import init_state as ref_init_state
from repro.training.train_loop import make_train_step as ref_make_train_step
from repro_torch import configs
from repro_torch.convert import train_state_from_numpy
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.config import reduced_config
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import TrainConfig, make_train_step
from _torch_train_util import (ref_leaves, stacked_leaves, to_torch,
                               two_part)


# ----------------------------------------------------------- the step ----

def _setups(seed=0, **kw):
    """(reference model, reference state, the port's model and state) on
    the reduced float32 qwen3 config, the same weights and AdamW state."""
    cfg = ref_reduced_config(ref_configs.get("qwen3_0_6b")).replace(
        dtype="float32")
    ref_model = ref_build_model(cfg)
    params = ref_init(jax.random.PRNGKey(seed), ref_model.param_specs())
    ref_state = jax.jit(lambda p: ref_init_state(p, RefTrainConfig(**kw)))(
        params)
    port_cfg = reduced_config(configs.get("qwen3_0_6b")).replace(
        dtype="float32")
    model, state = train_state_from_numpy(
        port_cfg, jax.tree.map(np.asarray, ref_state), device="cpu")
    return cfg, ref_model, ref_state, model, state


@pytest.mark.parametrize("grad_accum,accum_dtype,eight_bit", [
    (1, "float32", False), (2, "float32", False), (2, "bfloat16", False),
    (1, "float32", True), (2, "bfloat16", True)])
def test_train_step_matches_the_reference(grad_accum, accum_dtype,
                                          eight_bit):
    """3 steps (warmup 1: the rate is 0 at step 0, 1e-2 after): loss,
    "ce" and grad_norm within 1e-5 relative at every step; the
    parameters by the two-part rule.  In 8-bit, a moment one quantization
    step apart moves a parameter by a share of lr, and the next step's
    gradients with it: there the port's state is set to the reference's
    before each step, so each comparison is of one step."""
    kw = dict(lr=1e-2, warmup=1, total_steps=10, grad_accum=grad_accum,
              accum_dtype=accum_dtype, eight_bit_optimizer=eight_bit)
    cfg, ref_model, ref_state, model, state = _setups(**kw)
    ref_state = jax.tree.map(jnp.asarray, ref_state)
    ref_step = jax.jit(ref_make_train_step(ref_model, RefTrainConfig(**kw)))
    step = make_train_step(model, TrainConfig(**kw))
    ref_data = RefSyntheticLM(cfg, batch=4, seq=24, seed=0)
    data = SyntheticLM(cfg, batch=4, seq=24, seed=0, device="cpu")
    lr_sum = 0.0
    for i in range(3):
        if eight_bit:
            opt.tree_fill(state, [to_torch(a) for a in
                                  jax.tree.leaves(ref_state)])
            lr_sum = 0.0
        ref_state, ref_m = ref_step(ref_state, ref_data.batch_at(i))
        state, m = step(state, data.batch_at(i))
        assert set(m) == set(ref_m) == {"loss", "grad_norm", "lr", "ce",
                                        "aux"}
        assert all(v.device.type == "cpu" and v.shape == () and
                   not v.requires_grad for v in m.values())
        for k in ("loss", "ce", "grad_norm"):
            assert abs(float(m[k]) - float(ref_m[k])) <= 1e-5 * abs(
                float(ref_m[k])), (i, k)
        assert abs(float(m["lr"]) - float(ref_m["lr"])) <= 1e-6 * 1e-2
        lr_sum += float(m["lr"])
        two_part(stacked_leaves(state["params"]),
                  ref_leaves(ref_state["params"]), max(lr_sum, 1e-30),
                  eight_bit, i)
    assert int(state["step"]) == int(ref_state["step"]) == 3
    assert int(state["opt"]["count"]) == 3


def test_train_state_from_numpy_carries_every_leaf():
    for eight in (False, True):
        _, _, ref_state, model, state = _setups(eight_bit_optimizer=eight)
        ref = ref_leaves(ref_state)
        port = stacked_leaves(state)
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            assert p.dtype == r.dtype and p.shape == r.shape
            np.testing.assert_array_equal(p, r)
        assert all(p.requires_grad for p in model.parameters())
        assert opt.tree_leaves(state["params"])[0] is model.embed["table"]
