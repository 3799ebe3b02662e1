"""Configurations the port runs: the Nekbone workload (`nekbone.py`) and the
assigned LM architectures, as data copies of the reference's.

Each LM module exposes CONFIG (full assigned size).  `get(name)` resolves by
id or CLI alias; `reduced(name)` gives the same-family CPU smoke config.
`get` refuses no family: `models.registry.build_model` is what refuses a
family the port does not run yet.
"""

import importlib

ARCH_IDS = [
    "phi_3_vision_4_2b",
    "qwen3_0_6b",
    "qwen2_7b",
    "smollm_360m",
    "granite_8b",
    "kimi_k2_1t_a32b",
    "moonshot_v1_16b_a3b",
    "seamless_m4t_medium",
    "zamba2_2_7b",
    "xlstm_350m",
]

# CLI-friendly ids (match the assignment spelling)
ALIASES = {
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "qwen3-0.6b": "qwen3_0_6b",
    "qwen2-7b": "qwen2_7b",
    "smollm-360m": "smollm_360m",
    "granite-8b": "granite_8b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "zamba2-2.7b": "zamba2_2_7b",
    "xlstm-350m": "xlstm_350m",
}


def get(name: str):
    mod_name = ALIASES.get(name, name)
    mod =importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def reduced(name: str):
    from repro_torch.models.config import reduced_config
    return reduced_config(get(name))


def all_configs():
    return {aid: get(aid) for aid in ARCH_IDS}
