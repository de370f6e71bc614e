"""Architecture configs (assigned pool) + lookup by --arch id.

The port's own copy of ``repro.configs``: the same ten configs, as data.
"""
from repro_torch.configs import (deepseek_moe_16b, gemma2_27b, granite_3_2b,
                                 mamba2_130m, paligemma_3b, phi35_moe_42b,
                                 qwen3_4b, recurrentgemma_9b,
                                 seamless_m4t_medium, smollm_135m)

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (smollm_135m, granite_3_2b, qwen3_4b, gemma2_27b,
              recurrentgemma_9b, deepseek_moe_16b, phi35_moe_42b,
              seamless_m4t_medium, mamba2_130m, paligemma_3b)
}

# short aliases for --arch
ALIASES = {
    "smollm": "smollm-135m", "granite": "granite-3-2b", "qwen3": "qwen3-4b",
    "gemma2": "gemma2-27b", "recurrentgemma": "recurrentgemma-9b",
    "deepseek-moe": "deepseek-moe-16b", "phi35-moe": "phi3.5-moe-42b-a6.6b",
    "seamless": "seamless-m4t-medium", "mamba2": "mamba2-130m",
    "paligemma": "paligemma-3b",
}


def get_config(name: str):
    name = ALIASES.get(name, name)
    return ARCHS[name]


def list_archs():
    return sorted(ARCHS)
