"""Architecture registry: ``--arch <id>`` resolves here.

Each module defines CONFIG (the exact published dims from the brief) and
SMOKE (a reduced same-family config for CPU smoke tests).
"""
from __future__ import annotations

import importlib
from typing import Dict

ARCH_IDS = [
    "llama-3.2-vision-11b",
    "smollm-360m",
    "yi-6b",
    "granite-20b",
    "phi3-mini-3.8b",
    "deepseek-v2-lite-16b",
    "olmoe-1b-7b",
    "zamba2-2.7b",
    "musicgen-large",
    "rwkv6-3b",
]

_MODULES = {
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "smollm-360m": "smollm_360m",
    "yi-6b": "yi_6b",
    "granite-20b": "granite_20b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "zamba2-2.7b": "zamba2_2_7b",
    "musicgen-large": "musicgen_large",
    "rwkv6-3b": "rwkv6_3b",
}

# Sub-quadratic (SSM/hybrid) archs run the long_500k cell; pure full-attention
# archs skip it per the brief (documented in DESIGN.md §Arch-applicability).
SUBQUADRATIC = {"zamba2-2.7b", "rwkv6-3b"}


def get_config(arch_id: str, smoke: bool = False):
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.SMOKE if smoke else mod.CONFIG


def all_configs(smoke: bool = False) -> Dict[str, object]:
    return {a: get_config(a, smoke) for a in ARCH_IDS}
