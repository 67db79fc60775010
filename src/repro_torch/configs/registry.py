"""Architecture registry: ``--arch <id>`` resolution."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "qwen1.5-110b": "repro_torch.configs.qwen1_5_110b",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "internvl2-1b": "repro_torch.configs.internvl2_1b",
}


def arch_ids() -> List[str]:
    return list(_ARCH_MODULES)


def get(arch_id: str) -> ModelConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {arch_ids()}")
    mod = importlib.import_module(_ARCH_MODULES[arch_id])
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get(a) for a in arch_ids()}
