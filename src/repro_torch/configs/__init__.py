"""Architecture registry: ``get_config(arch_id)`` returns the exact
published configuration.

The data files are copies of the reference's ``repro/configs/*``. The
reference's per-cell input and cache specs (JAX shape structs) are not
carried over: the port's model makes its inputs and caches itself."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "zamba2-1.2b": "zamba2_1p2b",
    "musicgen-medium": "musicgen_medium",
    "deepseek-7b": "deepseek_7b",
    "stablelm-12b": "stablelm_12b",
    "minicpm3-4b": "minicpm3_4b",
    "granite-34b": "granite_34b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "xlstm-1.3b": "xlstm_1p3b",
}

ARCH_IDS = list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.config
