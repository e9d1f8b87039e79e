"""Architecture registry: ``--arch <id>`` resolution."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig, InputShape, INPUT_SHAPES, smoke_shape

_ARCH_MODULES = {
    "internvl2-26b":        "repro_torch.configs.internvl2_26b",
    "mamba2-2.7b":          "repro_torch.configs.mamba2_2_7b",
    "smollm-360m":          "repro_torch.configs.smollm_360m",
    "qwen3-moe-30b-a3b":    "repro_torch.configs.qwen3_moe_30b_a3b",
    "qwen1.5-110b":         "repro_torch.configs.qwen1_5_110b",
    "recurrentgemma-9b":    "repro_torch.configs.recurrentgemma_9b",
    "tinyllama-1.1b":       "repro_torch.configs.tinyllama_1_1b",
    "command-r-35b":        "repro_torch.configs.command_r_35b",
    "hubert-xlarge":        "repro_torch.configs.hubert_xlarge",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch.endswith("-reduced"):
        return get_config(arch[: -len("-reduced")]).reduced()
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def get_shape(name: str) -> InputShape:
    if name.startswith("smoke"):
        return smoke_shape("decode" if "decode" in name else "train")
    return INPUT_SHAPES[name]


def applicable(arch: str, shape: str) -> bool:
    """Which (arch x shape) pairs run. Encoder-only skips decode shapes;
    everything else runs all four (full-attention archs use the
    sliding-window variant for long_500k)."""
    cfg = get_config(arch)
    shp = get_shape(shape)
    if shp.kind == "decode" and not cfg.supports_decode():
        return False
    return True
