"""Configurations, ported: ``paper_apps`` (the five streaming apps of
§IV.B and the published Tables II–VI) and the architecture registry
(``--arch <id>`` → :class:`ModelConfig`).

The registry lists all ten of the reference's architectures, in its
order: the hybrid (zamba2), ssm (xlstm), vlm, audio, moe and dense
configs. An unknown id raises ``KeyError``.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401
    LatentMoEConfig,
    ModelConfig,
    ShapeConfig,
    SHAPES,
    SHAPES_BY_NAME,
    applicable,
)

_ARCH_MODULES: Dict[str, str] = {
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen1p5_0p5b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(_ARCH_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()
