"""Architecture registry of the port: ``get_config(arch_id)``,
``list_archs()`` and ``get_shape(name)``, as ``repro.configs``.

Every architecture of the reference is ported: the dense
``llama-3.2-1b``, ``glm4-9b``, ``phi4-mini-3.8b`` and
``mistral-large-123b``; the MoE ``mixtral-8x7b`` and ``mixtral-8x22b``
(sliding-window attention) and ``moonshot-v1-16b-a3b``; the hybrid
``zamba2-1.2b`` (Mamba2 blocks and one shared attention block); the
xLSTM ``xlstm-125m`` (mLSTM and sLSTM blocks, no adapters: FIRM trains
every parameter); the encoder-decoder ``whisper-large-v3`` and the VLM
``llama-3.2-vision-90b`` (``cross`` blocks reading a modality stub).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (FIRMConfig, InputShape, INPUT_SHAPES,
                                      LoRAConfig, MoEConfig, ModelConfig)

_ARCH_MODULES = {
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "glm4-9b": "glm4_9b",
    "mixtral-8x7b": "mixtral_8x7b",
    "whisper-large-v3": "whisper_large_v3",
    "zamba2-1.2b": "zamba2_1_2b",
    "mistral-large-123b": "mistral_large_123b",
    "mixtral-8x22b": "mixtral_8x22b",
    "xlstm-125m": "xlstm_125m",
    # the paper's own model
    "llama-3.2-1b": "llama32_1b",
}

ASSIGNED_ARCHS = tuple(k for k in _ARCH_MODULES if k != "llama-3.2-1b")


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def list_archs():
    return list(_ARCH_MODULES)


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]


__all__ = ["ModelConfig", "MoEConfig", "LoRAConfig", "FIRMConfig",
           "InputShape", "INPUT_SHAPES", "ASSIGNED_ARCHS",
           "get_config", "get_shape", "list_archs"]
