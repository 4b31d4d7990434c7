"""Architecture registry of the port: ``get_config(arch_id)``.

Ported: the dense ``llama-3.2-1b``, ``glm4-9b``, ``phi4-mini-3.8b`` and
``mistral-large-123b``; the MoE ``mixtral-8x7b`` and ``mixtral-8x22b``
(sliding-window attention) and ``moonshot-v1-16b-a3b``; the hybrid
``zamba2-1.2b`` (Mamba2 blocks and one shared attention block).  The other
architectures of ``repro.configs`` arrive with their model families.
"""
from __future__ import annotations

from repro_torch.configs.base import (FIRMConfig, LoRAConfig, MoEConfig,
                                      ModelConfig)
from repro_torch.configs.glm4_9b import CONFIG as _GLM4_9B
from repro_torch.configs.llama32_1b import CONFIG as _LLAMA32_1B
from repro_torch.configs.mistral_large_123b import CONFIG as _MISTRAL_LARGE
from repro_torch.configs.mixtral_8x22b import CONFIG as _MIXTRAL_8X22B
from repro_torch.configs.mixtral_8x7b import CONFIG as _MIXTRAL_8X7B
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as _MOONSHOT
from repro_torch.configs.phi4_mini_3_8b import CONFIG as _PHI4_MINI
from repro_torch.configs.zamba2_1_2b import CONFIG as _ZAMBA2_1_2B

_CONFIGS = {c.name: c for c in (
    _LLAMA32_1B, _ZAMBA2_1_2B, _MIXTRAL_8X7B, _MIXTRAL_8X22B, _MOONSHOT,
    _GLM4_9B, _PHI4_MINI, _MISTRAL_LARGE)}


def get_config(arch: str) -> ModelConfig:
    if arch not in _CONFIGS:
        raise KeyError(f"unknown arch {arch!r}; ported: {sorted(_CONFIGS)}")
    return _CONFIGS[arch]


__all__ = ["ModelConfig", "MoEConfig", "LoRAConfig", "FIRMConfig",
           "get_config"]
