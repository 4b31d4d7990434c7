"""Architecture registry of the port: ``get_config(arch_id)``.

Ported: the dense ``llama-3.2-1b`` and the hybrid ``zamba2-1.2b``
(Mamba2 blocks and one shared attention block).  The other architectures
of ``repro.configs`` arrive with their model families.
"""
from __future__ import annotations

from repro_torch.configs.base import (FIRMConfig, LoRAConfig, MoEConfig,
                                      ModelConfig)
from repro_torch.configs.llama32_1b import CONFIG as _LLAMA32_1B
from repro_torch.configs.zamba2_1_2b import CONFIG as _ZAMBA2_1_2B

_CONFIGS = {"llama-3.2-1b": _LLAMA32_1B, "zamba2-1.2b": _ZAMBA2_1_2B}


def get_config(arch: str) -> ModelConfig:
    if arch not in _CONFIGS:
        raise KeyError(f"unknown arch {arch!r}; ported: {sorted(_CONFIGS)}")
    return _CONFIGS[arch]


__all__ = ["ModelConfig", "MoEConfig", "LoRAConfig", "FIRMConfig",
           "get_config"]
