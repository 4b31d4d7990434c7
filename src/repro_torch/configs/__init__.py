"""Architecture registry of the port: ``get_config(arch_id)``.

Only the dense ``llama-3.2-1b`` is ported so far; the other
architectures of ``repro.configs`` arrive with their model families.
"""
from __future__ import annotations

from repro_torch.configs.base import (FIRMConfig, LoRAConfig, MoEConfig,
                                      ModelConfig)
from repro_torch.configs.llama32_1b import CONFIG as _LLAMA32_1B

_CONFIGS = {"llama-3.2-1b": _LLAMA32_1B}


def get_config(arch: str) -> ModelConfig:
    if arch not in _CONFIGS:
        raise KeyError(f"unknown arch {arch!r}; ported: {sorted(_CONFIGS)}")
    return _CONFIGS[arch]


__all__ = ["ModelConfig", "MoEConfig", "LoRAConfig", "FIRMConfig",
           "get_config"]
