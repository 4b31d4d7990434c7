"""Federated engine of the port: the algorithm registry and the trainer
(counterpart of ``repro.fed``; the planner and the scheduler are not
ported yet)."""
from repro_torch.fed.algorithms import (Algorithm, Capabilities,  # noqa
                                        available_algorithms, get_algorithm,
                                        register_algorithm)
from repro_torch.fed.engine import EngineConfig, FederatedTrainer  # noqa

__all__ = [
    "FederatedTrainer", "EngineConfig",
    "Algorithm", "Capabilities", "available_algorithms", "get_algorithm",
    "register_algorithm",
]
