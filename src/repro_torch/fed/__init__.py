"""Federated engine of the port: the algorithm registry, the front door
(``RunSpec -> plan() -> ExecutionPlan -> execute``) and the trainer
(counterpart of ``repro.fed``; the scheduler's ``ScheduledTrainer`` is not
ported yet)."""
from repro_torch.fed.algorithms import (Algorithm, Capabilities,  # noqa
                                        available_algorithms, get_algorithm,
                                        register_algorithm)
from repro_torch.fed.api import (EngineConfig, ExecutionPlan, RunSpec,  # noqa
                                 execute, plan)
from repro_torch.fed.engine import FederatedTrainer  # noqa

__all__ = [
    "FederatedTrainer", "EngineConfig",
    "RunSpec", "ExecutionPlan", "plan", "execute",
    "Algorithm", "Capabilities", "available_algorithms", "get_algorithm",
    "register_algorithm",
]
