"""Federated engine of the port: the algorithm registry, the front door
(``RunSpec -> plan() -> ExecutionPlan -> execute``), the trainer and the
scheduler's ``ScheduledTrainer`` (counterpart of ``repro.fed``)."""
from repro_torch.fed.algorithms import (Algorithm, Capabilities,  # noqa
                                        available_algorithms, get_algorithm,
                                        register_algorithm)
from repro_torch.fed.api import (EngineConfig, ExecutionPlan, RunSpec,  # noqa
                                 execute, plan)
from repro_torch.fed.engine import FederatedTrainer  # noqa
from repro_torch.fed.sched.policies import ScheduledTrainer  # noqa

__all__ = [
    "FederatedTrainer", "ScheduledTrainer", "EngineConfig",
    "RunSpec", "ExecutionPlan", "plan", "execute",
    "Algorithm", "Capabilities", "available_algorithms", "get_algorithm",
    "register_algorithm",
]
