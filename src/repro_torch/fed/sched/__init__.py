"""Scheduler subsystem of the port (counterpart of ``repro.fed.sched``):
simulated-time client heterogeneity, deadline and buffered-async
aggregation, cohort dispatch.

    from repro_torch.fed.sched import ScheduledTrainer
    from repro_torch.configs.base import SchedConfig

``clock`` (the simulated clock and event queue), ``profiles`` (client
system profiles), ``cohort`` (group-by-config cohort plans) and
``policies`` (sync, deadline, fedbuff and ``ScheduledTrainer``).  The
policies are exposed lazily (PEP 562): the engine imports ``sched.cohort``
when it is loaded, so this package's eager imports must not reach back
into ``repro_torch.fed.engine``.
"""
from repro_torch.fed.sched.clock import EventQueue, SimClock
from repro_torch.fed.sched.cohort import (Cohort, build_cohorts,
                                          cohort_summaries)
from repro_torch.fed.sched.profiles import (PROFILE_PRESETS, ClientProfile,
                                            sample_profiles)

_LAZY = ("ScheduledTrainer", "SyncPolicy", "DeadlinePolicy",
         "FedBuffPolicy", "make_policy", "client_round_seconds")


def __getattr__(name):
    if name in _LAZY:
        from repro_torch.fed.sched import policies
        return getattr(policies, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "EventQueue", "SimClock", "Cohort", "build_cohorts",
    "cohort_summaries", "ClientProfile", "PROFILE_PRESETS",
    "sample_profiles", *_LAZY,
]
