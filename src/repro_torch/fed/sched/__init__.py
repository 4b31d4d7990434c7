"""Scheduler subsystem of the port (counterpart of ``repro.fed.sched``).

Only the cohort planning is ported (``cohort``); the clock, the client
profiles, the sync, deadline and fedbuff policies and ``ScheduledTrainer``
are not ported yet.
"""
from repro_torch.fed.sched.cohort import (Cohort, build_cohorts,  # noqa
                                          cohort_summaries)

__all__ = ["Cohort", "build_cohorts", "cohort_summaries"]
