"""Group-by-config cohort planning (counterpart of
``repro.fed.sched.cohort``).

A *cohort plan* partitions the participants into groups with identical
static config (the preference stripped when it is lifted to a per-client
tensor), so that each group runs as one local phase: heterogeneous
local-step counts (``FIRMConfig.client_local_steps``) cost one phase per
distinct K.  Grouping is insertion-ordered (the first client with a new
config opens its cohort), so plans are deterministic for a fixed
participant order.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from repro_torch.configs.base import FIRMConfig


@dataclasses.dataclass(frozen=True)
class Cohort:
    """One dispatch group: shared static config and member clients."""
    cfc: FIRMConfig
    members: Tuple[int, ...]


def static_config_key(fc: FIRMConfig, lift_preference: bool) -> FIRMConfig:
    """The config a cohort shares: the preference removed iff it rides a
    per-client tensor instead of the static dataclass field."""
    if lift_preference:
        return dataclasses.replace(fc, preference=None)
    return fc


def build_cohorts(pairs: Sequence[Tuple[int, FIRMConfig]],
                  lift_preference: bool = False) -> List[Cohort]:
    """[(client_id, per-client config)] -> ordered list of Cohorts.

    Clients whose static keys match share a cohort; member order inside a
    cohort and cohort order both follow first appearance in ``pairs``.
    """
    groups: Dict[FIRMConfig, List[int]] = {}
    for c, fc in pairs:
        groups.setdefault(static_config_key(fc, lift_preference),
                          []).append(c)
    return [Cohort(cfc=k, members=tuple(v)) for k, v in groups.items()]


def cohort_summaries(plan: Sequence[Cohort]) -> Tuple[Tuple[int, int], ...]:
    """(n_members, local_steps) per cohort: the plan's compact view of the
    dispatch structure (JSON-able, order-preserving)."""
    return tuple((len(co.members), co.cfc.local_steps) for co in plan)
