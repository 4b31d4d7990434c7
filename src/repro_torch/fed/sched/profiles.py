"""Per-client system profiles: compute speed and link bandwidths
(counterpart of ``repro.fed.sched.profiles``).

A ``ClientProfile`` is the scheduler's model of one device: how fast it
burns through local-PPO token work and how fast its links move payload
bytes (``core.comms``' time-from-bytes models).  Profiles are sampled
once per run from a named preset distribution so heterogeneity is
reproducible under a seed (numpy's ``default_rng``, so a seed draws the
reference's profiles exactly):

  homogeneous  every client identical (the exact-equivalence anchor:
               all policies degenerate to synchronous rounds)
  uniform      rates drawn U[low, high] per dimension — mild spread
  lognormal    heavy-tailed rates around a median — realistic fleets
  bimodal      edge-vs-datacenter mixture: most clients are slow edge
               devices, a minority are datacenter-fast.  The straggler
               regime where deadline/async policies dominate sync.

Rates are tokens/s for compute and bytes/s for links.  Absolute values
are smoke-scale stand-ins; only the *ratios* drive policy comparisons.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClientProfile:
    tokens_per_sec: float
    up_bytes_per_sec: float
    down_bytes_per_sec: float


def _homogeneous(n: int, rng) -> Tuple[ClientProfile, ...]:
    return tuple(ClientProfile(4096.0, 12.5e6, 50e6) for _ in range(n))


def _uniform(n: int, rng) -> Tuple[ClientProfile, ...]:
    return tuple(ClientProfile(
        tokens_per_sec=float(rng.uniform(1024, 8192)),
        up_bytes_per_sec=float(rng.uniform(2e6, 25e6)),
        down_bytes_per_sec=float(rng.uniform(10e6, 100e6)))
        for _ in range(n))


def _lognormal(n: int, rng) -> Tuple[ClientProfile, ...]:
    # medians match the homogeneous preset; sigma=0.8 gives ~5x IQR spread
    def draw(median):
        return float(median * rng.lognormal(0.0, 0.8))
    return tuple(ClientProfile(draw(4096.0), draw(12.5e6), draw(50e6))
                 for _ in range(n))


def _bimodal(n: int, rng) -> Tuple[ClientProfile, ...]:
    # 75% edge devices (slow compute, 10 Mbps uplink), 25% datacenter
    # nodes ~100x faster: the max/median round-time ratio sync pays
    out = []
    for _ in range(n):
        if rng.uniform() < 0.75:
            out.append(ClientProfile(512.0, 1.25e6, 5e6))
        else:
            out.append(ClientProfile(65536.0, 1.25e9, 1.25e9))
    return tuple(out)


PROFILE_PRESETS = {
    "homogeneous": _homogeneous,
    "uniform": _uniform,
    "lognormal": _lognormal,
    "bimodal": _bimodal,
}


def sample_profiles(n_clients: int, preset: str = "homogeneous",
                    seed: int = 0) -> Tuple[ClientProfile, ...]:
    """Draw n client profiles from a named preset, deterministic in seed."""
    if preset not in PROFILE_PRESETS:
        raise ValueError(f"unknown profile preset {preset!r}; "
                         f"available: {tuple(sorted(PROFILE_PRESETS))}")
    rng = np.random.default_rng(seed)
    return PROFILE_PRESETS[preset](n_clients, rng)
