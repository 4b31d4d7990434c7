"""The round summary's one constructor (counterpart of
``repro.obs.records.round_summary``).

The port keeps its own copy: ``repro.obs`` imports JAX when its package
is imported.  The keys, their order and their types are the reference's,
and a test holds the two equal, the fused executor's ``fused`` key
included.  The typed metric records and the sinks are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence


def round_summary(*, stats: Dict[str, Any], comm_bytes: int, up_bytes: int,
                  down_bytes: int, participants: Sequence[int],
                  dispatches: float, up_nbytes: Sequence[int],
                  down_nbytes: int, local_steps: Sequence[int],
                  cohorts: int, fused: Optional[int] = None) -> dict:
    """The engine's per-round summary dict, for the per-round and the
    fused executors alike.

    ``stats`` holds the round's statistics on the host (numpy arrays and
    scalars): rewards, lam_mean, lam_disagreement, param_drift, kl,
    per_client_lam, rewards_per_client.  ``fused``, the length of the
    fused chunk the round ran in, is the last key, present only then.
    """
    summary = {
        "rewards": stats["rewards"],
        "lam_mean": stats["lam_mean"],
        "lam_disagreement": float(stats["lam_disagreement"]),
        "param_drift": float(stats["param_drift"]),
        "kl": float(stats["kl"]),
        "comm_bytes": comm_bytes,
        "up_bytes": up_bytes,
        "down_bytes": down_bytes,
        "participants": list(participants),
        "per_client_lam": stats["per_client_lam"],
        "rewards_per_client": stats["rewards_per_client"],
        "dispatches": dispatches,
        "up_nbytes": list(up_nbytes),
        "down_nbytes": down_nbytes,
        "local_steps": list(local_steps),
        "cohorts": cohorts,
    }
    if fused is not None:
        summary["fused"] = fused
    return summary
