"""One-switch debug toggles for NaN-hunting a divergent federated run
(counterpart of ``repro.obs.debug``).

Both switches sit behind the reference's environment variables, read once
at ``repro_torch.obs`` import:

    REPRO_DEBUG_NANS=1 PYTHONPATH=src python -m repro_torch.launch.train ...
    REPRO_X64=1 PYTHONPATH=src python -m repro_torch.launch.train ...

and behind ``set_debug_nan`` / ``set_x64``.  ``configure_from_env`` returns
the switches it applied under the port's own names (``debug_nans``,
``float64``).

``set_debug_nan(True)`` is the port's ``jax_debug_nans``: the first
operation whose floating output holds a NaN raises ``FloatingPointError``
naming it.  PyTorch has no such switch, so it is built from three checks:

* in the forward, a ``TorchDispatchMode`` (``NaNCheck``) around every
  program ``obs.jitwatch.wrap`` wraps, which looks at each ATen call's
  floating outputs (but those of ``empty``, ``empty_like``,
  ``empty_strided`` and ``new_empty``, uninitialised memory);
* in the backward, ``torch.autograd.set_detect_anomaly(True,
  check_nan=True)``, whose ``RuntimeError`` the program's scope re-raises
  as ``FloatingPointError``;
* after every launch of a hand-written kernel (``kernels.nancheck``,
  called by each wrapper under ``kernels/``): a ctypes launch is not an
  ATen op.

The forward check so covers the programs (``generate``, ``ref_logprobs``,
``step[<kernel>]``, ``stack_trees``, ``delta_flat``, ``flat_aggregate``,
``summary_device`` and FedCMOO's ``fedcmoo_grads``, ``grads_flat``,
``fedcmoo_apply``) and every kernel's outputs.  What runs between the
programs is not checked: the reward scoring, ``merge_trainable``, the
uplink codec's own torch operations (its quantize kernels' outputs are)
and the scheduler's stacking on the host.  A NaN made there raises at the
first checked operation that reads it, under that operation's name.

Each check reads a tensor back to the host, which no captured graph and no
fused chunk may do.  So while the switch is on nothing is captured: decode
runs its steps eagerly (``sampling.step_graph``), ``client_local_steps``
runs the update without graphs, and the fused executor refuses
(``FederatedTrainer.run_rounds_fused`` raises).  This is a mode the caller
asks for, not a fallback; turning the switch off restores capture.

``set_x64(True)`` is ``torch.set_default_dtype(torch.float64)``: every
factory call that names no dtype makes f64, as ``jax_enable_x64`` makes
every default-typed array f64.  Where the reference names a dtype the port
names it too, so the trained state keeps the reference's dtypes; a kernel
handed f64 raises ``TypeError`` before any launch.  ``False`` restores
f32.  Flip both switches at process start, not mid-run: a captured graph
keeps the dtypes it was captured with.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Mapping, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import nancheck
from repro_torch.obs import jitwatch

ENV_DEBUG_NANS = "REPRO_DEBUG_NANS"
ENV_X64 = "REPRO_X64"

_TRUTHY = {"1", "true", "yes", "on"}
_FALSY = {"0", "false", "no", "off", ""}

_aten = torch.ops.aten
# ops whose outputs are uninitialised memory: never checked
_UNINITIALISED = {_aten.empty, _aten.empty_like, _aten.empty_strided,
                  _aten.new_empty, _aten.new_empty_strided}
# the anomaly mode's message for a backward that made a NaN
_ANOMALY_NAN = "returned nan values"


def _parse(value: str, name: str) -> bool:
    v = value.strip().lower()
    if v in _TRUTHY:
        return True
    if v in _FALSY:
        return False
    raise ValueError(f"{name}={value!r}: expected a boolean "
                     f"({sorted(_TRUTHY)} / {sorted(_FALSY)})")


class NaNCheck(TorchDispatchMode):
    """Raises ``FloatingPointError`` at the first ATen call inside the
    block whose floating output holds a NaN, naming the call and the
    program it ran in."""

    def __init__(self, program: str = "") -> None:
        super().__init__()
        self.program = program

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket not in _UNINITIALISED and any(
                nancheck.has_nan(t) for t in tree_leaves(out)):
            raise FloatingPointError(
                f"NaN in the output of {func}"
                + (f" (program {self.program})" if self.program else ""))
        return out


@contextlib.contextmanager
def _nan_scope(program: str):
    """What a wrapped program runs in while the switch is on."""
    try:
        with NaNCheck(program):
            yield
    except RuntimeError as e:
        if _ANOMALY_NAN not in str(e):
            raise
        raise FloatingPointError(f"{e} (program {program})") from e


def nans_enabled() -> bool:
    return nancheck.enabled


def set_debug_nan(flag: bool) -> None:
    """Raise at the first NaN-producing operation inside a program or a
    kernel (what runs between them is not checked: see the module
    docstring); nothing is captured while it is on."""
    nancheck.enabled = bool(flag)
    torch.autograd.set_detect_anomaly(nancheck.enabled, check_nan=True)
    jitwatch.set_nan_check(_nan_scope if nancheck.enabled else None)


def set_x64(flag: bool) -> None:
    """Default floating tensors to 64 bits (separate divergence from f32
    accumulation noise)."""
    torch.set_default_dtype(torch.float64 if flag else torch.float32)


_applied: Optional[Dict[str, bool]] = None


def configure_from_env(env: Optional[Mapping[str, str]] = None, *,
                       force: bool = False) -> Dict[str, bool]:
    """Apply REPRO_DEBUG_NANS / REPRO_X64 if set; returns what it applied
    (``debug_nans``, ``float64``).

    Runs once a process (``repro_torch.obs`` import calls it); ``force``
    reads again: the tests pass an explicit ``env`` with ``force=True``.
    """
    global _applied
    if _applied is not None and not force:
        return dict(_applied)
    env = os.environ if env is None else env
    applied: Dict[str, bool] = {}
    v = env.get(ENV_DEBUG_NANS)
    if v is not None:
        flag = _parse(v, ENV_DEBUG_NANS)
        set_debug_nan(flag)
        applied["debug_nans"] = flag
    v = env.get(ENV_X64)
    if v is not None:
        flag = _parse(v, ENV_X64)
        set_x64(flag)
        applied["float64"] = flag
    _applied = applied
    return dict(applied)
