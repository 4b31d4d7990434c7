"""Carry parameter trees between the JAX package and the port.

The JAX side hands over its tree as nested dicts of **numpy** arrays
(``jax.tree_util.tree_map(np.asarray, params)``), so this module needs no
JAX.  Layouts are kept as they are: a projection ``w`` stays
``(din, dout)`` and is applied as ``x @ w``, and the pattern slots stay
stacked over periods on the leading axis (``slots["0"][...]`` has shape
``(n_periods, ...)``).  Only the container type changes.

``np.asarray`` of a JAX bf16 array has dtype ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses; such leaves travel as their 16-bit patterns
(``view(np.uint16)`` then ``view(torch.bfloat16)``), so every leaf
arrives bit for bit.

Containers keep their type: dicts, lists, tuples and NamedTuples are
rebuilt as they came, and ``None`` (the empty slots of
``split_trainable``'s trees) passes through as ``None`` both ways.  A JAX
``ClientState`` is of ``repro``'s own NamedTuple classes, which the port
cannot import; ``client_state_to_torch`` reads its fields by name into the
port's ``ClientState``/``AdamState``, and ``client_state_to_numpy`` turns
it back into numpy leaves in the port's classes, whose fields are the
reference's, in its order.  ``load_trainer_state`` carries a JAX
``FederatedTrainer``'s state between rounds into the port's trainer.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.rlhf.local import ClientState
from repro_torch.train.optim import AdamState


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def leaf_to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if _is_bf16(a):
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        # the bfloat16 numpy dtype is registered by ml_dtypes, which the
        # JAX side has loaded; the port itself never imports it
        return t.view(torch.int16).numpy().view(np.dtype("bfloat16"))
    return t.numpy()


def to_torch(tree, device="cuda"):
    """Nested dicts, lists, tuples or NamedTuples of numpy arrays (None
    slots allowed) -> the same of tensors."""
    dev = device_lib.resolve(device)
    return _map(tree, lambda a: leaf_to_torch(a, dev))


def to_numpy(tree):
    """Nested containers of tensors (None slots allowed) -> the same of
    numpy arrays."""
    return _map(tree, leaf_to_numpy)


def _map(tree, fn):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # NamedTuple
        return type(tree)(*(_map(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def client_state_to_torch(np_state, device="cuda"):
    """A JAX ``ClientState`` of numpy leaves (any NamedTuple with its
    fields, ``opt`` an ``AdamState``) -> the port's ``ClientState``."""
    opt = np_state.opt
    s = to_torch({f: getattr(np_state, f) for f in ClientState._fields
                  if f != "opt"}, device)
    return ClientState(**s, opt=AdamState(**to_torch(
        {f: getattr(opt, f) for f in AdamState._fields}, device)))


def client_state_to_numpy(state):
    """The port's ``ClientState`` -> the same classes with numpy leaves,
    laid out field for field as the JAX ``ClientState``."""
    return to_numpy(state)


def load_trainer_state(trainer, state: dict) -> None:
    """Load numpy copies of a JAX ``FederatedTrainer``'s state into the
    port's ``FederatedTrainer``, onto its device.

    ``state`` holds ``global_trainable`` (numpy tree), ``client_states``
    (one JAX ``ClientState`` of numpy leaves per client), ``uplink_state``
    (one residual array, or None, per client) and ``prompt_counts`` (each
    client's prompt-stream cursor, the reference's ``_count``).
    """
    dev = trainer.device
    trainer.global_trainable = to_torch(state["global_trainable"], dev)
    trainer.client_states = [client_state_to_torch(s, dev)
                             for s in state["client_states"]]
    trainer._uplink_state = [None if r is None else leaf_to_torch(r, dev)
                             for r in state["uplink_state"]]
    for ds, n in zip(trainer.datasets, state["prompt_counts"], strict=True):
        ds.count = int(n)
