"""Shared model primitives: RMSNorm, RoPE, SwiGLU, LoRA-aware projections.

Counterpart of ``repro.models.common``.  Parameters are plain nested dicts
of tensors.  A linear projection is ``{'w': (din, dout)}``, applied as
``x @ w``, optionally carrying LoRA factors ``{'lora_A': (din, r),
'lora_B': (r, dout)}`` in f32.  The rounding order of every function
matches the JAX reference.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.trees import tree_leaves, tree_map, tree_size  # noqa: F401

Param = dict  # nested dict of tensors


# --------------------------------------------------------------------- init
def normal(shape, scale: float, dtype, *, generator: torch.Generator,
           device) -> torch.Tensor:
    """N(0, scale^2) drawn in f32 from ``generator``, then cast to dtype."""
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


def init_linear(din: int, dout: int, *, generator: torch.Generator, device,
                lora_rank: int = 0, dtype=torch.bfloat16,
                scale: Optional[float] = None, lead: tuple = ()) -> Param:
    """``lead`` prepends stacking axes (e.g. ``(n_periods,)``) to each leaf."""
    scale = scale if scale is not None else 1.0 / math.sqrt(din)
    p = {"w": normal(lead + (din, dout), scale, dtype, generator=generator,
                     device=device)}
    if lora_rank:
        # A ~ N(0, 1/din), B = 0 (standard LoRA init: adapter starts at zero)
        p["lora_A"] = normal(lead + (din, lora_rank), 1.0 / math.sqrt(din),
                             torch.float32, generator=generator, device=device)
        p["lora_B"] = torch.zeros(lead + (lora_rank, dout),
                                  dtype=torch.float32, device=device)
    return p


def init_norm(d: int, *, device, dtype=torch.bfloat16,
              lead: tuple = ()) -> Param:
    return {"g": torch.ones(lead + (d,), dtype=dtype, device=device)}


def init_swiglu(d: int, dff: int, *, generator: torch.Generator, device,
                dtype=torch.bfloat16, lead: tuple = ()) -> Param:
    kw = dict(generator=generator, device=device, dtype=dtype, lead=lead)
    return {
        "w_gate": init_linear(d, dff, **kw),
        "w_up": init_linear(d, dff, **kw),
        "w_down": init_linear(dff, d, scale=1.0 / math.sqrt(dff), **kw),
    }


# ------------------------------------------------------------------ forward
def linear(p: Param, x: torch.Tensor, *, lora_alpha: float = 32.0
           ) -> torch.Tensor:
    """x @ w (+ LoRA path).  x: (..., din) -> (..., dout).

    Operands of two dtypes are promoted as JAX promotes them (bf16 @ f32
    runs in f32 and gives f32: the xLSTM gate projections), where
    ``torch.matmul`` would refuse them; a same-dtype product is left as it
    is.  The LoRA product runs in f32, is cast to the base output's dtype,
    and only then scaled by ``lora_alpha / r``; ``lora_alpha`` is 32
    whatever ``cfg.lora.alpha`` says, as in the reference.
    """
    w = p["w"]
    if x.dtype != w.dtype:
        dtype = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dtype), w.to(dtype)
    y = x @ w
    if "lora_A" in p:
        r = p["lora_A"].shape[-1]
        z = (x.float() @ p["lora_A"]) @ p["lora_B"]
        y = y + (lora_alpha / r) * z.to(y.dtype)
    return y


def rms_norm(p: Param, x: torch.Tensor, eps: float = 1e-5, *,
             use_kernel: bool = True) -> torch.Tensor:
    """Normalise in f32, cast to ``x.dtype``, then multiply by ``g``."""
    return ops.rmsnorm(x, p["g"], eps, use_kernel=use_kernel)


def swiglu(p: Param, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: p has 'w_gate', 'w_up', 'w_down'; SiLU in f32."""
    g = linear(p["w_gate"], x)
    u = linear(p["w_up"], x)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return linear(p["w_down"], h)


# ---------------------------------------------------------------------- scan
def tensor_leaves(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples, in order."""
    out = []
    map_tensors(out.append, tree)
    return out


def map_tensors(fn, tree):
    """``tree`` with ``fn`` applied to each tensor (dicts, lists and
    tuples walked, anything else kept)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return tree


def scan_operands(body, carry, xs) -> tuple:
    """The tensors a ``scan`` reads: those bound in ``body`` when it is a
    ``functools.partial`` (its arguments and keywords), then the carry's,
    then the xs'."""
    bound = ((body.args, body.keywords)
             if isinstance(body, functools.partial) else ())
    return tuple(tensor_leaves((bound, carry, xs)))


def scan_slice(xs, t: int, dim: int):
    """Slice ``t`` of ``xs`` (a tensor or a tuple of tensors) along
    ``dim``."""
    at = (slice(None),) * dim + (t,)
    if isinstance(xs, torch.Tensor):
        return xs[at]
    return tuple(x[at] for x in xs)


def scan_stack(ys: list, dim: int):
    """Per-step outputs (tensors, or tuples of them) stacked on ``dim``."""
    if isinstance(ys[0], torch.Tensor):
        return torch.stack(ys, dim=dim)
    return tuple(torch.stack(list(y), dim=dim) for y in zip(*ys))


def scan_loop(body, carry, xs, dim: int = 0, start: int = 0, ys=None):
    """``scan``'s Python loop from step ``start`` on, ``ys`` the outputs
    of the steps before it."""
    ys = list(ys or [])
    first = xs if isinstance(xs, torch.Tensor) else xs[0]
    for t in range(start, first.shape[dim]):
        carry, y = body(carry, scan_slice(xs, t, dim))
        ys.append(y)
    return carry, scan_stack(ys, dim)


def scan(body, carry, xs, dim: int = 0):
    """The counterpart of ``jax.lax.scan``: ``carry, y = body(carry, x)``
    for each slice ``x`` of ``xs`` (a tensor, or a tuple of tensors of
    one length) along ``dim``, in order; returns the final carry and the
    ``y``s stacked on ``dim``.  ``body`` takes any other tensor it reads
    bound in a ``functools.partial``.

    On plain tensors it is the Python loop (``scan_loop``), operation for
    operation.  It takes part in torch's function protocol on its tensor
    operands (``scan_operands``), so that a ``TorchFunctionMode`` sees the
    whole recurrence as one call (``launch.rules`` runs one over DTensors
    on their shards); a CUDA-graph capture pays only the protocol's check.
    """
    operands = scan_operands(body, carry, xs)
    if torch.overrides.has_torch_function(operands):
        return torch.overrides.handle_torch_function(
            scan, operands, body, carry, xs, dim=dim)
    return scan_loop(body, carry, xs, dim)


# ---------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (S,) or (B, S).

    Rotates interleaved pairs ``(x[..., 0::2], x[..., 1::2])`` in f32.
    """
    freqs = rope_freqs(x.shape[-1], theta, x.device)       # (Dh/2,)
    ang = positions[..., None].float() * freqs              # (..., S, Dh/2)
    if ang.dim() == 2:
        ang = ang[None]                                      # (1, S, Dh/2)
    cos = torch.cos(ang)[:, :, None, :]                      # (B|1,S,1,Dh/2)
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    o1 = x1 * cos - x2 * sin
    o2 = x1 * sin + x2 * cos
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


# ------------------------------------------------------------------ trees
LORA_KEYS = ("lora_A", "lora_B")


def tree_bytes(tree) -> int:
    """Bytes of a tree's leaves."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def is_lora_path(path) -> bool:
    """Whether a leaf's path (its dict keys, or key objects with a
    ``key``, as JAX's paths hold) runs through a LoRA factor."""
    return any(getattr(k, "key", k) in LORA_KEYS for k in path)


def _split(tree, keep_lora: bool, under_lora: bool = False):
    if isinstance(tree, dict):
        return {k: _split(v, keep_lora, under_lora or k in LORA_KEYS)
                for k, v in tree.items()}
    return tree if under_lora == keep_lora else None


def split_trainable(params, full_params_mode: bool = False):
    """Split params into (trainable, frozen) trees with None placeholders.

    In LoRA mode trainable = the lora_A/lora_B leaves (paper: adapters
    only); without adapters, or in full mode, everything is trainable.
    """
    has_lora = bool(tree_leaves(_split(params, keep_lora=True)))
    if full_params_mode or not has_lora:
        return params, tree_map(lambda _: None, params)
    return _split(params, keep_lora=True), _split(params, keep_lora=False)


def merge_trainable(train, frozen):
    if isinstance(train, dict):
        return {k: merge_trainable(train[k], frozen[k]) for k in train}
    return train if train is not None else frozen
