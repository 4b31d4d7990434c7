"""Dispatch between the Hopper kernels and their plain versions.

Mirrors ``repro.kernels.ops`` with ``use_kernel`` in place of
``use_pallas``.  The choice follows the tensor's device: a CPU tensor goes
to the plain PyTorch version in ``kernels.ref`` (differentiated by
autograd); any other tensor goes to the kernel's wrapper, which launches
on a CUDA tensor and raises on anything else.  On CUDA ``rmsnorm``,
``flash_attention`` and ``ssd_scan`` are ``autograd.Function``s whose
backward runs the backward kernels.  ``use_kernel=False`` forces the
plain version and exists for the tests and for ``chip_smoke.py``'s
comparisons; the model's main path never passes it.

A ``meta`` tensor (or a DTensor of meta shards) takes the plain version
too: it has shapes and no data, as in ``launch.specs``.  A CUDA DTensor
runs the kernel on the shard each device holds: ``rmsnorm`` with the
rows whole (the launch steps' serve step on a laid-out cache).  Under a
``launch.hlo_cost`` counter a plain version is one kernel call, charged
with the card kernel's costs (``kernels.costs``) and its own operations
left out; the differentiable ones then run as ``_Plain*`` functions whose
backward is the kernel's plain backward (``ref.*_bwd``), charged the same
way.
"""
from __future__ import annotations

import torch

from repro_torch import trees
from repro_torch.kernels import costs
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gram as _gram
from repro_torch.kernels import quantize as _q
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd as _ssd


def _kernel(x: torch.Tensor, use_kernel: bool) -> bool:
    return use_kernel and x.device.type not in ("cpu", "meta")


def _flash_layout(q, k, v):
    """DTensor q, k, v laid out as one flash call a device runs on its
    shards: batch and heads sharded as q's are, nothing else sharded, and
    k, v expanded to q's heads where q's head shards would split a GQA
    group (the plain version's ``repeat_interleave``, done before the
    split).  Differentiable DTensor operations."""
    from torch.distributed.tensor import Replicate
    mesh = q.device_mesh
    pl = [p if p.is_shard(0) or p.is_shard(2) else Replicate()
          for p in q.placements]
    shards = 1
    for i, p in enumerate(pl):
        if p.is_shard(2):
            shards *= mesh.size(i)
    if k.shape[2] % shards:
        g = q.shape[2] // k.shape[2]
        k, v = (t.repeat_interleave(g, dim=2) for t in (k, v))
    return tuple(t.redistribute(mesh, pl) for t in (q, k, v))


def _local(t):
    """(local tensor, rewrap) of a DTensor; (t, identity) of a tensor."""
    if not hasattr(t, "to_local"):
        return t, lambda x: x
    from torch.distributed.tensor import DTensor

    def wrap(x):
        return DTensor.from_local(x.contiguous(), t.device_mesh, t.placements,
                                  run_check=False, shape=t.shape,
                                  stride=_contiguous_strides(t.shape))
    return t.to_local(), wrap


def _contiguous_strides(shape) -> tuple:
    out, n = [], 1
    for size in reversed(shape):
        out.append(n)
        n *= size
    return tuple(reversed(out))


class _PlainFlash(torch.autograd.Function):
    """The plain attention as one counted kernel call, and its gradient as
    one counted backward call, each on the shards a device holds (a
    DTensor's local tensors, laid out by ``_flash_layout``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sliding_window):
        ctx.save_for_backward(q, k, v)
        ctx.mask = dict(causal=causal, sliding_window=sliding_window)
        (ql, wrap), (kl, _), (vl, _) = _local(q), _local(k), _local(v)
        with costs.call("flash_attention", ql, kl, vl, **ctx.mask) as c:
            return wrap(c.made(ref.flash_attention(ql, kl, vl, **ctx.mask)))

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        if hasattr(q, "to_local"):
            do = do.redistribute(q.device_mesh, q.placements)
        (ql, wq), (kl, wk), (vl, wv) = _local(q), _local(k), _local(v)
        with costs.call("flash_attention_bwd", ql, kl, vl, **ctx.mask) as c:
            dq, dk, dv = c.made(ref.flash_attention_bwd(
                ql, kl, vl, _local(do)[0], **ctx.mask))
        return wq(dq), wk(dk), wv(dv), None, None


class _PlainRMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, eps):
        ctx.save_for_backward(x, g)
        ctx.eps = eps
        with costs.call("rmsnorm", x, g) as c:
            return c.made(ref.rmsnorm(x, g, eps))

    @staticmethod
    def backward(ctx, dy):
        x, g = ctx.saved_tensors
        want_dg = ctx.needs_input_grad[1]
        with costs.call("rmsnorm_bwd", x, g, want_dg=want_dg) as c:
            dx = ref.rmsnorm_bwd(x, g, dy, ctx.eps)
            dg = ref.rmsnorm_dg(x, g, dy, ctx.eps) if want_dg else None
            c.made(dx if dg is None else (dx, dg))
        return dx, dg, None


class _PlainSSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bmat, cmat, dt, da, chunk):
        ctx.save_for_backward(x, bmat, cmat, dt, da)
        ctx.chunk = chunk
        with costs.call("ssd", x, bmat, cmat, dt, da, chunk=chunk,
                        return_state=True) as c:
            return c.made(ref.ssd_chunked(x, bmat, cmat, dt, da, chunk=chunk))

    @staticmethod
    def backward(ctx, dy, dstate):
        saved = ctx.saved_tensors
        with costs.call("ssd_bwd", *saved, chunk=ctx.chunk) as c:
            grads = c.made(ref.ssd_chunked_bwd(*saved, dy, dstate,
                                               chunk=ctx.chunk))
        return (*grads, None)


def gram(x, *, use_kernel: bool = True):
    """(M, d) stacked flat gradients -> (M, M) f32 Gram matrix."""
    if _kernel(x, use_kernel):
        return _gram.gram(x)
    with costs.call("gram", x) as c:
        return c.made(ref.gram(x))


def gram_from_pytrees(grads, *, use_kernel: bool = True):
    """List of M gradient trees -> (M, M).

    Each tree's leaves, in sorted-key order as ``jax.tree_util`` walks
    them, are flattened to f32 and concatenated into one row of an (M, d)
    matrix, as ``repro.kernels.ops.gram_from_pytrees`` does.
    """
    rows = [torch.cat([leaf.float().reshape(-1)
                       for leaf in trees.tree_leaves(g)]) for g in grads]
    return gram(torch.stack(rows), use_kernel=use_kernel)


def flash_attention(q, k, v, *, causal: bool = True, sliding_window: int = 0,
                    use_kernel: bool = True):
    if _kernel(q, use_kernel):
        return _fa.flash_attention(q, k, v, causal=causal,
                                   sliding_window=sliding_window)
    if costs.counting():
        if hasattr(q, "to_local"):
            q, k, v = _flash_layout(q, k, v)
        return _PlainFlash.apply(q, k, v, causal, sliding_window)
    return ref.flash_attention(q, k, v, causal=causal,
                               sliding_window=sliding_window)


def _rmsnorm_shards(x, g, eps: float):
    """The kernel on the shard of a CUDA DTensor ``x`` that a device
    holds, with its rows whole (the last dim gathered where it is
    sharded, a Partial sum reduced) and ``g`` whole; the result laid out
    as ``x`` then is."""
    from torch.distributed.tensor import Replicate
    last = x.ndim - 1
    x = x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_partial() or p.is_shard(last) else p
        for p in x.placements))
    g = g.full_tensor() if hasattr(g, "full_tensor") else g
    xl, wrap = _local(x)
    return wrap(_rn.rmsnorm(xl.contiguous(), g, eps))


def rmsnorm(x, g, eps: float = 1e-5, *, use_kernel: bool = True):
    if _kernel(x, use_kernel):
        if hasattr(x, "to_local"):
            return _rmsnorm_shards(x, g, eps)
        return _rn.rmsnorm(x, g, eps)
    if costs.counting():
        return _PlainRMSNorm.apply(x, g, eps)
    return ref.rmsnorm(x, g, eps)


def quantize(x2, bits, qmax: int = 127, *, use_kernel: bool = True):
    """(R, 1024) f32 + int32 rounding-bit patterns -> (int8 codes, (R, 1)
    scales)."""
    if _kernel(x2, use_kernel):
        return _q.quantize(x2, bits, qmax)
    with costs.call("quantize", x2, bits) as c:
        return c.made(ref.quantize(x2, bits, qmax))


def dequantize(codes, scales, *, use_kernel: bool = True):
    """(R, 1024) int8 codes, (R, 1) scales -> (R, 1024) f32."""
    if _kernel(codes, use_kernel):
        return _q.dequantize(codes, scales)[0]
    with costs.call("dequantize", codes, scales) as c:
        return c.made(ref.dequantize(codes, scales))


def dequantize_with_residual(codes, scales, adj, *, use_kernel: bool = True):
    """``dequantize`` plus the error-feedback residual ``adj - codes *
    scale`` rounded once, in one launch on CUDA: (decoded, residual)."""
    if _kernel(codes, use_kernel):
        return _q.dequantize(codes, scales, adj)
    with costs.call("dequantize", codes, scales, adj) as c:
        return c.made((ref.dequantize(codes, scales),
                       ref.dequantize_residual(codes, scales, adj)))


def _thresh(x2, thresh) -> torch.Tensor:
    """The threshold as an f32 tensor on ``x2``'s device (a Python float
    rounds once to f32, as ``jnp.asarray(t, jnp.float32)`` does)."""
    return torch.as_tensor(thresh, dtype=torch.float32,
                           device=x2.device).contiguous()


def abs_threshold_count(x2, thresh, *, use_kernel: bool = True):
    """Count of ``|x| >= thresh`` as f32: (R, 1024) with a scalar
    threshold -> 0-d, or (C, R, 1024) with (C,) thresholds -> (C,)."""
    if _kernel(x2, use_kernel):
        return _q.abs_threshold_count(x2, _thresh(x2, thresh))
    with costs.call("abs_threshold_count", x2, _thresh(x2, thresh)) as c:
        return c.made(ref.abs_threshold_count(x2, thresh))


def abs_threshold_mask(x2, thresh, *, use_kernel: bool = True):
    """``x`` where ``|x| >= thresh``, else +0.0; shapes as the count's."""
    if _kernel(x2, use_kernel):
        return _q.abs_threshold_mask(x2, _thresh(x2, thresh))
    with costs.call("abs_threshold_mask", x2, _thresh(x2, thresh)) as c:
        return c.made(ref.abs_threshold_mask(x2, thresh))


def topk_threshold(x2, k: int, iters: int = 32, *, use_kernel: bool = True):
    """Magnitude threshold bracket for top-k selection, by bisection (as
    ``repro.kernels.ops.topk_threshold``).

    x2: (R, 1024) f32, or (C, R, 1024) for C clients, each bracketed on its
    own.  Returns (lo, hi), 0-d or (C,) f32, with count(|x| >= lo) >= k >
    count(|x| >= hi) whenever such a bracket exists.  Each of the ``iters``
    passes is one count over all clients.  lo, hi and mid stay f32 tensors
    on the device: Python floats are f64 and would bisect to other
    thresholds, and reading them would wait for the device every pass.
    The constants are filled on the device (``torch.full``), not copied
    from the host, so the selection never waits for a copy either.
    """
    xf = x2.float()
    hi = torch.nextafter(xf.abs().amax(dim=(-2, -1)),
                         torch.full((), float("inf"), device=xf.device))
    lo = torch.zeros_like(hi)
    kf = torch.full((), float(k), dtype=torch.float32, device=xf.device)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        take = abs_threshold_count(xf, mid, use_kernel=use_kernel) >= kf
        lo, hi = torch.where(take, mid, lo), torch.where(take, hi, mid)
    return lo, hi


def ssd_scan(x, bmat, cmat, dt, da, *, chunk: int = 128,
             return_state: bool = False, use_kernel: bool = True):
    """The Mamba2 chunked SSD scan in the model's layout: x (B, S, nh, hd),
    B and C (B, S, ds) shared by the heads, dt and da (B, S, nh), f32 ->
    y (B, S, nh, hd) [, final state (B, nh, hd, ds)].  A CPU tensor takes
    ``ref.ssd_chunked`` (differentiated by autograd); a CUDA tensor the
    forward kernel, and its backward kernels when a gradient is asked
    for."""
    if _kernel(x, use_kernel):
        return _ssd.ssd_scan_trainable(x, bmat, cmat, dt, da, chunk=chunk,
                                       return_state=return_state)
    if costs.counting():
        y, state = _PlainSSD.apply(x, bmat, cmat, dt, da, chunk)
    else:
        y, state = ref.ssd_chunked(x, bmat, cmat, dt, da, chunk=chunk)
    return (y, state) if return_state else y
