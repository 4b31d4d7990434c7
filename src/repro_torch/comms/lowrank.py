"""Low-rank sketch codec, PowerSGD-style randomized range finder
(counterpart of ``repro.comms.lowrank``).

The flat vector is zero-padded and reshaped to a near-square (a, b) matrix
X and sent as Q (a, r) and B = Q^T X (r, b), with Q an orthonormal basis
of X (X^T X)^p Omega: r (a + b) f32 words instead of a b.  Rank-r
truncation is biased, so "lowrank:r+ef" is the spelling to use.  The
products and the QR are plain PyTorch (``torch.matmul``,
``torch.linalg.qr``), as the reference leaves them to XLA; f32 products
stay f32 only with TF32 off (``torch.backends.cuda.matmul.allow_tf32``,
False by default).

The random draw Omega (b, r) f32 comes from the generator ``key`` on the
vector's device, or is injected as ``bits`` (so that a test can hand the
port JAX's ``jax.random.normal`` draw).  Without either, a generator
seeded with 0 draws it, the counterpart of the reference's
``PRNGKey(0)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.comms.codec import Codec


# The f32 codec's decoded vector, and so its error-feedback residual, lies
# within F32_ERROR_K * 2**-24 * cond(P) * max|flat| of the same math in
# float64, P the range sample (``LowRankCodec.range_sample``): P's
# condition number scales the rounding of its QR, and rank r cancels the
# few dominant rows of a vector of mixed row scale almost exactly, so the
# error is measured against the terms that cancel.  Held on the CPU over
# draws of mixed row scale (tests/test_torch_lowrank_conditioning.py).
F32_ERROR_K = 4.0


def _matrix_shape(d: int):
    a = 1
    while a * a < d:
        a *= 2
    return a, -(-d // a)


class LowRankCodec(Codec):
    def __init__(self, rank: int = 4, power_iters: int = 1):
        if rank < 1:
            raise ValueError(f"lowrank rank must be >= 1, got {rank}")
        self.rank = rank
        self.power_iters = power_iters
        self.name = f"lowrank:{rank}"

    def _omega(self, b: int, key, bits, device) -> torch.Tensor:
        if bits is not None:
            if tuple(bits.shape) != (b, self.rank):
                raise ValueError(f"injected omega must be ({b}, "
                                 f"{self.rank}), got {tuple(bits.shape)}")
            return bits.to(device=device, dtype=torch.float32)
        if key is None:
            key = torch.Generator(device=device).manual_seed(0)
        return torch.randn((b, self.rank), generator=key, device=key.device,
                           dtype=torch.float32)

    def range_sample(self, flat, omega):
        """The padded (a, b) matrix X of ``flat`` and its (a, r) range
        sample P = X (X^T X)^p Omega, whose orthonormal basis is Q."""
        d = flat.numel()
        a, b = _matrix_shape(d)
        x = F.pad(flat.float(), (0, a * b - d)).reshape(a, b)
        p = x @ omega
        for _ in range(self.power_iters):
            p = x @ (x.T @ p)
        return x, p

    def encode_flat(self, flat, *, key=None, bits=None):
        a, b = _matrix_shape(flat.numel())
        x, p = self.range_sample(flat, self._omega(b, key, bits, flat.device))
        q, _ = torch.linalg.qr(p)                       # (a, r) orthonormal
        return {"q": q.contiguous(), "b": (q.T @ x).contiguous()}, \
            {"a": a, "b_cols": b}

    def decode_flat(self, payload):
        return (payload.arrays["q"] @ payload.arrays["b"]).reshape(-1)

    def bits_per_param(self, d: int) -> float:
        a, b = _matrix_shape(d)
        return 32.0 * self.rank * (a + b) / d

    def nbytes_static(self, d: int) -> int:
        a, b = _matrix_shape(d)
        return 4 * self.rank * (a + b)

    def meta_static(self, d: int):
        a, b = _matrix_shape(d)
        return {"a": a, "b_cols": b}
