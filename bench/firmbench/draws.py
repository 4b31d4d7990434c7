"""A round's inputs, drawn from the run's seed on the device.

Round r of seed n draws from one generator seeded by (n, r): the prompt
tokens (K, C, B, P), uniform over the vocabulary; then, where the round
is judged (``noise``), the Gumbel noise of sampling (K, C, T, B, V),
``-log(-log(u))`` with u uniform in [tiny, 1), and the uplink codec's
rounding offsets (C, rows, 1024) as int32 bit patterns of uniform
uint32s.  The same seed gives the same rounds; every seed gives the
same sizes.
"""
from __future__ import annotations

import torch

BLOCK = 1024


def round_seed(seed: int, r: int) -> int:
    return (int(seed) * 1_000_003 + 7919 * (r + 1)) % 2 ** 63


def draw(traffic: dict, vocab: int, d_trainable: int, seed: int, r: int,
         device, noise: bool = True) -> dict:
    f = traffic["firm"]
    k, c, b = f["local_steps"], f["n_clients"], f["batch_size"]
    p, t = traffic["prompt_len"], traffic["max_new"]
    g = torch.Generator(device=device).manual_seed(round_seed(seed, r))
    prompts = torch.randint(0, vocab, (k, c, b, p), generator=g,
                            device=device)
    if not noise:
        return {"prompts": prompts}
    gumbel = torch.rand((k, c, t, b, vocab), generator=g, device=device)
    gumbel.clamp_(min=torch.finfo(gumbel.dtype).tiny).log_().neg_().log_() \
        .neg_()
    rows = -(-d_trainable // BLOCK)
    bits = torch.randint(-2 ** 31, 2 ** 31, (c, rows, BLOCK),
                         dtype=torch.int32, generator=g, device=device)
    return {"prompts": prompts, "gumbel": gumbel, "up_bits": bits}
