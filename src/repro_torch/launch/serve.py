"""Serving driver: batched prefill + decode (counterpart of
``repro.launch.serve``), with the same flags plus ``--device``.

Serves every architecture (``configs.get_config``): ``llama-3.2-1b``
(the default), the ``zamba2-1.2b`` hybrid, the MoE ``mixtral-8x7b``,
``xlstm-125m`` and the others.  A config with cross blocks gets the
reference's zero modality stub: (B, n_vision_tokens, d) vision tokens for
``llama-3.2-vision-90b``, (B, 2P, d) frames for ``whisper-large-v3``, in
bf16, read by the prefill (the cross K/V then sit in the cache for every
decode step).  Examples, on the card at full width:
  PYTHONPATH=src python -m repro_torch.launch.serve --preset full \
      --batch 16 --prompt-len 128 --max-new 128
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
      --preset full --batch 16 --prompt-len 128 --max-new 128
and on the CPU at the smoke size:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
      --device cpu

Decode runs through ``rlhf.sampling.decode``, the runner ``generate``
uses (on CUDA one captured decode step, replayed), with the generator
that drew the weights and the prompts: the tokens are ``generate``'s for
the same seed.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as device_lib
from repro_torch.configs import get_config
from repro_torch.models import transformer
from repro_torch.rlhf.sampling import decode


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def modality_stub(cfg, batch: int, prompt_len: int, device):
    """The reference's serving stub for a config with cross blocks (zeros
    in bf16), else None."""
    key = transformer.stub_key(cfg)
    if key is None:
        return None
    n = cfg.n_vision_tokens if key == "vision" else 2 * prompt_len
    return {key: torch.zeros((batch, n, cfg.d_model), dtype=torch.bfloat16,
                             device=device)}


def main(argv=None) -> torch.Tensor:
    """Parse ``argv`` (default: the command line), serve one batch, print
    timings; returns the generated tokens (B, max_new)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-3.2-1b")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = device_lib.resolve(args.device)
    cfg = get_config(args.arch)
    if args.preset == "smoke":
        cfg = cfg.reduced()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = transformer.init_params(cfg, generator=gen, device=dev)
    b, p = args.batch, args.prompt_len
    prompt = torch.randint(0, cfg.vocab, (b, p), generator=gen, device=dev)
    aux = modality_stub(cfg, b, p, dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = transformer.prefill(cfg, params, prompt, aux,
                                        cache_len=p + args.max_new)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    t0 = time.perf_counter()
    out, _ = decode(cfg, params, cache, prompt[:, -1:], max_new=args.max_new,
                    temperature=args.temperature, generator=gen)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    print(f"[serve] arch={cfg.name} device={dev} batch={b} prompt={p} "
          f"new={args.max_new}")
    print(f"  prefill: {t_prefill:.3f}s  decode: {t_decode:.3f}s "
          f"({b * args.max_new / max(t_decode, 1e-9):.1f} tok/s)")
    print("  sample token ids:", out[0, :16].tolist())
    return out


if __name__ == "__main__":
    main()
