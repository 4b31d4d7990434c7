"""PyTorch + CUDA port of the FIRM reproduction (``repro``) for NVIDIA Hopper.

Module names mirror ``repro`` so that each counterpart is easy to find.
The package imports torch, numpy and the standard library only; it never
imports JAX or anything of ``repro``.  Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``, and raise when no card is present.
"""
