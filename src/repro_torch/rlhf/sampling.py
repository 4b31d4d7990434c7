"""Autoregressive response generation with the decode cache.

Counterpart of ``repro.rlhf.sampling.generate``.  Sampling is the argmax of
the tempered logits plus Gumbel noise, which is what
``jax.random.categorical`` computes.  The noise comes from ``generator``,
or is injected whole as ``gumbel`` (``(max_new, B, V)``), so that a test
can hand the port JAX's own draws.

The reference compiles its decode loop (``jit`` around a ``lax.scan``
over the steps).  The port's counterpart is one decode step on static
buffers (``_step``: the input token, the noise, and the output tokens and
logprobs, written at column ``pos - P`` on the device), which on CUDA is
captured once a call as a CUDA graph (``_StepGraph``) and replayed
``max_new - 1`` times; elsewhere the same step runs eagerly.  Step 0 runs
eagerly on the graph's side stream before the capture: it is real work
and the warm-up of every lazy first call.  Before each step the noise is
drawn (or copied, when injected) into its buffer outside the graph, so
the draws are the eager loop's.  The kernels' launch counters are moved
for the replays (``kernels.counters``), and ``decode_captures`` counts
the captures (one a ``decode`` call, which the plan audit reports).  No
garbage collection runs during a capture (``no_collection``).  A capture
or replay that fails raises; nothing falls back to the eager loop, which
stays as ``_decode_eager`` for the tests and ``chip_smoke.py`` to hold
the graph against.  While the NaN check is on (``obs.debug``) nothing is
captured: every step runs eagerly (``step_graph``).  ``generate`` is a
program of ``obs.jitwatch``.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import time
from typing import Optional

import torch

from repro_torch import trees
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import counters
from repro_torch.models import transformer
from repro_torch.obs import debug, jitwatch
from repro_torch.rng import (categorical, gumbel_from_uniform, gumbel_noise,
                             uniform_noise)

# per device: the side stream that captures, and the last graph
# captured, whose memory pool the next capture shares.  A pool lives as
# long as a graph captured into it (in the device's and the pinned host
# allocator alike), so the last graph is kept until the next one is
# captured; it is never replayed again.
_SIDE_STREAMS: dict = {}
_LAST_GRAPHS: dict = {}
# decode-step graphs captured so far
decode_captures = 0


def side_stream(device) -> "torch.cuda.Stream":
    """The device's side stream, on which every graph of the port (the
    decode step's, the local update's) is warmed and captured.  Each use
    starts by waiting for the current stream, so a block freed on it is
    reused only after the current stream's earlier work."""
    device = torch.device(device)
    key = device.index if device.index is not None \
        else torch.cuda.current_device()
    if key not in _SIDE_STREAMS:
        _SIDE_STREAMS[key] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[key]


@contextlib.contextmanager
def no_collection():
    """Python's cyclic garbage collector off for the block (as it was
    after it).  A CUDA graph freed while another is being captured (a
    dropped trainer's update graph, collected with the trainer's
    reference cycles) destroys its executable graph, which a capture in
    progress does not permit: the capture is lost.  So no collection runs
    during a capture."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _check_noise(generator, gumbel) -> None:
    if (generator is None) == (gumbel is None):
        raise ValueError("pass exactly one of generator= and gumbel=")


@torch.no_grad()
def _generate(cfg: ModelConfig, params, prompt: torch.Tensor, *,
              max_new: int = 32, temperature: float = 1.0,
              generator: Optional[torch.Generator] = None,
              gumbel: Optional[torch.Tensor] = None,
              aux: Optional[dict] = None):
    """prompt: (B, P) -> (tokens (B, P+max_new), logprobs, mask).

    logprobs are the sampling logprobs at generated positions, 0 elsewhere;
    mask is 1.0 on generated positions.  Tokens are int64.  ``aux`` is
    the modality stub of a config with cross blocks, read by the prefill,
    which leaves the cross K/V in the cache for every decode step.

    As in the reference, the prefill logits are not used: the last prompt
    token is fed again as the first decode input, at position P, so it
    sits twice in the cache (and a Mamba2 layer's state advances twice
    with it).
    """
    _check_noise(generator, gumbel)
    prompt = prompt.long()
    b, p = prompt.shape
    _, cache = transformer.prefill(cfg, params, prompt, aux,
                                   cache_len=p + max_new)
    new_toks, new_lps = decode(cfg, params, cache, prompt[:, -1:],
                               max_new=max_new, temperature=temperature,
                               generator=generator, gumbel=gumbel)
    zeros = torch.zeros((b, p), dtype=torch.float32, device=prompt.device)
    tokens = torch.cat([prompt, new_toks], dim=1)
    logprobs = torch.cat([zeros, new_lps], dim=1)
    mask = torch.cat([zeros, torch.ones((b, max_new), dtype=torch.float32,
                                        device=prompt.device)], dim=1)
    return tokens, logprobs, mask


generate = jitwatch.wrap("generate", _generate)


def generate_stacked(cfg: ModelConfig, params, prompts: torch.Tensor, *,
                     max_new: int = 32, temperature: float = 1.0,
                     generators=None, gumbel: Optional[torch.Tensor] = None,
                     aux: Optional[dict] = None):
    """C clients' generation over a (C, B, P) block: ``params`` holds the
    clients' parameters stacked on a leading axis, and client c's rollout
    is ``generate`` with its parameters, its prompts and its draws (one
    generator each in ``generators``, or its slice of ``gumbel``, (C,
    max_new, B, V)).  Returns stacked (C, B, P + max_new) tokens,
    logprobs and mask.  The reference vmaps one program over the
    clients; here each client's rollout is its own ``generate`` call (a
    decode graph of its own on the card).
    """
    c = prompts.shape[0]
    if (generators is None) == (gumbel is None):
        raise ValueError("pass exactly one of generators= and gumbel=")
    outs = [generate(cfg, trees.tree_map(lambda t, i=i: t[i], params),
                     prompts[i], max_new=max_new, temperature=temperature,
                     generator=None if generators is None else generators[i],
                     gumbel=None if gumbel is None else gumbel[i], aux=aux)
            for i in range(c)]
    return tuple(torch.stack(parts) for parts in zip(*outs))


@torch.no_grad()
def decode(cfg: ModelConfig, params, cache, last: torch.Tensor, *,
           max_new: int, temperature: float = 1.0,
           generator: Optional[torch.Generator] = None,
           gumbel: Optional[torch.Tensor] = None):
    """``max_new`` sampled steps from a prefilled ``cache`` (updated in
    place), the first fed ``last`` (B, 1) -> (tokens (B, max_new) int64,
    logprobs (B, max_new) f32).  On CUDA the steps after the first are
    replays of one captured graph (``step_graph``)."""
    graph = step_graph(last.device)
    return _decode(cfg, params, cache, last, max_new=max_new,
                   temperature=temperature, generator=generator,
                   gumbel=gumbel, graph=graph)


def step_graph(device) -> Optional["_StepGraph"]:
    """The graph a decode on ``device`` captures its step into: a
    ``_StepGraph`` on CUDA; None (every step eager) elsewhere and while the
    NaN check is on (``obs.debug.set_debug_nan``), whose checks read
    tensors back to the host."""
    if torch.device(device).type != "cuda" or debug.nans_enabled():
        return None
    return _StepGraph(device)


def _new_state(cfg: ModelConfig, cache, last: torch.Tensor, max_new: int,
               noise_dtype=torch.float32) -> dict:
    """The static buffers of the decode step: the cache, the position it
    starts at, the input token (B, 1), the noise (B, V) and the outputs
    (B, max_new)."""
    b, dev = last.shape[0], last.device
    return {"cache": cache, "start": cache["pos"].clone(),
            "tok": last.long().clone(),
            "noise": torch.empty((b, cfg.vocab), dtype=noise_dtype,
                                 device=dev),
            "tokens": torch.zeros((b, max_new), dtype=torch.long,
                                  device=dev),
            "logprobs": torch.zeros((b, max_new), dtype=torch.float32,
                                    device=dev)}


def _step(cfg: ModelConfig, params, state, *, temperature: float,
          from_uniform: bool) -> None:
    """One decode step on the static buffers of ``state``; what the graph
    captures, so nothing in it reads a tensor back to the host."""
    cache = state["cache"]
    col = (cache["pos"] - state["start"]).long()[None]   # output column
    logits, _ = transformer.decode_step(cfg, params, cache, state["tok"])
    logits = logits.float() / max(temperature, 1e-6)
    noise = state["noise"]
    if from_uniform:
        noise = gumbel_from_uniform(noise)
    nxt = categorical(logits, noise)
    lp = torch.log_softmax(logits, dim=-1).gather(-1, nxt[:, None])
    state["tokens"].index_copy_(1, col, nxt[:, None])
    state["logprobs"].index_copy_(1, col, lp)
    state["tok"].copy_(nxt[:, None])


def _decode(cfg: ModelConfig, params, cache, last: torch.Tensor, *,
            max_new: int, temperature: float,
            generator: Optional[torch.Generator] = None,
            gumbel: Optional[torch.Tensor] = None, graph=None):
    """The decode runner.  ``graph`` None runs every step eagerly; else it
    is a ``_StepGraph`` (or, in the tests, a stand-in with its
    ``warm``/``capture``/``replay``)."""
    global decode_captures
    _check_noise(generator, gumbel)
    dev = last.device
    state = _new_state(cfg, cache, last, max_new,
                       torch.float32 if gumbel is None else gumbel.dtype)
    step = functools.partial(_step, cfg, params, temperature=temperature,
                             from_uniform=gumbel is None)

    def feed(i: int) -> None:
        if gumbel is None:
            uniform_noise(state["noise"].shape, generator=generator,
                          device=dev, out=state["noise"])
        else:
            state["noise"].copy_(gumbel[i])

    feed(0)
    if graph is None:
        step(state)
    else:
        graph.warm(step, state)
    if graph is not None and max_new > 1:
        before = counters.read()
        with no_collection():
            graph.capture(step, state)
        decode_captures += 1
        per_replay = counters.since(before)
        counters.add(per_replay, -1)              # the capture ran nothing
    for i in range(1, max_new):
        feed(i)
        if graph is None:
            step(state)
        else:
            graph.replay()
            counters.add(per_replay)
    return state["tokens"], state["logprobs"]


class _StepGraph:
    """One decode step as a CUDA graph, captured on a side stream into the
    pool of the device's last decode graph (``capture_begin``/
    ``capture_end``, not ``torch.cuda.graph``, whose entry synchronises
    and empties the allocator's cache) and replayed on the current
    stream.  The timings of its capture and instantiation are kept
    (``capture_s``, ``instantiate_s``, and ``ready_at``, the
    ``perf_counter`` at which the graph was ready), and the graph itself
    (``keep_graph``) for counting its nodes."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.key = self.device.index if self.device.index is not None \
            else torch.cuda.current_device()
        self.side = side_stream(self.device)
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.capture_s = self.instantiate_s = self.ready_at = None

    def warm(self, step, state) -> None:
        """Run ``step`` eagerly on the side stream: step 0, and the first
        call of everything it reaches (cuBLAS, the kernels' library)."""
        current = torch.cuda.current_stream(self.device)
        self.side.wait_stream(current)
        with torch.cuda.stream(self.side):
            step(state)
        current.wait_stream(self.side)

    def capture(self, step, state) -> None:
        current = torch.cuda.current_stream(self.device)
        self.side.wait_stream(current)
        last = _LAST_GRAPHS.get(self.key)
        t0 = time.perf_counter()
        with torch.cuda.stream(self.side):
            self.graph.capture_begin(
                pool=None if last is None else last.graph.pool())
            try:
                step(state)
            except BaseException:
                with contextlib.suppress(Exception):
                    self.graph.capture_end()
                raise
            self.graph.capture_end()
        t1 = time.perf_counter()
        self.graph.instantiate()
        self.ready_at = time.perf_counter()
        self.capture_s, self.instantiate_s = t1 - t0, self.ready_at - t1
        current.wait_stream(self.side)
        _LAST_GRAPHS[self.key] = self

    def replay(self) -> None:
        self.graph.replay()


@torch.no_grad()
def _decode_eager(cfg: ModelConfig, params, cache, last: torch.Tensor, *,
                  max_new: int, temperature: float = 1.0,
                  generator: Optional[torch.Generator] = None,
                  gumbel: Optional[torch.Tensor] = None):
    """The eager decode loop, step by step from Python, which ``decode``
    must match bit for bit: for the tests and ``chip_smoke.py``."""
    _check_noise(generator, gumbel)
    tok = last.long()
    new_toks, new_lps = [], []
    for i in range(max_new):
        logits, cache = transformer.decode_step(cfg, params, cache, tok)
        logits = logits.float() / max(temperature, 1e-6)
        noise = (gumbel[i] if gumbel is not None else
                 gumbel_noise(logits.shape, generator=generator,
                              device=logits.device))
        nxt = categorical(logits, noise)
        lp = torch.log_softmax(logits, dim=-1).gather(-1, nxt[:, None])[:, 0]
        new_toks.append(nxt)
        new_lps.append(lp)
        tok = nxt[:, None]
    return torch.stack(new_toks, dim=1), torch.stack(new_lps, dim=1)
