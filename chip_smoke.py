#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py [--stop-after PHASE]

Phases, in order; any failure raises and the script exits non-zero
(``--stop-after`` ends the run after the named phase, with no result
line, for a first check of new kernels):

1. device:  the card's name and power limit; TF32 off for matmuls and cuDNN.
2. build:   one ``nvcc`` for each source of ``src/repro_torch/kernels/csrc``,
            all started together, then one link.
2b. launch: ``launch/`` on the card: ``make_host_mesh()`` over a world-1
            ``nccl`` group and the full llama-3.2-1b tree placed by
            ``param_shardings`` (each local shard its tensor, bit for
            bit); the dry-run's steps at full width with the batch cut
            (each cut reckoned first): ``train_4k``'s step at 2 x 4096,
            ``prefill_32k``'s at 2 x 32768, ``decode_32k``'s serve step at
            B = 32 against a full cache at position 32767, again on the
            same cache as DTensors laid out as a 16x16 mesh lays it out
            (slots on 'model', one shard a dim: the shard-local write and
            the softmax's all-reduces; logits and writes bit for bit the
            plain step's), the two-pod round (K = 2, 1 x 4096 a pod) whose
            trainables equal bit for bit across pods and the mean of each
            pod's solo steps, under the cost counter, which sees FedAvg's
            all-reduces (``fedavg_collective``, 13,631,488 bytes) and
            nothing else over 'pod', ``generate_stacked`` (2 clients x 16
            x 128, each client bit for bit its own ``generate``); the kernels'
            step against the plain versions' at 2 layers and B = 3 (the
            batch's logprobs the model's own; losses, the Gram, the
            trainables' change, lambda over the curvature); the flash kernel at S = 32768 on its last 256
            rows against the plain version, timed beside SDPA; each step's
            seconds (first and second call) and peak memory. The
            llama-3.2-1b dry-run runs beside the later phases in a
            subprocess and is read before the result lines: every pair
            ``ok`` but ``long_500k`` (``skipped``), on any torch.
3. rmsnorm: the CUDA kernel against its plain PyTorch version at the
            rollout's shapes, then timed beside ``F.rms_norm``.
4. flash:   the CUDA flash-attention kernel against its plain version
            (causal, ragged, non-causal, sliding window, f32, and zamba2's
            MHA with 32 query and 32 KV heads; then the tensor-core
            kernels' edges in bf16: Dh = 16, Sq = 1 and Skv = 1, S = 2048
            at B = 1 (32 key tiles of online softmax), GQA groups of 1, 4
            and 8, a window of 16), then head_dim 128 (mixtral's training
            shape B=16, S=256, 32 query and 8 KV heads; GQA groups of 1, 3,
            12 and 16; Sq = 1; windows of 16 and 4096 at B = 1, S = 4608;
            f32 within 1e-4), then the encoder-decoder and VLM shapes
            (``FLASH_ENCDEC_CASES``: whisper's non-causal encoder at
            S = 1500, cross-attention at Sq = 128 and 256 against 1500
            frames and 1601 vision tokens), the same bits from a second
            call, the
            path (tensor-core or FMA) that served each case, the HMMA
            instructions of each flash kernel (``cuobjdump -sass``) and the
            forward kernels' registers and spills; then timed beside
            ``F.scaled_dot_product_attention`` at the rollout's shape, at
            head_dim 128, at whisper's encoder shape and at the VLM's
            cross shape (Sq = 256).
5. gram:    the CUDA Gram kernel against its plain version at the local
            step's shape (2, 3,407,872) f32 and off it (M = 3 and 8, ragged
            d, bf16, a misaligned row; FedCMOO's server solve on a sketch,
            M = 2 at d = 8 and 64, and M = 4 at d = 1000), twice for the
            same bits; one CUDA
            kernel a call (the nodes of a CUDA graph captured from one
            call; ``torch.profiler``'s count is reported); then timed beside
            ``X @ X.T``, held and with the L2 flushed before each call.
6. quantize, 7. dequantize: the CUDA kernels against their plain versions,
            bit for bit (codes, scales, decoded values and the
            error-feedback residual), at the round's uplink shape
            (2 x 3328, 1024), padded rows, all-zero rows, round-to-nearest
            bits and bits >= 2**32 - 128, for int8 and int4; then timed
            (dequantize beside ``codes * scales``).
8. topk:    the CUDA threshold count and mask against their plain versions,
            exactly (counts equal, masks equal bit for bit), at the round's
            uplink shape (2, 3328, 1024) and off it (thresholds 0, negative,
            a median, a tie and above the max; all-zero rows, ties, -0.0, a
            ragged last row; C = 1, 2 and 3); then the whole top-k
            selection (32 bisection passes and the support) through the
            count kernel against the plain count's, bit for bit; timed
            beside ``torch.topk``.
9. ssd:     the CUDA SSD chunked-scan kernel against its plain version
            (``ref.ssd_chunked``) and both against the exact recurrence
            (``ref.ssd_scan``), y and the final state, at zamba2's rollout
            shapes (x (16, S, 64, 64) as a strided view into the
            convolution's output, S = 128 and 256), at ragged S = 1, 100,
            129 and 200, B = 1, a head with all-zero dt, ds = 16 (the
            smoke preset) and rows that are not 16-byte aligned; the same
            bits twice and from a contiguous copy;
            one CUDA kernel a call; HMMA instructions in both instances
            (``cuobjdump -sass``), at least two blocks an SM at ds = 64
            (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), the
            kernel's registers, spills and shared memory; then timed, held
            and with the L2 flushed before each call, beside its bound by
            bytes and TF32 operations and the FMA-f32 bound.
10. rmsnorm_bwd, 11. flash_bwd: the backward kernels against their plain
            versions (autograd of the plain forward) at the local step's
            shapes and off them (the forwards' extra cases, the flash
            kernels' new edges included), the same bits twice, then timed
            beside the backward of ``F.rms_norm`` and of SDPA (flash_bwd
            also at head_dim 128 and at the encoder-decoder and VLM shapes,
            whose cases it runs too, with the backward kernels' registers
            and spills).  rmsnorm_bwd also computes dg (a model without
            adapters trains its norms) at xlstm's shape and off it, against
            the plain formula (``ref.rmsnorm_dg``) and autograd, dx the
            same bits as without it, timed with and without and beside
            autograd of ``F.rms_norm`` for dx and dg together.  flash_bwd
            also sets the kernel's dq, dk, dv beside autograd of the plain
            f32 forward and beside FlashAttention-2's formula with D from
            the bf16 O, to measure what D from the bf16 O adds to the
            kernel's distance from f32.
12. ssd_bwd: the SSD backward kernels (``ssd_scan_bwd``: the chunk
            boundary states, one block a (batch row, group of heads,
            chunk), the sum of dB and dC over head groups) against the
            plain version (autograd of ``ref.ssd_chunked``) and the
            kernels' formulas written out (``ref.ssd_chunked_bwd``), dx,
            dB, dC, d(dt) and d(da), at the ssd phase's cases and at two of
            many chunks (S = 1000 in 8 chunks, and ds = 16 at S = 640 in
            5), with and without a d(final state); the same bits twice and
            from contiguous inputs; one forward and one backward launch
            through ``ops.ssd_scan`` with inputs that need a gradient;
            ``BWD_KERNELS`` CUDA kernels a call (a captured graph's nodes);
            registers and spills, the chunk kernel's blocks an SM and
            shared memory a block; timed held and with the L2 flushed,
            beside the plain backward and the bound.
13. rollout: ``fed.engine.rollout_batch`` on llama-3.2-1b at full width
            (random weights from a seeded generator): 16 prompts of 128
            tokens, 128 new tokens, 2 objectives.  The kernels' launch counts
            are zeroed just before it and must be exactly 4290 (rmsnorm)
            and 32 (flash attention), and 0 for the others, just after.  The
            outputs are checked, and a teacher-forced bf16 forward through
            the kernels must agree with the plain bf16 forward within 2e-2
            of the logits' scale and be as close to the f32 forward as the
            plain one is.  Then, uncounted: the rollout's steps timed one by
            one, and 8 decode steps under ``torch.profiler`` for the
            device's idle share.
14. rollout_hybrid: the same rollout on zamba2-1.2b at full width (32
            Mamba2 layers, 6 applications of one shared attention block).
            The counts are zeroed just before it and must be exactly 64
            (ssd: 32 in prefill, 32 in the reference forward; decode runs
            the exact recurrence), 12 (flash attention) and 45 x 130 = 5850
            (rmsnorm), and 0 for the others, just after.  The outputs are
            checked; teacher-forced, the kernels' bf16 logits are as close
            to an f32 forward as the plain bf16 path's, and the f32 forward
            through the kernels matches the plain f32 forward within 1e-4
            of the logits' scale; the decode logits after prefill(200)
            match an f32 forward at position 200.  Then the steps timed one by one and 8
            profiled decode steps.
            Both rollouts' ``breakdown_s`` give the decode through the
            graph by part: ``decode_capture`` (capture and instantiate) and
            ``decode_replay`` (the 127 replays).
15. decode_graph: generation as a captured program, on llama-3.2-1b and
            zamba2-1.2b at full width (B=16, P=128, 128 new, bf16 cache,
            one generator seed): the decode through one captured CUDA graph
            of a decode step (``sampling._decode`` with a ``_StepGraph``,
            as ``generate`` and ``serve`` run it) against the eager loop
            (``sampling._decode_eager``): tokens and logprobs bit for bit;
            the counts zeroed just before the graph's decode and exactly
            rmsnorm x 128 steps just after; the graph's kernel nodes equal
            to the kernels one eager step of the captured function
            launches (``torch.profiler``, less its noise draw); at most 4
            launch calls of the host a replay; both decodes' seconds, the
            capture's and the instantiation's, the idle share of 8
            profiled replays and both decodes' peak memory.
16. local_step: ``fed.engine.client_local_steps`` on the same model, one
            client, K=2 local steps of B=16 prompts (each a rollout, then
            ``firm_local_step`` with FIRMConfig's defaults).  The counts are
            zeroed just before it and must be exact just after.  Then,
            uncounted: one ``firm_local_step`` on the rollout phase's batch
            (lambda on the simplex, finite losses, lora_A gradients exactly
            0 while lora_B = 0, adapters and counters moved), its time by
            part, peak memory and device idle share, and the M gradients
            through the kernels, through the plain versions and through an
            f32 copy of the model.
17. local_step_hybrid: the same on zamba2-1.2b at full width: the counts
            exact (per step the rollout's, one forward's and per pull 27
            SSD backwards, 6 attention backwards and 39 norm backwards);
            lora_A gradients 0 while lora_B = 0, one firm_local_step's
            time by part, peak memory and idle share, the kernels' bf16
            gradients as close to an f32 copy as the plain bf16 path's and
            the f32 gradients through the kernels within 1e-3 (relative L2)
            of the plain f32 path's.
18. update_graph: the local update as a captured program
            (``rlhf/update_graph.py``), on llama-3.2-1b and zamba2-1.2b at
            full width on the rollout phases' batches, FIRMConfig's
            defaults: two client states A and B take three carried
            updates in the order A, B, A through one ``UpdateGraphs``
            (warm, capture and replay, replay) and through the eager
            ``firm_local_step``, new states and metrics bit for bit; one
            ``linear`` graph update against the eager one, bit for bit;
            the counts zeroed just before and exact just after (per
            update one forward, per pull the backwards, one Gram for
            ``firm`` and none for ``linear``); the graph's kernel nodes
            equal to the eager update's kernel launches; fewer than 100
            host launch calls a replayed update, copies included; a copy
            of the frozen tree at new addresses (the same values, then one
            leaf changed) captured anew and an in-place write to a leaf
            of the original replayed as it is, each equal to the eager
            update; the update's seconds eager and replayed, capture and
            instantiate, the idle share of 8 profiled replays, peak memory
            and the graph's pool, and FedCMOO's eager server solve.  Every
            later phase that runs ``firm``, ``firm_unreg`` or ``linear``
            on the card runs it through the trainer's graphs, and so do
            the local_step phases (one ``UpdateGraphs`` a call).
19. round:  ``FederatedTrainer.run_round`` on the same model, C=2 clients,
            K=1, R=2 rounds, first the ``wan`` preset (int8+ef uplink,
            identity downlink), then the ``extreme`` preset (topk:0.05+ef
            uplink, int8 downlink).  Each preset's counts are zeroed just
            before its rounds and must be exact just after (wan: one
            quantize and one dequantize a round; extreme: 32 threshold
            counts, one quantize and one dequantize a round, no mask);
            comm_bytes must be exactly 68,210,688 (wan) and 19,137,344
            (extreme); lambda on the simplex, drift > 0, residuals carried.
            Seconds per round by part, the uplink codec's share, peak
            memory, a third wan round under ``torch.profiler`` for the
            device's idle share, then four more with the update captured
            and eager in turns (graph, eager, eager, graph).
20. round_hybrid: one ``wan`` round (C=2, K=1) on zamba2-1.2b at full
            width: the counts exact, comm_bytes exactly 2,623,488 (the
            reference's ledger, tests/test_torch_hybrid_training.py),
            lambda on the simplex, drift > 0, residuals carried; seconds by
            part and peak memory.
21. round_parity: R=3 carried ``wan`` rounds of a tiny f32 llama, a
            tiny f32 zamba2 (hd 64, ds 16: the SSD kernels forward and
            backward) and a tiny f32 mixtral (4 experts top 2, window 8,
            capacity factor 0.5: tokens drop) on the card and on the CPU,
            the same weights and
            injected draws, both decoding with an f32 K/V cache; the
            summaries held within tests/test_torch_round.py's tolerances.
            Then on the tiny llama R=3 carried rounds of ``firm_unreg``,
            ``linear`` and ``fedcmoo`` with identity codecs and one
            ``fedcmoo`` round with int8 gradients (the ``wan`` preset),
            held the same way (the steps of these three by
            tests/test_torch_algorithm_rounds.py's rule).  Then three
            carried rounds each of the tiny llama through the loop executor
            (``firm``), of ``fedcmoo`` through the loop executor with the
            int8 gradient uplink (its exchange phase: one quantize launch
            a step over the clients' gradient rows), and of ``firm``
            with client_local_steps=(1, 2, 1) (two cohorts; the injected
            draws padded to the largest K), held the same way.  Then one
            fused chunk of R=3 rounds of the tiny llama on each side
            (``run_rounds_fused`` with the draws injected), ``wan`` and
            ``wan`` up with the ``delta+int8`` downlink (its rounding bits
            injected), held the same way round by round.
22. algorithms: the baselines on llama-3.2-1b at full width, ``wan``
            preset: one ``fedcmoo`` round (C=2, K=2: each step the clients'
            M gradients up through the int8 codec in one quantize and one
            dequantize launch, the server's lambda through the Gram kernel)
            and one ``linear`` round (C=2, K=1).  Counts zeroed just before
            each round and exact just after (fedcmoo: Gram 2, quantize and
            dequantize 3 each, the rest the round phase's per client-step;
            linear: Gram 0); comm_bytes exactly 61,474,816 (fedcmoo) and
            34,105,344 (linear); fedcmoo's lambda rows equal, its gradient
            uplink bit for bit with the plain codec on the same rows and
            draws, each server lambda within 1e-4 over min(1, D) of
            ``server_solve`` with the plain Gram; linear's lambda the
            weights.  Seconds by part and the exchange's own (stack, codec,
            solve).
23. executors: the front door at full width (llama-3.2-1b, ``wan``, C=2):
            ``fed.api.plan(RunSpec(...))``, which must allocate nothing on
            the card (``torch.cuda.memory_allocated`` unchanged) and give
            d = 3,407,872, then ``.build(device="cuda", params=...)`` and one
            round of each of two plans: the loop executor
            (vectorized_clients=False, K=1; executor ``loop``, 10
            dispatches) and cohorts of client_local_steps=(1, 2) (executor
            ``vectorized``, local mode ``cohort``, cohorts [[1, 1], [1, 2]],
            10 dispatches).  Each plan's bytes (6,842,368 up, 27,262,976
            down) and dispatches equal the round's (comm_bytes exactly
            34,105,344; ``cohorts`` 0 and 2); counts zeroed just before each
            round and exact just after (the round phase's a client-step,
            gram once a client-step, one quantize and one dequantize); each
            client made its K steps.  Seconds by part, seconds a
            client-step beside the same call's ``wan`` rounds, peak memory.
24. fused:  the fused executor (``run_rounds_fused``) at full width
            (llama-3.2-1b, C=2, K=1) against the per-round executor from
            the same seed and weights, one trainer after the other: ``wan``
            over three chunks of 3 rounds (the second and third under
            ``torch.cuda.set_sync_debug_mode("error")``, the second also
            under ``torch.profiler``: exactly one device-to-host copy, the
            idle share, host launch calls) against six per-round rounds,
            ``mobile`` over one chunk of 2 against 2.  Bit for bit over
            the rounds both ran: every summary key but ``dispatches``, the
            global adapters and the residual rows; ``fused`` R and
            ``dispatches`` 3 / R; exact launches (the round phase's a
            round, times the rounds) and bytes; seconds a round of the
            third chunk against per-round rounds 4-6, peak memory a
            chunk.
25. sched:  the scheduled path at full width (llama-3.2-1b, ``wan``, B=16,
            P=128, 128 new tokens, K=1), each trainer built by
            ``plan(RunSpec(..., sched=SchedConfig(...))).build()`` and
            freed before the next: (a) ``sync`` (C=2, bimodal profiles of
            seed 1, a JSONL sink) against the bare engine from the same
            seed, 2 rounds: every summary key and the global adapters bit
            for bit, ``sim_time``, ``round_duration`` and
            ``client_seconds`` from ``client_round_segments`` over the
            rounds' measured bytes, one JSONL line a record; (b)
            ``fedbuff`` at zero staleness (C=B=2, homogeneous), 2
            aggregations: (a)'s per-client rewards, bytes and adapters
            bit for bit, staleness [0, 0] at weights 0.5; (c)
            ``deadline`` (C=4, participation 0.5, overselect 2, bimodal
            seed 1, quantile 0.2), 2 rounds: clients 0 and 2 dropped each
            round, the round the deadline long, the dropped clients'
            broadcasts on the ledger, the trace valid and its server
            track summing to the last ``sim_time``; (d) ``fedbuff``
            under staleness (C=4, B=2, uniform profiles of seed 0, beta
            gain 1), 3 aggregations: arrivals stale by 1 and 2 at
            discounted weights, two betas through one update graph (one
            key, one capture; its pool's bytes), flows and the in-flight
            counter in the trace.  Launches exact for each case (the
            round phase's a client-step; one quantize and one dequantize
            a sync or deadline round, one a fedbuff client), seconds a
            round or aggregation, peak memory, and one copy to the host
            a round or aggregation (``CopiesToHost``).
26. audit:  the plan audit (``obs.audit_run(tr).raise_on_drift()``) of
            the reference's smoke matrix at full width: llama-3.2-1b,
            ``firm``, C=2, K=1, through ``plan(RunSpec(...)).build()``,
            over {identity, int8+ef} uplinks x {per round, fused R=2},
            then zamba2-1.2b fused (``wan``, R=2); each report on a line
            of its own, held exactly: no update-graph capture after the
            warm-up, one copy to the host a round (1/2 fused), the plan's
            bytes, 10 programs a round, one decode capture a client-step,
            the round phases' kernel launches a round, and one more fused
            chunk under ``jitwatch.record()`` with one copy to the host
            (``CopiesToHost``).  Then the debug switches (``obs.debug``):
            a llama client-step with the NaN check on (no graph captured,
            the eager path's launches), a NaN in an adapter entry
            (``FloatingPointError`` naming the op), two steps with it off
            (one update capture, two decode captures), an f64 tensor in
            the rmsnorm wrapper (``TypeError``, no launch), and a
            full-width ``wan`` round with f64 as the default dtype (its
            outcome recorded).  Audit seconds, decode captures and their
            seconds.
27. moe:    mixtral-8x7b at full width (d 4096, 32 query and 8 KV heads
            of 128, d_ff 14336, 8 experts top 2, capacity factor 1.25,
            window 4096, vocab 32000), depth cut to 4 of its 32 layers
            (all 32 hold 93.4 GB in bf16, more than the card's 80), random
            weights from a seed: (a) one decode of B = 16 prompts of 128
            tokens, 128 new, through the captured step against the eager
            loop, bit for bit, launches exact; (b) one client's K = 2
            local steps through an update graph against the same rollouts
            and eager updates, bit for bit, launches exact, the graph's
            pool; (c) R = 2 ``wan`` rounds (C = 2, K = 1) through
            ``plan(RunSpec(...)).build()``: launches a round exact, each
            round's bytes the plan's (3,421,184 up, 13,631,488 down),
            seconds by part, peak memory, a third round profiled for the
            idle share; (d) one prompt of 4608 tokens (the window bites):
            the logits through the kernels against the plain path, the
            ring (position p at slot p % 4096), and 64 decode steps that
            wrap it through the captured step against the eager loop, bit
            for bit.
28. xlstm:  xlstm-125m at full width (d 768, 4 heads of 192, 12 layers of
            (mLSTM, mLSTM, sLSTM) x 4, chunk 128, vocab 50304, no
            adapters: 115,087,104 parameters, all trained), nothing cut
            but C, K and R: (a) one decode of B = 16 prompts of 128
            tokens, 128 new, through the captured step against the eager
            loop, bit for bit, launches exact; (b) one client's K = 2
            full-parameter local steps through an update graph against
            the same rollouts and eager updates, bit for bit, launches
            exact (every norm's backward with dg), the graph's pool;
            (c) R = 2 ``wan`` rounds (C = 2, K = 1) through
            ``plan(RunSpec(...)).build()``: launches a round exact, each
            round's bytes the plan's, the frozen reference's bits
            unchanged, seconds by part, peak memory, a third round
            profiled for the idle share; (d) Gram and the int8 codec
            kernels at this d (2 x 115,087,104) against their plain
            versions, the codec bit for bit, and timed.
29. encdec: whisper-large-v3 at full width (32 encoder and 32 decoder
            layers, d 1280, 20 heads of 64, 2,036,149,760 parameters) on
            frames (16, 1500, 1280) drawn from the seed, and
            llama-3.2-vision-90b at full width, depth cut to one period
            (4 ``attn`` and 1 ``cross`` of its 100 layers, 6,535,544,832
            parameters; all 100 hold ~181 GB) on 1601 vision tokens:
            (a) prefill and 128 decode steps of B = 16 prompts of 128
            tokens with the stub, through the captured step against the
            eager loop, bit for bit, launches exact; (b) local steps with
            the stub through an update graph against the eager updates,
            bit for bit (whisper K = 2 at B = 8, the largest of 16, 8 and
            4 whose reckoned update fits in 60 GB; vision one step at
            B = 16), launches exact; (c) each model's bf16 logits through
            the kernels no further from the plain f32 forward than the
            plain bf16 path's.
30. codecs: the ``powersgd`` uplink (lowrank:4+ef) and the ``delta+int8``
            downlink at the round's width, on the card and again through
            the port's CPU path with the same inputs and injected draws:
            delta bit for bit; low-rank on the script's usual draw and five
            draws of the phase's own generator, each client's decoded
            vector and residual within max(1e-4, 8 2**-24 cond(P)) of
            max |flat + state|, cond(P) of the card's range sample in
            float64; the low-rank payload's bytes equal ``nbytes_static``
            (59,392).
31. train:  the ``launch.train`` CLI at full width, 2 clients, 1 round,
            for llama-3.2-1b and for zamba2-1.2b.
32. serve:  the ``launch.serve`` CLI at full width, a few tokens, for
            llama-3.2-1b and zamba2-1.2b, and zamba2's smoke preset.

Every number is printed as JSON on a line of its own; the second-to-last
line holds the per-kernel table and the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or outside a
checkout, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import functools
import gc
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published peaks of one H100 SXM (dense): HBM bytes/s, FLOP/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}

B, P, MAX_NEW, N_OBJ = 16, 128, 128, 2
N_CLIENTS, ROUNDS = 2, 2       # the round phase: C clients, R rounds


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def bound_ms(n_bytes: float, flops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def parse_ptxas(log: str, name: str) -> dict:
    """Registers, spills and static shared memory of each instance of
    kernel ``name`` (e.g. ``ssd_scan_kernel``) in the log of an ``nvcc
    -Xptxas -v`` build."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            k = re.search(rf"{name}I(\w*?)Li(\d+)E", m[1])
            cur = None if k is None else f"{name}<" + (
                "bf16, " if "bfloat16" in k[1] else
                "f32, " if k[1] == "f" else "") + f"{k[2]}>"
            if cur:
                out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", ln)
        if m:
            out[cur]["spill_stores"] = int(m[1])
            out[cur]["spill_loads"] = int(m[2])
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[cur]["registers"] = int(m[1])
            sm_ = re.search(r"(\d+) bytes smem", ln)
            out[cur]["static_smem"] = int(sm_[1]) if sm_ else 0
            cur = None
    return out


PHASES = ("device", "build", "launch", "rmsnorm", "flash", "gram", "quantize",
          "dequantize", "topk", "ssd", "rmsnorm_bwd", "flash_bwd", "ssd_bwd",
          "rollout", "rollout_hybrid", "decode_graph", "local_step",
          "local_step_hybrid", "update_graph",
          "round", "round_hybrid", "round_parity", "algorithms", "executors",
          "fused", "sched", "audit", "moe", "xlstm", "encdec", "codecs",
          "train", "serve")
# The launch phase's kernels' step against the plain one (2 layers,
# B = 3, the batch's logprobs the model's own): the limits on the Gram
# (relative to its largest entry) and on the trainables' change (cosine,
# and norm of the difference relative to the plain change).  Read on an
# H100 80GB HBM3 at 700 W (torch 2.11): the Gram 1.8e-3 apart, the change
# at a cosine of 0.957 and 0.294 of its norm apart; with flash's dk scaled
# by 0.8 the Gram was 0.079 apart, with rmsnorm's dx scaled by 0.8 0.69
# (Adam's first step moves each trainable by about lr times its
# gradient's sign, so a scaled gradient shows in the Gram, not the change).
GRAM_REL, UPDATE_COS, UPDATE_REL = 1e-2, 0.9, 0.5

# flash-attention cases: (label, (b, sq, skv, hq, hkv, dh), dtype, causal,
# window).  The forward runs FLASH_CASES, FLASH_EDGE_CASES and
# FLASH_D128_CASES, the backward FLASH_BWD_CASES, FLASH_EDGE_CASES and
# FLASH_D128_CASES; scripts/flash_same_bits.py those below head_dim 128.
# dh = 32 and 16 and the two Sq != Skv cases cover the other head dims the
# kernels are built for and query and key lengths that differ
FLASH_CASES = [
    ("rollout S=256 causal", (B, 256, 256, 32, 8, 64), "bf16", True, 0),
    ("prefill S=128 causal", (B, P, P, 32, 8, 64), "bf16", True, 0),
    ("ragged S=77 causal", (2, 77, 77, 32, 8, 64), "bf16", True, 0),
    ("non-causal S=256", (2, 256, 256, 32, 8, 64), "bf16", False, 0),
    ("window 64 S=256", (2, 256, 256, 32, 8, 64), "bf16", True, 64),
    ("f32 ragged S=100", (2, 100, 100, 32, 8, 64), "f32", True, 0),
    ("dh=32 S=40 causal", (2, 40, 40, 8, 2, 32), "bf16", True, 0),
    ("dh=16 f32 S=33 causal", (2, 33, 33, 4, 1, 16), "f32", True, 0),
    ("Sq=50 Skv=130 non-causal", (2, 50, 130, 32, 8, 64), "bf16", False, 0),
    ("Sq=130 Skv=50 causal", (2, 130, 50, 32, 8, 64), "bf16", True, 0),
    ("zamba2 MHA S=256 causal", (B, 256, 256, 32, 32, 64), "bf16", True, 0),
]
# the tensor-core kernels' edges (a single query or key, 32 key tiles of
# online softmax, GQA groups of 1, 4 and 8, a window of 16 that leaves rows
# of a tile with no key)
FLASH_EDGE_CASES = [
    ("dh=16 S=33 causal", (2, 33, 33, 4, 1, 16), "bf16", True, 0),
    ("Sq=1 Skv=1 causal", (2, 1, 1, 32, 8, 64), "bf16", True, 0),
    ("Sq=1 Skv=77 non-causal", (2, 1, 77, 32, 8, 64), "bf16", False, 0),
    ("Sq=77 Skv=1 non-causal", (2, 77, 1, 32, 8, 64), "bf16", False, 0),
    ("S=2048 B=1 causal", (1, 2048, 2048, 32, 8, 64), "bf16", True, 0),
    ("GQA group 1 S=128 causal", (2, 128, 128, 8, 8, 64), "bf16", True, 0),
    ("GQA group 4 S=128 causal", (2, 128, 128, 32, 8, 64), "bf16", True, 0),
    ("GQA group 8 S=128 causal", (2, 128, 128, 32, 4, 64), "bf16", True, 0),
    ("window 16 S=200", (2, 200, 200, 32, 8, 64), "bf16", True, 16),
]
# the forward's cases but zamba2's, for the backward
FLASH_BWD_CASES = [
    ("local step S=256 causal", (B, 256, 256, 32, 8, 64), "bf16", True, 0),
    ("ragged S=77 causal", (2, 77, 77, 32, 8, 64), "bf16", True, 0),
    ("non-causal S=256", (2, 256, 256, 32, 8, 64), "bf16", False, 0),
    ("window 64 S=256", (2, 256, 256, 32, 8, 64), "bf16", True, 64),
    ("f32 ragged S=100", (2, 100, 100, 32, 8, 64), "f32", True, 0),
    ("dh=32 S=40 causal", (2, 40, 40, 8, 2, 32), "bf16", True, 0),
    ("dh=16 f32 S=33 causal", (2, 33, 33, 4, 1, 16), "f32", True, 0),
    ("Sq=50 Skv=130 non-causal", (2, 50, 130, 32, 8, 64), "bf16", False, 0),
    ("Sq=130 Skv=50 causal", (2, 130, 50, 32, 8, 64), "bf16", True, 0),
]
# head_dim 128 (mixtral, moonshot, phi4-mini, mistral-large, glm4):
# mixtral's training shape, GQA groups of 1, 3, 12 and 16, a single query,
# windows of 16 and 4096 at S = 4608 (where 4096 bites), a window of 100
# (more than a key tile and not a multiple of one: tiles the window cuts
# beside tiles it keeps whole), f32
FLASH_D128_CASES = [
    ("dh=128 mixtral S=256 causal", (B, 256, 256, 32, 8, 128), "bf16", True,
     0),
    ("dh=128 GQA group 1 S=128 causal", (2, 128, 128, 16, 16, 128), "bf16",
     True, 0),
    ("dh=128 GQA group 3 S=128 causal", (2, 128, 128, 24, 8, 128), "bf16",
     True, 0),
    ("dh=128 GQA group 12 S=128 causal", (1, 128, 128, 96, 8, 128), "bf16",
     True, 0),
    ("dh=128 GQA group 16 S=128 causal", (2, 128, 128, 32, 2, 128), "bf16",
     True, 0),
    ("dh=128 ragged S=77 causal", (2, 77, 77, 32, 8, 128), "bf16", True, 0),
    ("dh=128 Sq=1 Skv=1 causal", (2, 1, 1, 32, 8, 128), "bf16", True, 0),
    ("dh=128 Sq=1 Skv=77 non-causal", (2, 1, 77, 32, 8, 128), "bf16", False,
     0),
    ("dh=128 window 16 S=4608 B=1", (1, 4608, 4608, 32, 8, 128), "bf16",
     True, 16),
    ("dh=128 window 4096 S=4608 B=1", (1, 4608, 4608, 32, 8, 128), "bf16",
     True, 4096),
    ("dh=128 window 100 S=300", (2, 300, 300, 32, 8, 128), "bf16", True,
     100),
    ("dh=128 f32 ragged S=100 causal", (2, 100, 100, 32, 8, 128), "f32",
     True, 0),
    ("dh=128 f32 window 16 S=200", (2, 200, 200, 32, 8, 128), "f32", True,
     16),
    ("dh=128 f32 Sq=1 Skv=77 non-causal", (2, 1, 77, 32, 8, 128), "f32",
     False, 0),
    ("dh=128 f32 GQA group 3 S=64", (2, 64, 64, 24, 8, 128), "f32", True, 0),
]
# the encoder-decoder and VLM shapes (non-causal): whisper's encoder over
# the 1500 frames of its 30 s window, its cross-attention from 128 and 256
# decoder positions to them, and the VLM's from 128 and 256 positions to
# its 1601 vision tokens; forward and backward, from a generator of their
# own
FLASH_ENCDEC_CASES = [
    ("whisper encoder S=1500", (B, 1500, 1500, 20, 20, 64), "bf16", False,
     0),
    ("whisper cross Sq=128 Skv=1500", (B, 128, 1500, 20, 20, 64), "bf16",
     False, 0),
    ("whisper cross Sq=256 Skv=1500", (B, 256, 1500, 20, 20, 64), "bf16",
     False, 0),
    ("vision cross Sq=128 Skv=1601", (B, 128, 1601, 64, 8, 128), "bf16",
     False, 0),
    ("vision cross Sq=256 Skv=1601", (B, 256, 1601, 64, 8, 128), "bf16",
     False, 0),
]
TOPK_PASSES = 32               # bisection passes of one top-k selection
# the host's calls that put work on a stream, as torch.profiler names them
KERNEL_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                       "cuLaunchKernel", "cuLaunchKernelEx")
HOST_LAUNCH_CALLS = KERNEL_LAUNCH_CALLS + ("cudaGraphLaunch",
                                           "cudaMemcpyAsync",
                                           "cudaMemsetAsync")


class StopAfter(Exception):
    """Raised to end the run after the phase named by --stop-after."""


def main(argv=None) -> int:
    import torch

    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("--stop-after", choices=PHASES, default=None)
    stop_after = args.parse_args(argv).stop_after
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    children = []             # processes the run starts, stopped on exit
    try:
        return run(torch, stop_after, children)
    except StopAfter:
        print(f"chip_smoke: stopped after {stop_after}; no result",
              file=sys.stderr)
        return 3
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait()


def run(torch, stop_after, children: list) -> int:
    # each phase's seconds on the host's clock, from the end of the one
    # before it
    phase_s, phase_end = {}, [time.perf_counter()]

    def done(phase: str) -> None:
        now = time.perf_counter()
        phase_s[phase] = now - phase_end[0]
        phase_end[0] = now
        if phase == stop_after:
            emit(phase="seconds_by_phase", seconds=phase_s)
            raise StopAfter(phase)

    from repro_torch.comms import codec as codec_lib
    from repro_torch.comms import lowrank, make_codec, sparsify
    from repro_torch.configs import INPUT_SHAPES, FIRMConfig, get_config
    from repro_torch.configs.base import CODEC_PRESETS
    from repro_torch.core import fedcmoo, firm, mgda
    from repro_torch.data.partition import make_client_datasets
    from repro_torch.fed.engine import (EngineConfig, FederatedTrainer,
                                        client_local_steps, rollout_batch)
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import costs as kernel_costs
    from repro_torch.kernels import counters as launch_counts
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.comms import quantize as qcodec
    from repro_torch.kernels import gram as gram_mod
    from repro_torch.kernels import quantize as q_mod
    from repro_torch.kernels import rmsnorm as rn_mod
    from repro_torch.kernels import ssd as ssd_mod
    from repro_torch.launch import hlo_cost
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch import serve
    from repro_torch.launch import sharding as launch_sh
    from repro_torch.launch import steps as launch_steps
    from repro_torch.launch import train as train_cli
    from repro_torch.models import common, ssm, transformer
    from repro_torch.fed import algorithms as algorithms_lib
    from repro_torch.rlhf import critic, local, ppo, rewards, sampling
    from repro_torch.rlhf import update_graph
    from repro_torch.rlhf.sampling import generate
    from repro_torch.rng import uniform_noise
    from repro_torch.train import optim

    import numpy as np
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    dev = torch.device("cuda")
    F = torch.nn.functional

    def events():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    # device clock cycles per ms of torch.cuda._sleep, measured once
    start, end = events()
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    torch.cuda.synchronize()
    sleep_cycles_per_ms = 10_000_000 / start.elapsed_time(end)

    def timed_ms(fn, iters: int = 50, warmup: int = 5,
                 hold: bool = True) -> float:
        """Mean device time of ``fn`` over ``iters`` back-to-back calls.

        With ``hold``, a sleep kernel holds the stream while the host
        queues the calls, so the events time the device alone and not the
        host's cost per launch, which exceeds a short kernel's run time;
        the sleep is lengthened until it outlasts the queueing.
        """
        for _ in range(warmup):
            fn()
        sleep_ms = 20.0
        while True:
            torch.cuda.synchronize()
            start, end = events()
            if hold:
                torch.cuda._sleep(int(sleep_ms * sleep_cycles_per_ms))
            t0 = time.perf_counter()
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            queued_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            if not hold or queued_ms < sleep_ms:
                return start.elapsed_time(end) / iters
            sleep_ms *= 4

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def device_profile(fn, steps: int, cpu_ops: bool = True):
        """Device busy and idle share of ``fn`` under torch.profiler; the
        window runs from the first kernel's start to the last one's end.
        Read from kineto's raw events (an update's replays trace some
        70,000 kernels, too many to build the profiler's event tree in
        time).  None ("not measured") when the trace holds no device
        time.  ``cpu_ops=False`` records no host operator (the CUDA
        activity alone, whose runtime calls still give the host's launch
        calls), for a window of whole rounds."""
        torch.cuda.synchronize()
        activities = [torch.profiler.ProfilerActivity.CUDA]
        if cpu_ops:
            activities.append(torch.profiler.ProfilerActivity.CPU)
        with torch.profiler.profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        # one pass over the events (a chunk of rounds traces ~10^6)
        kernels, host = [], {}
        on_card = torch.autograd.DeviceType.CUDA
        on_host = torch.autograd.DeviceType.CPU
        for e in prof.profiler.kineto_results.events():
            kind = e.device_type()
            if kind == on_card:
                kernels.append((e.name(), e.start_ns(), e.duration_ns()))
            elif kind == on_host:
                name = e.name()
                if name in HOST_LAUNCH_CALLS:
                    host[name] = host.get(name, 0) + 1
        del prof
        if not kernels:
            return None
        copies = sum(n.startswith(("Memcpy", "Memset")) for n, _, _ in kernels)
        to_host = sum(n.startswith("Memcpy DtoH") for n, _, _ in kernels)
        busy = sum(d_ for _, _, d_ in kernels) / 1e3
        window = (max(t + d_ for _, t, d_ in kernels)
                  - min(t for _, t, _ in kernels)) / 1e3
        by_name = {}
        for n, _, d_ in kernels:
            by_name[n] = by_name.get(n, 0) + d_ / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        return {"steps": steps, "kernels_per_step": len(kernels) / steps,
                "memcpy_memset_per_step": copies / steps,
                "device_to_host_copies": to_host,
                "host_launches_per_step": sum(host.values()) / steps,
                "host_launch_calls": host,
                "device_busy_us_per_step": busy / steps,
                "window_us_per_step": window / steps,
                "device_idle_share": 1 - busy / window,
                "top_kernels_us_per_step": {n: t / steps for n, t in top}}

    counters = launch_counts.COUNTERS
    zero_counts, read_counts = launch_counts.zero, launch_counts.read

    # --------------------------------------------------------------- 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi, flush=True)
    emit(phase="device", name=kind, nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    done("device")

    # ---------------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in
             lib_path.with_suffix(".log").read_text().splitlines()
             if "ptxas info" in ln and ("Used" in ln or "spill" in ln)]
    emit(phase="build", seconds=build_s, library=str(lib_path.name),
         ptxas=ptxas)
    done("build")

    def ptxas_by_kernel(name: str) -> dict:
        """``parse_ptxas`` of the library's build log."""
        return parse_ptxas(lib_path.with_suffix(".log").read_text(), name)

    libcuda = ctypes.CDLL("libcuda.so.1")
    graph_kernel_node = 0          # CU_GRAPH_NODE_TYPE_KERNEL

    def graph_nodes_per_call(fn) -> list:
        """The type of each node of a CUDA graph captured from one call of
        ``fn`` (``graph_kernel_node`` for a kernel): what the call
        launches, counted by the driver."""
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        torch.cuda.synchronize()
        with torch.cuda.graph(graph):
            fn()
        return graph_node_types(graph)

    def graph_node_types(graph) -> list:
        """The type of each node of a captured ``keep_graph`` CUDA graph."""
        handle = ctypes.c_void_p(graph.raw_cuda_graph())
        n = ctypes.c_size_t(0)
        check(libcuda.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0,
              "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * n.value)()
        check(libcuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0,
              "cuGraphGetNodes")
        types = []
        for node in nodes:
            t = ctypes.c_int(-1)
            check(libcuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                             ctypes.byref(t)) == 0,
                  "cuGraphNodeGetType")
            types.append(t.value)
        return types

    def profiled_kernels(fn, calls: int = 3) -> int:
        """CUDA kernel events torch.profiler reports for ``calls`` calls
        of ``fn``: reported only, since for kernels launched through
        ctypes it can miss some or report one more."""
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return sum(e.device_type == torch.autograd.DeviceType.CUDA
                   for e in prof.events())

    def cold_ms(fn, iters: int = 20) -> float:
        """Mean device time of ``fn`` with the L2 cache flushed before each
        call (a 128 MB write: the L2 holds 50 MB), events around the call
        alone; a sleep kernel holds the stream while the host queues, as
        in timed_ms."""
        l2_flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device=dev)
        fn()
        sleep_ms = 20.0
        while True:
            pairs = [events() for _ in range(iters)]
            torch.cuda.synchronize()
            torch.cuda._sleep(int(sleep_ms * sleep_cycles_per_ms))
            t0 = time.perf_counter()
            for start, end in pairs:
                l2_flush.fill_(1.0)
                start.record()
                fn()
                end.record()
            queued_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            if queued_ms < sleep_ms:
                return sum(a.elapsed_time(b) for a, b in pairs) / iters
            sleep_ms *= 4

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, dtype, generator=None):
        return torch.randn(
            shape, generator=gen if generator is None else generator,
            device=dev).to(dtype)

    def identical(a, b) -> bool:
        """The same dtype, shape and bits."""
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.reshape(-1).contiguous().view(torch.uint8),
            b.reshape(-1).contiguous().view(torch.uint8))

    def clone_cache(cache):
        return {"slots": common.tree_map(lambda t: t.clone(), cache["slots"]),
                "pos": cache["pos"].clone()}

    def flat_out(out):
        new_state, metrics = out
        return (update_graph._state_leaves(new_state)
                + [metrics[k] for k in sorted(metrics)])

    def same_update(got, want) -> bool:
        g, w = flat_out(got), flat_out(want)
        return len(g) == len(w) and all(
            a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(g, w))

    def pool_bytes(graph):
        """Bytes of the segments of the graph's private pool, from the
        allocator's snapshot; None when the snapshot names no pool."""
        pool = tuple(graph.pool())
        segs = torch.cuda.memory_snapshot()
        if not segs or "segment_pool_id" not in segs[0]:
            return None
        return sum(sg["total_size"] for sg in segs
                   if tuple(sg["segment_pool_id"]) == pool)

    def wan_trainer(cfg_, fc_, params_):
        """A trainer of C = 2 clients, K = 1, R = 2 ``wan`` rounds at B =
        16, P = 128, 128 new, through ``plan(RunSpec(...)).build()``, on
        ``params_``: (trainer, plan)."""
        from repro_torch.fed import api as api_m
        fc_r = dataclasses.replace(fc_, n_clients=N_CLIENTS, local_steps=1,
                                   rounds=ROUNDS)
        up, down = CODEC_PRESETS["wan"]
        plan_ = api_m.plan(api_m.RunSpec(cfg_, fc_r, EngineConfig(
            prompt_len=P, max_new=MAX_NEW, uplink_codec=up,
            downlink_codec=down)))
        return plan_.build(device=dev, params=params_), plan_

    def wan_rounds(label, tr, plan_, per_round):
        """R rounds of ``tr``: each round's launches exactly
        ``per_round`` and its bytes the plan's; seconds by part, peak
        memory, a third round profiled for the idle share.  Returns (the
        record, round 1's launches)."""
        part_s = {}
        names_r = {"_broadcast": "downlink", "_local_phase": "local_phase",
                   "_delta_flat": "delta", "_uplink": "uplink_codec",
                   "_aggregate_flat": "aggregate", "_record": "summary"}

        def timed(name, fn):
            def run_part(*a, **kw):
                out, sec = wall(lambda: fn(*a, **kw))
                part_s.setdefault(names_r[name], []).append(sec)
                return out
            return run_part
        for name in names_r:
            setattr(tr, name, timed(name, getattr(tr, name)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        summaries, round_s, launches_r = [], [], []
        for r in range(ROUNDS):
            zero_counts()
            s_r, sec = wall(tr.run_round)
            launches_r.append(read_counts())
            summaries.append(s_r)
            round_s.append(sec)
            check(launches_r[-1] == per_round,
                  f"{label} round {r + 1} launches {launches_r[-1]}, "
                  f"expected {per_round}")
            check(s_r["comm_bytes"] == (r + 1) * (
                plan_.up_bytes_per_round + plan_.down_bytes_per_round)
                and sum(s_r["up_nbytes"]) == plan_.up_bytes_per_round
                and N_CLIENTS * s_r["down_nbytes"]
                == plan_.down_bytes_per_round
                and s_r["participants"] == list(range(N_CLIENTS)),
                f"{label} round {r + 1} bytes {s_r['comm_bytes']} against "
                f"the plan's {plan_.up_bytes_per_round} up, "
                f"{plan_.down_bytes_per_round} down")
            lam_pc = s_r["per_client_lam"]
            check((lam_pc >= 0).all() and abs(lam_pc.sum(-1) - 1).max() < 1e-5
                  and math.isfinite(s_r["kl"]),
                  f"{label} round {r + 1}: lambda on the simplex, finite KL")
        check(summaries[0]["param_drift"] > 0,
              f"{label}: clients drifted apart")
        round_peak = torch.cuda.max_memory_allocated()
        prof = device_profile(lambda: tr.run_round(), 1, cpu_ops=False)
        return {
            "preset": "wan", "clients": N_CLIENTS, "local_steps": 1,
            "rounds": ROUNDS, "d_trainable": tr.d_trainable,
            "plan": {"up_bytes_per_round": plan_.up_bytes_per_round,
                     "down_bytes_per_round": plan_.down_bytes_per_round,
                     "executor": plan_.executor},
            "comm_bytes": summaries[-1]["comm_bytes"],
            "seconds_per_round": round_s,
            "breakdown_s": {k: v[:ROUNDS] for k, v in part_s.items()},
            "peak_memory_bytes": round_peak,
            "launches_per_round": launches_r[0],
            "device_idle_share": None if prof is None
            else prof["device_idle_share"], "profile": prof,
            "param_drift": [s_["param_drift"] for s_ in summaries],
            "lam_mean": [s_["lam_mean"].tolist() for s_ in summaries],
            "kl": [s_["kl"] for s_ in summaries]}, launches_r[0]

    def moe_phase() -> dict:
        """The ``moe`` phase (the module docstring's 27): mixtral-8x7b at
        full width and 4 of its 32 layers.  Emits its record and returns
        each flash kernel's launches in one round of (c)."""
        mcfg = dataclasses.replace(get_config("mixtral-8x7b"), n_layers=4,
                                   n_periods=4)
        check(mcfg.head_dim == 128 and mcfg.sliding_window == 4096
              and mcfg.moe.n_experts == 8 and mcfg.moe.top_k == 2,
              f"mixtral-8x7b's config changed: {mcfg}")
        fc_m = FIRMConfig()
        g_m = torch.Generator(device=dev).manual_seed(28)
        torch.cuda.synchronize()
        held_before = torch.cuda.memory_allocated()
        m_ref, init_s = wall(lambda: transformer.init_params(
            mcfg, generator=g_m, device=dev))
        weight_bytes = sum(t.numel() * t.element_size()
                           for t in common.tree_leaves(m_ref))
        m_train0, m_frozen = common.split_trainable(m_ref)
        # a policy one training step away from the reference
        m_train = common.tree_map(lambda t: t + 1e-3 * torch.randn(
            t.shape, generator=g_m, device=dev), m_train0)
        m_policy = common.merge_trainable(m_train, m_frozen)
        m_prompts = make_client_datasets(1, mcfg.vocab, P, generator=g_m,
                                         device=dev)[0].next_batch(B)
        fwd_norms, n_l = 2 * mcfg.n_layers + 1, mcfg.n_layers
        none = {name: 0 for name in counters}
        record = {"model": mcfg.name, "layers": mcfg.n_layers,
                  "params": mcfg.param_count(),
                  "active_params": mcfg.param_count(active_only=True),
                  "weight_bytes": weight_bytes, "init_s": init_s,
                  "memory_held_before_bytes": held_before}

        # (a) one rollout's decode through the captured step against the
        # eager loop: B = 16 prompts of 128 tokens, 128 new
        record["decode"] = decode_vs_eager(mcfg, m_policy, m_prompts, None, 5)
        check(record["decode"]["launches"] == dict(
            none, rmsnorm=fwd_norms * (MAX_NEW + 1), flash_attention=n_l),
              f"moe decode launches {record['decode']['launches']}")

        # (b) one client, K = 2 steps (rollout, then the FIRM update)
        # through an update graph against the same rollouts and eager
        # updates
        k_m = 2
        state0 = local.init_client_state(m_train, fc_m.n_objectives,
                                         mcfg.d_model,
                                         kl_coef=fc_m.kl_coef_init,
                                         device=dev)
        prompts_k = torch.stack([m_prompts.roll(k, 0) for k in range(k_m)])
        record["local_steps"] = steps_vs_eager(
            mcfg, fc_m, state0, m_frozen, m_ref, prompts_k, None, 40)
        per_client_step = dict(
            none, rmsnorm=fwd_norms * (MAX_NEW + 3),
            flash_attention=3 * n_l, rmsnorm_bwd=N_OBJ * 2 * n_l,
            flash_attention_bwd=N_OBJ * n_l, gram=1)
        check(record["local_steps"]["launches"] == {
            k: k_m * v for k, v in per_client_step.items()},
              f"moe local steps' launches {record['local_steps']['launches']}")
        del state0
        release_m()

        # (c) R = 2 wan rounds, C = 2, K = 1, through the front door
        tr, plan_m = wan_trainer(mcfg, fc_m, m_ref)
        check(tr.d_trainable == plan_m.d_trainable == 1_703_936
              and plan_m.up_bytes_per_round == 3_421_184
              and plan_m.down_bytes_per_round == 13_631_488,
              f"moe d_trainable {tr.d_trainable}, plan {plan_m.summary()}")
        per_round = {k: N_CLIENTS * v for k, v in per_client_step.items()}
        per_round.update(quantize=1, dequantize=1)
        record["rounds"], launches_r = wan_rounds(mcfg.name, tr, plan_m,
                                                  per_round)
        del tr
        release_m()

        # (d) the window at full width: one prompt of 4608 tokens (the
        # window of 4096 bites), then 64 new tokens on the ring
        p_long, new_long = 4608, 64
        long_prompt = torch.randint(0, mcfg.vocab, (1, p_long),
                                    generator=g_m, device=dev)
        with torch.no_grad():
            zero_counts()
            fwd_k, fwd_k_s = wall(lambda: transformer.forward_seq(
                mcfg, m_policy, long_prompt, collect_kv=True))
            check(read_counts()["flash_attention"] == n_l,
                  "moe long prompt: one flash launch a layer")
            logits = {"kernels": fwd_k["logits"].float(),
                      "plain": transformer.forward_seq(
                          mcfg, m_policy, long_prompt,
                          use_kernel=False)["logits"].float()}
            policy32 = common.tree_map(lambda t: t.float(), m_policy)
            for name, kern in (("f32_kernels", True), ("f32_plain", False)):
                logits[name] = transformer.forward_seq(
                    mcfg, policy32, long_prompt,
                    use_kernel=kern)["logits"].float()
            del policy32
        want32 = logits["f32_plain"]
        scale = max(1.0, float(want32.abs().max()))

        def dist(a, b):
            d_ = (a - b).abs()
            return {"max_abs": float(d_.max()), "mean_abs": float(d_.mean()),
                    "q999_abs": float(torch.quantile(d_.flatten()[::97],
                                                     0.999))}
        long_rec = {"prompt_len": p_long, "max_new": new_long,
                    "window": mcfg.sliding_window, "forward_s": fwd_k_s,
                    "logits_scale": scale,
                    "kernels_vs_f32": dist(logits["kernels"], want32),
                    "plain_vs_f32": dist(logits["plain"], want32),
                    "kernels_vs_plain": dist(logits["kernels"],
                                             logits["plain"]),
                    "f32_kernels_vs_f32_plain": dist(logits["f32_kernels"],
                                                     want32)}
        # bf16 by the f32 rule: the kernels' logits no further from the f32
        # forward than the plain bf16 path's (1.25x on the mean).  A
        # last-bit difference at a near-tie of the router moves a token's
        # expert, and through the capacity and the later layers' attention
        # other tokens, so no bf16 path stays within 2e-2 of another here
        # (on an H100: max 4.77 of a scale of 6.0).  The f32 forward
        # through the kernels (the FMA path) against the plain f32 forward:
        # 1e-3 of the scale on 99.9% of a 1/97 sample.
        check(long_rec["kernels_vs_f32"]["mean_abs"]
              <= 1.25 * long_rec["plain_vs_f32"]["mean_abs"]
              and long_rec["f32_kernels_vs_f32_plain"]["q999_abs"]
              <= 1e-3 * scale,
              f"moe long prompt: {long_rec}")
        del logits, want32
        k_all = fwd_k["kv"]["0"]["k"]
        del fwd_k
        (_, cache_l), prefill_s = wall(lambda: transformer.prefill(
            mcfg, m_policy, long_prompt, cache_len=p_long + new_long))
        c_ring = cache_l["slots"]["0"]["k"].shape[2]
        ring_slots = torch.arange(p_long - c_ring, p_long, device=dev) % c_ring
        check(c_ring == mcfg.sliding_window
              and identical(cache_l["slots"]["0"]["k"][:, :, ring_slots],
                            k_all[:, :, -c_ring:]),
              "moe long prompt: prefill's ring holds position p at slot "
              "p % 4096")
        del k_all
        before = cache_l["slots"]["0"]["k"].clone()
        cache_e = clone_cache(cache_l)
        (tok_lg, lp_lg), long_graph_s = wall(lambda: sampling._decode(
            mcfg, m_policy, cache_l, long_prompt[:, -1:], max_new=new_long,
            temperature=1.0, generator=torch.Generator(
                device=dev).manual_seed(7), graph=sampling._StepGraph(dev)))
        (tok_le, lp_le), long_eager_s = wall(lambda: sampling._decode_eager(
            mcfg, m_policy, cache_e, long_prompt[:, -1:], max_new=new_long,
            temperature=1.0, generator=torch.Generator(
                device=dev).manual_seed(7)))
        check(identical(tok_lg, tok_le) and identical(lp_lg, lp_le)
              and all(identical(a, b_) for a, b_ in zip(
                  common.tree_leaves(cache_l["slots"]),
                  common.tree_leaves(cache_e["slots"]))),
              "moe long decode: the captured ring decode is not the eager "
              "loop's bit for bit")
        # the decode wrote positions 4608..4671 at slots 512..575 and
        # left the others as prefill laid them out
        moved = (cache_l["slots"]["0"]["k"] != before).flatten(3).any(
            -1).any(0).any(0)
        written = torch.zeros(c_ring, dtype=torch.bool, device=dev)
        written[torch.arange(p_long, p_long + new_long, device=dev)
                % c_ring] = True
        check(int(cache_l["pos"]) == p_long + new_long
              and torch.equal(moved, written),
              "moe long decode: positions 4608..4671 went to slots "
              "p % 4096 and nowhere else")
        long_rec.update(prefill_s=prefill_s, decode_graph_s=long_graph_s,
                        decode_eager_s=long_eager_s,
                        ring_slots=c_ring)
        record["long_window"] = long_rec
        del cache_l, cache_e, before
        del m_ref, m_policy, m_train, m_train0, m_frozen
        release_m()
        emit(phase="moe", **record,
             tolerance="graphs bit for bit their eager paths; launches and "
             "bytes exact; long prompt: the kernels' bf16 logits no further "
             "from the plain f32 forward than the plain bf16 path's (1.25x "
             "on the mean), the f32 kernels within 1e-3 of the scale of the "
             "plain f32 forward on 99.9% of a 1/97 sample")
        return {name: launches_r[name]
                for name in ("flash_attention", "flash_attention_bwd")}

    def decode_vs_eager(cfg_, params_, prompts_, aux_, seed):
        """One rollout's decode (prefill with the stub ``aux_``, then
        MAX_NEW steps) through the captured step and through the eager
        loop, which must agree bit for bit.  Returns the record: seconds
        of each, the graph's capture and instantiation, its launches (the
        prefill's and the replays') and peak memory."""
        def decode_with(graph):
            cache = transformer.prefill(cfg_, params_, prompts_, aux_,
                                        cache_len=P + MAX_NEW)[1]
            fn = sampling._decode if graph else sampling._decode_eager
            kw = {"graph": sampling._StepGraph(dev)} if graph else {}
            return fn(cfg_, params_, cache, prompts_[:, -1:],
                      max_new=MAX_NEW, temperature=1.0,
                      generator=torch.Generator(device=dev).manual_seed(
                          seed), **kw)
        decode_with(True)                     # warm-up: cuBLAS, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        (tok_g, lp_g), graph_s = wall(lambda: decode_with(True))
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        g_last = sampling._LAST_GRAPHS[torch.cuda.current_device()]
        (tok_e, lp_e), eager_s = wall(lambda: decode_with(False))
        check(identical(tok_g, tok_e) and identical(lp_g, lp_e),
              f"{cfg_.name}: the captured decode's tokens and logprobs are "
              "not the eager loop's bit for bit")
        check(bool(((tok_g >= 0) & (tok_g < cfg_.vocab)).all()
                   & lp_g.isfinite().all() & (lp_g <= 0).all()),
              f"{cfg_.name} decode: token ids in range, finite logprobs")
        return {"batch": prompts_.shape[0], "prompt_len": P,
                "max_new": MAX_NEW, "graph_s": graph_s, "eager_s": eager_s,
                "capture_s": g_last.capture_s,
                "instantiate_s": g_last.instantiate_s,
                "seconds_per_step_graph": graph_s / MAX_NEW,
                "peak_memory_bytes": peak, "launches": launches}

    def steps_vs_eager(cfg_, fc_, state0, frozen_, ref_, prompts_k, aux_,
                       seed):
        """len(prompts_k) local steps of one client (rollout, then the
        FIRM update, with the stub ``aux_``) through an update graph (warm,
        then capture and replay; one step more on the first step's batch
        when K = 1, so that the graph is captured), then, with the graph
        freed, the same rollouts and eager updates: bit for bit.  Returns
        the record (seconds, launches, the pool's bytes, peak memory)."""
        bands_ = rewards.variant_bands(cfg_.vocab)
        tol_len = max(4, MAX_NEW // 2)
        k_ = prompts_k.shape[0]
        firm_alg = algorithms_lib.get_algorithm("firm")

        def gens():
            return [torch.Generator(device=dev).manual_seed(seed + k)
                    for k in range(k_)]

        def rollout(state, k, g_k):
            return rollout_batch(
                cfg_, common.merge_trainable(state.trainable, frozen_), ref_,
                prompts_k[k], *bands_, n_objectives=N_OBJ, max_new=MAX_NEW,
                length_tol=tol_len, generator=g_k, aux=aux_)
        runner = update_graph.UpdateGraphs()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        zero_counts()
        (st_g, met_g), k_graph_s = wall(lambda: client_local_steps(
            cfg_, fc_, state0, frozen_, ref_, *bands_, k_steps=k_,
            max_new=MAX_NEW, length_tol=tol_len, prompts=prompts_k,
            generators=gens(), graphs=runner, aux=aux_))
        launches = read_counts()
        batch0 = rollout(state0, 0, gens()[0])
        # K = 1: the graph's capture and replay; else a replay, timed
        out_c, replay_s = wall(lambda: firm_alg.step(
            cfg_, fc_, state0, frozen_, batch0, None, None, runner,
            aux=aux_))
        peak = torch.cuda.max_memory_allocated() - mem0
        g_upd = runner.graph("firm", cfg_, fc_, state0, frozen_, batch0,
                             (firm.config_tensor(fc_.beta, dev),), aux=aux_)
        check(runner.captures == 1 and g_upd is not None,
              f"{cfg_.name}: {runner.captures} update captures for one key")
        pool = pool_bytes(g_upd.graph)
        del runner, g_upd
        release_m()
        st_e, eager_upd_s = state0, []
        for k, g_k in enumerate(gens()):
            batch_k = rollout(st_e, k, g_k)
            if k == 0:
                check(all(identical(a, b_) for a, b_ in zip(batch_k,
                                                            batch0)),
                      f"{cfg_.name}: a rollout gave other bits")
            out_e, sec = wall(lambda: local.firm_local_step(
                cfg_, fc_, st_e, frozen_, batch_k, aux_))
            if k == 0:
                check(same_update(out_c, out_e),
                      f"{cfg_.name}: the captured update is not the eager "
                      "one bit for bit")
            st_e, met_e = out_e
            eager_upd_s.append(sec)
        check(all(identical(a, b_) for a, b_ in zip(
            update_graph._state_leaves(st_g),
            update_graph._state_leaves(st_e))) and identical(
                met_g["lam"][-1], met_e["lam"]),
              f"{cfg_.name}: {k_} steps through the update graph are not "
              "the eager updates bit for bit")
        return {"k_steps": k_, "batch": prompts_k.shape[1],
                "seconds": k_graph_s, "launches": launches,
                "update_eager_s": eager_upd_s, "update_graph_s": replay_s,
                "graph_pool_bytes": pool, "peak_memory_bytes": peak,
                "lam": met_g["lam"].tolist(), "kl": met_g["kl"].tolist()}

    def logits_vs_f32(cfg_, params_, tokens_, aux_):
        """The bf16 logits through the kernels and through the plain
        versions against the plain forward of an f32 copy of the model:
        the f32 rule (the kernels' no further from f32 than the plain
        bf16 path's, 1.25x on the mean)."""
        with torch.no_grad():
            kern = transformer.forward_seq(cfg_, params_, tokens_,
                                           aux_)["logits"].float()
            plain = transformer.forward_seq(cfg_, params_, tokens_, aux_,
                                            use_kernel=False)["logits"]
            plain = plain.float()
            p32 = common.tree_map(lambda t: t.float(), params_)
            a32 = {k: v.float() for k, v in aux_.items()}
            want = transformer.forward_seq(cfg_, p32, tokens_, a32,
                                           use_kernel=False)["logits"]
            want = want.float()
            del p32
        d_k, d_p = (kern - want).abs(), (plain - want).abs()
        rec = {"logits_scale": float(want.abs().max()),
               "kernels_vs_f32": {"max_abs": float(d_k.max()),
                                  "mean_abs": float(d_k.mean())},
               "plain_vs_f32": {"max_abs": float(d_p.max()),
                                "mean_abs": float(d_p.mean())}}
        check(bool(kern.isfinite().all()) and rec["kernels_vs_f32"][
            "mean_abs"] <= 1.25 * rec["plain_vs_f32"]["mean_abs"],
              f"{cfg_.name} logits by the f32 rule: {rec}")
        return rec

    def xlstm_phase() -> dict:
        """The ``xlstm`` phase (the module docstring's 28): xlstm-125m at
        full width, every parameter trained.  Emits its record and returns
        each kernel's launches in one round of (c)."""
        xcfg = get_config("xlstm-125m")
        check(xcfg.lora is None and xcfg.d_model == 768
              and xcfg.pattern == ("mlstm", "mlstm", "slstm")
              and xcfg.n_periods == 4 and xcfg.mlstm_chunk == 128,
              f"xlstm-125m's config changed: {xcfg}")
        fc_x = FIRMConfig()
        g_x = torch.Generator(device=dev).manual_seed(29)
        torch.cuda.synchronize()
        held_before = torch.cuda.memory_allocated()
        x_ref, init_s = wall(lambda: transformer.init_params(
            xcfg, generator=g_x, device=dev))
        leaves = common.tree_leaves(x_ref)
        n_params = sum(t.numel() for t in leaves)
        n_f32 = sum(t.numel() for t in leaves if t.dtype == torch.float32)
        check(n_params == 115_087_104 and n_f32 == 11_857_920,
              f"xlstm parameters {n_params}, f32 {n_f32}")
        x_train0, x_frozen = common.split_trainable(x_ref)
        check(x_train0 is x_ref and not common.tree_leaves(x_frozen),
              "xlstm: every parameter trainable")
        # a policy one training step away from the reference, each leaf
        # in its own dtype
        x_policy = common.tree_map(lambda t: (t.float() + 1e-3 * torch.randn(
            t.shape, generator=g_x, device=dev)).to(t.dtype), x_ref)
        x_prompts = make_client_datasets(1, xcfg.vocab, P, generator=g_x,
                                         device=dev)[0].next_batch(B)
        n_norms = 3 * xcfg.n_periods + 1
        none = {name: 0 for name in counters}
        record = {"model": xcfg.name, "layers": xcfg.n_layers,
                  "params": n_params, "f32_params": n_f32,
                  "weight_bytes": sum(t.numel() * t.element_size()
                                      for t in leaves),
                  "init_s": init_s, "memory_held_before_bytes": held_before}

        # (a) one rollout's decode: B = 16 prompts of 128 tokens, 128 new
        record["decode"] = decode_vs_eager(xcfg, x_policy, x_prompts, None, 5)
        check(record["decode"]["launches"] == dict(
            none, rmsnorm=n_norms * (MAX_NEW + 1)),
              f"xlstm decode launches {record['decode']['launches']}")

        # (b) one client, K = 2 full-parameter steps
        k_x = 2
        state0 = local.init_client_state(x_policy, fc_x.n_objectives,
                                         xcfg.d_model,
                                         kl_coef=fc_x.kl_coef_init,
                                         device=dev)
        prompts_k = torch.stack([x_prompts.roll(k, 0) for k in range(k_x)])
        record["local_steps"] = steps_vs_eager(
            xcfg, fc_x, state0, x_frozen, x_ref, prompts_k, None, 40)
        per_client_step = dict(
            none, rmsnorm=n_norms * (MAX_NEW + 3),
            rmsnorm_bwd=N_OBJ * n_norms, gram=1)
        check(record["local_steps"]["launches"] == {
            k: k_x * v for k, v in per_client_step.items()},
              f"xlstm local steps' launches "
              f"{record['local_steps']['launches']}")
        del state0, x_policy
        release_m()

        # (c) R = 2 wan rounds, C = 2, K = 1, through the front door, the
        # frozen reference unchanged
        tr, plan_x = wan_trainer(xcfg, fc_x, x_ref)
        check(tr.d_trainable == plan_x.d_trainable == n_params,
              f"xlstm d_trainable {tr.d_trainable}")
        ref_before = [t.clone() for t in common.tree_leaves(tr.ref_params)]
        per_round = {k: N_CLIENTS * v for k, v in per_client_step.items()}
        per_round.update(quantize=1, dequantize=1)
        record["rounds"], launches_r = wan_rounds(xcfg.name, tr, plan_x,
                                                  per_round)
        check(all(identical(a, b_) for a, b_ in zip(
            common.tree_leaves(tr.ref_params), ref_before)),
              "xlstm: the frozen reference moved in the rounds")
        record["rounds"].update(
            reference_unchanged=True, adam_moment_bytes=2 * 4 * n_params,
            update_graph_pool_bytes=[pool_bytes(e.graph.graph) for e in
                                     tr.update_graphs._entries.values()])
        del tr, ref_before
        release_m()

        # (d) Gram and the int8 codec kernels at this d (M = C = 2 rows of
        # 115,087,104), against their plain versions.  Over 115 M terms the
        # f32 sums of the two drift apart (by 5.0e-5 of the scale on an
        # H100), so each is held to an f64 Gram: the kernel no further
        # from it than the plain version, or 1e-5 of its scale
        xs = randn((N_OBJ, n_params), torch.float32, g_x)
        got, want = gram_mod.gram(xs), ref.gram(xs)
        x64 = xs.double()
        exact = (x64 @ x64.T).float()
        del x64
        gram_rec = {"shape": [N_OBJ, n_params],
                    "max_rel": max_rel(got, want),
                    "kernel_vs_f64": max_rel(got, exact),
                    "plain_vs_f64": max_rel(want, exact),
                    "same_bits_twice": identical(got, gram_mod.gram(xs)),
                    "ms": timed_ms(lambda: gram_mod.gram(xs), iters=10),
                    "plain_ms": timed_ms(lambda: ref.gram(xs), iters=10)}
        gram_rec["bound_ms"], gram_rec["bound_by"] = bound_ms(
            *kernel_costs.gram(xs))
        check(gram_rec["kernel_vs_f64"] <= max(1e-5, gram_rec["plain_vs_f64"])
              and gram_rec["same_bits_twice"], f"xlstm gram: {gram_rec}")
        rows = -(-n_params // 1024)
        x2 = torch.zeros((N_OBJ * rows * 1024,), device=dev)
        x2[:N_OBJ * n_params] = 1e-3 * xs.reshape(-1)
        x2 = x2.view(N_OBJ * rows, 1024)
        del xs, got, want, exact
        bits = torch.randint(-2 ** 31, 2 ** 31 - 1, x2.shape,
                             generator=g_x, device=dev, dtype=torch.int32)
        codes, scales = q_mod.quantize(x2, bits)
        codes_p, scales_p = ref.quantize(x2, bits)
        dec, res = q_mod.dequantize(codes, scales, x2)
        dec_p = ref.dequantize(codes_p, scales_p)
        res_p = ref.dequantize_residual(codes_p, scales_p, x2)
        codec_rec = {"rows": N_OBJ * rows,
                     "bit_for_bit": identical(codes, codes_p)
                     and identical(scales, scales_p)
                     and identical(dec, dec_p) and identical(res, res_p),
                     "quantize_ms": timed_ms(lambda: q_mod.quantize(
                         x2, bits), iters=10),
                     "dequantize_ms": timed_ms(lambda: q_mod.dequantize(
                         codes, scales, x2), iters=10)}
        codec_rec["quantize_bound_ms"], codec_rec["quantize_bound_by"] = \
            bound_ms(*kernel_costs.quantize(x2, bits))
        codec_rec["dequantize_bound_ms"], \
            codec_rec["dequantize_bound_by"] = bound_ms(
                *kernel_costs.dequantize(codes, scales, x2))
        check(codec_rec["bit_for_bit"], "xlstm codec kernels against the "
              "plain versions, bit for bit")
        del x2, bits, codes, scales, codes_p, scales_p, dec, res, dec_p, res_p
        record["gram"], record["codec"] = gram_rec, codec_rec
        del x_ref, x_train0, x_frozen, leaves
        release_m()
        emit(phase="xlstm", **record,
             tolerance="graphs bit for bit their eager paths; launches and "
             "bytes exact; the frozen reference bit for bit; Gram no "
             "further from an f64 Gram than the plain version, or 1e-5 of "
             "its scale; the codec kernels bit for bit")
        return {name: launches_r[name] for name in
                ("rmsnorm", "rmsnorm_bwd", "gram", "quantize", "dequantize")}

    def encdec_phase() -> dict:
        """The ``encdec`` phase (the module docstring's 29):
        whisper-large-v3 and one period of llama-3.2-vision-90b at full
        width with their modality stubs.  Emits its record and returns the
        launches of one whisper and one vision client-step."""
        record = {}
        none = {name: 0 for name in counters}
        fc_e = FIRMConfig()
        out = {}
        for name, cfg_, k_e, b_upd in (
                ("whisper", get_config("whisper-large-v3"), 2, 8),
                ("vision", dataclasses.replace(
                    get_config("llama-3.2-vision-90b"), n_layers=5,
                    n_periods=1), 1, B)):
            g_e = torch.Generator(device=dev).manual_seed(
                30 if name == "whisper" else 31)
            torch.cuda.synchronize()
            held_before = torch.cuda.memory_allocated()
            e_ref, init_s = wall(lambda: transformer.init_params(
                cfg_, generator=g_e, device=dev))
            n_params = common.tree_size(e_ref)
            check(n_params == {"whisper": 2_036_149_760,
                               "vision": 6_535_544_832}[name],
                  f"{name} parameters {n_params}")
            e_train0, e_frozen = common.split_trainable(e_ref)
            # a policy one training step away from the reference
            e_train = common.tree_map(lambda t: t + 1e-3 * torch.randn(
                t.shape, generator=g_e, device=dev), e_train0)
            e_policy = common.merge_trainable(e_train, e_frozen)
            # the stub: whisper's frames of a 30 s window (1500 frames,
            # arXiv:2212.04356), or the VLM's 1601 vision tokens
            key = transformer.stub_key(cfg_)
            n_aux = 1500 if key == "frames" else cfg_.n_vision_tokens
            aux_e = {key: randn((B, n_aux, cfg_.d_model), torch.bfloat16,
                                g_e)}
            prompts_e = make_client_datasets(
                1, cfg_.vocab, P, generator=g_e, device=dev)[0].next_batch(B)
            n_cross = cfg_.pattern.count("cross") * cfg_.n_periods
            dec_norms = (2 * cfg_.n_layers + n_cross + 1)
            fwd_norms = dec_norms + (2 * cfg_.encoder_layers + 1
                                     if cfg_.encoder_layers else 0)
            fwd_flash = cfg_.n_layers + n_cross + cfg_.encoder_layers
            rec = {"model": cfg_.name, "layers": cfg_.n_layers,
                   "encoder_layers": cfg_.encoder_layers, "params": n_params,
                   "weight_bytes": sum(t.numel() * t.element_size() for t in
                                       common.tree_leaves(e_ref)),
                   "aux": {key: list(aux_e[key].shape)},
                   "init_s": init_s, "memory_held_before_bytes": held_before}

            # (a) prefill and 128 decode steps, graph against eager
            rec["decode"] = decode_vs_eager(cfg_, e_policy, prompts_e, aux_e,
                                            7)
            check(rec["decode"]["launches"] == dict(
                none, rmsnorm=fwd_norms + dec_norms * MAX_NEW,
                flash_attention=fwd_flash),
                  f"{name} decode launches {rec['decode']['launches']}")

            # (b) local steps with the stub through the update graph
            state0 = local.init_client_state(e_train, fc_e.n_objectives,
                                             cfg_.d_model,
                                             kl_coef=fc_e.kl_coef_init,
                                             device=dev)
            aux_u = {key: aux_e[key][:b_upd]}
            prompts_k = torch.stack([prompts_e[:b_upd].roll(k, 0)
                                     for k in range(k_e)])
            rec["local_steps"] = steps_vs_eager(
                cfg_, fc_e, state0, e_frozen, e_ref, prompts_k, aux_u, 50)
            # the first norm (of the encoder, else of the decoder) reads no
            # tensor that needs a gradient: no backward there
            per_step = dict(
                none, rmsnorm=fwd_norms * 3 + dec_norms * MAX_NEW,
                flash_attention=3 * fwd_flash,
                rmsnorm_bwd=N_OBJ * (fwd_norms - 1 - (
                    1 if cfg_.encoder_layers else 0)),
                flash_attention_bwd=N_OBJ * fwd_flash, gram=1)
            check(rec["local_steps"]["launches"] == {
                k: k_e * v for k, v in per_step.items()},
                  f"{name} local steps' launches "
                  f"{rec['local_steps']['launches']}, per step {per_step}")
            out[name] = per_step
            del state0
            release_m()

            # (c) the bf16 logits by the f32 rule, two prompts
            rec["logits"] = logits_vs_f32(cfg_, e_policy, prompts_e[:2],
                                          {key: aux_e[key][:2]})
            record[name] = rec
            del e_ref, e_train0, e_frozen, e_train, e_policy, aux_e, aux_u
            release_m()
        emit(phase="encdec", **record,
             cuts={"whisper_update_batch": 8,
                   "vision_layers": "5 of 100 (one period)"},
             tolerance="graphs bit for bit their eager paths; launches "
             "exact; bf16 logits through the kernels no further from the "
             "plain f32 forward than the plain bf16 path's (1.25x on the "
             "mean)")
        return out

    def release_m():
        gc.collect()
        torch.cuda.empty_cache()

    # --------------------------------------------------------------- launch
    # launch/ on the card: the (1, 1) host mesh over a world-1 nccl group
    # and the steps of the dry-run, run on llama-3.2-1b at full width (16
    # layers, d 2048, 32/8 heads of 64, vocab 128256; random weights from
    # a generator of the phase's own, so that the later phases' inputs stay
    # as they were) at the dry-run's shapes with the batch cut; the dry-run
    # of llama-3.2-1b itself runs in a subprocess (a process has one
    # default process group: its fake one cannot share this one's), read
    # at the end of the script.
    dryrun_dir = tempfile.mkdtemp(prefix="dryrun_")
    dryrun_t0 = time.perf_counter()
    dryrun_proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama-3.2-1b", "--shape", "all", "--mesh", "both", "--out",
         str(Path(dryrun_dir) / "dryrun.json")],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 CUDA_VISIBLE_DEVICES=""),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    children.append(dryrun_proc)

    launch_mem0 = torch.cuda.memory_allocated()
    launch_gen = torch.Generator(device=dev).manual_seed(30)
    lcfg = get_config("llama-3.2-1b")
    lfc = FIRMConfig(n_objectives=N_OBJ, local_steps=2)
    lmesh = launch_mesh.make_host_mesh()
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1
          and tuple(lmesh.shape) == (1, 1)
          and lmesh.mesh_dim_names == ("data", "model"),
          "launch: make_host_mesh() is a (1, 1) mesh over a world-1 nccl "
          "group")
    lparams = transformer.init_params(lcfg, generator=launch_gen, device=dev)
    # non-zero lora_B: every adapter has a gradient
    for name in ("wq", "wk", "wv", "wo"):
        lparams["slots"]["0"]["attn"][name]["lora_B"].normal_(
            0.0, 0.02, generator=launch_gen)
    placed = launch_sh.place(lparams,
                             launch_sh.param_shardings(lparams, lmesh))
    check(all(torch.equal(p.to_local(), t) for p, t in zip(
        launch_sh.tree_leaves(placed), launch_sh.tree_leaves(lparams))),
        "launch: a local shard of the placed tree differs from its tensor")
    del placed
    ltrain, lfrozen = common.split_trainable(lparams)
    lstate0 = local.init_client_state(ltrain, N_OBJ, lcfg.d_model,
                                      lfc.kl_coef_init, device=dev)
    n_trainable = sum(t.numel() for t in launch_sh.tree_leaves(ltrain))
    check(n_trainable == 3_407_872, f"llama-3.2-1b has {n_trainable} "
          "trainable parameters, not 3,407,872")

    def model_logprobs(cfg_, params, tokens):
        """Per-token logprobs of ``tokens`` (leading dims, then S) under
        the model, without gradient, a sequence at a time."""
        flat = tokens.reshape(-1, tokens.shape[-1])
        with torch.no_grad():
            lp = [ppo.token_logprobs(transformer.forward_seq(
                cfg_, params, row[None])["logits"], row[None])
                for row in flat]
        return torch.cat(lp).reshape(tokens.shape)

    def launch_batch(b, s, lead=(), *, cfg_=None, train=None, frozen=None,
                     rewards=None):
        """A PPO batch: random tokens, the second half a response; the
        behaviour and reference logprobs the policy's own, so every ratio
        is 1 at the first step (the clipped objective's gradients are
        real) and the KL 0 (each objective's advantages its own reward's);
        ``rewards`` (B, M), or drawn from the generator."""
        cfg_ = cfg_ or lcfg
        train = ltrain if train is None else train
        frozen = lfrozen if frozen is None else frozen
        shape = lead + (b, s)
        mask = torch.zeros(shape, device=dev)
        mask[..., s // 2:] = 1.0
        tokens = torch.randint(0, cfg_.vocab, shape, generator=launch_gen,
                               device=dev, dtype=torch.int32)
        lp = model_logprobs(cfg_, common.merge_trainable(train, frozen),
                            tokens)
        if rewards is None:
            rewards = torch.randn(lead + (b, N_OBJ), generator=launch_gen,
                                  device=dev)
        return ppo.PPOBatch(tokens, mask, lp, lp.clone(), rewards)

    def peak_run(fn):
        """(fn's result, seconds, peak bytes allocated during it)."""
        torch.cuda.reset_peak_memory_stats()
        out, sec = wall(fn)
        return out, sec, torch.cuda.max_memory_allocated()

    def warm_s(fn) -> float:
        """Seconds of another call of ``fn``, its result dropped and its
        launches taken back (the path's launches are the first calls')."""
        def call():
            fn()
        before = read_counts()
        _, sec = wall(call)
        launch_counts.add(launch_counts.since(before), -1)
        return sec

    # the cuts, each reckoned before the run: a replayed update of 4096
    # tokens holds a 15,319,695,360-byte pool (PERF.md section 5), so a
    # train step of B x 4096 tokens about B times that beside the weights;
    # prefill keeps the bf16 logits of every position (2 V bytes a token)
    # and the K/V twice (collected and cached: 4 L Hkv Dh bytes each); the
    # decode cache is 2 L B S Hkv Dh bf16 and its step upcasts one layer's
    # K and V to f32
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in launch_sh.tree_leaves(lparams))
    s_train = INPUT_SHAPES["train_4k"].seq_len
    s_long = INPUT_SHAPES["prefill_32k"].seq_len
    kv_token = 2 * lcfg.n_layers * lcfg.n_kv_heads * lcfg.head_dim * 2
    reckon = {
        "train_4k": {b: weight_bytes + b * 15_319_695_360 for b in (4, 2, 1)},
        "prefill_32k": {b: weight_bytes + b * s_long * (
            2 * lcfg.vocab + 2 * kv_token) for b in (2, 1)},
        "decode_32k": {32: weight_bytes + 32 * s_long * kv_token
                       + 2 * 32 * s_long * lcfg.n_kv_heads * lcfg.head_dim
                       * 4},
    }
    train_b = next(b for b in (4, 2, 1) if reckon["train_4k"][b] < 60e9)
    prefill_b = next(b for b in (2, 1) if reckon["prefill_32k"][b] < 60e9)
    decode_b = 32
    check(reckon["decode_32k"][decode_b] < 60e9, "launch: the decode cut's "
          "reckoned memory is past 60 GB")
    launch_rec = {"model": lcfg.name, "nvidia_smi": smi,
                  "reckoned_bytes": {k: {str(b): v for b, v in d.items()}
                                     for k, d in reckon.items()},
                  "cuts": {"train_4k": f"batch 256 -> {train_b}",
                           "prefill_32k": f"batch 32 -> {prefill_b}",
                           "decode_32k": f"batch 128 -> {decode_b}",
                           "round": "2 pods, K = 2, 1 x 4096 a pod",
                           "long_500k": "skipped: full-attention arch"}}
    # the batches (their logprobs' forwards launch kernels) before the
    # counts are zeroed
    train_batch = launch_batch(train_b, s_train)
    pods, k_steps = 2, lfc.local_steps
    round_batches = launch_batch(1, s_train, lead=(pods, k_steps))
    zero_counts()
    # train_4k: one FIRM local step at S = 4096
    (lstate1, lmetrics), train_s, train_peak = peak_run(
        lambda: launch_steps.make_train_step(lcfg, lfc)(
            lstate0, lfrozen, train_batch))
    lam = lmetrics["lam"].float().cpu()
    check(sorted(lmetrics) == sorted(("losses", "lam", "lam_star", "gram",
                                      "kl", "grad_norm", "td_err",
                                      "ratio_mean"))
          and all(bool(torch.isfinite(v).all()) for v in lmetrics.values())
          and abs(float(lam.sum()) - 1.0) < 1e-3 and bool((lam >= 0).all())
          and abs(float(lmetrics["ratio_mean"]) - 1.0) < 1e-3,
          f"launch train step: metrics {sorted(lmetrics)}, lambda {lam}, "
          f"ratio_mean {float(lmetrics['ratio_mean'])} (the batch's "
          "logprobs are the policy's own)")
    launch_rec["train"] = {"batch": train_b, "seconds_first_call": train_s,
                           "seconds": warm_s(lambda: launch_steps
                                             .make_train_step(lcfg, lfc)(
                                                 lstate0, lfrozen,
                                                 train_batch)),
                           "peak_memory_bytes": train_peak,
                           "losses": lmetrics["losses"].tolist(),
                           "lam": lam.tolist(),
                           "ratio_mean": float(lmetrics["ratio_mean"]),
                           "kl": float(lmetrics["kl"]),
                           "gram": lmetrics["gram"].tolist()}
    emit(phase="launch", step="train", **launch_rec["train"])
    del lstate1, lmetrics, train_batch
    release_m()
    # prefill_32k: the sequence forward and the cache at S = 32768
    prefill_tokens = torch.randint(0, lcfg.vocab, (prefill_b, s_long),
                                   generator=launch_gen, device=dev,
                                   dtype=torch.int32)
    (last_logits, pcache), prefill_s, prefill_peak = peak_run(
        lambda: launch_steps.make_prefill_step(lcfg)(lparams,
                                                     prefill_tokens))
    check(tuple(last_logits.shape) == (prefill_b, lcfg.vocab)
          and bool(torch.isfinite(last_logits.float()).all())
          and int(pcache["pos"]) == s_long
          and tuple(pcache["slots"]["0"]["k"].shape) == (
              lcfg.n_periods, prefill_b, s_long, lcfg.n_kv_heads,
              lcfg.head_dim),
          "launch prefill step: last logits, cache or position")
    del last_logits, pcache
    launch_rec["prefill"] = {"batch": prefill_b,
                             "seconds_first_call": prefill_s,
                             "seconds": warm_s(lambda: launch_steps
                                               .make_prefill_step(lcfg)(
                                                   lparams, prefill_tokens)),
                             "peak_memory_bytes": prefill_peak}
    emit(phase="launch", step="prefill", **launch_rec["prefill"])
    del prefill_tokens
    release_m()
    # decode_32k: one step against a full cache drawn from the generator;
    # then the same step on the same cache laid out as the production
    # mesh lays it out (cache_shardings of a 16x16 mesh: batch on 'data',
    # slots on 'model') on the (1, 1) host mesh, as DTensors over the same
    # storage (a second 34 GB cache does not fit beside the first): its
    # slot write goes through launch.rules' shard-local write and its
    # softmax through the all-reduces of the max and the sum, one shard a
    # dim.  Both steps start from the same cache (the slot they write is
    # put back between them): the logits, the written slot and each
    # layer's K and V summed in f64 bit for bit.
    dcache = transformer.init_cache(lcfg, decode_b, s_long, device=dev)
    common.tree_map(lambda t: t.normal_(generator=launch_gen),
                    dcache["slots"])
    dcache["pos"].fill_(s_long - 1)
    dtoken = torch.randint(0, lcfg.vocab, (decode_b, 1), generator=launch_gen,
                           device=dev, dtype=torch.int32)
    dslot = {n: dcache["slots"]["0"][n][:, :, s_long - 1].clone()
             for n in ("k", "v")}

    def written():
        """The slot the step wrote, and each K and V summed in f64."""
        return ({n: dcache["slots"]["0"][n][:, :, s_long - 1].clone()
                 for n in ("k", "v")},
                torch.stack([torch.stack([t.sum(dtype=torch.float64)
                                          for t in dcache["slots"]["0"][n]])
                             for n in ("k", "v")]))

    (dlogits, dcache), decode_s, decode_peak = peak_run(
        lambda: launch_steps.make_serve_step(lcfg)(lparams, dcache, dtoken))
    check(tuple(dlogits.shape) == (decode_b, lcfg.vocab)
          and bool(torch.isfinite(dlogits.float()).all())
          and int(dcache["pos"]) == s_long,
          "launch serve step: logits not finite or the position did not "
          "advance")
    plain_slot, plain_sums = written()
    dcache["pos"].fill_(s_long - 1)
    launch_rec["decode"] = {"batch": decode_b, "seconds_first_call": decode_s,
                            "seconds": warm_s(lambda: launch_steps
                                              .make_serve_step(lcfg)(
                                                  lparams, dcache, dtoken)),
                            "peak_memory_bytes": decode_peak}
    for n in ("k", "v"):
        dcache["slots"]["0"][n][:, :, s_long - 1] = dslot[n]
    dcache["pos"].fill_(s_long - 1)
    prod = launch_mesh.AbstractMesh(*launch_mesh.SINGLE_POD)
    d_sh = launch_sh.tree_map(
        lambda s_: launch_sh.Sharding(lmesh, s_.spec),
        launch_sh.cache_shardings(lcfg, dcache, prod, decode_b))
    dt_cache = launch_sh.tree_map(
        lambda t, s_: DTensor.from_local(t, lmesh, s_.placements,
                                         run_check=False), dcache, d_sh)
    k_pl = dt_cache["slots"]["0"]["k"].placements
    check(k_pl == (Shard(1), Shard(2)), f"launch: the DTensor cache's K is "
          f"laid out as {k_pl}, not batch on 'data' and slots on 'model'")
    (dt_logits, dt_cache), dt_s, dt_peak = peak_run(
        lambda: launch_steps.make_serve_step(lcfg)(lparams, dt_cache,
                                                   dtoken))
    dt_slot, dt_sums = written()
    same = {"logits": torch.equal(dt_logits.to_local(), dlogits),
            "written_slot": all(torch.equal(dt_slot[n], plain_slot[n])
                                for n in ("k", "v")),
            "cache_sums": torch.equal(dt_sums, plain_sums),
            "position": int(dt_cache["pos"].to_local()) == s_long}
    check(all(same.values()) and dt_cache["slots"]["0"]["k"].placements
          == k_pl, f"launch serve step on the DTensor cache against the "
          f"plain one: {same}")
    dt_cache["pos"].to_local().fill_(s_long - 1)
    launch_rec["decode_dtensor_cache"] = {
        "placements_k": [str(p_) for p_ in k_pl],
        "seconds_first_call": dt_s,
        "seconds": warm_s(lambda: launch_steps.make_serve_step(lcfg)(
            lparams, dt_cache, dtoken)),
        "seconds_plain": launch_rec["decode"]["seconds"],
        "peak_memory_bytes": dt_peak, "bit_for_bit": same}
    emit(phase="launch", step="decode", **launch_rec["decode"],
         dtensor_cache=launch_rec["decode_dtensor_cache"])
    del dlogits, dt_logits, dt_cache, dcache, dtoken, dslot, plain_slot
    del dt_slot
    release_m()
    # the two-pod round: K = 2 steps a pod, FedAvg over the pod group (the
    # world-1 group: both pods are on this card), under the cost counter
    stacked0 = launch_sh.tree_map(lambda t: torch.stack([t] * pods), lstate0)
    pod_group = {"pod": dist.group.WORLD}
    with hlo_cost.CostCounter(groups=pod_group) as pod_counter:
        (rstate, rmetrics), round_s, round_peak = peak_run(
            lambda: launch_steps.make_federated_round(lcfg, lfc, pods)(
                stacked0, lfrozen, round_batches))
    path_launches = read_counts()
    round_cost = pod_counter.totals()
    round_warm_s = warm_s(lambda: launch_steps.make_federated_round(
        lcfg, lfc, pods)(stacked0, lfrozen, round_batches))
    emit(phase="launch", step="round", seconds_first_call=round_s,
         seconds=round_warm_s, peak_memory_bytes=round_peak,
         launches=path_launches,
         collectives_by_dim=round_cost["collectives_by_dim"])
    # each pod alone: its K steps through make_train_step
    solo = []
    for p in range(pods):
        s_ = lstate0
        for k in range(k_steps):
            s_, _ = launch_steps.make_train_step(lcfg, lfc)(
                s_, lfrozen, ppo.PPOBatch(*(t[p, k] for t in round_batches)))
        solo.append(s_.trainable)
    equal_pods = all(torch.equal(t[0], t[1]) for t in
                     launch_sh.tree_leaves(rstate.trainable))
    mean_of_solo = all(torch.equal(t[0], torch.stack([a, b_]).mean(0))
                       for t, a, b_ in zip(
                           launch_sh.tree_leaves(rstate.trainable),
                           launch_sh.tree_leaves(solo[0]),
                           launch_sh.tree_leaves(solo[1])))
    n_leaves = len(launch_sh.tree_leaves(ltrain))
    want_pod = {"pod": {"all-reduce": {"count": n_leaves,
                                       "bytes": 4 * n_trainable}}}
    check(equal_pods and mean_of_solo,
          f"launch round: pods equal {equal_pods}, the mean of the solo "
          f"steps {mean_of_solo}")
    check(round_cost["collectives_by_dim"] == want_pod
          and 4 * n_trainable == 13_631_488,
          f"launch round: collectives {round_cost['collectives_by_dim']}, "
          f"want FedAvg's alone {want_pod}")
    check(tuple(rmetrics["lam"].shape) == (pods, k_steps, N_OBJ),
          f"launch round: metrics' lam {tuple(rmetrics['lam'].shape)}")
    launch_rec["round"] = {
        "pods": pods, "local_steps": k_steps, "seconds": round_s,
        "peak_memory_bytes": round_peak,
        "pods_equal_bit_for_bit": equal_pods,
        "mean_of_solo_steps_bit_for_bit": mean_of_solo,
        "collectives_by_dim": round_cost["collectives_by_dim"],
        "kernel_calls": round_cost["kernels"]}
    del rstate, rmetrics, solo, s_, stacked0, round_batches
    release_m()
    check(all(path_launches[k] > 0 for k in (
        "rmsnorm", "rmsnorm_bwd", "flash_attention", "flash_attention_bwd",
        "gram")), f"launch: a kernel of the path did not launch: "
        f"{path_launches}")
    launch_rec["launches"] = path_launches

    # generate_stacked: 2 clients (the second's adapters moved) x 16
    # prompts of 128 tokens, 128 new tokens, one generator each; each
    # client's rows equal its own generate given a generator of the same
    # seed: tokens, logprobs and mask bit for bit
    gs_clients, gs_b, gs_p, gs_new = 2, 16, 128, 128
    moved = common.tree_map(lambda t: t + 0.01 * torch.randn(
        t.shape, generator=launch_gen, device=dev, dtype=t.dtype), ltrain)
    gs_params = [lparams, common.merge_trainable(moved, lfrozen)]
    gs_stacked = launch_sh.tree_map(lambda *ts: torch.stack(ts), *gs_params)
    gs_prompts = torch.randint(0, lcfg.vocab, (gs_clients, gs_b, gs_p),
                               generator=launch_gen, device=dev)

    def gs_gens():
        return [torch.Generator(device=dev).manual_seed(300 + c)
                for c in range(gs_clients)]
    zero_counts()
    gs_out, gs_s = wall(lambda: sampling.generate_stacked(
        lcfg, gs_stacked, gs_prompts, max_new=gs_new, generators=gs_gens()))
    gs_launches = read_counts()
    gs_same = []
    for c, g_ in enumerate(gs_gens()):
        one = generate(lcfg, gs_params[c], gs_prompts[c], max_new=gs_new,
                       generator=g_)
        gs_same.append(all(torch.equal(a, b_[c]) for a, b_ in
                           zip(one, gs_out)))
    check(tuple(gs_out[0].shape) == (gs_clients, gs_b, gs_p + gs_new)
          and all(gs_same) and gs_launches["flash_attention"] > 0
          and gs_launches["rmsnorm"] > 0,
          f"launch generate_stacked: shape {tuple(gs_out[0].shape)}, each "
          f"client's generate bit for bit {gs_same}, launches "
          f"{gs_launches}")
    launch_rec["generate_stacked"] = {
        "clients": gs_clients, "batch": gs_b, "prompt_len": gs_p,
        "max_new": gs_new, "seconds": gs_s, "launches": gs_launches,
        "clients_bit_for_bit_generate": gs_same}
    emit(phase="launch", step="generate_stacked",
         **launch_rec["generate_stacked"])
    del moved, gs_params, gs_stacked, gs_prompts, gs_out, one
    release_m()

    # the kernels' step against the plain versions' on the same inputs,
    # at 2 of the 16 layers and B = 3 (the plain attention holds 32 x
    # 4096^2 f32 scores, 2.1 GB a layer and sequence, for the backward),
    # the batch's logprobs the cut model's own and its rewards ordered
    # differently for the two objectives (sequence-level rewards whitened
    # over one or two sequences give both objectives the same or opposite
    # advantages: a Gram of rank 1), so that the gradients are at an
    # angle and the MGDA problem well posed: the losses (the forward)
    # within 2e-2 of their scale (the bf16 rule); the Gram of the M
    # objectives' gradients (their norms and cosine: the backward kernels)
    # within GRAM_REL of its largest entry; the trainables' change (Adam's
    # first step, about lr times each gradient's sign) at a cosine of at
    # least UPDATE_COS to the plain step's and within UPDATE_REL of its
    # norm; and lambda within 2e-2 over min(1, D), D the curvature of the
    # MGDA problem the plain step solved (its trace-normalised Gram, +
    # beta / 2 on the diagonal), as the repo holds lambda
    # (tests/test_torch_algorithm_rounds.py)
    cut = dataclasses.replace(lcfg, n_layers=2, n_periods=2)
    cut_frozen = {**lfrozen, "slots": common.tree_map(
        lambda t: t[:2], lfrozen["slots"])}
    cut_train = {**ltrain, "slots": common.tree_map(lambda t: t[:2],
                                                    ltrain["slots"])}
    cut_state = local.init_client_state(cut_train, N_OBJ, lcfg.d_model,
                                        lfc.kl_coef_init, device=dev)
    cut_batch = launch_batch(3, s_train, cfg_=cut, train=cut_train,
                             frozen=cut_frozen, rewards=torch.tensor(
                                 [[1.0, 0.0], [0.0, 1.0], [-1.0, -1.0]],
                                 device=dev))
    s_kernel, m_kernel = launch_steps.make_train_step(cut, lfc)(
        cut_state, cut_frozen, cut_batch)
    kernel_of = ops._kernel
    ops._kernel = lambda x, use_kernel: False    # every call: its plain one
    try:
        s_plain, m_plain = launch_steps.make_train_step(cut, lfc)(
            cut_state, cut_frozen, cut_batch)
    finally:
        ops._kernel = kernel_of

    def change(s_):
        return torch.cat([(a.double() - b_.double()).flatten() for a, b_ in
                          zip(launch_sh.tree_leaves(s_.trainable),
                              launch_sh.tree_leaves(cut_state.trainable))])
    d_kernel, d_plain = change(s_kernel), change(s_plain)
    plain_err = {k: float((m_kernel[k].float() - m_plain[k].float()).abs()
                          .max()) for k in ("lam", "losses", "gram")}
    plain_scale = {k: max(1.0, float(m_plain[k].float().abs().max()))
                   for k in ("lam", "losses")}
    q_ = m_plain["gram"].double()
    gram_rel = float((m_kernel["gram"].double() - q_).abs().max()
                     / q_.abs().max())
    update_cos = float(d_kernel @ d_plain
                       / (d_kernel.norm() * d_plain.norm()))
    update_rel = float((d_kernel - d_plain).norm() / d_plain.norm())
    q_ = q_ / (torch.trace(q_) / N_OBJ) + 0.5 * lfc.beta * torch.eye(
        N_OBJ, dtype=torch.float64, device=dev)
    curvature = float(q_[0, 0] + q_[1, 1] - 2 * q_[0, 1])
    launch_rec["plain_vs_kernels"] = {
        "layers": 2, "batch": 3, "max_abs_err": plain_err,
        "gram_rel_err": gram_rel, "update_cos": update_cos,
        "update_rel_err": update_rel, "curvature": curvature,
        "gram": m_plain["gram"].tolist(),
        "ratio_mean": float(m_kernel["ratio_mean"]),
        "kl": float(m_kernel["kl"]),
        "tolerance": f"losses 2e-2 of max(1, max |plain|); gram within "
                     f"{GRAM_REL} of its largest entry; the trainables' "
                     f"change at a cosine of at least {UPDATE_COS} and "
                     f"within {UPDATE_REL} of its norm; lambda 2e-2 over "
                     "min(1, D)"}
    check(plain_err["losses"] <= 2e-2 * plain_scale["losses"]
          and gram_rel <= GRAM_REL and update_cos >= UPDATE_COS
          and update_rel <= UPDATE_REL
          and plain_err["lam"] * min(1.0, curvature)
          <= 2e-2 * plain_scale["lam"],
          f"launch: the kernels' step against the plain one "
          f"{launch_rec['plain_vs_kernels']}")
    del cut_frozen, cut_train, cut_state, cut_batch, m_kernel, m_plain
    del s_kernel, s_plain, d_kernel, d_plain
    release_m()

    # the flash kernel at prefill_32k's shape: its first run past S = 4608
    # (512 key tiles); its output and lse on the last 256 query rows
    # against the plain version's over those rows and every key
    fq = randn((1, s_long, lcfg.n_heads, lcfg.head_dim), torch.bfloat16,
               launch_gen)
    fk, fv = (randn((1, s_long, lcfg.n_kv_heads, lcfg.head_dim),
                    torch.bfloat16, launch_gen) for _ in range(2))
    fo, flse = fa_mod.flash_attention_fwd(fq, fk, fv, causal=True,
                                          with_lse=True)
    start = s_long - 256
    kx, vx = (t.repeat_interleave(lcfg.q_per_kv, dim=2).float()
              for t in (fk, fv))
    sc = torch.einsum("bqhd,bkhd->bhqk", fq[:, start:].float(),
                      kx) * lcfg.head_dim ** -0.5
    qpos = torch.arange(start, s_long, device=dev)[:, None]
    kpos = torch.arange(s_long, device=dev)[None, :]
    sc = torch.where((qpos >= kpos)[None, None], sc, ref.NEG_INF)
    want_o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1),
                          vx).to(torch.bfloat16)
    want_lse = torch.logsumexp(sc, -1)
    del kx, vx, sc
    diff = (fo[:, start:].float() - want_o.float()).abs()
    row_max = want_o.float().abs().amax(dim=-1)
    lse_err = float((flse[:, :, start:] - want_lse).abs().max())
    check(bool((diff <= 2e-2 + 2e-2 * want_o.float().abs()).all())
          and bool((diff.amax(dim=-1) <= 2e-2 * row_max).all())
          and lse_err <= 4e-3,
          f"flash attention at S = {s_long}: max abs err {float(diff.max())},"
          f" lse err {lse_err}")
    ft = [t.transpose(1, 2) for t in (fq, fk, fv)]
    launch_flash = {
        "max_abs_err_prefill_32k": float(diff.max()),
        "lse_err_prefill_32k": lse_err,
        "ms_prefill_32k": timed_ms(lambda: fa_mod.flash_attention_fwd(
            fq, fk, fv, causal=True), iters=5, warmup=1),
        "library_ms_prefill_32k": timed_ms(
            lambda: F.scaled_dot_product_attention(*ft, is_causal=True,
                                                   enable_gqa=True),
            iters=5, warmup=1)}
    launch_flash["bound_ms_prefill_32k"], \
        launch_flash["bound_by_prefill_32k"] = bound_ms(
            *kernel_costs.flash_attention(fq, fk, fv, causal=True))
    del fq, fk, fv, fo, flse, want_o, want_lse, diff, ft
    del lparams, ltrain, lfrozen, lstate0
    release_m()
    dist.destroy_process_group()
    # what the phase leaves allocated (the later phases need the card),
    # less cuBLAS's workspaces, which its first GEMMs allocated
    torch._C._cuda_clearCublasWorkspaces()
    launch_rec["leftover_bytes"] = torch.cuda.memory_allocated() - launch_mem0
    check(launch_rec["leftover_bytes"] < 2 ** 26, "launch: the phase leaves "
          f"{launch_rec['leftover_bytes']} bytes allocated")
    emit(phase="launch", **launch_rec, flash_prefill_32k=launch_flash,
         tolerance="the round's trainables bit for bit across pods and the "
         "mean of the solo steps; FedAvg's all-reduces the only "
         "collectives over 'pod'; the kernels' step against the plain "
         "one's as plain_vs_kernels states (2 layers, B = 3); flash at "
         "S = 32768 within 2e-2 of each row's max |plain| on the last 256 "
         "rows, lse within 4e-3")
    done("launch")

    # -------------------------------------------------------------- 3. rmsnorm
    def bf16_ulps(a, b) -> int:
        """Largest distance between two bf16 tensors in units in the last
        place (bit patterns mapped to a monotonic integer scale)."""
        def key(t):
            bits = t.contiguous().view(torch.int16).int()
            return torch.where(bits < 0, -(bits & 0x7FFF), bits)
        return int((key(a) - key(b)).abs().max())

    # bf16: the normalised row (g = 1) may differ from the plain version's
    # by 1 ulp (f32 reduction order and rsqrtf); scaled by g, such a flip
    # spans less than 2 ulps of the product, so the output is held to 2.
    # The last three cases take the kernel's scalar path: a width that is
    # no multiple of 16 bytes, or a row that starts off a 16-byte boundary.
    d = 2048
    rms_cases = [((4096, d), torch.bfloat16, False, 0),
                 ((4096, d), torch.bfloat16, True, 0),
                 ((B, d), torch.bfloat16, False, 0),
                 ((3, d), torch.float32, False, 0),
                 ((1, 1001), torch.bfloat16, False, 0),
                 ((5, 2050), torch.float32, False, 0),
                 ((7, d), torch.bfloat16, False, 1)]
    rms_err = {}
    for shape, dtype, unit_g, offset in rms_cases:
        n = shape[0] * shape[1]
        x = randn((n + offset,), dtype)[offset:].view(shape)
        g = (torch.ones(shape[-1:], device=dev, dtype=dtype) if unit_g
             else randn(shape[-1:], dtype))
        got, want = rn_mod.rmsnorm(x, g), ref.rmsnorm(x, g)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        label = (f"{shape}{' g=1' if unit_g else ''}"
                 f"{' misaligned' if offset else ''}")
        if dtype == torch.bfloat16:
            ulps, limit = bf16_ulps(got, want), 1 if unit_g else 2
            check(ulps <= limit, f"rmsnorm {label} bf16 off by {ulps} ulp")
            rms_err[label] = {"max_abs": err, "max_ulps": ulps}
        else:
            rel = float(((got - want).abs()
                         / (want.abs() + 1e-6)).max())
            check(rel <= 1e-5, f"rmsnorm {shape} f32 rel err {rel}")
            rms_err[label] = {"max_abs": err, "max_rel": rel}
    x, g = randn((4096, d), torch.bfloat16), randn((d,), torch.bfloat16)
    rms_row = {
        "name": "rmsnorm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:41",
        "max_abs_err": rms_err[str((4096, d))]["max_abs"],
        "ms": timed_ms(lambda: rn_mod.rmsnorm(x, g)),
        "plain_ms": timed_ms(lambda: ref.rmsnorm(x, g)),
        "library_ms": timed_ms(lambda: F.rms_norm(x, (d,), g, 1e-5)),
        # the same loop paced by the host's launches, for comparison
        "ms_without_hold": timed_ms(lambda: rn_mod.rmsnorm(x, g),
                                    hold=False),
    }
    rms_row["bound_ms"], rms_row["bound_by"] = bound_ms(
        *kernel_costs.rmsnorm(x, g))
    emit(phase="rmsnorm", shape=[4096, d], dtype="bf16", checks=rms_err,
         tolerance="bf16: normalised row (g=1) <= 1 ulp, output <= 2 ulp; "
         "f32: 1e-5 relative", **rms_row)
    done("rmsnorm")

    # ---------------------------------------------------------------- 4. flash
    def qkv(b, sq, skv, hq, hkv, dh, dtype, generator=None):
        return tuple(randn(shape, dtype, generator) for shape in (
            (b, sq, hq, dh), (b, skv, hkv, dh), (b, skv, hkv, dh)))

    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}

    def plain_lse(q, k, causal, window):
        """The (B, Hq, Sq) log-sum-exp of the plain version's masked
        scaled scores, in f32."""
        b, sq, hq, dh = q.shape
        skv = k.shape[1]
        kx = k.repeat_interleave(hq // k.shape[2], dim=2).float()
        s_ = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx) * dh ** -0.5
        qp = torch.arange(sq, device=q.device)[:, None]
        kp = torch.arange(skv, device=q.device)[None, :]
        keep = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
        if causal:
            keep &= qp >= kp
        if window:
            keep &= qp - kp < window
        return torch.logsumexp(s_.masked_fill(~keep, -math.inf), dim=-1)

    def check_flash_fwd(label, q, k, causal, window, got, lse, want, tol):
        """The forward's o against the plain version: within tol + tol
        |want| each element, and in bf16 also within 2e-2 of each row's
        max |want| (a row of 4096 kept keys has |o| ~ 0.026, where the
        element rule is as large as the values); its lse within 4e-3
        (bf16: P is rounded to bf16, up to 2**-9 of the sum) or 1e-4 (f32)
        of the plain log-sum-exp, which a key tile wrongly kept whole
        moves by log(1 + 63 / 4096) = 0.015 at a window of 4096."""
        bf = got.dtype == torch.bfloat16
        diff = (got.float() - want.float()).abs()
        ok = bool((diff <= tol + tol * want.float().abs()).all())
        if bf:
            row_max = want.float().abs().amax(dim=-1)
            ok = ok and bool((diff.amax(dim=-1) <= 2e-2 * row_max).all())
        lse_err = float((lse - plain_lse(q, k, causal, window)).abs().max())
        ok = ok and lse_err <= (4e-3 if bf else 1e-4)
        flash_err[label] = float(diff.max())
        flash_lse_err[label] = lse_err
        check(ok, f"flash attention {label}: max abs err "
              f"{float(diff.max())}, lse err {lse_err}")

    # drawn from a generator of their own, so that the later phases'
    # inputs stay as they were
    edge_gen = torch.Generator(device=dev).manual_seed(1)
    flash_err, flash_lse_err, flash_paths = {}, {}, {}
    for (label, (b, sq, skv, hq, hkv, dh), dt, causal, window), g_ in [
            (case, gen) for case in FLASH_CASES] + [
            (case, edge_gen) for case in FLASH_EDGE_CASES]:
        dtype = dtypes[dt]
        q, k, v = qkv(b, sq, skv, hq, hkv, dh, dtype, g_)
        got = fa_mod.flash_attention(q, k, v, causal=causal,
                                     sliding_window=window)
        again, lse = fa_mod.flash_attention_fwd(q, k, v, causal=causal,
                                                sliding_window=window,
                                                with_lse=True)
        _, lse2 = fa_mod.flash_attention_fwd(q, k, v, causal=causal,
                                             sliding_window=window,
                                             with_lse=True)
        want = ref.flash_attention(q, k, v, causal=causal,
                                   sliding_window=window)
        torch.cuda.synchronize()
        flash_paths[label] = fa_mod.PATHS[dtype]
        check_flash_fwd(label, q, k, causal, window, got, lse, want,
                        2e-2 if dtype == torch.bfloat16 else 2e-4)
        check(identical(got, again) and identical(lse, lse2),
              f"flash attention {label}: a second call gave other bits")
    # head_dim 128, drawn from a generator of their own; f32 is held to
    # 1e-4 here
    d128_gen = torch.Generator(device=dev).manual_seed(2)
    for label, (b, sq, skv, hq, hkv, dh), dt, causal, window in \
            FLASH_D128_CASES:
        dtype = dtypes[dt]
        q, k, v = qkv(b, sq, skv, hq, hkv, dh, dtype, d128_gen)
        got, lse = fa_mod.flash_attention_fwd(q, k, v, causal=causal,
                                              sliding_window=window,
                                              with_lse=True)
        again, lse2 = fa_mod.flash_attention_fwd(q, k, v, causal=causal,
                                                  sliding_window=window,
                                                  with_lse=True)
        want = ref.flash_attention(q, k, v, causal=causal,
                                   sliding_window=window)
        torch.cuda.synchronize()
        flash_paths[label] = fa_mod.PATHS[dtype]
        check_flash_fwd(label, q, k, causal, window, got, lse, want,
                        2e-2 if dtype == torch.bfloat16 else 1e-4)
        check(identical(got, again) and identical(lse, lse2),
              f"flash attention {label}: a second call gave other bits")
        del q, k, v, got, again, want
    # the encoder-decoder and VLM shapes, from a generator of their own
    encdec_gen = torch.Generator(device=dev).manual_seed(4)
    for label, (b, sq, skv, hq, hkv, dh), dt, causal, window in \
            FLASH_ENCDEC_CASES:
        dtype = dtypes[dt]
        q, k, v = qkv(b, sq, skv, hq, hkv, dh, dtype, encdec_gen)
        got, lse = fa_mod.flash_attention_fwd(q, k, v, causal=causal,
                                              with_lse=True)
        again, lse2 = fa_mod.flash_attention_fwd(q, k, v, causal=causal,
                                                  with_lse=True)
        want = ref.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        flash_paths[label] = fa_mod.PATHS[dtype]
        check_flash_fwd(label, q, k, causal, window, got, lse, want, 2e-2)
        check(identical(got, again) and identical(lse, lse2),
              f"flash attention {label}: a second call gave other bits")
        del q, k, v, got, again, want, lse, lse2

    def sass_hmma(lib) -> dict:
        """HMMA (tensor-core) instructions in each flash and SSD kernel of
        the built library, from ``cuobjdump -sass``."""
        sass = subprocess.run([build.tool("cuobjdump"), "-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        counts = {}
        for section in sass.split("Function : ")[1:]:
            m = re.search(r"((?:flash_[a-z_]+|ssd_scan)_kernel)ILi(\d+)E",
                          section.split()[0])
            if m:
                counts[f"{m[1]}<{m[2]}>"] = sum(
                    "HMMA" in ln for ln in section.splitlines())
        return counts

    hmma = sass_hmma(lib_path)
    flash_hmma = {k: n for k, n in hmma.items() if k.startswith("flash_")}
    tc_kernels = [f"flash_{part}_mma_kernel<{dh}>" for part in
                  ("fwd", "bwd_dq", "bwd_dkv") for dh in fa_mod.HEAD_DIMS]
    check(all(flash_hmma.get(name, 0) > 0 for name in tc_kernels),
          f"a tensor-core flash kernel without HMMA: {flash_hmma}")
    s = 256
    q, k, v = qkv(B, s, s, 32, 8, 64, torch.bfloat16)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    flash_row = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:98",
        "max_abs_err": flash_err["rollout S=256 causal"],
        "ms": timed_ms(lambda: fa_mod.flash_attention(q, k, v, causal=True)),
        "plain_ms": timed_ms(lambda: ref.flash_attention(q, k, v,
                                                         causal=True),
                             iters=10),
        "library_ms": timed_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
    }
    # zamba2's MHA shape (32 KV heads): the kernel and SDPA
    qm, km, vm = qkv(B, s, s, 32, 32, 64, torch.bfloat16)
    flash_row["ms_mha"] = timed_ms(lambda: fa_mod.flash_attention(
        qm, km, vm, causal=True))
    flash_row["library_ms_mha"] = timed_ms(
        lambda: F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in (qm, km, vm)), is_causal=True))
    del qm, km, vm
    flash_row["bound_ms"], flash_row["bound_by"] = bound_ms(
        *kernel_costs.flash_attention(q, k, v, causal=True))
    # the same at head_dim 128, mixtral's training shape
    q, k, v = qkv(B, s, s, 32, 8, 128, torch.bfloat16, d128_gen)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    flash_row.update({
        "max_abs_err_dh128": flash_err["dh=128 mixtral S=256 causal"],
        "ms_dh128": timed_ms(lambda: fa_mod.flash_attention(q, k, v,
                                                            causal=True)),
        "plain_ms_dh128": timed_ms(lambda: ref.flash_attention(
            q, k, v, causal=True), iters=10),
        "library_ms_dh128": timed_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
    })
    flash_row["bound_ms_dh128"], flash_row["bound_by_dh128"] = bound_ms(
        *kernel_costs.flash_attention(q, k, v, causal=True))

    def flash_at(tag, b, sq, skv, hq, hkv, dh):
        """The kernel, the plain version and SDPA timed at one
        non-causal shape of ``FLASH_ENCDEC_CASES``, with its bound: every
        (query, key) pair kept."""
        q_, k_, v_ = qkv(b, sq, skv, hq, hkv, dh, torch.bfloat16, encdec_gen)
        t_ = [t.transpose(1, 2) for t in (q_, k_, v_)]
        flash_row.update({
            f"max_abs_err_{tag}": flash_err[next(
                c[0] for c in FLASH_ENCDEC_CASES
                if c[1] == (b, sq, skv, hq, hkv, dh))],
            f"ms_{tag}": timed_ms(lambda: fa_mod.flash_attention(
                q_, k_, v_, causal=False), iters=20),
            f"plain_ms_{tag}": timed_ms(lambda: ref.flash_attention(
                q_, k_, v_, causal=False), iters=3, warmup=1),
            f"library_ms_{tag}": timed_ms(
                lambda: F.scaled_dot_product_attention(*t_, enable_gqa=True),
                iters=20)})
        flash_row[f"bound_ms_{tag}"], flash_row[f"bound_by_{tag}"] = \
            bound_ms(*kernel_costs.flash_attention(q_, k_, v_, causal=False))
    # whisper's encoder (S = 1500, MHA of 20 heads of 64) and the VLM's
    # cross-attention (256 positions to 1601 vision tokens, Dh 128)
    flash_at("whisper_enc", B, 1500, 1500, 20, 20, 64)
    flash_at("vision_cross", B, 256, 1601, 64, 8, 128)
    flash_regs = ptxas_by_kernel("flash_fwd_mma_kernel")
    flash_regs.update(ptxas_by_kernel("flash_fwd_fma_kernel"))
    emit(phase="flash", shape=[B, s, 32, 8, 64], dtype="bf16", causal=True,
         checks=flash_err, lse_checks=flash_lse_err, paths=flash_paths,
         same_bits_twice=True, hmma=flash_hmma, registers=flash_regs,
         tolerance="2e-2 bf16, 2e-4 f32 (atol and rtol); 1e-4 f32 at "
         "dh=128; bf16 also 2e-2 of each row's max |plain|; lse 4e-3 bf16, "
         "1e-4 f32 of the plain log-sum-exp", **flash_row)
    done("flash")

    # ----------------------------------------------------------------- 5. gram
    cfg = get_config("llama-3.2-1b")
    r_lora = cfg.lora.rank
    dq_w, dkv_w = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    # LoRA parameters of wq, wk, wv, wo over all layers: the row width of
    # the local step's (M, d) gradient matrix
    d_lora = cfg.n_periods * r_lora * (2 * (cfg.d_model + dq_w)
                                       + 2 * (cfg.d_model + dkv_w))

    def max_rel(got, want) -> float:
        """Largest error relative to the compared tensor's scale."""
        return float((got.float() - want.float()).abs().max()
                     / want.float().abs().max())

    # sums over d in another order than cuBLAS's: 1e-5 of G's scale
    gram_cases = [((N_OBJ, d_lora), torch.float32, 0),
                  ((N_OBJ, d_lora), torch.bfloat16, 0),
                  ((3, 1000), torch.float32, 0),
                  ((8, 8193), torch.float32, 0),
                  ((3, 8193), torch.bfloat16, 0),
                  ((8, 1000), torch.bfloat16, 0),
                  ((2, 4096), torch.float32, 1),
                  # FedCMOO's server solve off the main path: a sketch of
                  # q columns, fewer than the kernel's blocks (most of
                  # them get no column), and M = 4 objectives
                  ((2, 8), torch.float32, 0),
                  ((2, 64), torch.float32, 0),
                  ((4, 1000), torch.float32, 0)]
    gram_err = {}
    for (m_, d_), dtype, offset in gram_cases:
        x = randn((m_ * d_ + offset,), dtype)[offset:].view(m_, d_)
        got, again = gram_mod.gram(x), gram_mod.gram(x)
        want = ref.gram(x)
        torch.cuda.synchronize()
        label = (f"({m_}, {d_}) {str(dtype)[6:]}"
                 f"{' misaligned' if offset else ''}")
        gram_err[label] = max_rel(got, want)
        check(gram_err[label] <= 1e-5, f"gram {label}: rel err "
              f"{gram_err[label]}")
        check(torch.equal(got, again), f"gram {label}: not the same bits "
              "twice")
    x = randn((N_OBJ, d_lora), torch.float32)
    gram_row = {
        "name": "gram", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gram.cu",
        "replaces": "src/repro/kernels/gram.py:43",
        "max_abs_err": float((gram_mod.gram(x) - ref.gram(x)).abs().max()),
        "ms": timed_ms(lambda: gram_mod.gram(x)),
        "plain_ms": timed_ms(lambda: ref.gram(x)),
        "library_ms": timed_ms(lambda: x @ x.T),
    }
    gram_row["bound_ms"], gram_row["bound_by"] = bound_ms(
        *kernel_costs.gram(x))
    # one kernel a call, and the time with a cold L2 (the held time reads
    # the 27.3 MB input mostly from the 50 MB L2)
    gram_nodes = graph_nodes_per_call(lambda: gram_mod.gram(x))
    check(gram_nodes == [graph_kernel_node],
          f"gram: one kernel a call expected, a call's graph {gram_nodes}")
    gram_profiled = profiled_kernels(lambda: gram_mod.gram(x))
    gram_row["cold_l2_ms"] = cold_ms(lambda: gram_mod.gram(x))
    emit(phase="gram", shape=[N_OBJ, d_lora], dtype="f32",
         checks=gram_err, same_bits_twice=True,
         graph_nodes_a_call=gram_nodes,
         profiler_kernels_in_3_calls=gram_profiled,
         ptxas=ptxas_by_kernel("gram_kernel"),
         tolerance="max |G - plain| <= 1e-5 max |plain| (sum order); the "
         "same bits on two runs", **gram_row)
    done("gram")

    # ------------------------------------------------------------- 6. quantize
    # the round's uplink: C = 2 clients' LoRA deltas, (C * 3328, 1024) rows.
    # The kernel must give the plain version's bits: codes equal, scales
    # equal as bit patterns.
    rows_round = N_CLIENTS * -(-d_lora // q_mod.BLOCK)

    def rand_bits(rows):
        return qcodec.random_bits((rows, q_mod.BLOCK), gen)

    def delta_rows(rows, generator=None):
        """Deltas of mixed scale per row, as the uplink sees them."""
        return (randn((rows, q_mod.BLOCK), torch.float32, generator)
                * torch.exp(4 * randn((rows, 1), torch.float32, generator))
                * 1e-4)

    def same_bits(a, b) -> bool:
        return a.shape == b.shape and torch.equal(
            a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))

    x_pad, _ = qcodec._stacked_blocks(randn((N_CLIENTS, 5 * 1024 + 77),
                                            torch.float32))
    x_zero = delta_rows(64)
    x_zero[::3] = 0
    x_round = delta_rows(rows_round)
    det = torch.full((rows_round, q_mod.BLOCK), qcodec.DET_BITS,
                     dtype=torch.int32, device=dev)
    # uint32 offsets >= 2**32 - 128 convert to r = 1.0 exactly
    top = torch.randint(-128, 0, (rows_round, q_mod.BLOCK), generator=gen,
                        device=dev, dtype=torch.int32)
    quant_cases = [
        ("round int8", x_round, rand_bits(rows_round), 127),
        ("round int4", x_round, rand_bits(rows_round), 7),
        ("padded d=5*1024+77 int8", x_pad, rand_bits(x_pad.shape[0]), 127),
        ("zero rows int4", x_zero, rand_bits(64), 7),
        ("bits 2**31 (nearest) int8", x_round, det, 127),
        ("bits >= 2**32-128 (r = 1) int8", x_round, top, 127),
        ("bits >= 2**32-128 (r = 1) int4", x_round, top, 7),
    ]
    quant_checks, quant_out = {}, {}
    for label, xq, bq, qmax in quant_cases:
        got_c, got_s = q_mod.quantize(xq, bq, qmax)
        want_c, want_s = ref.quantize(xq, bq, qmax)
        torch.cuda.synchronize()
        quant_checks[label] = {
            "codes_equal": bool(torch.equal(got_c, want_c)),
            "scales_same_bits": same_bits(got_s, want_s),
            "max_abs_err": max(
                float((got_c.int() - want_c.int()).abs().max()),
                float((got_s - want_s).abs().max()))}
        check(quant_checks[label]["codes_equal"]
              and quant_checks[label]["scales_same_bits"]
              and quant_checks[label]["max_abs_err"] == 0,
              f"quantize {label}: {quant_checks[label]}")
        quant_out[label] = (xq, got_c, got_s)
    check(bool((quant_out["zero rows int4"][2][::3] == 1).all()),
          "an all-zero row has scale 1")
    xq, bq = x_round, rand_bits(rows_round)
    quant_row = {
        "name": "quantize", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quantize.cu",
        "replaces": "src/repro/kernels/quantize.py:70",
        "max_abs_err": max(c["max_abs_err"] for c in quant_checks.values()),
        "ms": timed_ms(lambda: q_mod.quantize(xq, bq, 127)),
        "plain_ms": timed_ms(lambda: ref.quantize(xq, bq, 127)),
        # no one PyTorch call computes blockwise stochastic quantization
        "library_ms": None,
    }
    quant_row["bound_ms"], quant_row["bound_by"] = bound_ms(
        *kernel_costs.quantize(xq, bq))
    emit(phase="quantize", shape=list(xq.shape), checks=quant_checks,
         tolerance="bit-identical: codes equal, scales equal bit for bit",
         library="none: no single PyTorch call quantizes blockwise",
         **quant_row)
    done("quantize")

    # ----------------------------------------------------------- 7. dequantize
    # codes * scale, and with the error-feedback epilogue the residual
    # fma(-code, scale, adj); both bit-identical to the plain versions
    dequant_checks = {}
    for label, (xq_, codes_, scales_) in quant_out.items():
        dec, res = q_mod.dequantize(codes_, scales_, xq_)
        dec_only, none = q_mod.dequantize(codes_, scales_)
        torch.cuda.synchronize()
        want_dec = ref.dequantize(codes_, scales_)
        want_res = ref.dequantize_residual(codes_, scales_, xq_)
        dequant_checks[label] = {
            "decoded_same_bits": same_bits(dec, want_dec),
            "residual_same_bits": same_bits(res, want_res),
            "decode_only_same_bits": same_bits(dec_only, dec)
            and none is None}
        check(all(dequant_checks[label].values()),
              f"dequantize {label}: {dequant_checks[label]}")
        dequant_checks[label]["max_abs_err"] = max(
            float((dec - want_dec).abs().max()),
            float((res - want_res).abs().max()))
    _, codes_r, scales_r = quant_out["round int8"]
    dequant_row = {
        "name": "dequantize", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quantize.cu",
        "replaces": "src/repro/kernels/quantize.py:97",
        "max_abs_err": max(c["max_abs_err"]
                           for c in dequant_checks.values()),
        # the round runs it with the error-feedback epilogue
        "ms": timed_ms(lambda: q_mod.dequantize(codes_r, scales_r, x_round)),
        "plain_ms": timed_ms(lambda: (
            ref.dequantize(codes_r, scales_r),
            ref.dequantize_residual(codes_r, scales_r, x_round))),
        "library_ms": timed_ms(lambda: codes_r * scales_r),
        "ms_without_residual": timed_ms(lambda: q_mod.dequantize(codes_r,
                                                                 scales_r)),
        "plain_ms_without_residual": timed_ms(
            lambda: ref.dequantize(codes_r, scales_r)),
    }
    dequant_row["bound_ms"], dequant_row["bound_by"] = bound_ms(
        *kernel_costs.dequantize(codes_r, scales_r, x_round))
    dequant_row["bound_ms_without_residual"] = bound_ms(
        *kernel_costs.dequantize(codes_r, scales_r))[0]
    emit(phase="dequantize", shape=list(codes_r.shape),
         checks=dequant_checks,
         tolerance="bit-identical: decoded and residual equal bit for bit",
         library="codes * scales (decode only: compare "
         "ms_without_residual)", **dequant_row)
    done("dequantize")

    # ----------------------------------------------------------------- 8. topk
    # the threshold count and mask against their plain versions, exactly:
    # counts equal (integers in f32), masks equal bit for bit (-0.0 kept
    # at t <= 0, dropped entries +0.0); at the round's uplink shape (C = 2
    # clients of 3328 rows, (C,) thresholds on the device) and off it
    def thresholds(x):
        a = x.abs().reshape(x.shape[0], -1)
        c = x.shape[0]
        return {"zero": torch.zeros(c, device=dev),
                "negative": torch.full((c,), -1.0, device=dev),
                "median": a.median(dim=1).values,
                "tie 1e-4": torch.full((c,), 1e-4, device=dev),
                "above max": torch.nextafter(
                    a.amax(dim=1), torch.tensor(float("inf"), device=dev))}

    x_topk = x_round.view(N_CLIENTS, -1, q_mod.BLOCK)
    x_odd = delta_rows(3 * 64).view(3, 64, q_mod.BLOCK)
    x_odd[:, ::5] = 0.0                          # all-zero rows
    x_odd[:, 1, ::7] = -0.0                      # negative zeros
    x_odd[:, 2, :300] = 1e-4                     # ties at "tie 1e-4"
    x_odd[:, 2, 300:600] = -1e-4
    x_ragged, _ = qcodec._stacked_blocks(randn((1, 5 * 1024 + 77),
                                               torch.float32))
    thresh_cases = [("round C=2", x_topk), ("zero rows, ties, -0.0 C=3", x_odd),
                    ("ragged d=5*1024+77 C=1", x_ragged.view(1, -1,
                                                             q_mod.BLOCK)),
                    ("one client (R, 1024), 0-d threshold", x_round[:3328])]
    thresh_checks = {}
    for label, xt in thresh_cases:
        stacked = xt if xt.dim() == 3 else xt[None]
        for tname, t in thresholds(stacked).items():
            t = t if xt.dim() == 3 else t[0]
            got_n = q_mod.abs_threshold_count(xt, t)
            got_m = q_mod.abs_threshold_mask(xt, t)
            torch.cuda.synchronize()
            want_n = ref.abs_threshold_count(xt, t)
            want_m = ref.abs_threshold_mask(xt, t)
            key = f"{label}, t {tname}"
            thresh_checks[key] = {
                "counts": got_n.reshape(-1).tolist(),
                "counts_equal": bool(torch.equal(got_n, want_n)),
                "mask_same_bits": same_bits(got_m, want_m)}
            if xt is x_odd and bool((t <= 0).all()):
                thresh_checks[key]["negative_zeros_kept"] = bool(
                    (got_m[:, 1, ::7].view(torch.int32) == -2 ** 31).all())
            check(all(v for k_, v in thresh_checks[key].items()
                      if k_ != "counts"), f"threshold {key}: "
                  f"{thresh_checks[key]}")
            thresh_checks[key]["max_abs_err"] = max(
                float((got_n - want_n).abs().max()),
                float((got_m - want_m).abs().max()))

    # the whole selection of the uplink's top-k: the bisection's (lo, hi)
    # and the support through the count kernel, bit for bit as through the
    # plain count (which the round would run on the CPU)
    def selection(flats, k, use_kernel):
        xb, rows = qcodec._stacked_blocks(flats)
        lo, hi = ops.topk_threshold(xb.view(flats.shape[0], rows, -1), k,
                                    use_kernel=use_kernel)
        return (lo, hi) + sparsify.support_in_bracket(flats, lo, hi, k)

    flats_topk = x_round.view(N_CLIENTS, -1)
    k_round = max(1, int(round(0.05 * d_lora)))
    select_checks = {}
    for label, flats, k in [("round C=2 k=0.05 d", flats_topk, k_round),
                            ("zero rows, ties, -0.0 C=3 k=5000",
                             x_odd.view(3, -1), 5000),
                            ("ragged d C=1 k=300",
                             x_ragged.view(1, -1)[:, :5 * 1024 + 77], 300)]:
        got = selection(flats, k, True)
        want = selection(flats, k, False)
        idx_c, val_c = sparsify.topk_support_stacked(flats, k)
        torch.cuda.synchronize()
        xb = qcodec._stacked_blocks(flats)[0].view(flats.shape[0], -1,
                                                   q_mod.BLOCK)
        n_lo = ref.abs_threshold_count(xb, got[0])
        n_hi = ref.abs_threshold_count(xb, got[1])
        select_checks[label] = {
            "lo_hi_same_bits": same_bits(torch.stack(got[:2]),
                                         torch.stack(want[:2])),
            "indices_equal": bool(torch.equal(got[2], want[2])),
            "values_same_bits": same_bits(got[3], want[3]),
            "codec_path_equal": bool(torch.equal(idx_c, got[2])
                                     and torch.equal(val_c, got[3])),
            "bracket": bool(((n_hi < k) & (n_lo >= k)).all())}
        check(all(select_checks[label].values()),
              f"top-k selection {label}: {select_checks[label]}")
    t_mid = thresholds(x_topk)["median"]
    count_row = {
        "name": "abs_threshold_count", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/threshold.cu",
        "replaces": "src/repro/kernels/quantize.py:132",
        "max_abs_err": max(c["max_abs_err"] for c in thresh_checks.values()),
        # the wrapper's time: the scratch's zeroing and the kernel
        "ms": timed_ms(lambda: q_mod.abs_threshold_count(x_topk, t_mid)),
        "plain_ms": timed_ms(lambda: ref.abs_threshold_count(x_topk, t_mid)),
        # no one PyTorch call counts |x| >= t per client
        "library_ms": None,
        "ms_host_paced": timed_ms(
            lambda: q_mod.abs_threshold_count(x_topk, t_mid), hold=False),
    }
    mask_row = {
        "name": "abs_threshold_mask", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/threshold.cu",
        "replaces": "src/repro/kernels/quantize.py:161",
        "max_abs_err": max(c["max_abs_err"] for c in thresh_checks.values()),
        "ms": timed_ms(lambda: q_mod.abs_threshold_mask(x_topk, t_mid)),
        "plain_ms": timed_ms(lambda: ref.abs_threshold_mask(x_topk, t_mid)),
        # no one PyTorch call keeps x where |x| >= t (hardshrink keeps
        # |x| > t, for one Python-float t)
        "library_ms": None,
    }
    count_row["bound_ms"], count_row["bound_by"] = bound_ms(
        *kernel_costs.abs_threshold_count(x_topk, t_mid))
    mask_row["bound_ms"], mask_row["bound_by"] = bound_ms(
        *kernel_costs.abs_threshold_mask(x_topk, t_mid))
    selection_ms = {
        "kernel": timed_ms(lambda: sparsify.topk_support_stacked(
            flats_topk, k_round), iters=10, warmup=2),
        "plain": timed_ms(lambda: selection(flats_topk, k_round, False),
                          iters=10, warmup=2),
        "library_torch_topk": timed_ms(lambda: torch.topk(
            flats_topk.abs(), k_round, dim=1), iters=10, warmup=2),
        "kernel_host_paced": timed_ms(lambda: sparsify.topk_support_stacked(
            flats_topk, k_round), iters=10, warmup=2, hold=False)}
    # its parts: the 32-pass bisection, and the support from the bracket
    xb_topk = flats_topk.view(N_CLIENTS, -1, q_mod.BLOCK)
    lo_t, hi_t = ops.topk_threshold(xb_topk, k_round)
    selection_ms.update({
        "bisection_kernel": timed_ms(lambda: ops.topk_threshold(
            xb_topk, k_round), iters=10, warmup=2),
        "bisection_plain": timed_ms(lambda: ops.topk_threshold(
            xb_topk, k_round, use_kernel=False), iters=10, warmup=2),
        "support_in_bracket": timed_ms(lambda: sparsify.support_in_bracket(
            flats_topk, lo_t, hi_t, k_round), iters=10, warmup=2)})
    emit(phase="topk", shape=list(x_topk.shape), k=k_round,
         checks=thresh_checks, selection_checks=select_checks,
         selection_ms=selection_ms,
         tolerance="exact: counts equal, masks, (lo, hi), indices and "
         "values equal bit for bit", count=count_row, mask=mask_row)
    done("topk")

    # ------------------------------------------------------------------ 9. ssd
    # the SSD kernel against its plain version (ref.ssd_chunked, the
    # reference model's chunk body) and both against the exact per-step
    # recurrence (ref.ssd_scan), y and the final state; within 1e-4 of
    # each tensor's scale (f32 sums in other orders; the chunked form
    # against the recurrence: 1e-5 measured on the CPU).  Inputs as the
    # model makes them: x, B and C silu of one (B, S, din + 2 ds) tensor,
    # x, B and C strided views into it; dt = softplus(N(0, 1)); da = dt A
    # with A = -(1..16) over the heads, so L falls to ~-1800 in a chunk.
    zcfg = get_config("zamba2-1.2b")
    _, z_nh, z_hd, z_ds = ssm.dims(zcfg)

    def ssd_inputs(b, s, nh, ds, zero_dt_head=None, offset=0,
                   generator=None):
        """``offset`` > 0 starts x, B and C that many floats into rows of
        that many more, so no row is 16-byte aligned."""
        xbc = F.silu(randn((b, s, offset + nh * z_hd + 2 * ds),
                           torch.float32, generator))[..., offset:]
        x = xbc[..., :nh * z_hd].view(b, s, nh, z_hd)
        bm = xbc[..., nh * z_hd:nh * z_hd + ds]
        cm = xbc[..., nh * z_hd + ds:]
        dt = F.softplus(randn((b, s, nh), torch.float32, generator))
        if zero_dt_head is not None:
            dt[:, :, zero_dt_head] = 0
        a = -torch.linspace(1.0, 16.0, nh, device=dev)
        return x, bm, cm, dt, dt * a

    def per_head(x, bm, cm, dt, da):
        b, s, nh, hd = x.shape

        def heads(t):
            return t[:, :, None].expand(b, s, nh, t.shape[-1]).permute(
                0, 2, 1, 3).reshape(b * nh, s, -1)
        return (x.permute(0, 2, 1, 3).reshape(b * nh, s, hd), heads(bm),
                heads(cm), dt.permute(0, 2, 1).reshape(b * nh, s),
                da.permute(0, 2, 1).reshape(b * nh, s))

    ssd_cases = [("rollout S=256 strided", (B, 256, z_nh, z_ds), None),
                 ("prefill S=128 strided", (B, P, z_nh, z_ds), None),
                 ("ragged S=1", (2, 1, z_nh, z_ds), None),
                 ("ragged S=100", (2, 100, z_nh, z_ds), None),
                 ("ragged S=129", (2, 129, z_nh, z_ds), None),
                 ("ragged S=200", (2, 200, z_nh, z_ds), None),
                 ("B=1 S=256", (1, 256, z_nh, z_ds), None),
                 ("head 5 all-zero dt S=200", (2, 200, z_nh, z_ds), 5),
                 ("ds=16 (smoke preset) S=200", (2, 200, 8, 16), None)]
    # rows that are not 16-byte aligned take the kernel's 4-byte copies;
    # drawn from a generator of their own, so every other case and phase
    # keeps its inputs
    ssd_misaligned = "misaligned rows S=200"
    ssd_cases.append((ssd_misaligned, (2, 200, z_nh, z_ds), None))
    misaligned_gen = torch.Generator(device=dev).manual_seed(2)
    ssd_checks = {}
    for label, (b_, s_, nh_, ds_), zero in ssd_cases:
        xs_ = (ssd_inputs(b_, s_, nh_, ds_, offset=1,
                          generator=misaligned_gen)
               if label == ssd_misaligned else
               ssd_inputs(b_, s_, nh_, ds_, zero))
        y_k, st_k = ssd_mod.ssd_scan(*xs_, return_state=True)
        y_k2, st_k2 = ssd_mod.ssd_scan(*xs_, return_state=True)
        y_c, st_c = ssd_mod.ssd_scan(*(t.contiguous() for t in xs_),
                                     return_state=True)
        y_p, st_p = ref.ssd_chunked(*xs_)
        y_e, st_e = ref.ssd_scan(*per_head(*xs_), return_state=True)
        torch.cuda.synchronize()
        y_e = y_e.view(b_, nh_, s_, z_hd).permute(0, 2, 1, 3)
        st_e = st_e.view(b_, nh_, z_hd, ds_)
        ssd_checks[label] = {
            "y_vs_plain": max_rel(y_k, y_p),
            "state_vs_plain": max_rel(st_k, st_p),
            "y_vs_recurrence": max_rel(y_k, y_e),
            "state_vs_recurrence": max_rel(st_k, st_e),
            "plain_y_vs_recurrence": max_rel(y_p, y_e),
            "same_bits_twice": bool(torch.equal(y_k, y_k2)
                                    and torch.equal(st_k, st_k2)),
            "same_bits_contiguous": bool(torch.equal(y_k, y_c)
                                         and torch.equal(st_k, st_c)),
            "y_without_state_same_bits": bool(torch.equal(
                ssd_mod.ssd_scan(*xs_), y_k))}
        c_ = ssd_checks[label]
        check(max(c_["y_vs_plain"], c_["state_vs_plain"],
                  c_["y_vs_recurrence"], c_["state_vs_recurrence"]) <= 1e-4
              and c_["same_bits_twice"] and c_["same_bits_contiguous"]
              and c_["y_without_state_same_bits"], f"ssd {label}: {c_}")
        if zero is not None:
            c_["zero_dt_head_y_and_state_zero"] = bool(
                (y_k[:, :, zero] == 0).all() and (st_k[:, zero] == 0).all())
            check(c_["zero_dt_head_y_and_state_zero"],
                  f"ssd {label}: a head with dt = 0 keeps a zero state")
    xs_ = ssd_inputs(B, 256, z_nh, z_ds)
    ssd_row = {
        "name": "ssd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd.py:82",
        "max_abs_err": max(float((a - b_).abs().max()) for a, b_ in zip(
            ssd_mod.ssd_scan(*xs_, return_state=True), ref.ssd_chunked(
                *xs_))),
        "ms": timed_ms(lambda: ssd_mod.ssd_scan(*xs_, return_state=True)),
        "plain_ms": timed_ms(lambda: ref.ssd_chunked(*xs_), iters=10),
        # no one PyTorch call computes the chunked scan
        "library_ms": None,
        "ms_without_state": timed_ms(lambda: ssd_mod.ssd_scan(*xs_)),
        "plain_recurrence_ms": timed_ms(lambda: ref.ssd_scan(
            *per_head(*xs_)), iters=3, warmup=1),
    }
    ssd_bytes, ssd_ops, _ = kernel_costs.ssd(*xs_, chunk=zcfg.ssm_chunk,
                                             return_state=True)
    # the products run on tensor cores in TF32: the bound is the larger of
    # the bytes' time and the operations' at the TF32 peak; beside it the
    # bound of the same operations on the FMA pipes (f32)
    ssd_row["bound_ms"], ssd_row["bound_by"] = bound_ms(ssd_bytes, ssd_ops,
                                                        "tf32")
    ssd_row["bound_ms_fma_f32"], _ = bound_ms(ssd_bytes, ssd_ops, "f32")
    ssd_row["cold_l2_ms"] = cold_ms(lambda: ssd_mod.ssd_scan(
        *xs_, return_state=True))
    ssd_nodes = graph_nodes_per_call(lambda: ssd_mod.ssd_scan(
        *xs_, return_state=True))
    check(ssd_nodes == [graph_kernel_node],
          f"ssd: one kernel a call expected, a call's graph {ssd_nodes}")
    ssd_profiled = profiled_kernels(lambda: ssd_mod.ssd_scan(
        *xs_, return_state=True))
    ssd_hmma = {k: n for k, n in hmma.items() if k.startswith("ssd_")}
    check(all(ssd_hmma.get(f"ssd_scan_kernel<{ds_}>", 0) > 0
              for ds_ in ssd_mod.STATE_DIMS),
          f"an SSD kernel without HMMA: {ssd_hmma}")
    ssd_occupancy = {ds_: ssd_mod.occupancy(ds_)
                     for ds_ in ssd_mod.STATE_DIMS}
    check(ssd_occupancy[64]["blocks_per_sm"] >= 2,
          f"ssd at ds 64: fewer than two blocks an SM {ssd_occupancy}")
    emit(phase="ssd", shape={"x": [B, 256, z_nh, z_hd], "ds": z_ds},
         checks=ssd_checks,
         bytes=ssd_bytes, flops=ssd_ops, hmma=ssd_hmma,
         occupancy=ssd_occupancy, ptxas=ptxas_by_kernel("ssd_scan_kernel"),
         graph_nodes_a_call=ssd_nodes,
         profiler_kernels_in_3_calls=ssd_profiled,
         tolerance="max |kernel - plain| and |kernel - exact recurrence| "
         "<= 1e-4 of the compared tensor's max, y and final state; the same "
         "bits twice and from contiguous inputs", **ssd_row)
    done("ssd")

    # --------------------------------------------------------- 10. rmsnorm_bwd
    # bf16: dx is rounded once from f32 on both sides, after reductions in
    # another order, so it may differ by an ulp: 2e-2 of dx's scale.  f32:
    # 1e-4 of the scale.  The last three cases take the scalar path.
    def bwd_tol(dtype) -> float:
        return 2e-2 if dtype == torch.bfloat16 else 1e-4

    rms_bwd_err = {}
    for shape, dtype, offset in [((4096, d), torch.bfloat16, 0),
                                 ((4096, d), torch.float32, 0),
                                 ((B, d), torch.bfloat16, 0),
                                 ((1, 1001), torch.bfloat16, 0),
                                 ((5, 2050), torch.float32, 0),
                                 ((7, d), torch.bfloat16, 1)]:
        n = shape[0] * shape[1]
        x = randn((n + offset,), dtype)[offset:].view(shape)
        g, dy = randn(shape[-1:], dtype), randn(shape, dtype)
        got, want = rn_mod.rmsnorm_bwd(x, g, dy), ref.rmsnorm_bwd(x, g, dy)
        torch.cuda.synchronize()
        label = (f"{shape} {str(dtype)[6:]}"
                 f"{' misaligned' if offset else ''}")
        rms_bwd_err[label] = max_rel(got, want)
        check(rms_bwd_err[label] <= bwd_tol(dtype),
              f"rmsnorm_bwd {label}: rel err {rms_bwd_err[label]}")
    x, g, dy = (randn((4096, d), torch.bfloat16),
                randn((d,), torch.bfloat16), randn((4096, d), torch.bfloat16))
    xl = x.detach().requires_grad_()
    yl = F.rms_norm(xl, (d,), g, 1e-5)
    rms_bwd_row = {
        "name": "rmsnorm_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:41 (its gradient)",
        "max_abs_err": float((rn_mod.rmsnorm_bwd(x, g, dy)
                              - ref.rmsnorm_bwd(x, g, dy)).abs().max()),
        "ms": timed_ms(lambda: rn_mod.rmsnorm_bwd(x, g, dy)),
        "plain_ms": timed_ms(lambda: ref.rmsnorm_bwd(x, g, dy)),
        "library_ms": timed_ms(lambda: torch.autograd.grad(
            yl, xl, dy, retain_graph=True)),
    }
    rms_bwd_row["bound_ms"], rms_bwd_row["bound_by"] = bound_ms(
        *kernel_costs.rmsnorm_bwd(x, g))
    del xl, yl
    # dg (g trained: a model without adapters), from a generator of its
    # own: xlstm's update shape (B x 256 rows of 768) and off it (d 2048,
    # a last row group shorter than the others at 4099 rows, d 16384 whose
    # partials take more than 48 KB of shared memory, the scalar path at d
    # 1001 and off a 16-byte boundary); against the
    # plain formula and autograd of the plain forward, dx the same bits as
    # the call without dg, the same bits twice.  bf16 dg is one rounding
    # of an f32 sum over the rows taken in another order: 1e-2 of its
    # scale (an ulp is 2**-8); f32 1e-4
    dg_gen = torch.Generator(device=dev).manual_seed(6)
    rms_dg_err = {}
    for shape, dtype, offset in [((B * 256, 768), torch.bfloat16, 0),
                                 ((B * 256, 768), torch.float32, 0),
                                 ((4096, d), torch.bfloat16, 0),
                                 ((4099, 768), torch.bfloat16, 0),
                                 ((9, 16384), torch.float32, 0),
                                 ((3, 1001), torch.bfloat16, 0),
                                 ((7, 768), torch.bfloat16, 1)]:
        n = shape[0] * shape[1]
        x = randn((n + offset,), dtype, dg_gen)[offset:].view(shape)
        g, dy = randn(shape[-1:], dtype, dg_gen), randn(shape, dtype, dg_gen)
        dx, dg = rn_mod.rmsnorm_bwd(x, g, dy, want_dg=True)
        dx2, dg2 = rn_mod.rmsnorm_bwd(x, g, dy, want_dg=True)
        ga = g.detach().requires_grad_()
        (want_auto,) = torch.autograd.grad(ref.rmsnorm(x, ga), ga, dy)
        want = ref.rmsnorm_dg(x, g, dy)
        torch.cuda.synchronize()
        label = (f"{shape} {str(dtype)[6:]}"
                 f"{' misaligned' if offset else ''}")
        rms_dg_err[label] = {"vs_formula": max_rel(dg, want),
                             "vs_autograd": max_rel(dg, want_auto)}
        tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
        check(max(rms_dg_err[label].values()) <= tol
              and identical(dx, rn_mod.rmsnorm_bwd(x, g, dy))
              and identical(dx, dx2) and identical(dg, dg2),
              f"rmsnorm_bwd dg {label}: rel errs {rms_dg_err[label]}")
    x, g, dy = (randn((B * 256, 768), torch.bfloat16, dg_gen),
                randn((768,), torch.bfloat16, dg_gen),
                randn((B * 256, 768), torch.bfloat16, dg_gen))
    rms_bwd_row["ms_xlstm"] = timed_ms(lambda: rn_mod.rmsnorm_bwd(x, g, dy))
    rms_bwd_row["ms_with_dg_xlstm"] = timed_ms(
        lambda: rn_mod.rmsnorm_bwd(x, g, dy, want_dg=True))
    rms_bwd_row["plain_ms_with_dg_xlstm"] = timed_ms(
        lambda: (ref.rmsnorm_bwd(x, g, dy), ref.rmsnorm_dg(x, g, dy)))
    # one call computes dx and dg together: autograd of F.rms_norm with g
    # requiring a gradient
    xl, gl = x.detach().requires_grad_(), g.detach().requires_grad_()
    yl = F.rms_norm(xl, (768,), gl, 1e-5)
    rms_bwd_row["library_ms_with_dg_xlstm"] = timed_ms(
        lambda: torch.autograd.grad(yl, (xl, gl), dy, retain_graph=True))
    del xl, gl, yl
    # what the function needs (the kernel's partials scratch is its own
    # cost)
    rms_bwd_row["bound_ms_with_dg_xlstm"], \
        rms_bwd_row["bound_by_with_dg_xlstm"] = bound_ms(
            *kernel_costs.rmsnorm_bwd(x, g, want_dg=True))
    emit(phase="rmsnorm_bwd", shape=[4096, d], dtype="bf16",
         checks=rms_bwd_err, dg_checks=rms_dg_err,
         tolerance="max |dx - plain| <= 2e-2 (bf16) or 1e-4 (f32) of max "
         "|plain|; dg 1e-2 (bf16) or 1e-4 (f32) of max |plain|",
         **rms_bwd_row)
    done("rmsnorm_bwd")

    # ----------------------------------------------------------- 11. flash_bwd
    # the forward's cases but zamba2's, with the tensor-core kernels' edges
    flash_bwd_err, flash_bwd_paths = {}, {}
    edge_labels = {case[0] for case in FLASH_EDGE_CASES}
    for label, (b, sq, skv, hq, hkv, dh), dt, causal, window in \
            FLASH_BWD_CASES + FLASH_EDGE_CASES:
        dtype = dtypes[dt]
        g_ = edge_gen if label in edge_labels else gen
        q, k, v = qkv(b, sq, skv, hq, hkv, dh, dtype, g_)
        do = randn((b, sq, hq, dh), dtype, g_)
        o, lse = fa_mod.flash_attention_fwd(q, k, v, causal=causal,
                                            sliding_window=window,
                                            with_lse=True)
        got = fa_mod.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                         sliding_window=window)
        again = fa_mod.flash_attention_bwd(q, k, v, o, lse, do,
                                           causal=causal,
                                           sliding_window=window)
        want = ref.flash_attention_bwd(q, k, v, do, causal=causal,
                                       sliding_window=window)
        torch.cuda.synchronize()

        def d_scale(i, want_i) -> float:
            """max |plain|; where the plain gradient is exactly 0 (a single
            key: P = 1, so dS = dP - D cancels), the size of the cancelling
            terms, Dh^-0.5 max |dP| max |K| (dq) or max |Q| (dk)."""
            size = float(want_i.float().abs().max())
            if size > 0 or i == 2:
                return size
            dp = torch.einsum("bqhd,bkhd->bhqk", do.float(),
                              v.float().repeat_interleave(hq // hkv, dim=2))
            return (dh ** -0.5 * float(dp.abs().max())
                    * float((k if i == 0 else q).float().abs().max()))
        errs = {name: float((a.float() - w_.float()).abs().max())
                / d_scale(i, w_) for i, (name, a, w_) in enumerate(zip(
                    ("dq", "dk", "dv"), got, want))}
        flash_bwd_err[label] = errs
        flash_bwd_paths[label] = fa_mod.PATHS[dtype]
        check(max(errs.values()) <= bwd_tol(dtype),
              f"flash_attention_bwd {label}: rel errs {errs}")
        check(all(identical(a, a2) for a, a2 in zip(got, again)),
              f"flash_attention_bwd {label}: a second call gave other bits")
    # head_dim 128: the forward's cases, from their own generator again
    d128_gen.manual_seed(3)
    for label, (b, sq, skv, hq, hkv, dh), dt, causal, window in \
            FLASH_D128_CASES:
        dtype = dtypes[dt]
        q, k, v = qkv(b, sq, skv, hq, hkv, dh, dtype, d128_gen)
        do = randn((b, sq, hq, dh), dtype, d128_gen)
        o, lse = fa_mod.flash_attention_fwd(q, k, v, causal=causal,
                                            sliding_window=window,
                                            with_lse=True)
        got = fa_mod.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                         sliding_window=window)
        again = fa_mod.flash_attention_bwd(q, k, v, o, lse, do,
                                           causal=causal,
                                           sliding_window=window)
        want = ref.flash_attention_bwd(q, k, v, do, causal=causal,
                                       sliding_window=window)
        torch.cuda.synchronize()
        # d_scale of the loop above reads this iteration's inputs
        errs = {name: float((a.float() - w_.float()).abs().max())
                / d_scale(i, w_) for i, (name, a, w_) in enumerate(zip(
                    ("dq", "dk", "dv"), got, want))}
        flash_bwd_err[label] = errs
        flash_bwd_paths[label] = fa_mod.PATHS[dtype]
        check(max(errs.values()) <= bwd_tol(dtype),
              f"flash_attention_bwd {label}: rel errs {errs}")
        check(all(identical(a, a2) for a, a2 in zip(got, again)),
              f"flash_attention_bwd {label}: a second call gave other bits")
        del q, k, v, do, o, lse, got, again, want
    # the encoder-decoder and VLM shapes, from their own generator again
    encdec_gen.manual_seed(5)
    for label, (b, sq, skv, hq, hkv, dh), dt, causal, window in \
            FLASH_ENCDEC_CASES:
        dtype = dtypes[dt]
        q, k, v = qkv(b, sq, skv, hq, hkv, dh, dtype, encdec_gen)
        do = randn((b, sq, hq, dh), dtype, encdec_gen)
        o, lse = fa_mod.flash_attention_fwd(q, k, v, causal=causal,
                                            with_lse=True)
        got = fa_mod.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        again = fa_mod.flash_attention_bwd(q, k, v, o, lse, do,
                                           causal=causal)
        want = ref.flash_attention_bwd(q, k, v, do, causal=causal)
        torch.cuda.synchronize()
        errs = {name: float((a.float() - w_.float()).abs().max())
                / d_scale(i, w_) for i, (name, a, w_) in enumerate(zip(
                    ("dq", "dk", "dv"), got, want))}
        flash_bwd_err[label] = errs
        flash_bwd_paths[label] = fa_mod.PATHS[dtype]
        check(max(errs.values()) <= bwd_tol(dtype),
              f"flash_attention_bwd {label}: rel errs {errs}")
        check(all(identical(a, a2) for a, a2 in zip(got, again)),
              f"flash_attention_bwd {label}: a second call gave other bits")
        del q, k, v, do, o, lse, got, again, want
    q, k, v = qkv(B, s, s, 32, 8, 64, torch.bfloat16)
    do = randn((B, s, 32, 64), torch.bfloat16)
    o, lse = fa_mod.flash_attention_fwd(q, k, v, causal=True, with_lse=True)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                        enable_gqa=True)
    dot_ = do.transpose(1, 2)
    flash_bwd_row = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:98 (its gradient)",
        "max_abs_err": max(
            float((a.float() - w_.float()).abs().max()) for a, w_ in zip(
                fa_mod.flash_attention_bwd(q, k, v, o, lse, do),
                ref.flash_attention_bwd(q, k, v, do))),
        "ms": timed_ms(lambda: fa_mod.flash_attention_bwd(q, k, v, o, lse,
                                                          do)),
        "plain_ms": timed_ms(lambda: ref.flash_attention_bwd(q, k, v, do),
                             iters=10),
        "library_ms": timed_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot_, retain_graph=True)),
    }
    flash_bwd_row["bound_ms"], flash_bwd_row["bound_by"] = bound_ms(
        *kernel_costs.flash_attention_bwd(q, k, v, causal=True))
    del qt, kt, vt, ot
    # the same at head_dim 128, mixtral's training shape
    q8, k8, v8 = qkv(B, s, s, 32, 8, 128, torch.bfloat16, d128_gen)
    do8 = randn((B, s, 32, 128), torch.bfloat16, d128_gen)
    o8, lse8 = fa_mod.flash_attention_fwd(q8, k8, v8, causal=True,
                                          with_lse=True)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q8, k8, v8))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                        enable_gqa=True)
    dot_ = do8.transpose(1, 2)
    flash_bwd_row.update({
        "max_abs_err_dh128": max(
            float((a.float() - w_.float()).abs().max()) for a, w_ in zip(
                fa_mod.flash_attention_bwd(q8, k8, v8, o8, lse8, do8),
                ref.flash_attention_bwd(q8, k8, v8, do8))),
        "ms_dh128": timed_ms(lambda: fa_mod.flash_attention_bwd(
            q8, k8, v8, o8, lse8, do8)),
        "plain_ms_dh128": timed_ms(lambda: ref.flash_attention_bwd(
            q8, k8, v8, do8), iters=10),
        "library_ms_dh128": timed_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot_, retain_graph=True)),
    })
    flash_bwd_row["bound_ms_dh128"], flash_bwd_row["bound_by_dh128"] = \
        bound_ms(*kernel_costs.flash_attention_bwd(q8, k8, v8, causal=True))
    del qt, kt, vt, ot, q8, k8, v8, do8, o8, lse8

    def flash_bwd_at(tag, b, sq, skv, hq, hkv, dh):
        """The backward kernel, the plain version and SDPA's backward at
        one non-causal shape of ``FLASH_ENCDEC_CASES``, with its bound."""
        q_, k_, v_ = qkv(b, sq, skv, hq, hkv, dh, torch.bfloat16, encdec_gen)
        do_ = randn((b, sq, hq, dh), torch.bfloat16, encdec_gen)
        o_, lse_ = fa_mod.flash_attention_fwd(q_, k_, v_, causal=False,
                                              with_lse=True)
        t_ = [t.transpose(1, 2).detach().requires_grad_()
              for t in (q_, k_, v_)]
        ot_ = F.scaled_dot_product_attention(*t_, enable_gqa=True)
        flash_bwd_row.update({
            f"ms_{tag}": timed_ms(lambda: fa_mod.flash_attention_bwd(
                q_, k_, v_, o_, lse_, do_, causal=False), iters=20),
            f"plain_ms_{tag}": timed_ms(lambda: ref.flash_attention_bwd(
                q_, k_, v_, do_, causal=False), iters=3, warmup=1),
            f"library_ms_{tag}": timed_ms(lambda: torch.autograd.grad(
                ot_, t_, do_.transpose(1, 2), retain_graph=True),
                iters=20)})
        flash_bwd_row[f"bound_ms_{tag}"], \
            flash_bwd_row[f"bound_by_{tag}"] = bound_ms(
                *kernel_costs.flash_attention_bwd(q_, k_, v_, causal=False))
    flash_bwd_at("whisper_enc", B, 1500, 1500, 20, 20, 64)
    flash_bwd_at("vision_cross", B, 256, 1601, 64, 8, 128)

    # What D = rowsum(dO * O) from the bf16 O (the kernel's choice, as in
    # FlashAttention-2) adds to the kernel's distance from f32: the
    # kernel's dq, dk, dv beside (a) autograd of the plain forward in f32,
    # which uses the f32 O, and (b) FlashAttention-2's formula in plain f32
    # with D from the kernel's bf16 O; (c), the formula with the f32 O,
    # checks the formula against (a).
    def fa2_grads(o_for_d):
        hkv = k.shape[2]
        qpk = q.shape[2] // hkv
        qf = q.float().transpose(1, 2)
        kf, vf = (t.float().repeat_interleave(qpk, dim=2).transpose(1, 2)
                  for t in (k, v))
        dof = do.float().transpose(1, 2)
        scale = q.shape[3] ** -0.5
        causal_mask = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
        p_ = torch.softmax((qf @ kf.transpose(-1, -2) * scale).masked_fill(
            ~causal_mask, ref.NEG_INF), dim=-1)
        d_ = (dof * o_for_d.float().transpose(1, 2)).sum(-1, keepdim=True)
        ds_ = p_ * (dof @ vf.transpose(-1, -2) - d_)

        def group(t):  # (B, Hq, S, Dh) -> (B, S, Hkv, Dh), summed
            return t.transpose(1, 2).unflatten(2, (hkv, qpk)).sum(3)
        return ((ds_ @ kf * scale).transpose(1, 2),
                group(ds_.transpose(-1, -2) @ qf * scale),
                group(p_.transpose(-1, -2) @ dof))

    def rel_l2(got, want) -> float:
        return float((got.float() - want).norm() / want.norm())

    kernel_g = fa_mod.flash_attention_bwd(q, k, v, o, lse, do)
    grads_a = ref.flash_attention_bwd(q.float(), k.float(), v.float(),
                                      do.float())
    grads_b = fa2_grads(o)
    grads_c = fa2_grads(ref.flash_attention(q.float(), k.float(), v.float()))
    d_question = {}
    for i, name in enumerate(("dq", "dk", "dv")):
        d_question[name] = {
            "kernel_vs_a": rel_l2(kernel_g[i], grads_a[i]),
            "kernel_vs_b": rel_l2(kernel_g[i], grads_b[i]),
            "b_vs_a": rel_l2(grads_b[i], grads_a[i]),
            "c_vs_a": rel_l2(grads_c[i], grads_a[i]),
            "a_rounded_to_bf16_vs_a": rel_l2(grads_a[i].bfloat16(),
                                             grads_a[i])}
    check(max(v_["c_vs_a"] for v_ in d_question.values()) <= 1e-5,
          f"the FlashAttention-2 formula with the f32 O is autograd's: "
          f"{d_question}")
    del kernel_g, grads_a, grads_b, grads_c
    flash_bwd_regs = {}
    for part in ("dq", "dkv"):
        for path in ("mma", "fma"):
            flash_bwd_regs.update(ptxas_by_kernel(
                f"flash_bwd_{part}_{path}_kernel"))
    emit(phase="flash_bwd", shape=[B, s, 32, 8, 64], dtype="bf16",
         causal=True, checks=flash_bwd_err, same_bits_twice=True,
         registers=flash_bwd_regs,
         paths=flash_bwd_paths,
         d_from_bf16_o=d_question,
         tolerance="max |d - plain| <= 2e-2 (bf16) or 1e-4 (f32) of max "
         "|plain|, for each of dq, dk, dv (where the plain dq or dk is "
         "exactly 0, of Dh^-0.5 max|dP| max|K or Q|)", **flash_bwd_row)
    done("flash_bwd")

    # ------------------------------------------------------------- 12. ssd_bwd
    # the SSD backward kernels against the plain version (autograd of
    # ref.ssd_chunked) and against the kernels' formulas written out
    # (ref.ssd_chunked_bwd), dx, dB, dC, d(dt) and d(da), each within 1e-4
    # of its scale (d(da)'s at least max |dt d(dt)|: its terms are those
    # of dt d(dt), and where they cancel, at S = 1, the f32 sums leave a
    # residue of their size); the plain f32 autograd itself lies within
    # 1e-4 of a float64 recurrence (tests/test_torch_ssd_bwd.py), so no
    # float64 rule is needed.  The ssd phase's inputs and cases, with and
    # without a d(final state); dy and d(final state) N(0, 1); drawn from a
    # generator of the phase's own, so the later phases keep their inputs.
    bwd_gen = torch.Generator(device=dev).manual_seed(12)
    def ssd_bwd_scales(want, dt_):
        sc = [float(w.abs().max()) for w in want]
        sc[4] = max(sc[4], float((dt_ * want[3]).abs().max()))
        return sc

    def ssd_plain_bwd(xs_, dy_, dst_):
        leaves = [t.detach().clone().requires_grad_() for t in xs_]
        with torch.enable_grad():
            y_, st_ = ref.ssd_chunked(*leaves)
            outs = (y_, st_) if dst_ is not None else (y_,)
            return torch.autograd.grad(
                outs, leaves, (dy_, dst_) if dst_ is not None else (dy_,))

    grad_names = ("dx", "dB", "dC", "d(dt)", "d(da)")
    # the ssd phase's cases (the first with and without a d(final state),
    # then every other one with it), then two of many chunks, each with and
    # without: the chunks run in parallel, each from the first launch's
    # boundary states
    ssd_bwd_cases = [(label, dims, zero, (False, True) if k_case == 0 else
                      (k_case % 2 == 1,))
                     for k_case, (label, dims, zero) in enumerate(ssd_cases)]
    ssd_bwd_cases += [
        ("ragged S=1000 (8 chunks)", (2, 1000, z_nh, z_ds), None,
         (False, True)),
        ("ds=16 S=640 (5 chunks)", (2, 640, 8, 16), None, (False, True))]
    ssd_bwd_checks = {}
    for label, (b_, s_, nh_, ds_), zero, states in ssd_bwd_cases:
        xs_ = (ssd_inputs(b_, s_, nh_, ds_, offset=1,
                          generator=misaligned_gen)
               if label == ssd_misaligned else
               ssd_inputs(b_, s_, nh_, ds_, zero, generator=bwd_gen))
        dy_ = randn((b_, s_, nh_, z_hd), torch.float32, bwd_gen)
        for with_state in states:
            dst_ = (randn((b_, nh_, z_hd, ds_), torch.float32, bwd_gen)
                    if with_state else None)
            got = ssd_mod.ssd_scan_bwd(*xs_, dy_, dst_)
            again = ssd_mod.ssd_scan_bwd(*xs_, dy_, dst_)
            contig = ssd_mod.ssd_scan_bwd(*(t.contiguous() for t in xs_),
                                          dy_, dst_)
            plain = ssd_plain_bwd(xs_, dy_, dst_)
            formulas = ref.ssd_chunked_bwd(*xs_, dy_, dst_)
            torch.cuda.synchronize()
            scales = ssd_bwd_scales(plain, xs_[3])
            c_ = {"vs_plain": {n: float((a - w).abs().max()) / sc
                               for n, a, w, sc in zip(grad_names, got,
                                                      plain, scales)},
                  "vs_formulas": {n: float((a - w).abs().max()) / sc
                                  for n, a, w, sc in zip(
                                      grad_names, got, formulas, scales)},
                  "same_bits_twice": all(identical(a, a2) for a, a2 in
                                         zip(got, again)),
                  "same_bits_contiguous": all(identical(a, a2) for a, a2
                                              in zip(got, contig))}
            key = label + (" with d(final state)" if with_state else "")
            ssd_bwd_checks[key] = c_
            check(max(c_["vs_plain"].values()) <= 1e-4
                  and max(c_["vs_formulas"].values()) <= 1e-4
                  and c_["same_bits_twice"] and c_["same_bits_contiguous"],
                  f"ssd_bwd {key}: {c_}")
            if zero is not None:
                c_["zero_dt_head_dx_zero"] = bool((got[0][:, :, zero]
                                                   == 0).all())
                check(c_["zero_dt_head_dx_zero"],
                      f"ssd_bwd {key}: x gets no gradient through dt = 0")
    # through ops.ssd_scan: inputs that need a gradient run the forward
    # kernel and, at the pull, the backward kernels
    xs_ = ssd_inputs(B, 256, z_nh, z_ds, generator=bwd_gen)
    dy_ = randn((B, 256, z_nh, z_hd), torch.float32, bwd_gen)
    leaves = [t.detach().clone().requires_grad_() for t in xs_]
    launches_before = (ssd_mod.launches, ssd_mod.bwd_launches)
    with torch.enable_grad():
        y_ = ops.ssd_scan(*leaves)
        through_ops = torch.autograd.grad(y_, leaves, dy_)
    direct = ssd_mod.ssd_scan_bwd(*xs_, dy_)
    check((ssd_mod.launches - launches_before[0],
           ssd_mod.bwd_launches - launches_before[1]) == (1, 2)
          and all(identical(a, b_) for a, b_ in zip(through_ops, direct)),
          "ops.ssd_scan: one forward and one backward launch, the "
          "backward's bits")
    del leaves, y_, through_ops, direct
    # the training shape, timed: held, with the L2 flushed, the plain
    # version's backward on a kept graph
    p_leaves = [t.detach().clone().requires_grad_() for t in xs_]
    with torch.enable_grad():
        p_out = ref.ssd_chunked(*p_leaves)[0]
    ssd_bwd_row = {
        "name": "ssd_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_bwd.cu",
        "replaces": "src/repro/kernels/ssd.py:82 (its gradient)",
        "max_abs_err": max(float((a - w).abs().max()) for a, w in zip(
            ssd_mod.ssd_scan_bwd(*xs_, dy_), ssd_plain_bwd(xs_, dy_, None))),
        "ms": timed_ms(lambda: ssd_mod.ssd_scan_bwd(*xs_, dy_), iters=20),
        "plain_ms": timed_ms(lambda: torch.autograd.grad(
            p_out, p_leaves, dy_, retain_graph=True), iters=5, warmup=1),
        # no one PyTorch call computes the scan's gradient
        "library_ms": None,
        "cold_l2_ms": cold_ms(lambda: ssd_mod.ssd_scan_bwd(*xs_, dy_)),
    }
    del p_leaves, p_out
    # bytes: x, B, C, dt, da and dy read once, dx, dB, dC, d(dt) and d(da)
    # written once; operations: per chunk and head 4 hd a causal pair (dS,
    # and dx from the scores) and 10 hd ds a position (the chunk-start
    # state recomputed, dy^T h0, x^T dh, dh B and the new dh), per chunk
    # and batch row 6 ds a causal pair (C B^T, and dC and dB from the
    # gradient of C B^T, once for the heads)
    ssd_bwd_bytes, ssd_bwd_ops, _ = kernel_costs.ssd_bwd(
        *xs_, chunk=zcfg.ssm_chunk)
    ssd_bwd_row["bound_ms"], ssd_bwd_row["bound_by"] = bound_ms(
        ssd_bwd_bytes, ssd_bwd_ops, "tf32")
    ssd_bwd_row["bound_ms_fma_f32"], _ = bound_ms(ssd_bwd_bytes, ssd_bwd_ops,
                                                  "f32")
    ssd_bwd_nodes = graph_nodes_per_call(lambda: ssd_mod.ssd_scan_bwd(
        *xs_, dy_))
    check(ssd_bwd_nodes == [graph_kernel_node] * ssd_mod.BWD_KERNELS,
          f"ssd_bwd: {ssd_mod.BWD_KERNELS} kernels a call expected, a "
          f"call's graph {ssd_bwd_nodes}")
    ssd_bwd_ptxas = {**ptxas_by_kernel("ssd_bwd_states_kernel"),
                     **ptxas_by_kernel("ssd_bwd_chunk_kernel")}
    ssd_bwd_occupancy = {ds_: ssd_mod.occupancy(ds_, backward=True)
                         for ds_ in ssd_mod.STATE_DIMS}
    check(all(o["blocks_per_sm"] >= 1 for o in ssd_bwd_occupancy.values()),
          f"ssd_bwd: the chunk kernel fits no SM {ssd_bwd_occupancy}")
    emit(phase="ssd_bwd", shape={"x": [B, 256, z_nh, z_hd], "ds": z_ds},
         checks=ssd_bwd_checks, bytes=ssd_bwd_bytes, flops=ssd_bwd_ops,
         ptxas=ssd_bwd_ptxas, occupancy=ssd_bwd_occupancy,
         graph_nodes_a_call=ssd_bwd_nodes,
         tolerance="max |kernel - plain| and |kernel - formulas| <= 1e-4 of "
         "each gradient's scale (d(da): at least max |dt d(dt)|); the same "
         "bits twice and from contiguous inputs", **ssd_bwd_row)
    done("ssd_bwd")

    def decode_parts(mcfg, params, prompts, seed: int) -> dict:
        """One decode of MAX_NEW steps through the graph after prefill, by
        part: the capture plus instantiation, and the replays (from the
        graph's being ready to the last replay's end; the eager step 0
        ran before the capture)."""
        _, cache = transformer.prefill(mcfg, params, prompts,
                                       cache_len=P + MAX_NEW)
        g = sampling._StepGraph(dev)
        sampling._decode(mcfg, params, cache, prompts[:, -1:],
                         max_new=MAX_NEW, temperature=1.0,
                         generator=torch.Generator(device=dev).manual_seed(
                             seed), graph=g)
        torch.cuda.synchronize()
        return {"decode_capture": g.capture_s + g.instantiate_s,
                "decode_replay": time.perf_counter() - g.ready_at}

    # ------------------------------------------------------------- 13. rollout
    fc = FIRMConfig()
    check(fc.batch_size == B and fc.n_objectives == N_OBJ,
          "FIRMConfig defaults changed")
    ref_params = transformer.init_params(cfg, generator=gen, device=dev)
    train, frozen = common.split_trainable(ref_params)
    # a policy one training step away from the reference: non-zero lora_B
    train = common.tree_map(
        lambda t: t + 1e-3 * torch.randn(t.shape, generator=gen, device=dev),
        train)
    policy = common.merge_trainable(train, frozen)
    ds = make_client_datasets(1, cfg.vocab, P, generator=gen, device=dev)[0]
    prompts = ds.next_batch(B)
    band_h, band_x = rewards.variant_bands(cfg.vocab)
    length_tol = max(4, MAX_NEW // 2)

    def rollout():
        return rollout_batch(cfg, policy, ref_params, prompts, band_h, band_x,
                             n_objectives=N_OBJ, max_new=MAX_NEW,
                             length_tol=length_tol, generator=gen)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    batch, rollout_s = wall(rollout)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    per_forward = 2 * cfg.n_layers + 1
    rollout_launches = {"rmsnorm": per_forward * (1 + MAX_NEW + 1),
                        "flash_attention": 2 * cfg.n_layers}
    want_launches = dict(rollout_launches, rmsnorm_bwd=0,
                         flash_attention_bwd=0, gram=0, quantize=0,
                         dequantize=0, abs_threshold_count=0,
                         abs_threshold_mask=0, ssd=0, ssd_bwd=0)
    check(launches == want_launches,
          f"launch counts {launches}, expected {want_launches}")

    s_total = P + MAX_NEW
    tok, mask = batch.tokens, batch.response_mask
    check(tuple(tok.shape) == (B, s_total), f"tokens shape {tok.shape}")
    check(bool(((tok >= 0) & (tok < cfg.vocab)).all()), "token ids range")
    check(torch.equal(tok[:, :P], prompts), "prompt kept in the tokens")
    check(bool((mask[:, :P] == 0).all() and (mask[:, P:] == 1).all()),
          "response mask")
    for name in ("old_logprobs", "ref_logprobs"):
        lp = getattr(batch, name)
        check(tuple(lp.shape) == (B, s_total) and bool(lp.isfinite().all()),
              f"{name} finite of shape (B, S)")
        check(bool((lp <= 0).all()), f"{name} <= 0")
    check(bool((batch.old_logprobs[:, :P] == 0).all()), "prompt logprobs 0")
    r = batch.rewards
    check(tuple(r.shape) == (B, N_OBJ) and bool(r.isfinite().all()),
          "rewards shape")
    check(bool(((r >= 0) & (r <= 1)).all()), "rewards in [0, 1]")

    # teacher-forced: the same forward through the kernels and through the
    # plain versions, both in bf16, each against the plain forward in f32
    # (the same bf16 weights, upcast).  bf16 rounds at other places in the
    # kernels and the plain versions, so neither matches the other bit for
    # bit; the kernels' path must be as close to the f32 forward as the
    # plain path is: within 25% on the mean error and 50% on the largest.
    def logits_and_lp(p, **kw):
        logits = transformer.forward_seq(cfg, p, tok, **kw)["logits"]
        return logits.float(), ppo.token_logprobs(logits, tok)

    policy32 = common.tree_map(lambda t: t.float(), policy)
    logits_32, lp_32 = logits_and_lp(policy32, use_kernel=False)
    del policy32
    logits_k, lp_k = logits_and_lp(policy)
    logits_p, lp_p = logits_and_lp(policy, use_kernel=False)

    def err(a, b):
        d = (a - b).abs()
        return {"mean_abs": float(d.mean()), "max_abs": float(d.max())}

    tf = {"logits": {"kernels_vs_f32": err(logits_k, logits_32),
                     "plain_vs_f32": err(logits_p, logits_32),
                     "kernels_vs_plain": err(logits_k, logits_p),
                     "max_abs_value": float(logits_32.abs().max())},
          "logprobs": {"kernels_vs_f32": err(lp_k, lp_32),
                       "plain_vs_f32": err(lp_p, lp_32),
                       "kernels_vs_plain": err(lp_k, lp_p)}}
    # kernels against plain directly, at the CPU parity tests' bf16
    # tolerance (tests/test_torch_models.py): 2e-2 of the tensor's scale
    for what, got, want in (("logits", logits_k, logits_p),
                            ("logprobs", lp_k, lp_p)):
        limit = 2e-2 * max(1.0, float(want.abs().max()))
        tf[what]["kernels_vs_plain"]["limit"] = limit
        check(tf[what]["kernels_vs_plain"]["max_abs"] <= limit,
              f"teacher-forced {what}, kernels vs plain: {tf[what]}")
    del logits_32, logits_k, logits_p
    for what, e in tf.items():
        k, p = e["kernels_vs_f32"], e["plain_vs_f32"]
        check(k["mean_abs"] <= 1.25 * p["mean_abs"]
              and k["max_abs"] <= 1.5 * p["max_abs"],
              f"teacher-forced {what}: kernels further from f32 than the "
              f"plain path: {e}")

    # where the rollout's time goes (after the counted run)
    _, prefill_s = wall(lambda: transformer.prefill(
        cfg, policy, prompts, cache_len=s_total))
    (tokens2, _, mask2), generate_s = wall(lambda: generate(
        cfg, policy, prompts, max_new=MAX_NEW, generator=gen))
    _, rewards_s = wall(lambda: rewards.score_batch_banded(
        band_h, band_x, tokens2, mask2, N_OBJ, length_tol))
    _, ref_s = wall(lambda: ppo.token_logprobs(
        transformer.forward_seq(cfg, ref_params, tokens2)["logits"],
        tokens2))
    parts = decode_parts(cfg, policy, prompts, seed=11)
    emit(phase="rollout", model=cfg.name, params=cfg.param_count(),
         batch=B, prompt_len=P, max_new=MAX_NEW, n_objectives=N_OBJ,
         seconds=rollout_s, generated_tokens_per_s=B * MAX_NEW / rollout_s,
         peak_memory_bytes=peak, launches=launches,
         teacher_forced=tf,
         tolerance="kernels vs plain bf16: max abs <= 2e-2 * max(1, max "
         "|plain|); kernels' error vs the f32 forward <= 1.25x (mean) and "
         "1.5x (max) the plain bf16 path's",
         reward_means=[float(x) for x in r.mean(0)],
         breakdown_s={"prefill": prefill_s,
                      "decode_128_steps": generate_s - prefill_s,
                      **parts, "generate": generate_s, "rewards": rewards_s,
                      "reference_logprobs": ref_s})

    # device busy share of decode: 8 steps under torch.profiler
    _, cache = transformer.prefill(cfg, policy, prompts,
                                   cache_len=P + MAX_NEW)
    step_tok = prompts[:, -1:]

    def decode_8():
        nonlocal cache
        for _ in range(8):
            _, cache = transformer.decode_step(cfg, policy, cache, step_tok)

    emit(phase="decode_profile", profile=device_profile(decode_8, 8))
    done("rollout")

    # ------------------------------------------------------ 14. rollout_hybrid
    # the same rollout on zamba2-1.2b at full width: 32 Mamba2 layers (the
    # SSD kernel in every sequence forward) and 6 applications of the one
    # shared attention block (MHA, 32 query and 32 KV heads)
    z_ref = transformer.init_params(zcfg, generator=gen, device=dev)
    z_train, z_frozen = common.split_trainable(z_ref)
    z_train = common.tree_map(
        lambda t: t + 1e-3 * torch.randn(t.shape, generator=gen, device=dev),
        z_train)
    z_policy = common.merge_trainable(z_train, z_frozen)
    z_ds_ = make_client_datasets(1, zcfg.vocab, P, generator=gen,
                                 device=dev)[0]
    z_prompts = z_ds_.next_batch(B)
    z_band_h, z_band_x = rewards.variant_bands(zcfg.vocab)

    def z_rollout():
        return rollout_batch(zcfg, z_policy, z_ref, z_prompts, z_band_h,
                             z_band_x, n_objectives=N_OBJ, max_new=MAX_NEW,
                             length_tol=length_tol, generator=gen)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    z_batch, z_rollout_s = wall(z_rollout)
    z_launches = read_counts()
    z_peak = torch.cuda.max_memory_allocated()
    n_mamba = zcfg.pattern.count("mamba2") * zcfg.n_periods
    n_attn = len(zcfg.pattern) * zcfg.n_periods - n_mamba
    z_per_forward = n_mamba + 2 * n_attn + 1
    want_z = {name: 0 for name in counters}
    want_z.update(rmsnorm=z_per_forward * (1 + MAX_NEW + 1),
                  flash_attention=2 * n_attn, ssd=2 * n_mamba)
    check((n_mamba, n_attn, z_per_forward) == (32, 6, 45)
          and want_z["rmsnorm"] == 5850, "zamba2's layer counts changed")
    check(z_launches == want_z,
          f"zamba2 launch counts {z_launches}, expected {want_z}")

    z_tok, z_mask = z_batch.tokens, z_batch.response_mask
    check(tuple(z_tok.shape) == (B, s_total), f"tokens shape {z_tok.shape}")
    check(bool(((z_tok >= 0) & (z_tok < zcfg.vocab)).all()),
          "token ids range")
    check(torch.equal(z_tok[:, :P], z_prompts), "prompt kept in the tokens")
    check(bool((z_mask[:, :P] == 0).all() and (z_mask[:, P:] == 1).all()),
          "response mask")
    for name in ("old_logprobs", "ref_logprobs"):
        lp = getattr(z_batch, name)
        check(tuple(lp.shape) == (B, s_total) and bool(lp.isfinite().all())
              and bool((lp <= 0).all()), f"zamba2 {name} finite, <= 0")
    z_r = z_batch.rewards
    check(tuple(z_r.shape) == (B, N_OBJ) and bool(((z_r >= 0)
                                                  & (z_r <= 1)).all()),
          "zamba2 rewards in [0, 1]")

    # teacher-forced.  bf16: the kernels' path as close to the f32 forward
    # (the same bf16 weights, upcast) as the plain path, the llama rule;
    # the two bf16 paths' distance from each other is reported, not gated:
    # through 38 layers each lies up to ~6% of the logits' scale from the
    # f32 forward (1-ulp flips, measured on one H100), beyond the llama
    # gate's 2e-2.  f32: the same forward through the kernels and through
    # the plain versions within 1e-4 of the logits' scale.
    def z_logits_and_lp(p, **kw):
        logits = transformer.forward_seq(zcfg, p, z_tok, **kw)["logits"]
        return logits.float(), ppo.token_logprobs(logits, z_tok)

    z_policy32 = common.tree_map(lambda t: t.float(), z_policy)
    z_logits_32, z_lp_32 = z_logits_and_lp(z_policy32, use_kernel=False)
    z_logits_k32, z_lp_k32 = z_logits_and_lp(z_policy32)
    z_logits_k, z_lp_k = z_logits_and_lp(z_policy)
    z_logits_p, z_lp_p = z_logits_and_lp(z_policy, use_kernel=False)
    z_tf = {"logits": {"kernels_vs_f32": err(z_logits_k, z_logits_32),
                       "plain_vs_f32": err(z_logits_p, z_logits_32),
                       "kernels_vs_plain": err(z_logits_k, z_logits_p),
                       "f32_kernels_vs_f32_plain": err(z_logits_k32,
                                                       z_logits_32),
                       "max_abs_value": float(z_logits_32.abs().max())},
            "logprobs": {"kernels_vs_f32": err(z_lp_k, z_lp_32),
                         "plain_vs_f32": err(z_lp_p, z_lp_32),
                         "kernels_vs_plain": err(z_lp_k, z_lp_p),
                         "f32_kernels_vs_f32_plain": err(z_lp_k32, z_lp_32)}}
    for what, want in (("logits", z_logits_32), ("logprobs", z_lp_32)):
        limit = 1e-4 * max(1.0, float(want.abs().max()))
        z_tf[what]["f32_kernels_vs_f32_plain"]["limit"] = limit
        check(z_tf[what]["f32_kernels_vs_f32_plain"]["max_abs"] <= limit,
              f"zamba2 teacher-forced f32 {what}, kernels vs plain: "
              f"{z_tf[what]}")
    del z_logits_32, z_logits_k32, z_logits_k, z_logits_p
    for what, e in z_tf.items():
        k, p = e["kernels_vs_f32"], e["plain_vs_f32"]
        check(k["mean_abs"] <= 1.25 * p["mean_abs"]
              and k["max_abs"] <= 1.5 * p["max_abs"],
              f"zamba2 teacher-forced {what}: kernels further from f32 than "
              f"the plain path: {e}")

    # decode after prefill(S) against the f32 forward at position S, on the
    # f32 copy of the weights and an f32 cache: 1e-4 (rtol and atol), as
    # the CPU test of the port holds it
    s_pre = 200
    with torch.no_grad():
        z_full = transformer.forward_seq(zcfg, z_policy32,
                                         z_tok[:, :s_pre + 1])["logits"]
        _, z_cache = transformer.prefill(zcfg, z_policy32, z_tok[:, :s_pre],
                                         cache_len=s_pre + 1,
                                         cache_dtype=torch.float32)
        z_dec, _ = transformer.decode_step(zcfg, z_policy32, z_cache,
                                           z_tok[:, s_pre:s_pre + 1])
    z_want = z_full[:, s_pre].float()
    z_dec_err = (z_dec.float() - z_want).abs()
    z_decode_check = {"max_abs": float(z_dec_err.max()),
                      "max_abs_value": float(z_want.abs().max()),
                      "within_1e-4": bool((z_dec_err <= 1e-4
                                           + 1e-4 * z_want.abs()).all())}
    check(z_decode_check["within_1e-4"],
          f"zamba2 decode after prefill({s_pre}) vs the f32 forward: "
          f"{z_decode_check}")
    del z_policy32, z_full, z_cache

    _, z_prefill_s = wall(lambda: transformer.prefill(
        zcfg, z_policy, z_prompts, cache_len=s_total))
    (z_tokens2, _, z_mask2), z_generate_s = wall(lambda: generate(
        zcfg, z_policy, z_prompts, max_new=MAX_NEW, generator=gen))
    _, z_rewards_s = wall(lambda: rewards.score_batch_banded(
        z_band_h, z_band_x, z_tokens2, z_mask2, N_OBJ, length_tol))
    _, z_ref_s = wall(lambda: ppo.token_logprobs(
        transformer.forward_seq(zcfg, z_ref, z_tokens2)["logits"],
        z_tokens2))
    _, z_cache = transformer.prefill(zcfg, z_policy, z_prompts,
                                     cache_len=P + MAX_NEW)
    z_step_tok = z_prompts[:, -1:]

    def z_decode_8():
        nonlocal z_cache
        for _ in range(8):
            _, z_cache = transformer.decode_step(zcfg, z_policy, z_cache,
                                                 z_step_tok)

    z_profile = device_profile(z_decode_8, 8)
    z_parts = decode_parts(zcfg, z_policy, z_prompts, seed=12)
    emit(phase="rollout_hybrid", model=zcfg.name,
         params=common.tree_size(z_ref),
         param_count_reference_arithmetic=zcfg.param_count(), batch=B,
         prompt_len=P, max_new=MAX_NEW, n_objectives=N_OBJ,
         seconds=z_rollout_s, generated_tokens_per_s=B * MAX_NEW / z_rollout_s,
         peak_memory_bytes=z_peak, launches=z_launches, teacher_forced=z_tf,
         decode_after_prefill=z_decode_check,
         tolerance="bf16: kernels' error vs the f32 forward <= 1.25x "
         "(mean) and 1.5x (max) the plain bf16 path's; f32: kernels vs plain "
         "max abs <= 1e-4 * max(1, max |plain|); f32 decode after prefill vs "
         "the f32 forward: 1e-4 + 1e-4 |forward|",
         reward_means=[float(x) for x in z_r.mean(0)],
         breakdown_s={"prefill": z_prefill_s,
                      "decode_128_steps": z_generate_s - z_prefill_s,
                      **z_parts, "generate": z_generate_s,
                      "rewards": z_rewards_s,
                      "reference_logprobs": z_ref_s},
         decode_profile=z_profile)
    del z_cache
    done("rollout_hybrid")

    # -------------------------------------------------------- 15. decode_graph
    # generation as a captured program: on each model at full width, the
    # decode of MAX_NEW steps through one captured CUDA graph a call
    # (sampling._decode with a _StepGraph, as generate and serve run it)
    # against the eager loop (sampling._decode_eager), the same noise
    def decode_graph_case(mcfg, params, prompts, per_step: int,
                          seed: int) -> dict:
        last = prompts[:, -1:]
        _, cache = transformer.prefill(mcfg, params, prompts,
                                       cache_len=P + MAX_NEW)
        cache_e = clone_cache(cache)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (tok_e, lp_e), eager_s = wall(lambda: sampling._decode_eager(
            mcfg, params, cache_e, last, max_new=MAX_NEW, temperature=1.0,
            generator=torch.Generator(device=dev).manual_seed(seed)))
        eager_peak = torch.cuda.max_memory_allocated() - base
        del cache_e
        g = sampling._StepGraph(dev)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        tok_g, lp_g = sampling._decode(
            mcfg, params, cache, last, max_new=MAX_NEW, temperature=1.0,
            generator=torch.Generator(device=dev).manual_seed(seed), graph=g)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        got_launches = read_counts()
        graph_peak = torch.cuda.max_memory_allocated() - base
        want = {name: 0 for name in counters}
        want["rmsnorm"] = per_step * MAX_NEW
        check(got_launches == want, f"{mcfg.name} graph decode launches "
              f"{got_launches}, expected {want}")
        same = {"tokens": bool(torch.equal(tok_g, tok_e)),
                "logprobs": bool(torch.equal(lp_g, lp_e))}
        check(all(same.values()), f"{mcfg.name}: the graph's decode is not "
              f"the eager loop's bit for bit: {same}")
        types = graph_node_types(g.graph)
        nodes = {"kernel": types.count(graph_kernel_node),
                 "other": len(types) - types.count(graph_kernel_node),
                 "by_type": {str(t): types.count(t) for t in set(types)}}
        seconds = {"eager_decode": eager_s, "graph_decode": t_end - t0,
                   "capture": g.capture_s, "instantiate": g.instantiate_s,
                   "replays": t_end - g.ready_at}
        del g, cache
        # the captured function run eagerly, 8 steps under the profiler,
        # then a graph of it captured on the same buffers, 8 replays each
        # after its noise draw, under the profiler
        _, cache = transformer.prefill(mcfg, params, prompts,
                                       cache_len=P + MAX_NEW)
        state = sampling._new_state(mcfg, cache, last, MAX_NEW)
        step = functools.partial(sampling._step, mcfg, params,
                                 temperature=1.0, from_uniform=True)
        noise_gen = torch.Generator(device=dev).manual_seed(seed)

        def draw():
            uniform_noise(state["noise"].shape, generator=noise_gen,
                          device=dev, out=state["noise"])

        def eager_8():
            for _ in range(8):
                draw()
                step(state)

        eager_prof = device_profile(eager_8, 8)
        g = sampling._StepGraph(dev)
        draw()
        g.warm(step, state)
        g.capture(step, state)

        def replays_8():
            for _ in range(8):
                draw()
                g.replay()

        replay_prof = device_profile(replays_8, 8)
        # the eager step's kernels, counted at the host's launch calls (the
        # trace's device side can drop a kernel or two in a thousand),
        # less the noise draw's one kernel; its copies beside them
        calls = (eager_prof or {}).get("host_launch_calls", {})
        eager_kernels = sum(calls.get(n, 0) for n in KERNEL_LAUNCH_CALLS) / 8
        eager_kernels -= 1
        eager_copies = sum(calls.get(n, 0) for n in HOST_LAUNCH_CALLS
                           if n not in KERNEL_LAUNCH_CALLS) / 8
        check(nodes["kernel"] == eager_kernels,
              f"{mcfg.name}: {nodes} graph nodes a step, the eager step "
              f"launches {eager_kernels} kernels ({calls})")
        if replay_prof is not None:
            check(replay_prof["host_launches_per_step"] <= 4,
                  f"{mcfg.name}: {replay_prof['host_launch_calls']} host "
                  "launches in 8 replays")
        del g, state, cache
        return {"model": mcfg.name, "bit_identical": same,
                "seconds": seconds,
                "graph_nodes_a_step": nodes,
                "eager_kernels_a_step": eager_kernels,
                "eager_copies_a_step": eager_copies,
                "eager_profile": eager_prof, "replay_profile": replay_prof,
                "launches": got_launches,
                "peak_memory_bytes": {"eager": eager_peak,
                                      "graph": graph_peak,
                                      "delta": graph_peak - eager_peak}}

    for case in ((cfg, policy, prompts, per_forward, 21),
                 (zcfg, z_policy, z_prompts, z_per_forward, 22)):
        emit(phase="decode_graph", **decode_graph_case(*case))
    # the reference weights, the adapters and the batch stay for training
    del z_policy, z_frozen
    done("decode_graph")

    # ---------------------------------------------------------- 16. local step
    # one client from the reference (lora_B = 0), K local steps, each a
    # rollout of B prompts and one firm_local_step, with FIRMConfig's
    # defaults (M = 2, B = 16, beta = 0.01, pgd with 100 iterations)
    k_steps = 2
    train0, frozen0 = common.split_trainable(ref_params)
    state0 = local.init_client_state(train0, fc.n_objectives, cfg.d_model,
                                     kl_coef=fc.kl_coef_init, device=dev)
    ds_local = make_client_datasets(1, cfg.vocab, P, generator=gen,
                                    device=dev)[0]
    torch.cuda.synchronize()
    zero_counts()
    (final, kept), local_s = wall(lambda: client_local_steps(
        cfg, fc, state0, frozen0, ref_params, band_h, band_x,
        k_steps=k_steps, max_new=MAX_NEW, length_tol=length_tol,
        dataset=ds_local, generators=[gen] * k_steps))
    local_launches = read_counts()
    # per step: a rollout, then one forward and M backward pulls; layer 0's
    # ln1 reads the embedding, which needs no gradient, so a pull runs
    # 2 L norms backward (not 2 L + 1) and L attentions backward
    want_local = {
        "rmsnorm": k_steps * (rollout_launches["rmsnorm"] + per_forward),
        "flash_attention": k_steps * (rollout_launches["flash_attention"]
                                      + cfg.n_layers),
        "rmsnorm_bwd": k_steps * N_OBJ * 2 * cfg.n_layers,
        "flash_attention_bwd": k_steps * N_OBJ * cfg.n_layers,
        "gram": k_steps, "quantize": 0, "dequantize": 0,
        "abs_threshold_count": 0, "abs_threshold_mask": 0, "ssd": 0,
        "ssd_bwd": 0}
    check(local_launches == want_local,
          f"local-step launch counts {local_launches}, expected {want_local}")
    lam = kept["lam"]
    check(tuple(lam.shape) == (k_steps, N_OBJ) and bool((lam >= 0).all())
          and float((lam.sum(-1) - 1).abs().max()) < 1e-5,
          f"lambda on the simplex: {lam.tolist()}")
    check(bool(kept["kl"].isfinite().all() & kept["rewards"].isfinite().all()),
          "finite kl and rewards")
    check(int(final.step) == k_steps and int(final.opt.count) == k_steps,
          "step and Adam count advanced")
    moved = [bool((a != b).any()) for a, b in zip(
        common.tree_leaves(final.trainable), common.tree_leaves(train0))]
    check(all(moved), f"every adapter moved ({sum(moved)}/{len(moved)})")

    def attn_leaves(tree, name):
        """The ``name`` (lora_A or lora_B) leaves of wq, wk, wv, wo."""
        attn = tree["slots"]["0"]["attn"]
        return [attn[w][name] for w in sorted(attn)]

    # one firm_local_step on a fixed batch (the rollout phase's), uncounted:
    # at step 1 lora_B = 0, so every lora_A gradient is exactly 0
    grads0, _, _ = ppo.per_objective_grads(cfg, fc, train0, frozen0,
                                           state0.critic, batch,
                                           state0.kl_coef)
    for j, g_j in enumerate(grads0):
        check(all(bool((t == 0).all()) for t in attn_leaves(g_j, "lora_A")),
              f"objective {j}: a lora_A gradient is not 0 while lora_B = 0")
        check(all(bool((t != 0).any()) for t in attn_leaves(g_j, "lora_B")),
              f"objective {j}: a lora_B gradient is 0")
    del grads0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated()
    (state1, metrics), update_s = wall(lambda: local.firm_local_step(
        cfg, fc, state0, frozen0, batch))
    update_peak = torch.cuda.max_memory_allocated()
    for key in ("losses", "grad_norm", "kl", "ratio_mean", "td_err"):
        check(bool(metrics[key].isfinite().all()), f"{key} finite")
    lam1 = metrics["lam"]
    check(bool((lam1 >= 0).all()) and abs(float(lam1.sum()) - 1) < 1e-5,
          f"lambda on the simplex: {lam1.tolist()}")
    check(int(state1.step) == 1 and int(state1.opt.count) == 1
          and float(state1.kl_coef) != float(state0.kl_coef),
          "step, Adam count and kl_coef advanced")
    check(all(bool((a != b).any()) for a, b in zip(
        attn_leaves(state1.trainable, "lora_B"),
        attn_leaves(train0, "lora_B"))), "lora_B moved")

    # the update's time by part, each ended by a synchronise
    with torch.enable_grad():
        tr = common.tree_map(lambda t: t.detach().requires_grad_(), train0)
        (losses, extras), fwd_s = wall(lambda: ppo.multi_objective_losses(
            cfg, fc, tr, frozen0, state0.critic, batch, state0.kl_coef))
        leaves = common.tree_leaves(tr)
        pulls, pulls_s = wall(lambda: [torch.autograd.grad(
            losses[j], leaves, retain_graph=j < N_OBJ - 1)
            for j in range(N_OBJ)])
    grads = []
    for flat in pulls:
        it = iter(flat)
        grads.append(common.tree_map(lambda _: next(it), tr))
    _, gram_s = wall(lambda: ops.gram_from_pytrees(grads))
    res, resolve_s = wall(lambda: firm.resolve(
        grads, fc, prev_lam=state0.lam,
        eta=firm.eta_schedule(state0.step + 1)))
    _, adam_s = wall(lambda: optim.adam_update(
        res.direction, state0.opt, state0.trainable, lr=fc.actor_lr,
        max_grad_norm=1.0))
    _, feats, r_tok, _, mask_ = extras
    _, critic_s = wall(lambda: critic.td_update(
        state0.critic, feats, r_tok, mask_, fc.gamma, fc.critic_lr,
        critic.r_w_bound(r_max=1.0)))
    check(grads[0]["slots"]["0"]["attn"]["wq"]["lora_B"].numel() > 0
          and sum(t.numel() for t in leaves) == d_lora,
          "the gradient row width is the gram phase's d")
    del tr, losses, extras, pulls, leaves, res
    update_profile = device_profile(lambda: local.firm_local_step(
        cfg, fc, state0, frozen0, batch), 1)

    # the M gradients on the fixed batch with non-zero lora_B (the rollout
    # phase's adapters), through the kernels, through the plain versions
    # and through an f32 copy of the model: the kernels' path must be as
    # close to f32 as the plain bf16 path is, within 25% on the relative L2
    # error and 60% on 1 - cosine (about 1.25 squared)
    def flat_grads(frz, **kw):
        g, _, _ = ppo.per_objective_grads(cfg, fc, train, frz, state0.critic,
                                          batch, state0.kl_coef, **kw)
        return [torch.cat([t.float().reshape(-1)
                           for t in common.tree_leaves(g_j)]) for g_j in g]

    g_kernel = flat_grads(frozen0)
    g_plain = flat_grads(frozen0, use_kernel=False)
    frozen32 = common.tree_map(lambda t: t.float(), frozen0)
    g_f32 = flat_grads(frozen32, use_kernel=False)
    del frozen32

    def compare(a, b):
        return {"rel_l2": float((a - b).norm() / b.norm()),
                "cosine": float(torch.dot(a, b) / (a.norm() * b.norm()))}

    grad_check = []
    for j in range(N_OBJ):
        e = {"kernels_vs_f32": compare(g_kernel[j], g_f32[j]),
             "plain_vs_f32": compare(g_plain[j], g_f32[j]),
             "kernels_vs_plain": compare(g_kernel[j], g_plain[j]),
             "norm_f32": float(g_f32[j].norm())}
        grad_check.append(e)
        k_, p_ = e["kernels_vs_f32"], e["plain_vs_f32"]
        check(k_["rel_l2"] <= 1.25 * p_["rel_l2"]
              and 1 - k_["cosine"] <= 1.6 * (1 - p_["cosine"]),
              f"objective {j}: kernels' gradient further from f32 than the "
              f"plain path's: {e}")
    g_stack = torch.stack(g_kernel)
    gram_path = {"rel_err_vs_plain": max_rel(gram_mod.gram(g_stack),
                                             ref.gram(g_stack))}
    check(gram_path["rel_err_vs_plain"] <= 1e-5,
          f"gram of the real gradients: {gram_path}")
    del g_kernel, g_plain, g_f32, g_stack
    # the same K steps again, uncounted, from the same start, with each
    # part of a step timed (the body of client_local_steps), then one
    # more rollout alone as a control for the host's speed at that time
    st, step_parts = state0, []
    for _ in range(k_steps):
        params = common.merge_trainable(st.trainable, frozen0)
        p_k, prompts_s = wall(lambda: ds_local.next_batch(B))
        b_k, roll_s = wall(lambda: rollout_batch(
            cfg, params, ref_params, p_k, band_h, band_x,
            n_objectives=N_OBJ, max_new=MAX_NEW, length_tol=length_tol,
            generator=gen))
        (st, _), upd_s = wall(lambda: local.firm_local_step(
            cfg, fc, st, frozen0, b_k))
        step_parts.append({"prompts": prompts_s, "rollout": roll_s,
                           "update": upd_s})
    del st, params, b_k
    _, control_rollout_s = wall(rollout)
    if update_profile is not None:
        # busy time over the update's wall time without the profiler, whose
        # own host cost stretches the traced window
        update_profile["device_busy_share_of_unprofiled_wall"] = (
            update_profile["device_busy_us_per_step"] / (update_s * 1e6))
    emit(phase="local_step", model=cfg.name, k_steps=k_steps,
         n_objectives=N_OBJ, batch=B, prompt_len=P, max_new=MAX_NEW,
         gradient_width=d_lora, seconds=local_s, launches=local_launches,
         warm_steps_s=step_parts, control_rollout_s=control_rollout_s,
         lam=lam.tolist(), kl=kept["kl"].tolist(),
         rewards=kept["rewards"].tolist(),
         update={"seconds": update_s,
                 "peak_memory_bytes": update_peak,
                 "memory_before_bytes": mem_before,
                 "losses": metrics["losses"].tolist(),
                 "grad_norm": float(metrics["grad_norm"]),
                 "lam_star": metrics["lam_star"].tolist(),
                 "gram": metrics["gram"].tolist(),
                 "breakdown_s": {"forward_and_losses": fwd_s,
                                 "backward_pulls": pulls_s,
                                 "gram": gram_s,
                                 "resolve_with_gram": resolve_s,
                                 "adam": adam_s, "critic_td": critic_s},
                 "profile": update_profile},
         rollout_seconds=rollout_s, gradient_check=grad_check,
         gram_of_real_gradients=gram_path,
         tolerance="kernels' gradient vs f32: rel L2 <= 1.25x and "
         "(1 - cosine) <= 1.6x the plain bf16 path's; gram 1e-5 of scale")
    done("local_step")

    # --------------------------------------------------- 17. local_step_hybrid
    # zamba2 at full width, one client from the reference (lora_B = 0), K
    # local steps of B prompts.  The adapters are the shared attention
    # block's; the Mamba2 layers before its first slot need no gradient,
    # the others their input's (the SSD backward kernels).  Per step: the
    # rollout's launches, one forward (32 SSD scans, 6 attentions, 45
    # norms), then per pull 27 SSD backwards, 6 attention backwards and the
    # backward of every norm whose input needs a gradient (all but the
    # first five Mamba2 layers' and the first shared slot's ln1).
    first_shared = zcfg.pattern.index("shared_attn")
    z_pull = {"ssd_bwd": n_mamba - first_shared,
              "flash_attention_bwd": n_attn,
              "rmsnorm_bwd": z_per_forward - first_shared - 1}
    check(z_pull == {"ssd_bwd": 27, "flash_attention_bwd": 6,
                     "rmsnorm_bwd": 39}, f"zamba2's pulls changed {z_pull}")
    z_step = {name: 0 for name in counters}
    z_step.update(rmsnorm=want_z["rmsnorm"] + z_per_forward,
                  flash_attention=want_z["flash_attention"] + n_attn,
                  ssd=want_z["ssd"] + n_mamba, gram=1,
                  **{k: N_OBJ * v for k, v in z_pull.items()})
    z_train0, z_frozen0 = common.split_trainable(z_ref)
    z_state0 = local.init_client_state(z_train0, fc.n_objectives,
                                       zcfg.d_model, kl_coef=fc.kl_coef_init,
                                       device=dev)
    # a generator of the phase's own, so the later phases keep their inputs
    z_gen = torch.Generator(device=dev).manual_seed(16)
    z_ds_local = make_client_datasets(1, zcfg.vocab, P, generator=z_gen,
                                      device=dev)[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    (z_final, z_kept), z_local_s = wall(lambda: client_local_steps(
        zcfg, fc, z_state0, z_frozen0, z_ref, z_band_h, z_band_x,
        k_steps=k_steps, max_new=MAX_NEW, length_tol=length_tol,
        dataset=z_ds_local, generators=[z_gen] * k_steps))
    z_local_launches = read_counts()
    z_local_peak = torch.cuda.max_memory_allocated()
    want_zlocal = {k: k_steps * v for k, v in z_step.items()}
    check(z_local_launches == want_zlocal,
          f"zamba2 local-step launch counts {z_local_launches}, expected "
          f"{want_zlocal}")
    z_lam = z_kept["lam"]
    check(tuple(z_lam.shape) == (k_steps, N_OBJ) and bool((z_lam >= 0).all())
          and float((z_lam.sum(-1) - 1).abs().max()) < 1e-5,
          f"zamba2 lambda on the simplex: {z_lam.tolist()}")
    check(bool(z_kept["kl"].isfinite().all()
               & z_kept["rewards"].isfinite().all()),
          "zamba2 finite kl and rewards")
    check(int(z_final.step) == k_steps and int(z_final.opt.count) == k_steps,
          "zamba2 step and Adam count advanced")
    z_moved = [bool((a != b).any()) for a, b in zip(
        common.tree_leaves(z_final.trainable), common.tree_leaves(z_train0))]
    check(all(z_moved) and len(z_moved) == 8,
          f"every zamba2 adapter moved ({sum(z_moved)}/{len(z_moved)})")
    del z_final

    def shared_leaves(tree, name):
        """The ``name`` (lora_A or lora_B) leaves of the shared block's wq,
        wk, wv, wo."""
        attn = tree["shared"]["attn"]
        return [attn[w][name] for w in sorted(attn)]

    # uncounted, on the rollout_hybrid phase's batch: at lora_B = 0 every
    # lora_A gradient is exactly 0
    z_grads0, _, _ = ppo.per_objective_grads(
        zcfg, fc, z_train0, z_frozen0, z_state0.critic, z_batch,
        z_state0.kl_coef)
    for j, g_j in enumerate(z_grads0):
        check(all(bool((t == 0).all()) for t in shared_leaves(g_j,
                                                              "lora_A")),
              f"zamba2 objective {j}: a lora_A gradient is not 0 while "
              "lora_B = 0")
        check(all(bool((t != 0).any()) for t in shared_leaves(g_j,
                                                              "lora_B")),
              f"zamba2 objective {j}: a lora_B gradient is 0")
    del z_grads0
    # one firm_local_step from non-zero lora_B (the rollout_hybrid phase's
    # adapters), with its time by part
    z_state1 = z_state0._replace(trainable=z_train)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    z_mem_before = torch.cuda.memory_allocated()
    (z_new, z_metrics), z_update_s = wall(lambda: local.firm_local_step(
        zcfg, fc, z_state1, z_frozen0, z_batch))
    z_update_peak = torch.cuda.max_memory_allocated()
    for key in ("losses", "grad_norm", "kl", "ratio_mean", "td_err"):
        check(bool(z_metrics[key].isfinite().all()), f"zamba2 {key} finite")
    z_lam1 = z_metrics["lam"]
    check(bool((z_lam1 >= 0).all()) and abs(float(z_lam1.sum()) - 1) < 1e-5,
          f"zamba2 lambda on the simplex: {z_lam1.tolist()}")
    check(all(bool((a != b).any()) for a, b in zip(
        common.tree_leaves(z_new.trainable), common.tree_leaves(z_train))),
        "every zamba2 adapter moved")
    with torch.enable_grad():
        z_tr = common.tree_map(lambda t: t.detach().requires_grad_(), z_train)
        (z_losses, z_extras), z_fwd_s = wall(
            lambda: ppo.multi_objective_losses(
                zcfg, fc, z_tr, z_frozen0, z_state0.critic, z_batch,
                z_state0.kl_coef))
        z_leaves = common.tree_leaves(z_tr)
        z_pulls, z_pulls_s = wall(lambda: [torch.autograd.grad(
            z_losses[j], z_leaves, retain_graph=j < N_OBJ - 1)
            for j in range(N_OBJ)])
    z_g = []
    for flat in z_pulls:
        it = iter(flat)
        z_g.append(common.tree_map(lambda _: next(it), z_tr))
    _, z_gram_s = wall(lambda: ops.gram_from_pytrees(z_g))
    z_res, z_resolve_s = wall(lambda: firm.resolve(
        z_g, fc, prev_lam=z_state0.lam,
        eta=firm.eta_schedule(z_state0.step + 1)))
    _, z_adam_s = wall(lambda: optim.adam_update(
        z_res.direction, z_state0.opt, z_train, lr=fc.actor_lr,
        max_grad_norm=1.0))
    _, z_feats, z_rtok, _, z_mask_ = z_extras
    _, z_critic_s = wall(lambda: critic.td_update(
        z_state0.critic, z_feats, z_rtok, z_mask_, fc.gamma, fc.critic_lr,
        critic.r_w_bound(r_max=1.0)))
    del z_tr, z_losses, z_extras, z_pulls, z_leaves, z_g, z_res
    z_update_profile = device_profile(lambda: local.firm_local_step(
        zcfg, fc, z_state1, z_frozen0, z_batch), 1)
    if z_update_profile is not None:
        z_update_profile["device_busy_share_of_unprofiled_wall"] = (
            z_update_profile["device_busy_us_per_step"] / (z_update_s * 1e6))

    # the M gradients on the fixed batch through the kernels, through the
    # plain versions and through an f32 copy of the model: the kernels'
    # bf16 path as close to f32 as the plain bf16 path (the llama rule),
    # and in f32 the kernels' gradients within 1e-3 relative L2 of the
    # plain f32 path's
    def z_flat_grads(frz, **kw):
        g, _, _ = ppo.per_objective_grads(zcfg, fc, z_train, frz,
                                          z_state0.critic, z_batch,
                                          z_state0.kl_coef, **kw)
        out = [torch.cat([t.float().reshape(-1)
                          for t in common.tree_leaves(g_j)]) for g_j in g]
        torch.cuda.empty_cache()
        return out

    zg_kernel = z_flat_grads(z_frozen0)
    zg_plain = z_flat_grads(z_frozen0, use_kernel=False)
    z_frozen32 = common.tree_map(lambda t: t.float(), z_frozen0)
    zg_f32 = z_flat_grads(z_frozen32, use_kernel=False)
    zg_kernel32 = z_flat_grads(z_frozen32)
    del z_frozen32
    z_grad_check = []
    for j in range(N_OBJ):
        e = {"kernels_vs_f32": compare(zg_kernel[j], zg_f32[j]),
             "plain_vs_f32": compare(zg_plain[j], zg_f32[j]),
             "kernels_vs_plain": compare(zg_kernel[j], zg_plain[j]),
             "f32_kernels_vs_f32_plain": compare(zg_kernel32[j], zg_f32[j]),
             "norm_f32": float(zg_f32[j].norm())}
        z_grad_check.append(e)
        k_, p_ = e["kernels_vs_f32"], e["plain_vs_f32"]
        check(k_["rel_l2"] <= 1.25 * p_["rel_l2"]
              and 1 - k_["cosine"] <= 1.6 * (1 - p_["cosine"]),
              f"zamba2 objective {j}: kernels' gradient further from f32 "
              f"than the plain path's: {e}")
        check(e["f32_kernels_vs_f32_plain"]["rel_l2"] <= 1e-3,
              f"zamba2 objective {j}: f32 gradients through the kernels "
              f"vs plain: {e}")
    del zg_kernel, zg_plain, zg_f32, zg_kernel32
    emit(phase="local_step_hybrid", model=zcfg.name, k_steps=k_steps,
         n_objectives=N_OBJ, batch=B, prompt_len=P, max_new=MAX_NEW,
         gradient_width=sum(t.numel() for t in common.tree_leaves(z_train)),
         seconds=z_local_s, launches=z_local_launches,
         per_pull=z_pull, peak_memory_bytes=z_local_peak,
         lam=z_lam.tolist(), kl=z_kept["kl"].tolist(),
         rewards=z_kept["rewards"].tolist(),
         update={"seconds": z_update_s,
                 "peak_memory_bytes": z_update_peak,
                 "memory_before_bytes": z_mem_before,
                 "losses": z_metrics["losses"].tolist(),
                 "grad_norm": float(z_metrics["grad_norm"]),
                 "lam_star": z_metrics["lam_star"].tolist(),
                 "breakdown_s": {"forward_and_losses": z_fwd_s,
                                 "backward_pulls": z_pulls_s,
                                 "gram": z_gram_s,
                                 "resolve_with_gram": z_resolve_s,
                                 "adam": z_adam_s, "critic_td": z_critic_s},
                 "profile": z_update_profile},
         gradient_check=z_grad_check,
         tolerance="kernels' bf16 gradient vs f32: rel L2 <= 1.25x and "
         "(1 - cosine) <= 1.6x the plain bf16 path's; f32 kernels vs f32 "
         "plain: rel L2 <= 1e-3")
    del z_new, z_state1
    done("local_step_hybrid")

    # -------------------------------------------------------- 18. update_graph
    # the local update as a captured program (rlhf/update_graph.py), on
    # each model at full width with FIRMConfig's defaults, on the rollout
    # phases' batches: the runner against the eager firm_local_step
    def update_graph_case(mcfg, frz, state_a, state_b, batch_, per_update):
        firm_alg = algorithms_lib.get_algorithm("firm")
        batches = [batch_._replace(rewards=batch_.rewards.roll(k, 0))
                   for k in range(3)]
        order = (("A", 0), ("B", 1), ("A", 2))
        # three carried updates in the order A, B, A: eagerly, then
        # through one runner from the same states and batches
        states, want, eager_s = {"A": state_a, "B": state_b}, [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        for name, k in order:
            out, sec = wall(lambda: local.firm_local_step(
                mcfg, fc, states[name], frz, batches[k]))
            states[name] = out[0]
            want.append(out)
            eager_s.append(sec)
        eager_peak = torch.cuda.max_memory_allocated() - mem0
        runner = update_graph.UpdateGraphs()
        states, got, graph_s = {"A": state_a, "B": state_b}, [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        zero_counts()
        for name, k in order:
            out, sec = wall(lambda: firm_alg.step(
                mcfg, fc, states[name], frz, batches[k], None, None, runner))
            states[name] = out[0]
            got.append(out)
            graph_s.append(sec)
        launches = read_counts()
        graph_peak = torch.cuda.max_memory_allocated() - mem0
        want_counts = {name: 0 for name in counters}
        want_counts.update({name: 3 * n for name, n in per_update.items()})
        check(launches == want_counts, f"{mcfg.name} update graph launches "
              f"{launches}, expected {want_counts}")
        bits = [same_update(g_, w_) for g_, w_ in zip(got, want)]
        check(all(bits), f"{mcfg.name}: the graph's updates A, B, A are not "
              f"the eager updates' bit for bit: {bits}")
        g = runner.graph("firm", mcfg, fc, state_a, frz, batches[0],
                         (firm.config_tensor(fc.beta, dev),))
        check(runner.captures == 1 and g is not None,
              f"{mcfg.name}: {runner.captures} captures for one key")
        pool = pool_bytes(g.graph)
        types = graph_node_types(g.graph)
        nodes = {"kernel": types.count(graph_kernel_node),
                 "other": len(types) - types.count(graph_kernel_node),
                 "by_type": {str(t): types.count(t) for t in set(types)}}
        # the eager update's kernels, counted at the host's launch calls
        eager_prof = device_profile(lambda: local.firm_local_step(
            mcfg, fc, state_b, frz, batches[1]), 1)
        calls = (eager_prof or {}).get("host_launch_calls", {})
        eager_kernels = sum(calls.get(n, 0) for n in KERNEL_LAUNCH_CALLS)
        check(nodes["kernel"] == eager_kernels,
              f"{mcfg.name}: {nodes} graph nodes an update, the eager "
              f"update launches {eager_kernels} kernels ({calls})")
        # replayed updates, copies in and out included: 8 timed, then 8
        # under the profiler
        def replays_8():
            for k in range(8):
                firm_alg.step(mcfg, fc, state_b, frz, batches[k % 3], None,
                              None, runner)
        _, replays_s = wall(replays_8)
        replay_prof = device_profile(replays_8, 8)
        if replay_prof is not None:
            check(replay_prof["host_launches_per_step"] < 100,
                  f"{mcfg.name}: {replay_prof['host_launch_calls']} host "
                  "launches in 8 replayed updates")
        # linear: one graph update (the runner's second call) against eager
        lin = algorithms_lib.get_algorithm("linear")
        weights = lin.traced_extra(fc, EngineConfig(), device=dev)
        lin_runner = update_graph.UpdateGraphs()
        lin.step(mcfg, fc, state_a, frz, batches[0], None, weights,
                 lin_runner)
        zero_counts()
        lin_got = lin.step(mcfg, fc, state_b, frz, batches[1], None,
                           weights, lin_runner)
        lin_launches = read_counts()
        lin_want = local.linear_local_step(mcfg, fc, state_b, frz,
                                           batches[1], weights)
        want_lin = {name: 0 for name in counters}
        want_lin.update(per_update, gram=0)
        check(lin_runner.captures == 1 and lin_launches == want_lin,
              f"{mcfg.name} linear graph launches {lin_launches}, "
              f"expected {want_lin}")
        check(same_update(lin_got, lin_want),
              f"{mcfg.name}: linear's graph update is not the eager one's")
        del lin_runner, lin_got, lin_want
        # a stale graph: a copy of frozen at new addresses (the same
        # values, then one leaf changed) is captured anew; an in-place
        # write to a leaf of the original tree is replayed as it is
        stale = {}
        norm = common.tree_leaves(frz["final_norm"])[0]
        copies = {"same_values": common.tree_map(lambda t: t.clone(), frz)}
        changed = common.tree_map(lambda t: t.clone(), frz)
        common.tree_leaves(changed["final_norm"])[0].mul_(1.25)
        copies["one_leaf_changed"] = changed
        for label, frz_c in copies.items():
            caps = runner.captures
            for _ in range(2):
                got_c = firm_alg.step(mcfg, fc, state_b, frz_c, batches[1],
                                      None, None, runner)
            want_c = local.firm_local_step(mcfg, fc, state_b, frz_c,
                                           batches[1])
            stale[label] = {"new_captures": runner.captures - caps,
                            "bit_identical": same_update(got_c, want_c)}
        saved = norm.clone()
        norm.mul_(0.75)
        caps = runner.captures
        got_c = firm_alg.step(mcfg, fc, state_b, frz, batches[1], None, None,
                              runner)
        want_c = local.firm_local_step(mcfg, fc, state_b, frz, batches[1])
        stale["in_place_write"] = {"new_captures": runner.captures - caps,
                                   "bit_identical": same_update(got_c, want_c)}
        norm.copy_(saved)
        check(all(v["bit_identical"] for v in stale.values())
              and stale["same_values"]["new_captures"] == 1
              and stale["one_leaf_changed"]["new_captures"] == 1
              and stale["in_place_write"]["new_captures"] == 0,
              f"{mcfg.name}: stale-graph checks {stale}")
        peak_all = torch.cuda.max_memory_allocated()
        seconds = {"eager_updates": eager_s,
                   "graph_calls_warm_capture_replay": graph_s,
                   "replayed_update_mean": replays_s / 8,
                   "capture": g.capture_s, "instantiate": g.instantiate_s}
        del copies, changed, got_c, want_c, runner, g, got, want, states
        torch.cuda.empty_cache()
        return {"model": mcfg.name, "bit_identical_A_B_A": bits,
                "launches": launches, "linear_launches": lin_launches,
                "seconds": seconds, "graph_nodes": nodes, "eager_kernels": eager_kernels,
                "eager_host_launch_calls": calls,
                "eager_profile": eager_prof, "replay_profile": replay_prof,
                "stale_graph": stale,
                "peak_memory_bytes": {"eager_three_updates": eager_peak,
                                      "graph_three_calls": graph_peak,
                                      "delta": graph_peak - eager_peak,
                                      "phase_peak_allocated": peak_all},
                "graph_pool_bytes": pool}

    llama_update = {"rmsnorm": per_forward,
                    "flash_attention": cfg.n_layers,
                    "rmsnorm_bwd": N_OBJ * 2 * cfg.n_layers,
                    "flash_attention_bwd": N_OBJ * cfg.n_layers, "gram": 1}
    zamba2_update = {"rmsnorm": z_per_forward, "flash_attention": n_attn,
                     "ssd": n_mamba, "gram": 1,
                     **{k: N_OBJ * v for k, v in z_pull.items()}}
    for case in ((cfg, frozen0, state0._replace(trainable=train), state0,
                  batch, llama_update),
                 (zcfg, z_frozen0, z_state0._replace(trainable=z_train),
                  z_state0, z_batch, zamba2_update)):
        emit(phase="update_graph", **update_graph_case(*case))
    # FedCMOO's server solve (eager, 100 pgd iterations) after the host
    # reads left the projection: two clients' (M, d) matrices at llama's d
    solve_gen = torch.Generator(device=dev).manual_seed(23)
    mats = [randn((N_OBJ, d_lora), torch.float32, solve_gen)
            for _ in range(N_CLIENTS)]
    fedcmoo.server_solve(mats)
    solve_s = [wall(lambda: fedcmoo.server_solve(mats))[1]
               for _ in range(5)]
    emit(phase="update_graph", fedcmoo_server_solve_s=solve_s,
         server_solve_shape=[N_CLIENTS, N_OBJ, d_lora])
    del mats
    done("update_graph")

    # --------------------------------------------------------------- 19. round
    # the federated round at full width: C = 2 clients, K = 1 local step,
    # R = 2 rounds so that the error-feedback residual carries into round
    # 2; first the ``wan`` preset (int8+ef uplink, identity downlink), then
    # the ``extreme`` preset (topk:0.05+ef uplink, int8 downlink).  Each
    # trainer starts from the rollout phase's reference weights; the counts
    # are zeroed just before its rounds and read just after.
    fc_round = dataclasses.replace(fc, n_clients=N_CLIENTS, local_steps=1,
                                   rounds=ROUNDS)
    steps = N_CLIENTS * fc_round.local_steps * ROUNDS
    # the local phase's launches; each preset adds its codecs'
    want_round = {name: steps * n // k_steps
                  for name, n in want_local.items()}
    names = {"_broadcast": "downlink", "_local_phase": "local_phase",
             "_delta_flat": "delta", "_uplink": "uplink_codec",
             "_aggregate_flat": "aggregate", "_record": "summary"}

    def federated_rounds(preset: str):
        """ROUNDS counted rounds of a fresh trainer with the preset's
        codecs and the checks every preset shares: (trainer, summaries,
        launches, the record to emit)."""
        up, down = CODEC_PRESETS[preset]
        trainer = FederatedTrainer(
            cfg, fc_round, EngineConfig(prompt_len=P, max_new=MAX_NEW,
                                        uplink_codec=up, downlink_codec=down),
            params=ref_params, device=dev)
        check(trainer.d_trainable == d_lora,
              "the round's d is the gram phase's")
        # the round's parts, each ended by a synchronise (instance
        # wrappers: the trainer itself does not synchronise)
        part_s = {}

        def timed_part(name, fn):
            def run_part(*a, **kw):
                out, sec = wall(lambda: fn(*a, **kw))
                part_s.setdefault(names[name], []).append(sec)
                return out
            return run_part

        for name in names:
            setattr(trainer, name, timed_part(name, getattr(trainer, name)))
        # the residuals each uplink call is handed and hands back, kept to
        # check that round 2 starts from round 1's
        ef_log = []
        uplink_rt = trainer.uplink_codec.roundtrip_stacked

        def logged_uplink_rt(flats, spec, states, **kw):
            out = uplink_rt(flats, spec, states, **kw)
            ef_log.append((list(states), [r.clone() for r in out[1]]))
            return out
        trainer.uplink_codec.roundtrip_stacked = logged_uplink_rt
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        summaries, round_s = [], []
        for _ in range(ROUNDS):
            summary, sec = wall(trainer.run_round)
            summaries.append(summary)
            round_s.append(sec)
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        trainer.uplink_codec.roundtrip_stacked = uplink_rt
        up_static = trainer.uplink_codec.nbytes_static(d_lora)
        down_static = trainer.downlink_codec.nbytes_static(d_lora)
        check(summaries[-1]["comm_bytes"]
              == ROUNDS * N_CLIENTS * (up_static + down_static),
              f"{preset} comm_bytes {summaries[-1]['comm_bytes']}")
        for s_ in summaries:
            check(s_["up_nbytes"] == [up_static] * N_CLIENTS
                  and s_["down_nbytes"] == down_static
                  and s_["participants"] == list(range(N_CLIENTS))
                  and s_["dispatches"] == 6, f"round bookkeeping {s_}")
            lam_pc = s_["per_client_lam"]
            check(lam_pc.shape == (N_CLIENTS, N_OBJ) and (lam_pc >= 0).all()
                  and abs(lam_pc.sum(-1) - 1).max() < 1e-5,
                  f"per-client lambda on the simplex: {lam_pc.tolist()}")
            check(math.isfinite(s_["lam_disagreement"]),
                  "lam_disagreement finite")
        check(summaries[0]["param_drift"] > 0, "clients drifted apart")
        check(all(bool(t.isfinite().all()) for t in
                  common.tree_leaves(trainer.global_trainable)),
              "finite global adapters")
        check(any(bool((a != b).any()) for a, b in zip(
            common.tree_leaves(trainer.global_trainable),
            common.tree_leaves(train0))), "the global adapters moved")
        res_rms = [float(r.norm()) for r in trainer._uplink_state]
        check(all(0 < r < float("inf") for r in res_rms),
              f"error-feedback residuals finite and non-zero: {res_rms}")
        check(len(ef_log) == ROUNDS
              and all(r is None for r in ef_log[0][0])
              and all(all(a is not None and torch.equal(a, b)
                          for a, b in zip(ef_log[i + 1][0], ef_log[i][1]))
                      for i in range(ROUNDS - 1)),
              "error-feedback residuals carried: each round's uplink "
              "starts from the residuals the round before handed back")
        breakdown = {k: v[:ROUNDS] for k, v in part_s.items()}
        record = dict(
            model=cfg.name, preset=preset, clients=N_CLIENTS,
            local_steps=fc_round.local_steps, rounds=ROUNDS, batch=B,
            prompt_len=P, max_new=MAX_NEW, uplink=up, downlink=down,
            d_trainable=d_lora, seconds_per_round=round_s,
            launches=launches, breakdown_s=breakdown,
            uplink_codec_share=[u / r for u, r in zip(
                breakdown["uplink_codec"], round_s)],
            peak_memory_bytes=peak, comm_bytes=summaries[-1]["comm_bytes"],
            up_nbytes=summaries[-1]["up_nbytes"],
            down_nbytes=summaries[-1]["down_nbytes"],
            param_drift=[s_["param_drift"] for s_ in summaries],
            lam_disagreement=[s_["lam_disagreement"] for s_ in summaries],
            per_client_lam=[s_["per_client_lam"].tolist()
                            for s_ in summaries],
            kl=[s_["kl"] for s_ in summaries],
            rewards=[s_["rewards"].tolist() for s_ in summaries],
            residual_norms=res_rms)
        return trainer, summaries, launches, record

    trainer, summaries, round_launches, wan_record = federated_rounds("wan")
    want_wan = dict(want_round, quantize=ROUNDS, dequantize=ROUNDS)
    check(round_launches == want_wan,
          f"round launch counts {round_launches}, expected {want_wan}")
    up_static = trainer.uplink_codec.nbytes_static(d_lora)
    check(up_static == -(-d_lora // 1024) * (1024 + 4),
          f"int8 payload bytes {up_static}")
    want_bytes = ROUNDS * N_CLIENTS * (up_static + 4 * d_lora)
    check(summaries[-1]["comm_bytes"] == want_bytes == 68_210_688,
          f"comm_bytes {summaries[-1]['comm_bytes']}, expected {want_bytes}")
    # one more round, uncounted, under the profiler: the device's busy and
    # idle share of a whole round (kineto's raw events; the round launches
    # some 450,000 kernels)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, profiled_s = wall(trainer.run_round)
    dev_events = [(e.start_ns(), e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA]
    del prof
    round_profile = None          # not measured: the trace held no kernel
    if dev_events:
        busy_ns = sum(d_ for _, d_ in dev_events)
        window_ns = (max(t + d_ for t, d_ in dev_events)
                     - min(t for t, _ in dev_events))
        round_profile = {
            "device_events": len(dev_events),
            "device_busy_s": busy_ns / 1e9,
            "profiled_window_s": window_ns / 1e9,
            "profiled_round_s": profiled_s,
            "device_idle_share_of_profiled_window": 1 - busy_ns / window_ns,
            "device_idle_share_of_unprofiled_round":
                1 - busy_ns / 1e9 / (sum(wan_record["seconds_per_round"])
                                     / ROUNDS)}
    # the same trainer's rounds with the update captured and eager, in
    # turns (graph, eager, eager, graph): without the trainer's graphs
    # each client-step's update is the first and only call of a runner of
    # its own, the eager step on the side stream
    graphs = trainer.update_graphs
    turns_s = {"graph": [], "eager": []}
    for mode in ("graph", "eager", "eager", "graph"):
        trainer.update_graphs = graphs if mode == "graph" else None
        turns_s[mode].append(wall(trainer.run_round)[1])
    trainer.update_graphs = graphs
    emit(phase="round", profile=round_profile,
         graph_vs_eager_round_s=turns_s, **wan_record)
    del trainer, graphs

    # the extreme preset: the top-k uplink's 32 count passes a round (one
    # launch over both clients each), the int8 broadcast's quantize and
    # dequantize, no mask (the JAX package calls it nowhere)
    trainer, summaries, extreme_launches, extreme_record = \
        federated_rounds("extreme")
    want_extreme = dict(want_round, quantize=ROUNDS, dequantize=ROUNDS,
                        abs_threshold_count=TOPK_PASSES * ROUNDS,
                        abs_threshold_mask=0)
    check(extreme_launches == want_extreme,
          f"extreme launch counts {extreme_launches}, expected "
          f"{want_extreme}")
    up_static = trainer.uplink_codec.nbytes_static(d_lora)
    down_static = trainer.downlink_codec.nbytes_static(d_lora)
    check(up_static == 8 * k_round == 1_363_152
          and down_static == -(-d_lora // 1024) * (1024 + 4) == 3_421_184,
          f"extreme payload bytes {up_static}, {down_static}")
    check(summaries[-1]["comm_bytes"] == 19_137_344,
          f"extreme comm_bytes {summaries[-1]['comm_bytes']}")
    emit(phase="round_extreme", **extreme_record)
    del trainer
    done("round")

    # -------------------------------------------------------- 20. round_hybrid
    # the wan round on zamba2 at full width: C = 2 clients, K = 1, R = 1,
    # from the rollout_hybrid phase's reference weights.  comm_bytes is the
    # value tests/test_torch_hybrid_training.py takes from the reference's
    # codecs and ledger for this config (ZAMBA2_WAN_COMM_BYTES there).
    fc_zround = dataclasses.replace(fc, n_clients=N_CLIENTS, local_steps=1,
                                    rounds=1)
    up, down = CODEC_PRESETS["wan"]
    z_trainer = FederatedTrainer(
        zcfg, fc_zround, EngineConfig(prompt_len=P, max_new=MAX_NEW,
                                      uplink_codec=up, downlink_codec=down),
        params=z_ref, device=dev)
    z_part_s = {}

    def z_timed_part(name, fn):
        def run_part(*a, **kw):
            out, sec = wall(lambda: fn(*a, **kw))
            z_part_s[names[name]] = sec
            return out
        return run_part

    for name in names:
        setattr(z_trainer, name, z_timed_part(name, getattr(z_trainer, name)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    z_summary, z_round_s = wall(z_trainer.run_round)
    z_round_launches = read_counts()
    z_round_peak = torch.cuda.max_memory_allocated()
    want_zround = {k: N_CLIENTS * v for k, v in z_step.items()}
    want_zround.update(quantize=1, dequantize=1)
    check(z_round_launches == want_zround,
          f"zamba2 round launch counts {z_round_launches}, expected "
          f"{want_zround}")
    z_d = z_trainer.d_trainable
    check(z_d == 262_144 and z_summary["comm_bytes"] == 2_623_488
          == N_CLIENTS * (z_trainer.uplink_codec.nbytes_static(z_d)
                          + z_trainer.downlink_codec.nbytes_static(z_d)),
          f"zamba2 wan comm_bytes {z_summary['comm_bytes']} (d = {z_d})")
    z_lam_pc = z_summary["per_client_lam"]
    check(z_lam_pc.shape == (N_CLIENTS, N_OBJ) and (z_lam_pc >= 0).all()
          and abs(z_lam_pc.sum(-1) - 1).max() < 1e-5,
          f"zamba2 per-client lambda on the simplex: {z_lam_pc.tolist()}")
    check(z_summary["param_drift"] > 0, "zamba2 clients drifted apart")
    z_res_norms = [float(r.norm()) for r in z_trainer._uplink_state]
    check(all(0 < r < float("inf") for r in z_res_norms),
          f"zamba2 error-feedback residuals carried: {z_res_norms}")
    check(all(bool(t.isfinite().all()) for t in
              common.tree_leaves(z_trainer.global_trainable))
          and any(bool((a != b).any()) for a, b in zip(
              common.tree_leaves(z_trainer.global_trainable),
              common.tree_leaves(z_train0))),
          "zamba2 global adapters finite and moved")
    emit(phase="round_hybrid", model=zcfg.name, preset="wan",
         clients=N_CLIENTS, local_steps=1, rounds=1, batch=B, prompt_len=P,
         max_new=MAX_NEW, uplink=up, downlink=down, d_trainable=z_d,
         seconds_per_round=z_round_s, breakdown_s=z_part_s,
         launches=z_round_launches, peak_memory_bytes=z_round_peak,
         comm_bytes=z_summary["comm_bytes"],
         up_nbytes=z_summary["up_nbytes"],
         down_nbytes=z_summary["down_nbytes"],
         param_drift=z_summary["param_drift"],
         lam_disagreement=z_summary["lam_disagreement"],
         per_client_lam=z_lam_pc.tolist(), kl=z_summary["kl"],
         rewards=z_summary["rewards"].tolist(), residual_norms=z_res_norms)
    del z_trainer
    done("round_hybrid")

    # -------------------------------------------------------- 21. round_parity
    # a round on the card against the port's CPU round (which the CPU tests
    # hold to the JAX package), at a tiny f32 config of each trained
    # model: R = 3 carried wan rounds of C = 2 clients, K = 1, B = 2, 8
    # prompt and 12 new tokens, the same weights and the same injected
    # draws (prompts, Gumbel noise, rounding bits) on both sides, from a
    # generator of the phase's own.  Both sides decode with an f32 K/V
    # cache (generate's default is bf16, on both sides of the CPU tests
    # too, where the sampling logprobs agree to the bf16 tolerance): a
    # last-bit difference of an f32 key or value flips its bf16 rounding,
    # which moves the behaviour logprobs, and through the PPO ratio lambda
    # and drift, by more than the kernels do (on an H100, tiny zamba2 on
    # the bf16 cache: lambda 7.1e-4 and drift 1.07e-4 of their scale; a
    # llama client's Adam step 9.9e-2 of its scale).  Held within
    # tests/test_torch_round.py's tolerances: bytes, participants and
    # rewards exact; drift 1e-4 of its scale; KL 1e-6 absolute; lambda 1e-4
    # and the clients' and the global's steps (moves over actor_lr) 1e-2,
    # each over min(1, D), D the curvature of the MGDA problem at the
    # round's worst step (from the CPU steps' Gram matrices).  The zamba2
    # config runs the SSD kernels forward and backward (hd 64, ds 16).
    def parity_rounds(cfg_p, algorithm="firm", up="int8+ef", n_rounds=3,
                      vectorized=True, het_steps=None, down="identity",
                      fused=False, clients=2):
        """n_rounds carried rounds on both sides; ``vectorized=False`` asks
        for the loop executor, ``het_steps`` for heterogeneous
        client_local_steps (cohorts), one entry a client; ``fused`` runs
        the rounds as one chunk of the fused executor on each side;
        ``clients`` the clients of a round without cohorts.  A low-rank
        uplink is also held as the codecs phase holds it: the CPU codec
        on the card's own inputs of the round (rows, residuals, omega)
        against the card's decoded rows and residuals, within max(1e-4,
        2 F32_ERROR_K 2**-24 cond(P)) of max |flat + state|."""
        pb, pp, pnew = 2, 8, 12
        pc, k_max = ((len(het_steps), max(het_steps)) if het_steps
                     else (clients, 1))
        fc_p = dataclasses.replace(FIRMConfig(), n_clients=pc, local_steps=1,
                                   batch_size=pb, n_objectives=N_OBJ,
                                   client_local_steps=het_steps)
        ec_p = EngineConfig(algorithm=algorithm, prompt_len=pp, max_new=pnew,
                            uplink_codec=up, downlink_codec=down,
                            vectorized_clients=vectorized,
                            fused_rounds=n_rounds if fused else 1)
        g_cpu = torch.Generator().manual_seed(19)
        p_cpu = transformer.init_params(cfg_p, generator=g_cpu,
                                        device="cpu", dtype=torch.float32)
        tr_p, fr_p = common.split_trainable(p_cpu)
        tr_p = common.tree_map(lambda t: t + 0.05 * torch.randn(
            t.shape, generator=g_cpu), tr_p)
        p_cpu = common.merge_trainable(tr_p, fr_p)
        sides = {"cpu": FederatedTrainer(cfg_p, fc_p, ec_p, params=p_cpu,
                                         device="cpu"),
                 "cuda": FederatedTrainer(
                     cfg_p, fc_p, ec_p, device=dev, params=common.tree_map(
                         lambda t: t.to(dev), p_cpu))}
        alg = sides["cpu"].algorithm
        exchange = not alg.caps.traced_server_exchange
        up_inner = getattr(sides["cpu"].uplink_codec, "inner", None)
        low_rank = isinstance(up_inner, lowrank.LowRankCodec)
        top_k = isinstance(up_inner, sparsify.TopKCodec)
        beta = alg.resolve_config(fc_p).beta
        # the MGDA problems solved: the clients' Gram matrices (firm,
        # firm_unreg) or the server's average matrices (fedcmoo); linear
        # solves none.  The uplink's input rows and the new global adapters
        # of every round, on each side.
        grams, uplinks = {"cpu": [], "cuda": []}, {"cpu": [], "cuda": []}
        globals_ = {s_: [torch.cat([t.reshape(-1).cpu() for t in
                                    common.tree_leaves(tr.global_trainable)])]
                    for s_, tr in sides.items()}
        step_fn, solve_fn = local.firm_local_step, fedcmoo.server_solve
        side_of = {}

        def spy_step(cfg_, fc_, state, *a, **kw):
            # on the card the step runs inside a captured update, where a
            # read to the host would end the capture: only the CPU's
            # Gram matrices are read (the curvature below)
            st, met = step_fn(cfg_, fc_, state, *a, **kw)
            if side_of["now"] == "cpu":
                grams["cpu"].append(
                    met["gram"].detach().double().cpu().numpy())
            return st, met

        def spy_solve(mats, *a, **kw):
            avg = sum(m_.detach().double().cpu() for m_ in mats) / len(mats)
            grams[side_of["now"]].append((avg @ avg.T).numpy())
            return solve_fn(mats, *a, **kw)
        # the card's uplink calls of a low-rank codec: (rows, spec,
        # residuals, omega) in, (residuals, decoded) out
        lr_calls, rt_of = [], {}
        for side, tr in sides.items():
            # the host boundary, which both executors' rounds run
            rt_of[side] = tr.uplink_codec.roundtrip_stacked

            def spy_up(flats, *a, _rt=rt_of[side], _side=side, **kw):
                if low_rank and _side == "cuda":
                    inputs = (flats.detach().clone(), a[0], [
                        None if t is None else t.clone()
                        for t in (a[1] if len(a) > 1 else kw["states"])],
                        kw["bits"].clone())
                out = _rt(flats, *a, **kw)
                uplinks[_side].append(flats.detach().cpu().clone())
                if low_rank and _side == "cuda":
                    lr_calls.append((inputs, out[1], out[2]))
                return out
            tr.uplink_codec.roundtrip_stacked = spy_up

            def spy_aggregate(*a, _agg=tr._aggregate_flat, _side=side):
                out = _agg(*a)
                globals_[_side].append(torch.cat(
                    [t.reshape(-1).cpu() for t in common.tree_leaves(out)]))
                return out
            tr._aggregate_flat = spy_aggregate
        rows = -(-sides["cpu"].d_trainable // q_mod.BLOCK)
        lr = fc_p.actor_lr
        records = []
        local.firm_local_step = spy_step
        fedcmoo.server_solve = spy_solve
        transformer.prefill = f32_prefill
        all_draws = []
        for r in range(n_rounds):
            draws = {
                "prompts": torch.randint(0, cfg_p.vocab,
                                         (k_max, pc, pb, pp),
                                         generator=g_cpu),
                "gumbel": -torch.log(-torch.log(torch.rand(
                    (k_max, pc, pnew, pb, cfg_p.vocab),
                    generator=g_cpu).clamp(1e-12, 1 - 1e-7))),
                # the uplink's draws: omega for a low-rank codec, none
                # for top-k, else the rounding bits
                "up_bits": (torch.randn(
                    (pc, lowrank._matrix_shape(sides["cpu"].d_trainable)[1],
                     up_inner.rank), generator=g_cpu) if low_rank else
                    torch.randint(-2 ** 31, 2 ** 31 - 1, (pc, rows, 1024),
                                  dtype=torch.int32, generator=g_cpu))}
            if top_k:
                del draws["up_bits"]
            if down != "identity":
                draws["down_bits"] = torch.randint(
                    -2 ** 31, 2 ** 31 - 1, (rows, 1024), dtype=torch.int32,
                    generator=g_cpu)
            if exchange:
                draws["grad_bits"] = torch.randint(
                    -2 ** 31, 2 ** 31 - 1, (k_max, pc * N_OBJ, rows, 1024),
                    dtype=torch.int32, generator=g_cpu)
            all_draws.append(draws)

        def on(side, draws):
            dev_s = torch.device("cpu") if side == "cpu" else dev
            return {k: v.to(dev_s) for k, v in draws.items()}
        # each round's delta uplink rows (a fedcmoo round sends its
        # gradients through the same identity codec before them)
        chunk, round_up = {}, {"cpu": [], "cuda": []}
        if fused:
            for side, tr in sides.items():
                side_of["now"] = side
                chunk[side], sec_ = wall(lambda: tr.run_rounds_fused(
                    n_rounds, draws=[on(side, d_) for d_ in all_draws]))
                chunk[side + "_s"] = sec_ / n_rounds
                round_up[side] = uplinks[side][-n_rounds:]
        for r in range(n_rounds):
            summ, sec = {}, {}
            for side, tr in sides.items():
                side_of["now"] = side
                if fused:
                    summ[side], sec[side] = chunk[side][r], chunk[side + "_s"]
                else:
                    summ[side], sec[side] = wall(lambda: tr.run_round(
                        **on(side, all_draws[r])))
                    round_up[side].append(uplinks[side][-1])
            before = {s_: g_[r] for s_, g_ in globals_.items()}
            after = {s_: g_[r + 1] for s_, g_ in globals_.items()}
            curv = []
            # the round's problems: one a step (fedcmoo's server) or one a
            # client-step
            n_solved = (k_max if exchange else
                        sum(het_steps) if het_steps else pc)
            for g in grams["cpu"][r * n_solved:(r + 1) * n_solved]:
                q = g / (np.trace(g) / N_OBJ) + 0.5 * beta * np.eye(N_OBJ)
                curv.append(q[0, 0] + q[1, 1] - 2 * q[0, 1])
            slack = 1 / min(1.0, float(min(curv))) if curv else 1.0
            got, want = summ["cuda"], summ["cpu"]

            def of_scale(a, b):
                a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
                return float(np.abs(a - b).max() / np.abs(b).max())

            def past(a, b, tol):
                """Share of entries past tol of the scale."""
                a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
                return float((np.abs(a - b) > tol * np.abs(b).max()).mean())
            steps = {"client_steps": (round_up["cuda"][r] / lr,
                                      round_up["cpu"][r] / lr),
                     "global_step": ((after["cuda"] - before["cuda"]) / lr,
                                     (after["cpu"] - before["cpu"]) / lr)}
            rec = {
                "round": r + 1,
                "curvature": float(min(curv)) if curv else None,
                "seconds": sec,
                "exact": all(got[k] == want[k] for k in (
                    "comm_bytes", "up_bytes", "down_bytes", "participants",
                    "up_nbytes", "down_nbytes", "dispatches", "cohorts",
                    "local_steps")) and got.get("fused") == want.get("fused")
                and got.get("fused") == (n_rounds if fused else None)
                and bool(np.array_equal(got["rewards_per_client"],
                                        want["rewards_per_client"])),
                "drift": of_scale(got["param_drift"], want["param_drift"]),
                "kl_abs": abs(got["kl"] - want["kl"]),
                "lam": max(of_scale(got[k], want[k]) for k in (
                    "lam_mean", "per_client_lam", "lam_disagreement")),
                **{k: of_scale(*v) for k, v in steps.items()}}
            ok = (rec["exact"] and rec["drift"] <= 1e-4
                  and rec["kl_abs"] <= 1e-6 and rec["lam"] <= 1e-4 * slack)
            if low_rank:
                (flats_c, spec_c, states_c, omega_c), res_c, dec_c = \
                    lr_calls[r]
                _, cpu_res, cpu_dec = rt_of["cpu"](
                    flats_c.cpu(), spec_c,
                    [None if t is None else t.cpu() for t in states_c],
                    bits=omega_c.cpu())
                rec["lowrank"] = []
                for c in range(pc):
                    adj = flats_c[c] + (0 if states_c[c] is None
                                        else states_c[c])
                    scale = float(adj.abs().max())
                    _, p_c = up_inner.range_sample(adj, omega_c[c])
                    sv = torch.linalg.svdvals(p_c.double().cpu())
                    cond = float(sv[0] / sv[-1])
                    lr_rec = {
                        "cond_P": cond,
                        "decoded_err": float((dec_c[c].cpu() - cpu_dec[c])
                                             .abs().max()) / scale,
                        "residual_err": float((res_c[c].cpu() - cpu_res[c])
                                              .abs().max()) / scale,
                        "limit": max(1e-4, 2 * lowrank.F32_ERROR_K
                                     * 2.0 ** -24 * cond)}
                    rec["lowrank"].append(lr_rec)
                    ok = ok and max(lr_rec["decoded_err"],
                                    lr_rec["residual_err"]) <= lr_rec["limit"]
            if algorithm == "firm":
                ok = ok and all(rec[k] <= 1e-2 * slack for k in steps)
            else:
                # the rule of tests/test_torch_algorithm_rounds.py for
                # these algorithms: at most 0.2% of the entries past 1e-2
                # of the scale (Adam's step where the combined gradient
                # nears eps), each within 0.25
                rec["share_past"] = {k: past(*v, 1e-2 * slack)
                                     for k, v in steps.items()}
                ok = ok and all(rec[k] <= max(0.25, 1e-2 * slack)
                                and rec["share_past"][k] <= 2e-3
                                for k in steps)
            records.append(rec)
            check(ok, f"round_parity {cfg_p.name} {algorithm} {up} round "
                  f"{r + 1}: {rec}")
        local.firm_local_step = step_fn
        fedcmoo.server_solve = solve_fn
        transformer.prefill = prefill_fn
        return records

    prefill_fn = transformer.prefill
    f32_prefill = functools.partial(prefill_fn, cache_dtype=torch.float32)

    parity = {}
    # the tiny mixtral: 4 experts top 2, a window of 8 (which a rollout of
    # 8 + 12 tokens crosses) and capacity factor 0.5 (8 slots an expert
    # for the update's 40 choices a row: tokens drop)
    tiny_mixtral = get_config("mixtral-8x7b").reduced(n_layers=2,
                                                      d_model=64, vocab=64)
    tiny_mixtral = dataclasses.replace(
        tiny_mixtral, sliding_window=8, moe=dataclasses.replace(
            tiny_mixtral.moe, capacity_factor=0.5))
    for cfg_p in (dataclasses.replace(
            get_config("llama-3.2-1b").reduced(n_layers=2, d_model=64,
                                               vocab=256), n_kv_heads=2),
                  get_config("zamba2-1.2b").reduced(n_layers=2, d_model=64,
                                                    vocab=64),
                  tiny_mixtral):
        zero_counts()
        parity[cfg_p.name] = {"rounds": parity_rounds(cfg_p),
                              "card_launches": read_counts()}
    check(parity["zamba2-1.2b-smoke"]["card_launches"]["ssd_bwd"] > 0,
          "the zamba2 round on the card ran the SSD backward")
    check(parity["mixtral-8x7b-smoke"]["card_launches"][
        "flash_attention_bwd"] > 0, "the mixtral round on the card ran the "
          "flash backward")
    # the other algorithms on the tiny llama: three carried rounds each
    # with identity codecs, and one fedcmoo round with int8 gradients
    tiny_llama = dataclasses.replace(get_config("llama-3.2-1b").reduced(
        n_layers=2, d_model=64, vocab=256), n_kv_heads=2)
    parity_algorithms = {}
    for algorithm, up, n_rounds in (("firm_unreg", "identity", 3),
                                    ("linear", "identity", 3),
                                    ("fedcmoo", "identity", 3),
                                    ("fedcmoo", "int8+ef", 1)):
        zero_counts()
        parity_algorithms[f"{algorithm} {up}"] = {
            "rounds": parity_rounds(tiny_llama, algorithm, up, n_rounds),
            "card_launches": read_counts()}
    check(parity_algorithms["fedcmoo identity"]["card_launches"]["gram"]
          == 3 and parity_algorithms["fedcmoo int8+ef"]["card_launches"][
              "quantize"] == 2 and parity_algorithms["linear identity"][
              "card_launches"]["gram"] == 0,
          f"round_parity launches {parity_algorithms}")
    # the loop executor and cohorts on the tiny llama, three carried rounds
    # each: firm through the loop; fedcmoo through the loop executor with
    # the int8 gradient uplink (its exchange phase: per round one quantize
    # launch over the 2 clients x M gradient rows, and one for the delta);
    # firm with client_local_steps=(1, 2, 1), two cohorts
    parity_executors = {}
    for label, algorithm, vec, steps_p in (
            ("firm loop", "firm", False, None),
            ("fedcmoo loop", "fedcmoo", False, None),
            ("firm cohorts 1,2,1", "firm", True, (1, 2, 1))):
        zero_counts()
        parity_executors[label] = {
            "rounds": parity_rounds(tiny_llama, algorithm, "int8+ef", 3,
                                    vectorized=vec, het_steps=steps_p),
            "card_launches": read_counts()}
    x_launches = {k: v["card_launches"] for k, v in parity_executors.items()}
    check(x_launches["firm loop"]["gram"] == 3 * 2
          and x_launches["fedcmoo loop"]["gram"] == 3
          and x_launches["fedcmoo loop"]["quantize"] == 3 * 2
          and x_launches["firm cohorts 1,2,1"]["gram"] == 3 * 4,
          f"round_parity executors' launches {x_launches}")
    # the fused executor on the tiny llama: one chunk of R = 3 rounds on
    # each side, wan, then wan up with the delta+int8 downlink (its
    # rounding bits injected)
    parity_fused = {}
    for down_p in ("identity", "delta+int8"):
        zero_counts()
        parity_fused[f"wan up, {down_p} down"] = {
            "rounds": parity_rounds(tiny_llama, "firm", "int8+ef", 3,
                                    down=down_p, fused=True),
            "card_launches": read_counts()}
    f_launches = {k: v["card_launches"] for k, v in parity_fused.items()}
    check(f_launches["wan up, identity down"]["quantize"] == 3
          and f_launches["wan up, delta+int8 down"]["quantize"] == 6
          and all(v["gram"] == 3 * 2 for v in f_launches.values()),
          f"round_parity fused launches {f_launches}")
    # C = 4 clients on the tiny llama, R = 2 carried rounds each: the
    # extreme preset (the top-k uplink, whose abs_threshold_count counts
    # over the four clients' rows; the int8 downlink) and the powersgd
    # preset (lowrank:4+ef up, omega injected)
    parity_clients, c4_start = {}, time.perf_counter()
    for preset in ("extreme", "powersgd"):
        up_p, down_p = CODEC_PRESETS[preset]
        zero_counts()
        parity_clients[f"{preset} C=4"] = {
            "rounds": parity_rounds(tiny_llama, "firm", up_p, 2,
                                    down=down_p, clients=4),
            "card_launches": read_counts()}
    c4_s = time.perf_counter() - c4_start
    c_launches = {k: v["card_launches"] for k, v in parity_clients.items()}
    check(c_launches["extreme C=4"]["abs_threshold_count"] > 0
          and all(v["gram"] == 2 * 4 for v in c_launches.values()),
          f"round_parity C = 4 launches {c_launches}")
    emit(phase="round_parity", models=parity,
         algorithms=parity_algorithms, executors=parity_executors,
         fused=parity_fused, clients=parity_clients,
         clients_seconds=c4_s,
         tolerance="exact bytes, participants, dispatches and rewards; "
         "drift 1e-4 of its scale; KL 1e-6 absolute; lambda 1e-4 and the "
         "steps over actor_lr 1e-2 of their scale, each over min(1, D); "
         "firm_unreg, linear and fedcmoo: at most 0.2% of a step's "
         "entries past 1e-2, each within 0.25; the low-rank uplink: the "
         "CPU codec on the card's inputs within max(1e-4, 2 F32_ERROR_K "
         "2**-24 cond(P)) of max |flat + state|")
    done("round_parity")

    # ---------------------------------------------------------- 22. algorithms
    # the baselines at full width, from the rollout phase's reference
    # weights, with the wan preset: one fedcmoo round of C = 2 clients and
    # K = 2 steps (every step each client's M gradients go up through the
    # error-feedback-stripped int8 codec, one quantize and one dequantize
    # launch over the C * M rows, and the server solves lambda through the
    # Gram kernel), then one linear round of C = 2, K = 1 (fixed weights:
    # no Gram).  The counts are zeroed just before each round and read
    # just after.  Then, uncounted: the gradient uplink against the plain
    # codec (ref.quantize and ref.dequantize on the same rows and the same
    # rounding bits, drawn again from the saved generator states) bit for
    # bit, and each server lambda against server_solve with the plain Gram
    # within 1e-4 over min(1, D), the round tests' lambda rule.
    def algorithm_round(algorithm, k):
        fc_a = dataclasses.replace(fc, n_clients=N_CLIENTS, local_steps=k,
                                   rounds=1)
        up, down = CODEC_PRESETS["wan"]
        tr = FederatedTrainer(cfg, fc_a, EngineConfig(
            algorithm=algorithm, prompt_len=P, max_new=MAX_NEW,
            uplink_codec=up, downlink_codec=down), params=ref_params,
            device=dev)
        exchange = not tr.algorithm.caps.traced_server_exchange
        part_s, grad_log, solve_log, stack_s = {}, [], [], []

        def timed_part(name, fn):
            def run_part(*a, **kw):
                out, sec = wall(lambda: fn(*a, **kw))
                part_s[names[name]] = sec
                return out
            return run_part
        for name in names:
            setattr(tr, name, timed_part(name, getattr(tr, name)))
        grad_codec = (tr.algorithm._grad_codec(tr.uplink_codec) if exchange
                      else tr.uplink_codec)
        codec_rt = grad_codec.roundtrip_stacked
        solve_fn, stack_fn = fedcmoo.server_solve, fedcmoo.stack_grads_flat

        def logged_rt(flats, spec, states=None, *, keys=None, bits=None):
            saved = [g_.get_state() for g_ in keys]
            out, sec = wall(lambda: codec_rt(flats, spec, states, keys=keys,
                                             bits=bits))
            grad_log.append((flats.clone(), saved, out, sec))
            return out

        def logged_solve(mats, *a, **kw):
            lam_, sec = wall(lambda: solve_fn(mats, *a, **kw))
            solve_log.append(([m_.clone() for m_ in mats], lam_, sec))
            return lam_

        def logged_stack(*a, **kw):
            out, sec = wall(lambda: stack_fn(*a, **kw))
            stack_s.append(sec)
            return out
        if exchange:
            grad_codec.roundtrip_stacked = logged_rt
            fedcmoo.server_solve = logged_solve
            fedcmoo.stack_grads_flat = logged_stack
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        summary, sec = wall(tr.run_round)
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        grad_codec.roundtrip_stacked = codec_rt
        fedcmoo.server_solve, fedcmoo.stack_grads_flat = solve_fn, stack_fn
        client_steps = N_CLIENTS * k
        want = {name: client_steps * n // k_steps
                for name, n in want_local.items()}
        want.update(gram=k if exchange else 0,
                    quantize=k + 1 if exchange else 1,
                    dequantize=k + 1 if exchange else 1)
        check(launches == want, f"{algorithm} launch counts {launches}, "
              f"expected {want}")
        per_client = tr.algorithm.uplink_bytes_per_participant(
            fc_a, tr.uplink_codec, d_lora)
        delta_bytes = tr.uplink_codec.nbytes_static(d_lora)
        check(tr.ledger.up_bytes == N_CLIENTS * per_client
              and summary["up_nbytes"] == [delta_bytes] * N_CLIENTS
              and summary["down_nbytes"] == 4 * d_lora
              and summary["dispatches"] == 5 + tr.algorithm
              .vec_phase_dispatches(k)
              and summary["participants"] == list(range(N_CLIENTS)),
              f"{algorithm} bookkeeping {summary}")
        lam_pc = summary["per_client_lam"]
        check(lam_pc.shape == (N_CLIENTS, N_OBJ) and (lam_pc >= 0).all()
              and abs(lam_pc.sum(-1) - 1).max() < 1e-5,
              f"{algorithm} lambda on the simplex: {lam_pc.tolist()}")
        check(summary["param_drift"] > 0 and math.isfinite(summary["kl"]),
              f"{algorithm} drift {summary['param_drift']}")
        check(all(bool(t.isfinite().all()) for t in
                  common.tree_leaves(tr.global_trainable))
              and any(bool((a != b).any()) for a, b in zip(
                  common.tree_leaves(tr.global_trainable),
                  common.tree_leaves(train0))),
              f"{algorithm} global adapters finite and moved")
        record = dict(
            model=cfg.name, algorithm=algorithm, preset="wan",
            clients=N_CLIENTS, local_steps=k, rounds=1, batch=B,
            prompt_len=P, max_new=MAX_NEW, uplink=up, downlink=down,
            d_trainable=d_lora, seconds_per_round=sec,
            seconds_per_client_step=sec / client_steps,
            breakdown_s=part_s, launches=launches, peak_memory_bytes=peak,
            comm_bytes=summary["comm_bytes"], up_bytes=tr.ledger.up_bytes,
            up_bytes_per_participant=per_client,
            up_nbytes=summary["up_nbytes"],
            down_nbytes=summary["down_nbytes"],
            dispatches=summary["dispatches"],
            param_drift=summary["param_drift"],
            lam_disagreement=summary["lam_disagreement"],
            per_client_lam=lam_pc.tolist(), kl=summary["kl"],
            rewards=summary["rewards"].tolist())
        return tr, summary, record, grad_log, solve_log, stack_s

    tr_f, s_f, fedcmoo_record, grad_log, solve_log, stack_s = \
        algorithm_round("fedcmoo", 2)
    check(s_f["comm_bytes"] == 61_474_816
          and fedcmoo_record["up_bytes_per_participant"] == 17_105_920,
          f"fedcmoo comm_bytes {s_f['comm_bytes']}")
    lam_pc = s_f["per_client_lam"]
    # one global lambda: equal rows, so the disagreement is the formula's
    # floor sqrt(0 + 1e-30) in f32
    check(bool((lam_pc == lam_pc[0]).all()) and s_f["lam_disagreement"]
          == float(np.sqrt(np.float32(1e-30))),
          f"fedcmoo lambda rows {lam_pc.tolist()}, disagreement "
          f"{s_f['lam_disagreement']}")
    check(len(grad_log) == 2 and len(solve_log) == 2 and len(stack_s) == 2,
          "fedcmoo: one gradient roundtrip, stack and solve a step")
    grad_checks, lam_checks = [], []
    for flats, saved, (payloads, _, decoded), _ in grad_log:
        check(tuple(flats.shape) == (N_CLIENTS * N_OBJ, d_lora)
              and len(payloads) == N_CLIENTS * N_OBJ,
              f"gradient uplink rows {tuple(flats.shape)}")
        x, rows_g = qcodec._stacked_blocks(flats)
        gens = []
        for st in saved:
            g_ = torch.Generator(device=dev)
            g_.set_state(st)
            gens.append(g_)
        rbits = torch.cat([qcodec.random_bits((rows_g, q_mod.BLOCK), g_)
                           for g_ in gens])
        codes, scales = ref.quantize(x, rbits, 127)
        dec = ref.dequantize(codes, scales).reshape(
            N_CLIENTS * N_OBJ, -1)[:, :d_lora]
        same = (torch.equal(torch.cat([p_.arrays["codes"]
                                       for p_ in payloads]), codes)
                and torch.equal(torch.cat([p_.arrays["scales"]
                                           for p_ in payloads]), scales)
                and torch.equal(decoded, dec))
        grad_checks.append(same)
        check(same, "fedcmoo gradient uplink: not the plain codec's bits")
    for mats, lam_got, _ in solve_log:
        avg = sum(mats) / len(mats)
        g_plain = ref.gram(avg)
        lam_plain = mgda.solve(g_plain, 0.0, trace_normalize=True,
                               solver="pgd", iters=100)
        g64 = g_plain.double().cpu().numpy()
        q = g64 / (np.trace(g64) / N_OBJ)
        curv_s = q[0, 0] + q[1, 1] - 2 * q[0, 1]
        err = float((lam_got - lam_plain).abs().max()
                    / lam_plain.abs().max())
        lam_checks.append({"rel_err": err, "curvature": curv_s,
                           "gram_rel_err": max_rel(ops.gram(avg), g_plain)})
        check(err <= 1e-4 / min(1.0, curv_s),
              f"fedcmoo server lambda vs plain Gram: {lam_checks[-1]}")
    fedcmoo_record.update(
        gradient_uplink_bit_for_bit=grad_checks, server_lambda=lam_checks,
        exchange_s={"stack": stack_s,
                    "codec": [sec_ for *_, sec_ in grad_log],
                    "solve": [sec_ for *_, sec_ in solve_log]},
        lam_disagreement_floor=float(np.sqrt(np.float32(1e-30))))
    del tr_f, grad_log, solve_log
    tr_l, s_l, linear_record, _, _, _ = algorithm_round("linear", 1)
    check(s_l["comm_bytes"] == 34_105_344
          and linear_record["launches"]["gram"] == 0,
          f"linear comm_bytes {s_l['comm_bytes']}")
    check(bool((s_l["lam_mean"] == np.float32(0.5)).all()),
          f"linear lam_mean {s_l['lam_mean'].tolist()} is the weights")
    del tr_l
    emit(phase="algorithms", fedcmoo=fedcmoo_record, linear=linear_record,
         tolerance="exact bytes and launches; the gradient uplink bit for "
         "bit with the plain codec; the server lambda within 1e-4 of the "
         "plain Gram's over min(1, D)")
    done("algorithms")

    # ----------------------------------------------------------- 23. executors
    # the front door at full width: plan(RunSpec) -> build(device="cuda",
    # params=the rollout phase's reference weights) -> one round, wan
    # preset, C = 2, for two plans: the loop executor
    # (vectorized_clients=False, K = 1) and cohorts of heterogeneous K
    # (client_local_steps=(1, 2): one cohort of K = 1, one of K = 2, so the
    # first full-width firm round with K > 1).  plan() builds its tree on
    # the meta device, so it allocates nothing on the card; the plan's
    # bytes and dispatches are the round's.  The counts are zeroed just
    # before each round and read just after: the round phase's launches
    # a client-step, and one quantize and one dequantize.
    from repro_torch.fed import api
    wan_up, wan_down = CODEC_PRESETS["wan"]
    fc_x = dataclasses.replace(fc, n_clients=N_CLIENTS, local_steps=1,
                               rounds=1)
    ec_x = dict(prompt_len=P, max_new=MAX_NEW, uplink_codec=wan_up,
                downlink_codec=wan_down)
    executor_cases = {
        "loop": (api.RunSpec(cfg, fc_x, EngineConfig(
            vectorized_clients=False, **ec_x)),
            dict(executor="loop", local_mode="loop", cohorts=[],
                 dispatches_per_round=10.0), "_local_phase_loop", 0),
        "cohort": (api.RunSpec(cfg, dataclasses.replace(
            fc_x, client_local_steps=(1, 2)), EngineConfig(**ec_x)),
            dict(executor="vectorized", local_mode="cohort",
                 cohorts=[[1, 1], [1, 2]], dispatches_per_round=10.0),
            "_local_phase_cohorts", 2)}
    names_x = {"_broadcast": "downlink", "_delta_flat": "delta",
               "_uplink": "uplink_codec", "_aggregate_flat": "aggregate",
               "_record": "summary"}
    wan_client_step_s = [s_ / N_CLIENTS
                         for s_ in wan_record["seconds_per_round"]]
    executors = {}
    for mode_x, (spec_x, want_plan, phase_fn, want_cohorts) in \
            executor_cases.items():
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        api.trainable_size.cache_clear()
        plan_x, plan_s = wall(lambda: api.plan(spec_x))
        mem1 = torch.cuda.memory_allocated()
        summ_x = plan_x.summary()
        check(mem1 == mem0, f"plan() allocated {mem1 - mem0} bytes on the "
              "card")
        check(plan_x.d_trainable == d_lora == 3_407_872
              and all(summ_x[k] == v for k, v in want_plan.items())
              and summ_x["up_bytes_per_round"] == 6_842_368
              and summ_x["down_bytes_per_round"] == 27_262_976,
              f"{mode_x} plan {summ_x}")
        tr_x = plan_x.build(device="cuda", params=ref_params)
        check(tr_x.plan is plan_x, "the trainer keeps the plan it was built "
              "from")
        part_s = {}

        def timed_part(name, fn, label):
            def run_part(*a, **kw):
                out, sec = wall(lambda: fn(*a, **kw))
                part_s[label] = part_s.get(label, 0.0) + sec
                return out
            return run_part
        for name, label in {**names_x, phase_fn: "local_phase"}.items():
            setattr(tr_x, name, timed_part(name, getattr(tr_x, name),
                                           label))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        summary, sec = wall(tr_x.run_round)
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        steps_x = [tr_x._client_fcs[c].local_steps
                   for c in range(N_CLIENTS)]
        client_steps = sum(steps_x)
        want = {name: client_steps * n // k_steps
                for name, n in want_local.items()}
        want.update(quantize=1, dequantize=1)
        check(launches == want, f"{mode_x} launch counts {launches}, "
              f"expected {want}")
        check(summary["comm_bytes"] == 34_105_344
              == plan_x.up_bytes_per_round + plan_x.down_bytes_per_round
              and summary["dispatches"] == plan_x.dispatches_per_round
              and summary["cohorts"] == want_cohorts
              and summary["local_steps"] == steps_x
              and summary["participants"] == list(range(N_CLIENTS)),
              f"{mode_x} bookkeeping {summary}")
        lam_pc = summary["per_client_lam"]
        check(lam_pc.shape == (N_CLIENTS, N_OBJ) and (lam_pc >= 0).all()
              and abs(lam_pc.sum(-1) - 1).max() < 1e-5,
              f"{mode_x} lambda on the simplex: {lam_pc.tolist()}")
        check(summary["param_drift"] > 0 and math.isfinite(summary["kl"]),
              f"{mode_x} drift {summary['param_drift']}")
        # each client made its own K steps: the step counters and the
        # prompt streams
        check([int(tr_x.client_states[c].step) for c in range(N_CLIENTS)]
              == steps_x == [ds.count for ds in tr_x.datasets],
              f"{mode_x} client steps {steps_x}")
        check(all(bool(t.isfinite().all()) for t in
                  common.tree_leaves(tr_x.global_trainable))
              and any(bool((a != b).any()) for a, b in zip(
                  common.tree_leaves(tr_x.global_trainable),
                  common.tree_leaves(train0))),
              f"{mode_x} global adapters finite and moved")
        executors[mode_x] = dict(
            model=cfg.name, preset="wan", clients=N_CLIENTS,
            client_local_steps=steps_x, batch=B, prompt_len=P,
            max_new=MAX_NEW, plan=summ_x, plan_seconds=plan_s,
            plan_allocated_bytes=mem1 - mem0, seconds_per_round=sec,
            breakdown_s=part_s,
            seconds_per_client_step=sec / client_steps,
            wan_round_seconds_per_client_step=wan_client_step_s,
            client_step_vs_wan=[sec / client_steps / w_
                                for w_ in wan_client_step_s],
            launches=launches, peak_memory_bytes=peak,
            wan_round_peak_memory_bytes=wan_record["peak_memory_bytes"],
            comm_bytes=summary["comm_bytes"],
            dispatches=summary["dispatches"], cohorts=summary["cohorts"],
            param_drift=summary["param_drift"],
            per_client_lam=lam_pc.tolist(), kl=summary["kl"],
            rewards=summary["rewards"].tolist())
        del tr_x
    emit(phase="executors", **executors,
         tolerance="exact bytes, dispatches, cohorts and launches; "
         "plan() allocates nothing on the card")
    done("executors")

    # --------------------------------------------------------------- 24. fused
    # the fused executor at full width (llama-3.2-1b, C = 2, K = 1) against
    # the per-round executor from the same seed and the rollout phase's
    # reference weights, one trainer after the other: each peaks at ~20.8
    # GB besides its ~15 GB update pool, so two at once do not fit; each
    # hands its summaries, global adapters and error-feedback rows to the
    # host and is freed.  Each trainer's first chunk (of the per-round
    # trainer: its first R rounds) warms and captures the update; the
    # second runs under torch.cuda.set_sync_debug_mode("error"), where any
    # synchronising call raises (the chunk's one copy to the host goes
    # into pinned memory and the host waits on an event, which the mode
    # does not flag).  wan: two chunks of 3 against six rounds, the second
    # chunk timed against rounds 4-6.  mobile: three chunks of 2 against
    # two rounds; the fused trainer's second chunk runs under
    # torch.profiler (CUDA activity alone) for its idle share, host launch
    # calls and traced device-to-host copies (at most one: the trace can
    # lose its tail), the shortest window that holds a whole chunk; its
    # third under CopiesToHost for the exact count of copies to the host
    # (one).  Held bit for bit over the rounds both ran: every
    # summary key but dispatches (and fused), the global adapters and the
    # residual rows after them; fused is R and dispatches the reference's
    # 3 / R.  The counts are zeroed just before each trainer's rounds and
    # read just after: the round phase's launches a round, times the
    # rounds.
    fc_f = dataclasses.replace(fc, n_clients=N_CLIENTS, local_steps=1)
    launches_a_round = {name: N_CLIENTS * n // k_steps
                        for name, n in want_local.items()}

    def host_copy(tr):
        return ([t.cpu() for t in common.tree_leaves(tr.global_trainable)],
                [r_.cpu() for r_ in tr._uplink_state])

    from torch.utils._python_dispatch import TorchDispatchMode
    aten = torch.ops.aten

    class CopiesToHost(TorchDispatchMode):
        """Counts the ATen calls that bring card data to the host (a copy
        or conversion of a CUDA tensor onto the CPU, a scalar read): the
        exact count, where a CUPTI trace of ~10^6 records can lose its
        tail (one run of this phase traced 0 copies in a chunk that
        another traced with 1 copy and ~2,600 more records)."""

        def __init__(self):
            super().__init__()
            self.count = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            op = func.overloadpacket
            if op is aten.copy_:
                hit = args[0].device.type == "cpu" and args[1].is_cuda
            elif op is aten._to_copy:
                to = kwargs.get("device")
                hit = (args[0].is_cuda and to is not None
                       and torch.device(to).type == "cpu")
            else:
                hit = (op in (aten._local_scalar_dense, aten.item)
                       and args[0].is_cuda)
            self.count += hit
            return func(*args, **kwargs)

    def fused_case(preset: str, chunk: int, chunks: dict,
                   profiled: bool = False):
        """``chunks``: mode -> the number of chunks of ``chunk`` rounds it
        runs; the fused trainer's second is profiled if ``profiled``."""
        up, down = CODEC_PRESETS[preset]
        codec_launches = 1 + (down != "identity")
        n_common = chunk * min(chunks.values())
        runs = {}
        for mode, n_chunks in chunks.items():
            tr = FederatedTrainer(cfg, fc_f, EngineConfig(
                prompt_len=P, max_new=MAX_NEW, uplink_codec=up,
                downlink_codec=down,
                fused_rounds=chunk if mode == "fused" else 1),
                params=ref_params, device=dev)
            check(tr.plan.executor == ("fused" if mode == "fused"
                                       else "vectorized"),
                  f"{preset} {mode} executor {tr.plan.executor}")
            hist, recs = [], []
            torch.cuda.synchronize()
            zero_counts()
            for i in range(n_chunks):
                strict = i > 0

                def run_chunk():
                    if strict:
                        torch.cuda.set_sync_debug_mode("error")
                    try:
                        if mode == "fused":
                            return tr.run_rounds_fused(chunk)
                        return [tr.run_round() for _ in range(chunk)]
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                rec = {"chunk": i + 1, "sync_debug_mode_error": strict}
                if mode == "fused" and profiled and i == 1:
                    box = []
                    rec["profile"] = device_profile(
                        lambda: box.append(run_chunk()), chunk,
                        cpu_ops=False)
                    out = box[0]
                elif mode == "fused" and profiled and i == 2:
                    # apart from the profile: the counter's host time
                    # would show as device idle
                    to_host = CopiesToHost()
                    with to_host:
                        out = run_chunk()
                    rec["device_to_host_copies_aten"] = to_host.count
                else:
                    t0 = time.perf_counter()
                    out = run_chunk()
                    torch.cuda.synchronize()
                    rec["seconds"] = time.perf_counter() - t0
                    rec["seconds_per_round"] = rec["seconds"] / chunk
                rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
                hist += out
                recs.append(rec)
                if len(hist) == n_common:
                    common_state = host_copy(tr)
            launches = read_counts()
            n_rounds = chunk * n_chunks
            want = {name: n_rounds * n for name, n in
                    launches_a_round.items()}
            want.update(quantize=n_rounds * codec_launches,
                        dequantize=n_rounds * codec_launches)
            check(launches == want, f"{preset} {mode} launch counts "
                  f"{launches}, expected {want}")
            runs[mode] = dict(hist=hist, chunks=recs, launches=launches,
                              state=common_state)
            del tr
            gc.collect()
            torch.cuda.empty_cache()
        fused, per = runs["fused"], runs["per_round"]
        for r, sf in enumerate(fused["hist"]):
            check(sf["fused"] == chunk and sf["dispatches"] == 3 / chunk
                  and sf["comm_bytes"] == (r + 1) * N_CLIENTS * (
                      make_codec(up).nbytes_static(d_lora)
                      + make_codec(down).nbytes_static(d_lora)),
                  f"{preset} fused round {r + 1}: {sf}")
        for r, (sf, sp) in enumerate(zip(fused["hist"], per["hist"])):
            check(list(sf) == list(sp) + ["fused"]
                  and all(np.array_equal(np.asarray(sf[k]), np.asarray(sp[k]))
                          for k in sp if k != "dispatches"),
                  f"{preset} round {r + 1}: fused {sf} per round {sp}")
        check(all(torch.equal(a, b) for a, b in zip(
            fused["state"][0] + fused["state"][1],
            per["state"][0] + per["state"][1], strict=True)),
            f"{preset}: the global adapters and residual rows after "
            f"{n_common} rounds, bit for bit")
        return {mode: dict(
            chunks=run["chunks"], launches=run["launches"],
            dispatches=[s_["dispatches"] for s_ in run["hist"]])
            for mode, run in runs.items()} | dict(
            preset=preset, uplink=up, downlink=down, chunk=chunk,
            rounds_bit_for_bit=n_common,
            comm_bytes=per["hist"][-1]["comm_bytes"],
            kl=[s_["kl"] for s_ in fused["hist"]],
            param_drift=[s_["param_drift"] for s_ in fused["hist"]])

    fused_wan = fused_case("wan", 3, {"fused": 2, "per_round": 2})
    fused_mobile = fused_case("mobile", 2, {"fused": 3, "per_round": 1},
                              profiled=True)
    prof_f = fused_mobile["fused"]["chunks"][1]["profile"]
    aten_f = fused_mobile["fused"]["chunks"][2]["device_to_host_copies_aten"]
    check(aten_f == 1 and prof_f is not None
          and prof_f["device_to_host_copies"] <= 1,
          f"fused chunks' device-to-host copies: {aten_f} counted (chunk "
          f"3), {prof_f} traced (chunk 2)")
    last3 = {"fused (chunk 2)":
             fused_wan["fused"]["chunks"][1]["seconds_per_round"],
             "per round (rounds 4-6)":
             fused_wan["per_round"]["chunks"][1]["seconds_per_round"]}
    emit(phase="fused", model=cfg.name, clients=N_CLIENTS, local_steps=1,
         batch=B, prompt_len=P, max_new=MAX_NEW, d_trainable=d_lora,
         nvidia_smi=smi, wan=fused_wan, mobile=fused_mobile,
         seconds_per_round=last3,
         fused_over_per_round=(last3["fused (chunk 2)"]
                               / last3["per round (rounds 4-6)"]),
         per_round_idle_share_of_a_profiled_round=(
             None if round_profile is None else
             round_profile["device_idle_share_of_profiled_window"]),
         tolerance="bit for bit: every summary key but dispatches, the "
         "global adapters and the residual rows; exact launches and bytes")
    done("fused")

    # --------------------------------------------------------------- 25. sched
    # the scheduled path at full width (llama-3.2-1b, the rollout phase's
    # reference weights, wan, B = 16, P = 128, 128 new tokens, K = 1),
    # every trainer through plan(RunSpec(..., sched=)).build() and freed
    # before the next is built (each holds a ~15 GB update pool).  Each
    # case's rounds (or aggregations) are timed and their launches counted
    # (zeroed just before, read just after); then one more run of one
    # round (for fedbuff: a dispatch of every client and one aggregation)
    # under CopiesToHost gives the exact count of copies to the host.
    # (a) sync (C = 2, bimodal seed 1, a JSONL sink) against the bare
    # engine from the same seed: every summary key and the global adapters
    # bit for bit, the clock from the rounds' measured bytes; (b) fedbuff
    # at zero staleness (C = B = 2, homogeneous) against (a)'s rounds;
    # (c) deadline (C = 4, participation 0.5, overselect 2, bimodal seed
    # 1: clients 1 and 3 fast) drops clients 0 and 2 each round; (d)
    # fedbuff under staleness (C = 4, B = 2, uniform seed 0, gain 1): the
    # fast pair of bimodal seed 1 would fill every buffer and leave every
    # staleness 0, so the profiles are uniform seed 0, whose arrivals are
    # stale by 1 and 2 and whose third dispatch runs two beta buckets,
    # both through the one update graph.
    from repro_torch.configs.base import SchedConfig
    from repro_torch.core import comms as comms_lib
    from repro_torch.fed.sched import ScheduledTrainer, sample_profiles
    from repro_torch.obs import span_seconds_by_track, validate_trace
    seq_len = P + MAX_NEW
    per_step = {name: n // k_steps for name, n in want_local.items()}
    ec_s = EngineConfig(prompt_len=P, max_new=MAX_NEW, uplink_codec=wan_up,
                        downlink_codec=wan_down)

    def build_sched(n_clients, sc=None, ec_=ec_s, **fc_kw):
        fc_s = dataclasses.replace(fc, n_clients=n_clients, local_steps=1,
                                   **fc_kw)
        p_ = api.plan(api.RunSpec(cfg, fc_s, ec_, sched=sc))
        built = p_.build(device=dev, params=ref_params)
        check((sc is None) != isinstance(built, ScheduledTrainer),
              f"plan(sched={sc}).build() gave {type(built).__name__}")
        return built

    def sched_run(label, obj, n, client_steps, codec_calls):
        """``obj.run(n)`` timed, its launches exact; returns the last
        n entries of the history and the case's record."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        hist, sec = wall(lambda: obj.run(n))
        launches = read_counts()
        want = {name: client_steps * k for name, k in per_step.items()}
        want.update(quantize=codec_calls, dequantize=codec_calls)
        check(launches == want, f"sched {label} launch counts {launches}, "
              f"expected {want}")
        return list(hist[-n:]), dict(
            seconds=sec, seconds_per_round=sec / n, launches=launches,
            peak_memory_bytes=torch.cuda.max_memory_allocated())

    def copies_to_host(obj):
        """Copies to the host of one more run of one round."""
        to_host = CopiesToHost()
        with to_host:
            obj.run(1)
        return to_host.count

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    def same_summaries(got, want, keys):
        return all(np.array_equal(np.asarray(g[k]), np.asarray(w[k]))
                   for g, w in zip(got, want, strict=True) for k in keys)

    sched_out = {}
    # (a) sync against the bare engine
    bare = build_sched(2)
    hist_e, rec_e = sched_run("bare engine", bare, 2, 4, 2)
    adapters_e = host_copy(bare)[0]
    del bare
    release()
    with tempfile.TemporaryDirectory() as tmp:
        jsonl = Path(tmp, "sched.jsonl")
        st = build_sched(2, SchedConfig(policy="sync", profile="bimodal",
                                        profile_seed=1),
                         dataclasses.replace(ec_s,
                                             metrics_sink=f"jsonl:{jsonl}"))
        hist_a, rec_a = sched_run("sync", st, 2, 4, 2)
        adapters_a = host_copy(st.trainer)[0]
        check(same_summaries(hist_a, hist_e, list(hist_e[0]))
              and all(torch.equal(x, y) for x, y in zip(
                  adapters_a, adapters_e, strict=True)),
              "sync: the bare engine's summaries and adapters bit for bit")
        profs = sample_profiles(2, "bimodal", 1)
        t_sim = 0.0
        for s_ in hist_a:
            durs = [sum(x for _, x in comms_lib.client_round_segments(
                profs[c], s_["down_nbytes"], s_["up_nbytes"][i], 1, B,
                seq_len)) for i, c in enumerate(s_["participants"])]
            t_sim += max(durs)
            check(s_["sim_time"] == t_sim
                  and s_["round_duration"] == max(durs)
                  and s_["client_seconds"] == [round(x, 6) for x in durs],
                  f"sync clock {s_['sim_time']} {s_['client_seconds']}, "
                  f"from the measured bytes {t_sim} {durs}")
        rec_a["device_to_host_copies_a_round"] = copies_to_host(st)
        st.obs.close()
        lines = [json.loads(x) for x in jsonl.read_text().splitlines()]
        kl_lines = [x["value"] for x in lines if x["name"] == "round/kl"]
        check(len(lines) == len(st.obs.records)
              and kl_lines == [s_["kl"] for s_ in st.trainer.history],
              f"sync JSONL: {len(lines)} lines, {len(st.obs.records)} "
              f"records, round/kl {kl_lines}")
        rec_a.update(jsonl_lines=len(lines), sim_time=hist_a[-1]["sim_time"],
                     client_seconds=[s_["client_seconds"] for s_ in hist_a])
    del st
    release()
    sched_out["sync"] = rec_a
    sched_out["bare_engine"] = rec_e
    # (b) fedbuff at zero staleness against (a)'s sync rounds
    st = build_sched(2, SchedConfig(policy="fedbuff", buffer_size=2))
    hist_b, rec_b = sched_run("fedbuff B=C", st, 2, 4, 4)
    check(same_summaries(hist_b, hist_a, ["rewards_per_client",
                                          "comm_bytes"])
          and all(s_["staleness"] == [0, 0]
                  and s_["staleness_weights"] == [0.5, 0.5]
                  for s_ in hist_b)
          and all(torch.equal(x, y) for x, y in zip(
              host_copy(st.trainer)[0], adapters_a, strict=True)),
          "fedbuff at zero staleness: sync's rewards, bytes and adapters "
          f"bit for bit, {[s_['staleness'] for s_ in hist_b]}")
    rec_b["device_to_host_copies_an_aggregation"] = copies_to_host(st)
    del st
    release()
    sched_out["fedbuff_zero_staleness"] = rec_b
    # (c) deadline
    st = build_sched(4, SchedConfig(policy="deadline", overselect=2.0,
                                    profile="bimodal", profile_seed=1,
                                    deadline_quantile=0.2),
                     participation=0.5)
    hist_c, rec_c = sched_run("deadline", st, 2, 4, 2)
    for r, s_ in enumerate(hist_c):
        check(s_["selected"] == [0, 1, 2, 3] and s_["dropped"] == [0, 2]
              and s_["participants"] == [1, 3]
              and s_["round_duration"] == s_["deadline"]
              and s_["down_bytes"] == (r + 1) * 4 * s_["down_nbytes"],
              f"deadline round {r}: {s_}")
    trace_c = st.trace.to_dict()
    validate_trace(trace_c)
    server_s = span_seconds_by_track(trace_c)[(1, 0)]
    check(abs(server_s - hist_c[-1]["sim_time"])
          <= 1e-9 * hist_c[-1]["sim_time"],
          f"deadline server track {server_s} s, sim_time "
          f"{hist_c[-1]['sim_time']}")
    rec_c["device_to_host_copies_a_round"] = copies_to_host(st)
    rec_c.update(deadline_s=[s_["deadline"] for s_ in hist_c],
                 sim_time=hist_c[-1]["sim_time"], server_track_s=server_s,
                 down_bytes=hist_c[-1]["down_bytes"])
    del st
    release()
    sched_out["deadline"] = rec_c
    # (d) fedbuff under staleness: one update graph for every beta
    st = build_sched(4, SchedConfig(policy="fedbuff", buffer_size=2,
                                    profile="uniform", profile_seed=0,
                                    staleness_beta_gain=1.0))
    betas = []
    phase_fn = st.trainer._local_phase

    def beta_spy(members, broadcast, *a, cfc, **kw):
        betas.append(cfc.beta)
        return phase_fn(members, broadcast, *a, cfc=cfc, **kw)
    st.trainer._local_phase = beta_spy
    hist_d, rec_d = sched_run("fedbuff stale", st, 3, 8, 8)
    betas_d = list(betas)       # the copies' run below dispatches again
    graphs_d = st.trainer.update_graphs
    stale = [s_["staleness"] for s_ in hist_d]
    check(max(max(x) for x in stale) >= 1
          and all(dict(zip(s_["staleness"], s_["staleness_weights"]))[
              max(s_["staleness"])] < 0.5 for s_ in hist_d
              if max(s_["staleness"]) > min(s_["staleness"]))
          and len(set(betas_d)) == 2
          and graphs_d.captures == 1 and len(graphs_d._entries) == 1,
          f"fedbuff stale: staleness {stale}, betas {betas_d}, "
          f"{graphs_d.captures} captures, {len(graphs_d._entries)} keys")
    trace_d = st.trace.to_dict()
    validate_trace(trace_d)
    check({"s", "f", "C"} <= {e["ph"] for e in trace_d["traceEvents"]},
          "fedbuff trace: flows and the in-flight counter")
    (entry_d,) = graphs_d._entries.values()
    pool_d = pool_bytes(entry_d.graph.graph)
    rec_d.update(
        device_to_host_copies_an_aggregation=copies_to_host(st),
        staleness=stale,
        staleness_weights=[s_["staleness_weights"] for s_ in hist_d],
        participants=[s_["participants"] for s_ in hist_d],
        betas=betas_d, update_graph_keys=len(graphs_d._entries),
        pool_bytes=pool_d,
        pool_bytes_with_beta_in_the_key=(
            None if pool_d is None else len(set(betas_d)) * pool_d),
        sim_time=hist_d[-1]["sim_time"])
    del st, graphs_d, entry_d
    release()
    sched_out["fedbuff_stale"] = rec_d
    for key_, want_ in (("sync", "device_to_host_copies_a_round"),
                        ("fedbuff_zero_staleness",
                         "device_to_host_copies_an_aggregation"),
                        ("deadline", "device_to_host_copies_a_round"),
                        ("fedbuff_stale",
                         "device_to_host_copies_an_aggregation")):
        check(sched_out[key_][want_] == 1,
              f"sched {key_}: {sched_out[key_][want_]} copies to the host")
    emit(phase="sched", model=cfg.name, batch=B, prompt_len=P,
         max_new=MAX_NEW, local_steps=1, preset="wan", nvidia_smi=smi,
         phase_seconds=time.perf_counter() - phase_end[0], **sched_out,
         tolerance="bit for bit: sync against the bare engine, fedbuff "
         "at zero staleness against sync; exact launches, bytes, clock and "
         "copies to the host")
    done("sched")

    # --------------------------------------------------------------- 26. audit
    # the plan audit (obs.audit) of the reference's smoke matrix
    # (benchmarks/bench_report.py --smoke) at full width: llama-3.2-1b,
    # firm, C = 2, K = 1, B = 16, P = 128, 128 new tokens, the rollout
    # phase's reference weights, through plan(RunSpec(...)).build(), over
    # {identity, int8+ef} uplinks x {per round, fused R = 2}; then
    # zamba2-1.2b fused (wan, R = 2).  Each audit_run(tr).raise_on_drift()
    # (one warm-up round or chunk, then 2 rounds or 2 chunks), its report
    # on a line of its own, and held exactly: no update-graph capture
    # after the warm-up, one copy to the host a round (1/2 fused), the
    # plan's bytes, 10 programs a round (the reference's 6, or 3 / R
    # fused), one decode capture a client-step, and the kernels' launches
    # a round the round phases'; a fused trainer runs one more chunk under
    # jitwatch.record() and CopiesToHost (one copy).  Each trainer is freed
    # before the next.  Then the debug switches on llama (obs.debug): one
    # client-step with the NaN check on (no graph captured, the eager
    # path's launches), one with a NaN written into an adapter entry
    # (FloatingPointError naming the first op), two with the switch off
    # (a capture and a replay again), an f64 tensor handed to the rmsnorm
    # wrapper (TypeError, no launch), and one full-width wan round with
    # f64 as the default dtype, whose outcome is recorded.
    from repro_torch.obs import audit_run, debug, jitwatch
    fc_a = dataclasses.replace(fc, n_clients=N_CLIENTS, local_steps=1,
                               rounds=4)
    per_round = {name: N_CLIENTS * n for name, n in per_step.items()}

    def last_decode_capture_s():
        g_ = sampling._LAST_GRAPHS[torch.cuda.current_device()]
        return g_.capture_s + g_.instantiate_s

    def audit_case(mcfg, params, uplink, chunk, want_round):
        ec_a = EngineConfig(prompt_len=P, max_new=MAX_NEW,
                            uplink_codec=uplink, fused_rounds=chunk)
        p_a = api.plan(api.RunSpec(mcfg, fc_a, ec_a))
        check(p_a.executor == ("fused" if chunk > 1 else "vectorized"),
              f"audit plan executor {p_a.executor}")
        tr = p_a.build(device=dev, params=params)
        t0 = time.perf_counter()
        report = audit_run(tr).raise_on_drift()
        audit_s = time.perf_counter() - t0
        rec = report.to_json()
        emit(phase="audit_report", model=mcfg.name, **rec)
        got = {c.name: c.observed for c in report.checks}
        d = tr.d_trainable
        up_b = N_CLIENTS * make_codec(uplink).nbytes_static(d)
        want = {k: float(v) for k, v in want_round.items() if v}
        check(got["recompiles_after_warmup"] == 0
              and got["host_transfers_per_round"] == 1 / chunk
              and got["up_bytes_per_round"] == p_a.up_bytes_per_round == up_b
              and got["down_bytes_per_round"] == p_a.down_bytes_per_round
              == N_CLIENTS * 4 * d
              and got["dispatches_per_round"] == 10
              and report.reference_dispatches_per_round
              == (6 if chunk == 1 else 3 / chunk)
              and report.decode_captures_per_round == N_CLIENTS
              and report.compiles_by_name == {}
              and report.launches_per_round == want,
              f"audit {mcfg.name} {uplink} R={chunk}: {rec}, launches "
              f"expected {want}")
        out = dict(seconds=audit_s, window_seconds=report.seconds,
                   seconds_per_round=report.seconds / report.rounds,
                   decode_captures_per_round=report.decode_captures_per_round,
                   decode_capture_s=last_decode_capture_s(),
                   up_bytes_per_round=got["up_bytes_per_round"],
                   launches_per_round=report.launches_per_round)
        if chunk > 1:
            to_host = CopiesToHost()
            with jitwatch.record() as log_, to_host:
                tr.run(chunk)
            check(to_host.count == 1 and log_.compile_count == 0,
                  f"an instrumented fused chunk: {to_host.count} copies to "
                  f"the host, {log_.compile_count} captures")
            out["device_to_host_copies_a_chunk_aten"] = to_host.count
        del tr
        release()
        return out

    audit_out = {}
    for uplink in ("identity", wan_up):
        want_a = dict(per_round, quantize=int(uplink != "identity"),
                      dequantize=int(uplink != "identity"))
        for chunk in (1, 2):
            audit_out[f"llama {uplink} R={chunk}"] = audit_case(
                cfg, ref_params, uplink, chunk, want_a)
    audit_out["zamba2 wan R=2"] = audit_case(zcfg, z_ref, wan_up, 2,
                                             want_zround)

    # the debug switches: one llama client-step at a time
    dbg_gen = torch.Generator(device=dev).manual_seed(26)
    dbg_ds = make_client_datasets(1, cfg.vocab, P, generator=dbg_gen,
                                  device=dev)[0]

    def dbg_steps(state, graphs, k=1):
        return client_local_steps(
            cfg, fc, state, frozen0, ref_params, band_h, band_x, k_steps=k,
            max_new=MAX_NEW, length_tol=length_tol, dataset=dbg_ds,
            generators=[dbg_gen] * k, graphs=graphs)

    dbg = {}
    graphs_d = update_graph.UpdateGraphs()
    dc0 = sampling.decode_captures
    debug.set_debug_nan(True)
    try:
        torch.cuda.synchronize()
        zero_counts()
        (st_d, m_d), dbg_s = wall(lambda: dbg_steps(state0, graphs_d))
        launches_d = read_counts()
        check(launches_d == per_step and graphs_d.captures == 0
              and not graphs_d._entries and sampling.decode_captures == dc0
              and bool(m_d["kl"].isfinite().all()),
              f"a client-step under the NaN check: launches {launches_d}, "
              f"expected {per_step}; {graphs_d.captures} update captures, "
              f"{sampling.decode_captures - dc0} decode captures")
        poisoned = common.tree_map(lambda t: t.clone(), state0.trainable)
        common.tree_leaves(poisoned)[0].view(-1)[0] = float("nan")
        try:
            dbg_steps(state0._replace(trainable=poisoned), graphs_d)
            nan_error = None
        except FloatingPointError as e:
            nan_error = str(e)
        check(nan_error is not None and "NaN in the output of" in nan_error,
              f"a NaN adapter entry under the NaN check: {nan_error}")
    finally:
        debug.set_debug_nan(False)
    zero_counts()
    dc1 = sampling.decode_captures
    (_, m_on), on_s = wall(lambda: dbg_steps(state0, graphs_d, k=2))
    launches_on = read_counts()
    check(graphs_d.captures == 1 and sampling.decode_captures == dc1 + 2
          and launches_on == {k: 2 * v for k, v in per_step.items()},
          f"the switch off: {graphs_d.captures} update captures, "
          f"{sampling.decode_captures - dc1} decode captures, launches "
          f"{launches_on}")
    dbg.update(debug_nans_step_s=dbg_s, launches=launches_d,
               nan_error=nan_error, switched_off_two_steps_s=on_s,
               switched_off_update_captures=graphs_d.captures)
    del graphs_d, st_d
    release()
    x64 = torch.ones((4, cfg.d_model), dtype=torch.float64, device=dev)
    before_ = read_counts()["rmsnorm"]
    try:
        rn_mod.rmsnorm_fwd(x64, x64[0].contiguous())
        f64_error = None
    except TypeError as e:
        f64_error = str(e)
    check(f64_error is not None and read_counts()["rmsnorm"] == before_,
          f"an f64 tensor in the rmsnorm wrapper: {f64_error}")
    dbg["f64_kernel_error"] = f64_error
    # one full-width wan round with float64 the default dtype: it must
    # run, with the reference's f32/int32 client state (a raise fails the
    # phase)
    debug.set_x64(True)
    try:
        tr_x = FederatedTrainer(
            cfg, fc_a, EngineConfig(prompt_len=P, max_new=MAX_NEW,
                                    uplink_codec=wan_up,
                                    downlink_codec=wan_down),
            params=ref_params, device=dev)
        s_x, x_s = wall(tr_x.run_round)
        state_dtypes = sorted({str(t.dtype) for t in
                               update_graph._state_leaves(
                                   tr_x.client_states[0])})
        del tr_x
    finally:
        debug.set_x64(False)
    check(math.isfinite(s_x["kl"]) and s_x["comm_bytes"]
          == N_CLIENTS * (make_codec(wan_up).nbytes_static(d_lora)
                          + 4 * d_lora)
          and state_dtypes == ["torch.float32", "torch.int32"],
          f"the f64 round: {s_x}, client-state dtypes {state_dtypes}")
    dbg["x64_round"] = dict(outcome="ran", seconds=x_s,
                            client_state_dtypes=state_dtypes,
                            kl=s_x["kl"], rewards=s_x["rewards"].tolist())
    release()
    emit(phase="audit", model=cfg.name, clients=N_CLIENTS, local_steps=1,
         batch=B, prompt_len=P, max_new=MAX_NEW, nvidia_smi=smi,
         audits=audit_out, debug=dbg,
         phase_seconds=time.perf_counter() - phase_end[0],
         tolerance="exact: captures after warm-up, copies to the host, "
         "bytes, programs and launches a round")
    done("audit")

    # ----------------------------------------------------------------- 27. moe
    moe_launches = moe_phase()
    done("moe")

    # --------------------------------------------------------------- 28. xlstm
    xlstm_launches = xlstm_phase()
    done("xlstm")

    # -------------------------------------------------------------- 29. encdec
    encdec_launches = encdec_phase()
    done("encdec")

    # -------------------------------------------------------------- 30. codecs
    # the powersgd uplink (lowrank:4+ef) and the delta downlink
    # (delta+int8) at the round's width, on the card, then through the
    # port's CPU path with the same inputs and injected draws (omega, the
    # rounding bits).  Delta: bit for bit (the quantize kernels are, and
    # one f32 subtraction and addition round alike on both).  Low-rank:
    # the card's products and QR sum in other orders than the CPU's, and
    # the range sample P = X X^T X omega is ill-conditioned on deltas of
    # mixed row scale (cond(P) up to ~1e5), while rank 4 cancels their
    # dominant rows almost exactly.  So each client's decoded vector and
    # residual are held, against max |flat + state| (the terms that
    # cancel), to max(1e-4, 2 F32_ERROR_K 2**-24 cond(P)), cond(P) in
    # float64 from the card's own P: F32_ERROR_K bounds one f32 side
    # against float64 (tests/test_torch_lowrank_conditioning.py), and the
    # card and the CPU are two such sides.  Checked on the script's usual
    # draw and on five draws of the phase's own generator.
    _, spec_d = codec_lib.tree_to_flat({"a": torch.zeros(d_lora)})

    def rel_err(got, want) -> float:
        return float((got.cpu() - want).abs().max() / want.abs().max())

    lr_codec = make_codec(CODEC_PRESETS["powersgd"][0])
    _, b_cols = lowrank._matrix_shape(d_lora)

    def lowrank_draw(generator=None):
        flats = delta_rows(rows_round, generator).view(N_CLIENTS, d_lora)
        states = [1e-2 * delta_rows(rows_round // N_CLIENTS,
                                    generator).view(-1)
                  for _ in range(N_CLIENTS)]
        omega = randn((N_CLIENTS, b_cols, lr_codec.inner.rank),
                      torch.float32, generator)
        return flats, states, omega

    def lowrank_check(label, flats, states, omega):
        (pay, res, dec), sec = wall(lambda: lr_codec.roundtrip_stacked(
            flats, spec_d, states, bits=omega))
        _, cpu_res, cpu_dec = lr_codec.roundtrip_stacked(
            flats.cpu(), spec_d, [t.cpu() for t in states],
            bits=omega.cpu())
        clients = []
        for c in range(N_CLIENTS):
            adj = flats[c] + states[c]
            scale = float(adj.abs().max())
            _, p_c = lr_codec.inner.range_sample(adj, omega[c])
            sv = torch.linalg.svdvals(p_c.double().cpu())
            cond = float(sv[0] / sv[-1])
            rec = {"cond_P": cond,
                   "cancellation": scale / float(res[c].abs().max()),
                   "decoded_err": float((dec[c].cpu() - cpu_dec[c]).abs()
                                        .max()) / scale,
                   "residual_err": float((res[c].cpu() - cpu_res[c]).abs()
                                         .max()) / scale,
                   "residual_err_of_own_max": rel_err(res[c], cpu_res[c]),
                   "limit": max(1e-4, 2 * lowrank.F32_ERROR_K * 2.0 ** -24
                                * cond)}
            check(max(rec["decoded_err"], rec["residual_err"])
                  <= rec["limit"], f"lowrank:4+ef card vs CPU, {label} "
                  f"client {c}: {rec}")
            clients.append(rec)
        nbytes = [p_.nbytes for p_ in pay]
        check(nbytes == [lr_codec.nbytes_static(d_lora)] * N_CLIENTS
              and lr_codec.nbytes_static(d_lora) == 59_392,
              f"lowrank payload bytes {nbytes}")
        return {"draw": label, "clients": clients, "nbytes": nbytes,
                "seconds": sec}

    lr_checks = [lowrank_check("usual", *lowrank_draw())]
    codec_gen = torch.Generator(device=dev).manual_seed(16)
    lr_checks += [lowrank_check(f"codec generator {i}",
                                *lowrank_draw(codec_gen)) for i in range(5)]
    dl_codec = make_codec("delta+int8")
    theta0 = 1e-2 * randn((d_lora,), torch.float32)
    thetas = [theta0, theta0 + delta_rows(rows_round // N_CLIENTS).view(-1)]
    dl_state = dl_state_cpu = None
    dl_checks, dl_s = [], []
    for theta in thetas:
        dbits = rand_bits(rows_round // N_CLIENTS)
        (dp, dl_state, ddec), sec = wall(lambda: dl_codec.roundtrip_flat(
            theta, spec_d, dl_state, bits=dbits))
        cp, dl_state_cpu, cdec = dl_codec.roundtrip_flat(
            theta.cpu(), spec_d, dl_state_cpu, bits=dbits.cpu())
        dl_s.append(sec)
        dl_checks.append({
            "codes_equal": bool(torch.equal(dp.arrays["codes"].cpu(),
                                            cp.arrays["codes"])),
            "scales_same_bits": same_bits(dp.arrays["scales"].cpu(),
                                          cp.arrays["scales"]),
            "decoded_same_bits": same_bits(ddec.cpu(), cdec),
            "reference_same_bits": same_bits(dl_state[0].cpu(),
                                             dl_state_cpu[0]),
            "nbytes_static": dp.nbytes == dl_codec.nbytes_static(d_lora)})
        check(all(dl_checks[-1].values()),
              f"delta+int8 card vs CPU: {dl_checks[-1]}")
    emit(phase="codecs", d=d_lora, lowrank={
        "spec": lr_codec.name, "checks": lr_checks,
        "nbytes_static": lr_codec.nbytes_static(d_lora),
        "tolerance": "per client, max |card - CPU| of the decoded vector "
        "and of the residual <= max(1e-4, 2 F32_ERROR_K 2**-24 cond(P)) "
        f"max |flat + state|, F32_ERROR_K = {lowrank.F32_ERROR_K}"},
        delta={"spec": dl_codec.name, "checks": dl_checks, "seconds": dl_s,
               "tolerance": "bit-identical"})
    done("codecs")

    # --------------------------------------------------------------- 31. train
    with tempfile.TemporaryDirectory() as tmp:
        report = io.StringIO()
        with contextlib.redirect_stdout(report):
            tr_cli, train_s = wall(lambda: train_cli.main(
                ["--preset", "full", "--clients", "2", "--local-steps", "1",
                 "--rounds", "1", "--batch-size", "4", "--max-new", "8",
                 "--device", "cuda", "--out", tmp]))
        hist = json.loads(Path(tmp, "history.json").read_text())["history"]
        check(len(hist) == 1 and Path(tmp, "adapters.npz").exists(),
              "launch.train wrote its history and adapters")
        # the launcher's codecs are identity both ways
        check(hist[0]["comm_bytes"] == 2 * 2 * 4 * d_lora,
              f"launch.train comm_bytes {hist[0]['comm_bytes']}")
    # zamba2 at full width through the same CLI
    with tempfile.TemporaryDirectory() as tmp:
        z_report = io.StringIO()
        with contextlib.redirect_stdout(z_report):
            z_cli, z_train_s = wall(lambda: train_cli.main(
                ["--arch", "zamba2-1.2b", "--preset", "full", "--clients",
                 "2", "--local-steps", "1", "--rounds", "1", "--batch-size",
                 "4", "--max-new", "8", "--device", "cuda", "--out", tmp]))
        hist = json.loads(Path(tmp, "history.json").read_text())["history"]
        check(len(hist) == 1 and Path(tmp, "adapters.npz").exists()
              and hist[0]["comm_bytes"] == 2 * 2 * 4 * z_cli.d_trainable,
              f"launch.train on zamba2: {hist}")
    del tr_cli, z_cli
    emit(phase="train", seconds=train_s, report=report.getvalue(),
         zamba2={"seconds": z_train_s, "report": z_report.getvalue()})
    done("train")

    # --------------------------------------------------------------- 32. serve
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        out, serve_s = wall(lambda: serve.main(
            ["--preset", "full", "--batch", "4", "--prompt-len", "32",
             "--max-new", "8", "--device", "cuda"]))
    check(tuple(out.shape) == (4, 8), f"serve output shape {out.shape}")
    serve_runs = {"llama-3.2-1b full": {"seconds": serve_s,
                                        "report": report.getvalue()}}
    # zamba2 at full width (ragged S = 32 in the SSD kernel), and its smoke
    # preset (ds = 16)
    for preset in ("full", "smoke"):
        report = io.StringIO()
        with contextlib.redirect_stdout(report):
            out, sec = wall(lambda: serve.main(
                ["--arch", "zamba2-1.2b", "--preset", preset, "--batch", "4",
                 "--prompt-len", "32", "--max-new", "8", "--device",
                 "cuda"]))
        check(tuple(out.shape) == (4, 8), f"zamba2 {preset} serve output "
              f"shape {out.shape}")
        serve_runs[f"zamba2-1.2b {preset}"] = {"seconds": sec,
                                               "report": report.getvalue()}
    emit(phase="serve", runs=serve_runs)

    # the llama-3.2-1b dry-run started in the launch phase
    dryrun_log, _ = dryrun_proc.communicate(timeout=900)
    dryrun_s = time.perf_counter() - dryrun_t0
    dryrun_file = Path(dryrun_dir) / "dryrun.json"
    records = (json.loads(dryrun_file.read_text())
               if dryrun_file.exists() else [])
    # every pair recorded: long_500k skipped (llama is full attention),
    # the others ok, whatever the torch version
    statuses = {(r["shape"], r["mesh"]): r["status"] for r in records}
    want_statuses = {(shape, mesh): "skipped" if shape == "long_500k"
                     else "ok" for shape in INPUT_SHAPES
                     for mesh in ("16x16", "2x16x16")}
    errors = {(r["shape"], r["mesh"]): r.get("error", "")[:300]
              for r in records if r["status"] == "error"}
    check(statuses == want_statuses and dryrun_proc.returncode == 0,
          f"launch dry-run (torch {torch.__version__}): exit "
          f"{dryrun_proc.returncode}, {statuses}, errors {errors}; its "
          f"output ends {dryrun_log[-2000:]}")
    for r in records:
        r.pop("trace", None)
    emit(phase="launch_dryrun", seconds=dryrun_s, torch=torch.__version__,
         records=records)
    dryrun_file.unlink()
    os.rmdir(dryrun_dir)

    # launches: each kernel's in the run of the path it was ported for,
    # the wan round for the first seven, the extreme round for the top-k
    # passes (the mask is on no path: 0), the zamba2 rollout for the SSD
    rows = (rms_row, rms_bwd_row, flash_row, flash_bwd_row, gram_row,
            quant_row, dequant_row)
    for row in rows:
        row["launches"] = round_launches[row["name"]]
    for row in (count_row, mask_row):
        row["launches"] = extreme_launches[row["name"]]
    # the SSD kernel's: the zamba2 rollout's; its backward's: the zamba2
    # round's
    ssd_row["launches"] = z_launches["ssd"]
    ssd_bwd_row["launches"] = z_round_launches["ssd_bwd"]
    rows += (count_row, mask_row, ssd_row, ssd_bwd_row)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # the flash rows also carry head_dim 128 (mixtral's training shape) and
    # their launches in one round of the moe phase
    for row in (flash_row, flash_bwd_row):
        row["launches_moe_round"] = moe_launches[row["name"]]
    # the launches of one xlstm round (full-parameter) and of one whisper
    # and one vision client-step of the encdec phase
    for row in (rms_row, rms_bwd_row, gram_row, quant_row, dequant_row):
        row["launches_xlstm_round"] = xlstm_launches[row["name"]]
    for row in (rms_row, rms_bwd_row, flash_row, flash_bwd_row, gram_row):
        row["launches_whisper_step"] = encdec_launches["whisper"][row["name"]]
        row["launches_vision_step"] = encdec_launches["vision"][row["name"]]
        # the launch phase's: llama-3.2-1b's train, prefill and serve steps
        # and its two-pod round
        row["launches_launch"] = path_launches[row["name"]]
    # the flash forward at prefill_32k's shape (the launch phase)
    flash_row.update(launch_flash)
    extra = ("launches_moe_round", "max_abs_err_dh128", "ms_dh128",
             "plain_ms_dh128", "bound_ms_dh128", "bound_by_dh128",
             "library_ms_dh128", "launches_xlstm_round",
             "launches_whisper_step", "launches_vision_step",
             "launches_launch") + tuple(
        f"{key}_{tag}" for tag in ("whisper_enc", "vision_cross")
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")) + tuple(
        f"{key}_prefill_32k" for key in ("max_abs_err", "lse_err", "ms",
                                         "bound_ms", "bound_by",
                                         "library_ms")) + (
        "ms_xlstm", "ms_with_dg_xlstm", "plain_ms_with_dg_xlstm",
        "library_ms_with_dg_xlstm", "bound_ms_with_dg_xlstm",
        "bound_by_with_dg_xlstm")
    done("serve")
    emit(phase="seconds_by_phase", seconds=phase_s)
    print(json.dumps({"kernels": [{k: row[k] for k in keys + extra
                                   if k in keys or k in row}
                                  for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
