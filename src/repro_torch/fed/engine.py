"""The federated engine (counterpart of ``repro.fed.engine``).

``rollout_batch`` is what every local step runs before any gradient:
generation (prefill, then decode and sample), banded rewards, and the
frozen reference model's logprobs (``FederatedTrainer._make_batch`` and the
first lines of ``one_client`` in the reference's ``_make_round_fn``).
Everything here runs on every pattern: the dense pattern, the MoE and
sliding-window patterns (mixtral, moonshot), the zamba2 hybrid, whose
training differentiates the Mamba2 layers through the SSD backward
kernel, and xlstm, which has no adapters, so that FIRM trains (and the
uplink carries) every parameter, bf16 leaves and f32 gate weights alike.
``rollout_batch`` and ``client_local_steps`` also take a modality stub
``aux`` (whisper's frames, the VLM's vision tokens); the round does not,
as the reference's does not, so ``FederatedTrainer`` refuses those
families.
``client_local_steps`` runs K local steps of one client, each a rollout
then the algorithm's ``step`` (FIRM's by default): ``one_client`` and the
scan ``body`` of ``_make_round_fn`` for a single client.  Every mode of
the round below runs its steps through it.  On CUDA a client-local
algorithm's update is a captured program (``rlhf/update_graph``), as the
reference jits it; the trainer holds the graphs (``update_graphs``).

``FederatedTrainer`` runs the federated round, ``run_round``, for every
algorithm of the registry (``fed.algorithms``: ``firm``, ``firm_unreg``,
``linear``, ``fedcmoo``), on the path the plan (``fed.api``) resolves from
the algorithm's capabilities, never from its name.  Every round: the
broadcast through the downlink codec; the local phase, in one of the
reference's three modes:

* ``vec`` (the vectorized executor, one cohort): K ``step``s per
  participant, all from the decoded broadcast, or, for an algorithm with
  a server exchange between steps, its ``exchange_phase`` (fedcmoo: the M
  gradients of every participant through the gradient codec in one
  stacked roundtrip and one server lambda solve a step);
* ``cohort`` (heterogeneous ``client_local_steps``): the generation keys
  and prompt blocks drawn once in the canonical loop order (step-major,
  skipping clients whose K is used up), then each static-config cohort's
  ``vec`` phase on its slice of them, the rows put back in participant
  order and the scalar metrics merged weighted by n_g K_g;
* ``loop`` (the loop executor, ``EngineConfig.vectorized_clients=False``):
  the algorithm's ``loop_phase``, each client-step under the client's own
  config, the metrics reduced as the reference's loop reduces them (flat
  means over the client-steps, each client's last lambda); an algorithm
  with a server exchange runs its ``exchange_phase``, as in ``vec``;

then the stacked flat delta, ONE stacked uplink roundtrip (one quantize
and one dequantize launch over all clients for ``int8``/``int4``, with
error feedback; one batched 32-pass bisection for ``topk``), FedAvg, the
drift statistics, the comms ledger and the round summary, whose
``dispatches`` and ``cohorts`` are the reference's for the mode taken.
The clients run one after another in every mode: the kernels'
``autograd.Function``s have no vmap rule, and one client's update already
peaks at ~17 GB at full width.  The round's statistics reach the host in
one copy at its end (``_to_host``).

The fused executor (``run_rounds_fused``, the reference's round-level
``lax.scan``) runs R ``vec`` rounds as one chunk through the same round
body (``_round``), the participants worked out before the chunk starts,
and copies the R rounds' statistics to the host in one copy after the
last: on CUDA, where the rounds' generation and updates are captured
programs, the host queues a whole chunk without waiting on the device.
The reference's chunk runs its codecs through their traced contract
because a jitted scan cannot hold a ``Payload``; the port's rounds run
the host boundary, which is the same transform
(``Codec.encode_decode_traced*``) and whose payloads read nothing from
the device, so both executors count the payloads' bytes, which equal
``nbytes_static``.

Every summary goes out as typed records (``obs.records``) through the
trainer's pipeline (``obs``, with the sinks ``EngineConfig.metrics_sink``
names) from the one place summaries are made, ``_record``, after the
statistics' one copy to the host: emission reads nothing from the device,
for a round and a chunk alike.  ``host_transfers`` counts those copies.
The scheduler (``fed.sched``) drives the trainer through ``run_round``,
``run`` and the round's pieces.

The round's stages are programs of ``obs.jitwatch``, under the reference's
names: ``generate`` and ``ref_logprobs`` (the rollout), ``step[<kernel>]``
(the update), ``stack_trees``, ``delta_flat``, ``flat_aggregate`` and
``summary_device``.  The plan audit (``obs.audit``) counts their calls
under ``jitwatch.record()`` and holds them to the plan; the summary's
``dispatches`` stays the reference's count.  While
the NaN check is on (``obs.debug``) the update runs without graphs and
the fused executor refuses.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch import trees
from repro_torch.comms import codec as codec_lib
from repro_torch.comms import make_codec
from repro_torch.configs.base import FIRMConfig, ModelConfig
from repro_torch.core import comms, drift, fedavg
from repro_torch.data.partition import make_client_datasets
from repro_torch.data.prompts import PromptDataset
from repro_torch.fed import algorithms as algorithms_lib
from repro_torch.fed import api as api_lib
from repro_torch.fed.api import EngineConfig  # noqa: F401  (its home is api)
from repro_torch.models import transformer
from repro_torch.models.common import merge_trainable, split_trainable
from repro_torch.obs import debug, jitwatch
from repro_torch.obs.metrics import MetricsPipeline
from repro_torch.obs.records import round_summary
from repro_torch.rlhf import local as local_lib
from repro_torch.rlhf import ppo, rewards as rewards_lib
from repro_torch.rlhf import update_graph
from repro_torch.rlhf.sampling import generate


def _ref_logprobs(cfg: ModelConfig, ref_params, tokens: torch.Tensor,
                  aux=None):
    """The frozen reference's logprobs of ``tokens``."""
    ref_out = transformer.forward_seq(cfg, ref_params, tokens, aux)
    return ppo.token_logprobs(ref_out["logits"], tokens)


_ref_logprobs = jitwatch.wrap("ref_logprobs", _ref_logprobs)


@torch.no_grad()
def rollout_batch(cfg: ModelConfig, params, ref_params, prompts: torch.Tensor,
                  band_h, band_x, *, n_objectives: int, max_new: int,
                  length_tol: int,
                  generator: Optional[torch.Generator] = None,
                  gumbel: Optional[torch.Tensor] = None,
                  aux=None) -> ppo.PPOBatch:
    """(B, P) prompts -> ``PPOBatch`` of (B, P + max_new) rows.

    ``params`` is the client's policy (adapters merged), ``ref_params`` the
    frozen reference.  ``band_h``/``band_x`` are the (lo, hi) helpful and
    harmful bands of ``rewards.variant_bands``.  The sampling noise comes
    from ``generator`` or is injected as ``gumbel`` (max_new, B, V).
    ``aux`` is the modality stub, read by generation and the reference's
    forward alike.
    """
    tokens, old_lp, mask = generate(cfg, params, prompts, max_new=max_new,
                                    generator=generator, gumbel=gumbel,
                                    aux=aux)
    r = rewards_lib.score_batch_banded(band_h, band_x, tokens, mask,
                                       n_objectives, length_tol)
    ref_lp = _ref_logprobs(cfg, ref_params, tokens, aux)
    return ppo.PPOBatch(tokens, mask, old_lp, ref_lp, r)


def client_local_steps(cfg: ModelConfig, fc: FIRMConfig,
                       state: local_lib.ClientState, frozen, ref_params,
                       band_h, band_x, *, k_steps: int, max_new: int,
                       length_tol: int,
                       dataset: Optional[PromptDataset] = None,
                       prompts: Optional[torch.Tensor] = None,
                       generators: Optional[Sequence[torch.Generator]] = None,
                       gumbel: Optional[torch.Tensor] = None,
                       preference: Optional[torch.Tensor] = None,
                       algorithm: Optional[algorithms_lib.Algorithm] = None,
                       extra=None,
                       graphs: Optional[update_graph.UpdateGraphs] = None,
                       aux=None):
    """K local steps of one client.  Returns (final state, metrics).

    Each step merges the client's adapters into ``frozen``, rolls out
    ``fc.batch_size`` prompts and runs ``algorithm.step`` (FIRM's
    ``firm_local_step`` by default, the program ``step[<kernel>]``) with
    ``extra``, the algorithm's ``traced_extra``.  On CUDA the update runs
    through ``graphs`` (the trainer's captured updates; without them, a
    set of this call's own), on the CPU and while the NaN check is on
    (``obs.debug``) eagerly.  Prompts come
    from ``dataset`` or are injected as ``prompts`` (K, B, P); step k's
    sampling noise comes from ``generators[k]`` (the reference's one key a
    step) or is injected as ``gumbel`` (K, max_new, B, V).
    ``preference`` is the client's (M,) preference, overriding
    ``fc.preference``.  ``aux`` is the modality stub of a config with
    cross blocks, read by every rollout and update (an operand of the
    captured update).  The metrics are the reference's per-step keep:
    ``lam`` (K, M), ``rewards`` (K, M) and ``kl`` (K,).
    """
    if (dataset is None) == (prompts is None):
        raise ValueError("pass exactly one of dataset= and prompts=")
    algorithm = algorithm or algorithms_lib.FIRMAlgorithm()
    if debug.nans_enabled():
        graphs = None       # the NaN check reads tensors back: no capture
    elif graphs is None and state.lam.is_cuda:
        graphs = update_graph.UpdateGraphs()
    step = jitwatch.wrap(f"step[{algorithm.kernel}]", algorithm.step,
                         captures=None if graphs is None
                         else lambda: graphs.captures)
    kept = {"lam": [], "rewards": [], "kl": []}
    for k in range(k_steps):
        params = merge_trainable(state.trainable, frozen)
        p = (dataset.next_batch(fc.batch_size) if prompts is None
             else prompts[k])
        batch = rollout_batch(
            cfg, params, ref_params, p, band_h, band_x,
            n_objectives=fc.n_objectives, max_new=max_new,
            length_tol=length_tol,
            generator=None if generators is None else generators[k],
            gumbel=None if gumbel is None else gumbel[k], aux=aux)
        state, metrics = step(cfg, fc, state, frozen, batch, preference,
                              extra, graphs, aux=aux)
        for key, vals in kept.items():
            vals.append(metrics[key])
    return state, {key: torch.stack(vals) for key, vals in kept.items()}


class LocalPhaseResult(NamedTuple):
    """What the local phase hands back to the round."""
    lams: torch.Tensor               # (P, M) final per-client lambda
    rewards_mean: torch.Tensor       # (M,) mean over all client-steps
    kl_mean: torch.Tensor            # scalar
    stacked_trainable: object        # tree with a leading (P,) client axis
    rewards_pc: torch.Tensor         # (P, M) per-client mean over steps


# the round's statistics, in the order they are packed on the device
STATS = ("rewards", "lam_mean", "lam_disagreement", "param_drift", "kl",
         "per_client_lam", "rewards_per_client")


def _delta_flat(stacked, anchor) -> torch.Tensor:
    """All P client deltas against the anchor -> (P, d) f32 rows in
    sorted-key leaf order.

    The difference of two bf16 leaves is taken in f32: the reference
    writes ``(a - b).astype(f32)``, but its jitted round (XLA keeps the
    excess precision of the bf16 subtraction it widens) computes the f32
    difference, which is what it sends."""
    return torch.cat([(a.float() - b.float()).reshape(a.shape[0], -1)
                      for a, b in zip(trees.tree_leaves(stacked),
                                      trees.tree_leaves(anchor))], dim=1)


def _flat_aggregate(anchor, flats, staleness, staleness_pow: float, spec):
    """Staleness-weighted FedAvg of the (P, d) decoded deltas, applied to
    the anchor tree (uniform at zero staleness)."""
    w = fedavg.staleness_weights(
        torch.as_tensor(staleness, dtype=torch.float32,
                        device=flats.device), staleness_pow)
    agg = codec_lib.flat_to_tree(fedavg.fedavg_flat_weighted(flats, w), spec)
    return trees.tree_map(lambda b, d: b + d, anchor, agg)


def _summary_device(res: "LocalPhaseResult") -> torch.Tensor:
    """The round's statistics (``STATS``), packed on the device into one
    f32 vector: the summary's values, bit for bit."""
    stats = (res.rewards_mean, res.lams.mean(0),
             drift.lambda_disagreement(res.lams)["pairwise_mean"],
             drift.param_drift_stacked(res.stacked_trainable),
             res.kl_mean, res.lams, res.rewards_pc)
    for name, t in zip(STATS, stats):
        if t.dtype != torch.float32:
            raise TypeError(f"round statistic {name} is {t.dtype}, "
                            "not float32")
    return torch.cat([t.detach().reshape(-1) for t in stats])


# the round's programs after the local phase (obs.jitwatch)
_stack_trees = jitwatch.wrap("stack_trees", fedavg.stack_trees)
_delta_flat = jitwatch.wrap("delta_flat", _delta_flat)
_flat_aggregate = jitwatch.wrap("flat_aggregate", _flat_aggregate)
_summary_device = jitwatch.wrap("summary_device", _summary_device)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host in one device-to-host copy.  On CUDA: a
    non-blocking copy into pinned memory, then a wait on an event recorded
    after it, the one point where the host waits for the device."""
    if t.device.type != "cuda":
        return t.detach().numpy().copy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    copied = torch.cuda.Event()
    copied.record()
    copied.synchronize()
    return host.numpy().copy()


class FederatedTrainer:
    """Server and C clients of a federated algorithm of the registry (FIRM,
    paper Alg. 1, by default), one round at a time.

    Runs on ``device`` (``cuda`` unless the caller passes ``"cpu"``).
    ``params`` is an optional initial model tree (e.g. a JAX model carried
    over by ``bridge.to_torch``); without it the weights are drawn from
    ``ec.seed``.  A config whose forward reads a modality stub (a VLM's
    vision tokens, an encoder-decoder's frames) is refused: the round
    passes none, as the reference's does not (its first rollout raises
    ``KeyError``).  Without adapters (xlstm) every parameter is
    trainable, and the frozen reference is a copy of the initial
    parameters (``ref_params``), so that nothing the round writes can
    move it.  ``plan`` is the ``fed.api.ExecutionPlan`` the trainer
    runs (``ExecutionPlan.build`` passes it); without it the trainer plans
    its own spec, and keeps the plan as ``self.plan`` either way.

    Randomness comes from one main stream, read at the reference's key
    points in its order: one draw for the downlink, then the local phase's
    (for a client-local algorithm one generation draw a client-step,
    step-major over the participants, skipping clients whose K is used up;
    for fedcmoo, per step, one generation and M gradient-codec draws a
    participant and one lambda draw), then P uplink draws; each draw seeds
    a generator on the device.  Participants come from a stream keyed on
    (seed, round) alone.  ``run_round`` also takes each draw injected, so
    that a test can hand the port JAX's.

    Participants.  With ``participation < 1`` each round draws
    ``round(participation * C)`` clients from that stream.  Like every
    other draw of the port it is not the reference's (``jax.random.choice``
    on its named participation stream): the same seed picks other clients.
    Parity comes from injecting the reference's draw, as for the prompts,
    the Gumbel noise and the codecs' bits: ``run_round(participants=...)``
    takes one round's sorted client indices, and ``run(R, participants=)``
    a schedule of R such lists, one a round, which it hands to
    ``run_round`` (or ``run_rounds_fused``); without a schedule each round
    draws its own.
    """

    def __init__(self, cfg: ModelConfig, fc: FIRMConfig,
                 ec: Optional[EngineConfig] = None, *, params=None,
                 device=None, plan: Optional[api_lib.ExecutionPlan] = None):
        ec = EngineConfig() if ec is None else ec
        stub = transformer.stub_key(cfg)
        if stub is not None:
            raise ValueError(
                f"{cfg.name}'s forward reads the modality stub "
                f"aux['{stub}'], which the federated round does not pass "
                "(the reference's round fails at its first rollout with "
                f"KeyError: '{stub}'); run its generation and local steps "
                "with aux= (rollout_batch, client_local_steps)")
        # the algorithm owns the local step and the capabilities every
        # path decision reads; (fc, ec) is checked before any work
        self.algorithm = algorithms_lib.get_algorithm(ec.algorithm)
        self.algorithm.validate(fc, ec)
        self.cfg, self.fc, self.ec = cfg, fc, ec
        self.device = device_lib.resolve(device)
        gen = torch.Generator(device=self.device).manual_seed(ec.seed)
        self.params = (params if params is not None else
                       transformer.init_params(cfg, generator=gen,
                                               device=self.device))
        trainable, frozen = split_trainable(self.params)
        self.frozen = frozen
        # the frozen reference; where every parameter is trainable (no
        # adapters: nothing is frozen) it is a copy of its own
        self.ref_params = (self.params if trees.tree_leaves(frozen)
                           else trees.tree_map(torch.clone, self.params))
        self.global_trainable = trainable
        self.client_states = [
            local_lib.init_client_state(trainable, fc.n_objectives,
                                        cfg.d_model, fc.kl_coef_init,
                                        device=self.device)
            for _ in range(fc.n_clients)]
        self.datasets = make_client_datasets(
            fc.n_clients, cfg.vocab, ec.prompt_len,
            alpha=ec.dirichlet_alpha, generator=gen, device=self.device)
        # shared TreeSpec of the per-client delta (the uplink's flat rows)
        _, self._delta_spec = codec_lib.tree_to_flat(trainable)
        self._length_tol = max(4, ec.max_new // 2)
        self._bands = [rewards_lib.variant_bands(
            cfg.vocab, "alt" if ec.heterogeneous_rms
            and c >= fc.n_clients // 2 else "default")
            for c in range(fc.n_clients)]
        self.ledger = comms.CommsLedger()
        self.uplink_codec = make_codec(ec.uplink_codec)
        self.downlink_codec = make_codec(ec.downlink_codec)
        self._uplink_state = [None] * fc.n_clients
        self._downlink_state = None
        self.d_trainable = trees.tree_size(trainable)
        # the captured local updates, freed with the trainer
        self.update_graphs = (update_graph.UpdateGraphs()
                              if self.device.type == "cuda" else None)
        self.history: List[dict] = []
        # the statistics' copies to the host: one a round, one a chunk
        self.host_transfers = 0
        # every summary fans out as records through this pipeline (an
        # in-memory sink always, and those ec.metrics_sink names)
        self.obs = MetricsPipeline.from_spec(ec.metrics_sink)
        self._rng = torch.Generator().manual_seed(ec.seed + 1)
        self._round_idx = 0
        # per-client configs, expanded through the algorithm
        # (resolve_config, per-client preferences and local steps)
        self._client_fcs = algorithms_lib.client_configs(self.algorithm, fc)
        self._stacked_pref = (
            torch.tensor(fc.client_preferences, dtype=torch.float32,
                         device=self.device)
            if fc.client_preferences is not None else None)
        # the declarative mirror of this trainer's path decisions, built
        # through the capability resolution the methods below use
        self.plan = plan if plan is not None else api_lib.plan(
            api_lib.RunSpec(model=cfg, firm=fc, engine=ec),
            d_trainable=self.d_trainable)

    # ------------------------------------------------------------------
    def _next_key(self) -> torch.Generator:
        """A generator on the device seeded by the main stream's next
        draw: the counterpart of splitting the reference's PRNG key."""
        seed = int(torch.randint(0, 2 ** 63 - 1, (), generator=self._rng))
        return torch.Generator(device=self.device).manual_seed(seed)

    def _sample_participants(self, n: Optional[int] = None,
                             round_idx: Optional[int] = None) -> List[int]:
        """This round's participants, from a stream keyed on (seed, round)
        only: the same draw whatever else consumed the main stream.  ``n``
        overrides the participation's count (the deadline policy
        over-selects); the first clients of one permutation, so a larger
        ``n`` keeps the smaller draw's clients."""
        fc = self.fc
        if n is None:
            n = max(1, int(round(fc.participation * fc.n_clients)))
        if n >= fc.n_clients:
            return list(range(fc.n_clients))
        r = self._round_idx if round_idx is None else round_idx
        g = torch.Generator().manual_seed(
            hash((self.ec.seed + 1, 0x5ced, r)) % 2 ** 63)
        return sorted(int(i) for i in torch.randperm(fc.n_clients,
                                                     generator=g)[:n])

    def _local_phase_mode(self, participants: List[int]):
        """The round's local-phase path, ("vec" | "cohort" | "loop", cohort
        plan or None): capability resolution alone, shared with the
        planner (``api.resolve_local_mode``)."""
        mode, plan, _ = api_lib.resolve_local_mode(
            self.algorithm, self._client_fcs, participants,
            vectorized_clients=self.ec.vectorized_clients,
            lift_preference=self._stacked_pref is not None)
        return mode, plan

    def _fused_mode(self):
        """(eligible, the cohort's config) for the fused executor:
        ``api.resolve_fused`` over the whole population's local mode."""
        mode, plan = self._local_phase_mode(list(range(self.fc.n_clients)))
        ok, _ = api_lib.resolve_fused(self.algorithm, mode,
                                      self.uplink_codec, self.downlink_codec)
        return (True, plan[0].cfc) if ok else (False, None)

    # ------------------------------------------------------------------
    def _broadcast(self, bits=None):
        """theta_t through the downlink codec: (payload, decoded tree)."""
        payload, self._downlink_state, broadcast = \
            self.downlink_codec.roundtrip(self.global_trainable,
                                          self._downlink_state,
                                          key=self._next_key(), bits=bits)
        return payload, broadcast

    def _make_batch(self, c: int, trainable, prompts: torch.Tensor, *,
                    generator=None, gumbel=None) -> ppo.PPOBatch:
        """Client ``c``'s rollout of ``prompts`` (B, P) under its adapters
        ``trainable`` and its reward bands: the reference's ``_make_batch``
        on the given adapters and prompts."""
        return rollout_batch(
            self.cfg, merge_trainable(trainable, self.frozen),
            self.ref_params, prompts, *self._bands[c],
            n_objectives=self.fc.n_objectives, max_new=self.ec.max_new,
            length_tol=self._length_tol, generator=generator, gumbel=gumbel)

    def _local_phase(self, participants: List[int], broadcast, prompts=None,
                     gumbel=None, grad_bits=None, sketch_noise=None, *,
                     cfc: FIRMConfig, drawn=None) -> LocalPhaseResult:
        """One cohort's local phase (the ``vec`` mode): K local steps of
        every participant, all from the broadcast.

        The participants share ``cfc``, the cohort's config (its
        per-client preference lifted out).  An algorithm that exchanges
        nothing with the server between steps
        (``caps.traced_server_exchange``) runs each client's K steps
        alone: client c's step k takes the k-th prompt block and the
        generation draw [k][c], and the per-step metrics are kept as (K,
        P, ...) and reduced one axis at a time, as the reference's are.
        Any other hands the phase to ``algorithm.exchange_phase``.
        ``drawn`` is the (prompt blocks (K, P, B, prompt_len), generation
        keys [K][P]) pair the cohort mode drew for this cohort; without it
        both are drawn here.
        """
        has_pref = self._stacked_pref is not None
        k_steps = cfc.local_steps
        # every participant adopts the decoded broadcast (the adapters are
        # never updated in place, so the anchor survives for the delta)
        states = [self.client_states[c]._replace(trainable=broadcast)
                  for c in participants]
        if not self.algorithm.caps.traced_server_exchange:
            prompts = self._prompt_blocks(participants, k_steps, prompts)
            lams, rewards_mean, kl_mean, rewards_pc, states = \
                self.algorithm.exchange_phase(
                    self, cfc, participants, states, prompts, gumbel=gumbel,
                    grad_bits=grad_bits, sketch_noise=sketch_noise)
        else:
            if drawn is None:
                gen_keys = [[self._next_key() for _ in participants]
                            for _ in range(k_steps)]
                prompts = self._prompt_blocks(participants, k_steps, prompts)
            else:
                prompts, gen_keys = drawn
            extra = self.algorithm.traced_extra(cfc, self.ec,
                                                device=self.device)
            kept = []
            for ci, c in enumerate(participants):
                states[ci], m = client_local_steps(
                    self.cfg, cfc, states[ci], self.frozen, self.ref_params,
                    *self._bands[c], k_steps=k_steps,
                    max_new=self.ec.max_new, length_tol=self._length_tol,
                    prompts=prompts[:, ci],
                    generators=(None if gumbel is not None else
                                [gen_keys[k][ci] for k in range(k_steps)]),
                    gumbel=None if gumbel is None else gumbel[:, ci],
                    preference=self._stacked_pref[c] if has_pref else None,
                    algorithm=self.algorithm, extra=extra,
                    graphs=self.update_graphs)
                kept.append(m)
            ms = {key: torch.stack([m[key] for m in kept], dim=1)
                  for key in ("lam", "rewards", "kl")}        # (K, P, ...)
            lams, rewards_pc = ms["lam"][-1], ms["rewards"].mean(0)
            rewards_mean = rewards_pc.mean(0)
            kl_mean = ms["kl"].mean(0).mean(0)
        for ci, c in enumerate(participants):
            self.client_states[c] = states[ci]
        return LocalPhaseResult(
            lams, rewards_mean, kl_mean,
            _stack_trees([s.trainable for s in states]), rewards_pc)

    def _local_phase_cohorts(self, plan, participants: List[int], broadcast,
                             prompts=None, gumbel=None) -> LocalPhaseResult:
        """The ``cohort`` mode: one ``_local_phase`` a static-config cohort.

        The generation keys and prompt blocks are drawn once, in the
        canonical loop order (step-major over all participants, skipping
        clients whose K is used up), before any cohort runs, and each
        cohort gets its slice; so a multi-cohort round reads every stream
        as the loop executor does.  The rows go back in participant order,
        and the scalar metrics merge weighted by each cohort's client-step
        count n_g K_g.  Injected ``prompts`` and ``gumbel`` are padded to
        the largest K: entry [k, i] is read iff k < K of participant i.
        """
        pos = {c: i for i, c in enumerate(participants)}
        keys, blocks = {}, {}
        for k, ci, c in algorithms_lib._step_major(self, participants):
            keys[c, k] = self._next_key()
            blocks[c, k] = self._step_prompts(c, ci, k, prompts)
        lams = [None] * len(participants)
        rewards_pc = [None] * len(participants)
        rew_acc, kl_acc, w_tot = 0.0, 0.0, 0
        for co in plan:
            members, ks = list(co.members), range(co.cfc.local_steps)
            idx = [pos[c] for c in members]
            res = self._local_phase(
                members, broadcast, cfc=co.cfc,
                gumbel=None if gumbel is None else gumbel[:len(ks)][:, idx],
                drawn=(torch.stack([torch.stack([blocks[c, k]
                                                 for c in members])
                                    for k in ks]),
                       [[keys[c, k] for c in members] for k in ks]))
            for i, p in enumerate(idx):
                lams[p], rewards_pc[p] = res.lams[i], res.rewards_pc[i]
            w = len(members) * len(ks)
            rew_acc = rew_acc + w * res.rewards_mean
            kl_acc = kl_acc + w * res.kl_mean
            w_tot += w
        return LocalPhaseResult(
            torch.stack(lams), rew_acc / w_tot, kl_acc / w_tot,
            _stack_trees([self.client_states[c].trainable
                          for c in participants]),
            torch.stack(rewards_pc))

    def _local_phase_loop(self, participants: List[int], broadcast,
                          prompts=None, gumbel=None, grad_bits=None,
                          sketch_noise=None) -> LocalPhaseResult:
        """The ``loop`` mode (the loop executor): the algorithm's
        ``loop_phase`` from the broadcast, its metrics reduced as the
        reference's loop reduces them: each participant's lambda from its
        last client-step, ``rewards`` and ``kl`` flat means over all the
        client-steps at once, the per-client rewards a mean over each
        client's own steps.  Injected draws as in ``_local_phase_cohorts``
        (padded to the largest K).

        An algorithm with a server exchange between steps runs its
        ``exchange_phase``, as in the ``vec`` mode: its K steps are lock
        step and homogeneous, and its reductions are already the loop's
        (flat over the client-steps, one global lambda a row).  Sending
        each gradient through the codec on its own, as the reference's
        loop does, gives the same rows, draws and bytes."""
        if not self.algorithm.caps.traced_server_exchange:
            return self._local_phase(
                participants, broadcast, prompts, gumbel, grad_bits,
                sketch_noise, cfc=self.algorithm.resolve_config(self.fc))
        states = [self.client_states[c]._replace(trainable=broadcast)
                  for c in participants]
        entries = self.algorithm.loop_phase(self, participants, states,
                                            prompts=prompts, gumbel=gumbel)
        for ci, c in enumerate(participants):
            self.client_states[c] = states[ci]
        last_lam = {m["client"]: m["lam"] for m in entries}
        rewards_pc = torch.stack([
            torch.stack([m["rewards"] for m in entries
                         if m["client"] == c]).mean(0) for c in participants])
        return LocalPhaseResult(
            torch.stack([last_lam[c] for c in participants]),
            torch.stack([m["rewards"] for m in entries]).mean(0),
            torch.stack([m["kl"] for m in entries]).mean(),
            _stack_trees([s.trainable for s in states]), rewards_pc)

    def _step_prompts(self, c: int, ci: int, k: int, prompts=None):
        """Client ``c``'s (B, prompt_len) prompt block of step ``k``: drawn
        from its stream, or entry [k, ci] of the injected ``prompts``, in
        which case the stream's count still advances."""
        ds = self.datasets[c]
        if prompts is None:
            return ds.next_batch(self.fc.batch_size)
        ds.count += 1
        return prompts[k, ci]

    def _loop_step(self, c: int, ci: int, k: int, state, prompts=None,
                   gumbel=None):
        """One client-step of the loop executor: client ``c`` (participant
        ``ci``) at step ``k``, under its own config, through
        ``client_local_steps`` with one step.  Reads one generation draw;
        returns (new state, the step's lam, rewards and kl)."""
        cfc = self._client_fcs[c]
        gen = self._next_key()
        state, m = client_local_steps(
            self.cfg, cfc, state, self.frozen, self.ref_params,
            *self._bands[c], k_steps=1, max_new=self.ec.max_new,
            length_tol=self._length_tol,
            prompts=self._step_prompts(c, ci, k, prompts)[None],
            generators=None if gumbel is not None else [gen],
            gumbel=None if gumbel is None else gumbel[k, ci][None],
            algorithm=self.algorithm,
            extra=self.algorithm.traced_extra(cfc, self.ec,
                                              device=self.device),
            graphs=self.update_graphs)
        return state, {key: v[0] for key, v in m.items()}

    def _prompt_blocks(self, participants: List[int], k_steps: int,
                       prompts=None) -> torch.Tensor:
        """The (K, P, B, prompt_len) prompt blocks of the local phase, step
        by step (``_step_prompts``): drawn from each participant's stream,
        or injected as ``prompts``, in which case the streams' counts
        still advance by K."""
        return torch.stack([
            torch.stack([self._step_prompts(c, ci, k, prompts)
                         for ci, c in enumerate(participants)])
            for k in range(k_steps)])

    def _delta_flat(self, stacked, anchor) -> torch.Tensor:
        """All P client deltas against the anchor -> (P, d) f32 rows in
        sorted-key leaf order (``delta_flat``)."""
        return _delta_flat(stacked, anchor)

    def _uplink(self, participants: List[int], flat_deltas, bits=None):
        """Every participant's delta through the uplink codec in one
        stacked roundtrip: (payloads, decoded (P, d))."""
        up_keys = [self._next_key() for _ in participants]
        payloads, new_states, decoded = self.uplink_codec.roundtrip_stacked(
            flat_deltas, self._delta_spec,
            [self._uplink_state[c] for c in participants], keys=up_keys,
            bits=bits)
        for ci, c in enumerate(participants):
            self._uplink_state[c] = new_states[ci]
            self.ledger.send_up(payloads[ci])
        return payloads, decoded

    def _aggregate_flat(self, anchor, flats, staleness,
                        staleness_pow: float = 0.5):
        """(anchor tree, (P, d) decoded deltas, (P,) staleness) -> new
        params: staleness-weighted FedAvg (uniform at zero staleness;
        ``flat_aggregate``)."""
        return _flat_aggregate(anchor, flats, staleness, staleness_pow,
                               self._delta_spec)

    def _round_stats(self, res: LocalPhaseResult) -> torch.Tensor:
        """The round's statistics packed on the device
        (``summary_device``)."""
        return _summary_device(res)

    def _unpack_stats(self, row: np.ndarray, n_part: int) -> dict:
        """A host row of ``_round_stats`` back into the statistics."""
        m = self.fc.n_objectives
        shapes = ((m,), (m,), (), (), (), (n_part, m), (n_part, m))
        out, off = {}, 0
        for name, shape in zip(STATS, shapes):
            n = int(np.prod(shape))
            out[name] = row[off:off + n].reshape(shape)
            off += n
        return out

    def _round_dispatches(self, mode: str, plan,
                          participants: List[int]) -> int:
        """The reference engine's jitted dispatches in a round of this mode,
        which its summary reports and its readers compare across
        executors: the planner's count (``api._dispatch_estimate``) on
        this round's participants.  The port runs the same stages eagerly;
        the count measures no work of the port."""
        return int(round(api_lib._dispatch_estimate(
            self.algorithm, "loop" if mode == "loop" else "vectorized",
            mode, plan, [self._client_fcs[c] for c in participants],
            len(participants), 1)))

    def _round(self, participants: List[int], *, prompts=None, gumbel=None,
               up_bits=None, down_bits=None, grad_bits=None,
               sketch_noise=None):
        """The body of a round, for both executors: the broadcast, the
        local phase, the stacked delta through the uplink, FedAvg and the
        ledger.  It leaves the statistics on the device: it returns them
        packed (``_round_stats``) beside the summary's other fields, which
        ``_record`` turns into the summary.  The injected draws are
        ``run_round``'s."""
        dl_payload, broadcast = self._broadcast(down_bits)
        for _ in participants:
            self.ledger.send_down(dl_payload)
        mode, plan = self._local_phase_mode(participants)
        if mode == "vec":
            res = self._local_phase(participants, broadcast, prompts, gumbel,
                                    grad_bits, sketch_noise,
                                    cfc=plan[0].cfc)
        elif mode == "cohort":
            res = self._local_phase_cohorts(plan, participants, broadcast,
                                            prompts, gumbel)
        else:
            res = self._local_phase_loop(participants, broadcast, prompts,
                                         gumbel, grad_bits, sketch_noise)
        flat_deltas = self._delta_flat(res.stacked_trainable, broadcast)
        payloads, decoded = self._uplink(participants, flat_deltas, up_bits)
        self.global_trainable = self._aggregate_flat(
            broadcast, decoded, torch.zeros(len(participants),
                                            dtype=torch.float32,
                                            device=decoded.device))
        self.ledger.next_round()
        self._round_idx += 1
        return self._round_stats(res), dict(
            comm_bytes=self.ledger.total,
            up_bytes=self.ledger.up_bytes,
            down_bytes=self.ledger.down_bytes,
            participants=participants,
            dispatches=self._round_dispatches(mode, plan, participants),
            up_nbytes=[int(p.nbytes) for p in payloads],
            down_nbytes=comms.measured_bytes(dl_payload),
            local_steps=[self._client_fcs[c].local_steps
                         for c in participants],
            cohorts=len(plan) if plan is not None else 0)

    def _record(self, rounds, **fields) -> List[dict]:
        """The summaries of ``rounds``, ``_round``'s (statistics, fields)
        pairs of the last ``len(rounds)`` rounds, appended to the history
        and emitted through ``obs``: the statistics of all of them come to
        the host in one copy.  ``fields`` override the rounds'."""
        host = _to_host(torch.cat([row for row, _ in rounds]))
        self.host_transfers += 1
        round0 = self._round_idx - len(rounds)
        out, off = [], 0
        for row, own in rounds:
            stats = self._unpack_stats(host[off:off + row.numel()],
                                       len(own["participants"]))
            off += row.numel()
            out.append(round_summary(stats=stats, **{**own, **fields}))
        self.history += out
        for r, summary in enumerate(out):
            self.obs.emit_round(summary, round=round0 + r)
        return out

    def run_round(self, participants: Optional[List[int]] = None, *,
                  prompts=None, gumbel=None, up_bits=None,
                  down_bits=None, grad_bits=None,
                  sketch_noise=None) -> dict:
        """One federated round; returns its summary.

        Injected draws, each replacing the stream's: ``prompts`` (K, P, B,
        prompt_len), ``gumbel`` (K, P, max_new, B, V), and the codecs'
        draws, ``up_bits`` (P, ...) and ``down_bits``: for a quantize codec
        the (rows, 1024) int32 rounding-bit patterns, for a low-rank codec
        omega (b, rank) f32; top-k reads none.  For fedcmoo also the
        gradient uplink's draws, ``grad_bits`` (K, P * M, ...) in the rows'
        client-major order, and the sketch's normal draws,
        ``sketch_noise`` (K, d, q).  With heterogeneous
        ``client_local_steps``, K is the largest and ``prompts`` and
        ``gumbel`` are padded to it: entry [k, i] is read iff k is below
        participant i's K, so the entries read are those of the step-major
        order.  The main stream is read all the same (P uplink draws
        whatever the codec), so later rounds' draws stay where the
        reference's are.
        """
        if participants is None:
            participants = self._sample_participants()
        return self._record([self._round(
            participants, prompts=prompts, gumbel=gumbel, up_bits=up_bits,
            down_bits=down_bits, grad_bits=grad_bits,
            sketch_noise=sketch_noise)])[0]

    def run_rounds_fused(self, rounds: int, *,
                         participants: Optional[Sequence[Sequence[int]]]
                         = None, draws: Optional[Sequence[dict]] = None
                         ) -> List[dict]:
        """``rounds`` rounds as one chunk, with one copy to the host at its
        end; returns their summaries.

        Each round is ``run_round``'s body (``_round``) on the ``vec``
        path, so the chunk is the per-round rounds bit for bit; only the
        statistics' copy to the host waits for the chunk's end.  The
        summaries are ``run_round``'s but for ``dispatches``, the
        reference's count for a fused chunk amortised over its rounds
        (3 / R), and ``fused``, R.  ``participants`` is a schedule of one
        sorted list a round (default: ``_sample_participants`` of each
        round, worked out before the chunk starts); ``draws`` one dict a
        round of ``run_round``'s injected draws (``prompts``, ``gumbel``,
        ``up_bits``, ``down_bits``).  If a round raises, the rounds before
        it are recorded as if the chunk had ended there, so the trainer is
        where those rounds through ``run_round`` would leave it.  An
        algorithm, executor or cohort structure the fused executor cannot
        run raises ``ValueError``, and so does a chunk while the NaN check
        is on (``obs.debug``): its checks would read the chunk back.
        """
        if debug.nans_enabled():
            raise ValueError(
                "the fused executor reads nothing back before a chunk "
                "ends, and the NaN check (obs.debug.set_debug_nan) reads "
                "every operation's output: run the rounds with run_round")
        ok, cfc = self._fused_mode()
        if not ok:
            raise ValueError(
                "fused_rounds requires a fusable algorithm (traced server "
                "exchange, vmap-safe local step), one full-population "
                "static-config cohort, and codecs supporting the traced "
                "contract; use run()/run_round() instead")
        for name, given in (("participant schedule", participants),
                            ("draws", draws)):
            if given is not None and len(given) != rounds:
                raise ValueError(f"a fused chunk's {name} needs one entry a "
                                 f"round: {len(given)} for {rounds} rounds")
        round0 = self._round_idx
        schedule = [self._sample_participants(round_idx=round0 + r)
                    if participants is None else list(participants[r])
                    for r in range(rounds)]
        chunk = dict(fused=rounds, dispatches=api_lib._dispatch_estimate(
            self.algorithm, "fused", "vec", None, [cfc], self.fc.n_clients,
            rounds))
        done = []
        try:
            for parts, drawn in zip(schedule, draws or [{}] * rounds):
                done.append(self._round(parts, **drawn))
        except BaseException:
            if done:
                self._record(done, **chunk)
            raise
        return self._record(done, **chunk)

    def run(self, rounds: Optional[int] = None,
            participants: Optional[Sequence[Sequence[int]]] = None
            ) -> List[dict]:
        """``rounds`` rounds (default ``fc.rounds``); returns the history.

        ``participants``, if given, is a schedule of one list of client
        indices a round, each handed to ``run_round`` (or its chunk's to
        ``run_rounds_fused``); without it every round draws its own.  With
        ``fused_rounds`` R > 1 and a trainer the fused executor can run,
        the horizon runs as chunks of R rounds, the last one shorter, a
        last chunk of one round through ``run_round``, as the reference's
        ``run`` does; otherwise round by round.
        """
        rounds = rounds or self.fc.rounds
        if participants is not None and len(participants) != rounds:
            raise ValueError(f"a participant schedule needs one entry a "
                             f"round: {len(participants)} for {rounds} "
                             "rounds")
        chunk = (max(1, int(self.ec.fused_rounds)) if self._fused_mode()[0]
                 else 1)
        r = 0
        while r < rounds:
            n = min(chunk, rounds - r)
            sched = (None if participants is None
                     else [list(p) for p in participants[r:r + n]])
            if n == 1:
                self.run_round(None if sched is None else sched[0])
            else:
                self.run_rounds_fused(n, participants=sched)
            r += n
        return self.history
