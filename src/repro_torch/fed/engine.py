"""The federated engine (counterpart of ``repro.fed.engine``).

``rollout_batch`` is what every local step runs before any gradient:
generation (prefill, then decode and sample), banded rewards, and the
frozen reference model's logprobs (``FederatedTrainer._make_batch`` and the
first lines of ``one_client`` in the reference's ``_make_round_fn``).
Everything here runs on every ported pattern: the dense llama pattern and
the zamba2 hybrid, whose training differentiates the Mamba2 layers through
the SSD backward kernel.
``client_local_steps`` runs K local steps of one client, each a rollout
then the algorithm's ``step`` (FIRM's by default): ``one_client`` and the
scan ``body`` of ``_make_round_fn`` for a single client.

``FederatedTrainer`` runs the federated round, ``run_round``, with the
semantics of the reference's vectorized executor, for every algorithm of
the registry (``fed.algorithms``: ``firm``, ``firm_unreg``, ``linear``,
``fedcmoo``).  The trainer dispatches on the algorithm's capabilities,
never on its name: the broadcast through the downlink codec, then either
K ``step``s per participant (all starting from the decoded broadcast) or,
for an algorithm with a server exchange between steps, its
``exchange_phase`` (fedcmoo: the M gradients of every participant through
the gradient codec in one stacked roundtrip and one server lambda solve a
step); then the stacked flat delta, ONE stacked uplink roundtrip (one
quantize and one dequantize launch over all clients for ``int8``/``int4``,
with error feedback; one batched 32-pass bisection for ``topk``), FedAvg,
the drift statistics, the comms ledger and the round summary.  The
clients run one after another in a Python loop: the kernels'
``autograd.Function``s have no vmap rule, and one client's update already
peaks at ~17 GB at full width.  The reference's loop executor, cohorts of
heterogeneous ``client_local_steps``, the planner, the fused multi-round
executor and the scheduler are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence

import torch

from repro_torch import device as device_lib
from repro_torch import trees
from repro_torch.comms import codec as codec_lib
from repro_torch.comms import make_codec
from repro_torch.configs.base import FIRMConfig, ModelConfig
from repro_torch.core import comms, drift, fedavg
from repro_torch.data.partition import (make_client_datasets,
                                        sample_prompt_block)
from repro_torch.data.prompts import PromptDataset
from repro_torch.fed import algorithms as algorithms_lib
from repro_torch.models import transformer
from repro_torch.models.common import merge_trainable, split_trainable
from repro_torch.obs.records import round_summary
from repro_torch.rlhf import local as local_lib
from repro_torch.rlhf import ppo, rewards as rewards_lib
from repro_torch.rlhf.sampling import generate


@torch.no_grad()
def rollout_batch(cfg: ModelConfig, params, ref_params, prompts: torch.Tensor,
                  band_h, band_x, *, n_objectives: int, max_new: int,
                  length_tol: int,
                  generator: Optional[torch.Generator] = None,
                  gumbel: Optional[torch.Tensor] = None) -> ppo.PPOBatch:
    """(B, P) prompts -> ``PPOBatch`` of (B, P + max_new) rows.

    ``params`` is the client's policy (adapters merged), ``ref_params`` the
    frozen reference.  ``band_h``/``band_x`` are the (lo, hi) helpful and
    harmful bands of ``rewards.variant_bands``.  The sampling noise comes
    from ``generator`` or is injected as ``gumbel`` (max_new, B, V).
    """
    tokens, old_lp, mask = generate(cfg, params, prompts, max_new=max_new,
                                    generator=generator, gumbel=gumbel)
    r = rewards_lib.score_batch_banded(band_h, band_x, tokens, mask,
                                       n_objectives, length_tol)
    ref_out = transformer.forward_seq(cfg, ref_params, tokens)
    ref_lp = ppo.token_logprobs(ref_out["logits"], tokens)
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
                       extra=None):
    """K local steps of one client.  Returns (final state, metrics).

    Each step merges the client's adapters into ``frozen``, rolls out
    ``fc.batch_size`` prompts and runs ``algorithm.step`` (FIRM's
    ``firm_local_step`` by default) with ``extra``, the algorithm's
    ``traced_extra``.  Prompts come
    from ``dataset`` or are injected as ``prompts`` (K, B, P); step k's
    sampling noise comes from ``generators[k]`` (the reference's one key a
    step) or is injected as ``gumbel`` (K, max_new, B, V).
    ``preference`` is the client's (M,) preference, overriding
    ``fc.preference``.  The metrics are the reference's per-step keep:
    ``lam`` (K, M), ``rewards`` (K, M) and ``kl`` (K,).
    """
    if (dataset is None) == (prompts is None):
        raise ValueError("pass exactly one of dataset= and prompts=")
    algorithm = algorithm or algorithms_lib.FIRMAlgorithm()
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
            gumbel=None if gumbel is None else gumbel[k])
        state, metrics = algorithm.step(cfg, fc, state, frozen, batch,
                                        preference, extra)
        for key, vals in kept.items():
            vals.append(metrics[key])
    return state, {key: torch.stack(vals) for key, vals in kept.items()}


@dataclasses.dataclass
class EngineConfig:
    """Engine knobs orthogonal to the FIRM hyperparameters: the fields of
    the reference's ``EngineConfig`` that the port runs (the loop and
    fused executors and the metric sinks are not ported yet).
    ``algorithm`` names an entry of the registry (``fed.algorithms``)."""
    algorithm: str = "firm"
    prompt_len: int = 8
    max_new: int = 24
    dirichlet_alpha: float = 0.3
    seed: int = 0
    heterogeneous_rms: bool = False      # half the clients use the alt RM
    fedcmoo_compress_rank: Optional[int] = None   # fedcmoo sketch rank
    linear_weights: Optional[Sequence[float]] = None  # linear scalarization
    # comms codecs (repro_torch.comms registry specs, e.g. "int8+ef")
    uplink_codec: str = "identity"       # client -> server deltas
    downlink_codec: str = "identity"     # server -> client broadcast


# The reference's vectorized executor makes five jitted dispatches a round
# around its local phase (stack the states, unstack, the delta, the
# aggregate, the summary), and the algorithm's ``vec_phase_dispatches``
# inside it.  The port runs the same stages eagerly and reports the
# reference's count in the round summary, which its readers compare
# across executors; it measures no work of the port.
ROUND_DISPATCHES_OUTSIDE_PHASE = 5


class LocalPhaseResult(NamedTuple):
    """What the local phase hands back to the round."""
    lams: torch.Tensor               # (P, M) final per-client lambda
    rewards_mean: torch.Tensor       # (M,) mean over all client-steps
    kl_mean: torch.Tensor            # scalar
    stacked_trainable: object        # tree with a leading (P,) client axis
    rewards_pc: torch.Tensor         # (P, M) per-client mean over steps


class FederatedTrainer:
    """Server and C clients of a federated algorithm of the registry (FIRM,
    paper Alg. 1, by default), one round at a time.

    Runs on ``device`` (``cuda`` unless the caller passes ``"cpu"``).
    ``params`` is an optional initial model tree (e.g. a JAX model carried
    over by ``bridge.to_torch``); without it the weights are drawn from
    ``ec.seed``.  Randomness comes from one main stream, read at the
    reference's key points in its order: one draw for the downlink, then
    the local phase's (for a client-local algorithm K x P generation draws
    step-major over the participants; for fedcmoo, per step, one
    generation and M gradient-codec draws a participant and one lambda
    draw), then P uplink draws; each draw seeds a generator on the
    device.  Participants come
    from a stream keyed on (seed, round) alone.  ``run_round`` also takes
    each draw injected, so that a test can hand the port JAX's.

    Participants.  With ``participation < 1`` each round draws
    ``round(participation * C)`` clients from that stream.  Like every
    other draw of the port it is not the reference's (``jax.random.choice``
    on its named participation stream): the same seed picks other clients.
    Parity comes from injecting the reference's draw, as for the prompts,
    the Gumbel noise and the codecs' bits: ``run_round(participants=...)``
    takes one round's sorted client indices, and ``run(R, participants=)``
    a schedule of R such lists, one a round, which it hands to
    ``run_round``; without a schedule each round draws its own.
    """

    def __init__(self, cfg: ModelConfig, fc: FIRMConfig,
                 ec: Optional[EngineConfig] = None, *, params=None,
                 device=None):
        ec = EngineConfig() if ec is None else ec
        # the algorithm owns the local step and the capabilities every
        # path decision reads; (fc, ec) is checked before any work
        self.algorithm = algorithms_lib.get_algorithm(ec.algorithm)
        self.algorithm.validate(fc, ec)
        if fc.client_local_steps is not None and \
                len(set(fc.client_local_steps)) > 1:
            raise NotImplementedError(
                "heterogeneous client_local_steps (several cohorts) are not "
                "ported yet")
        self.cfg, self.fc, self.ec = cfg, fc, ec
        self.device = device_lib.resolve(device)
        gen = torch.Generator(device=self.device).manual_seed(ec.seed)
        self.params = (params if params is not None else
                       transformer.init_params(cfg, generator=gen,
                                               device=self.device))
        trainable, frozen = split_trainable(self.params)
        self.frozen = frozen
        self.ref_params = self.params                 # frozen reference
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
        self.history: List[dict] = []
        self._rng = torch.Generator().manual_seed(ec.seed + 1)
        self._round_idx = 0
        # per-client configs, expanded through the algorithm
        # (resolve_config, per-client preferences and local steps)
        self._client_fcs = algorithms_lib.client_configs(self.algorithm, fc)
        self._stacked_pref = (
            torch.tensor(fc.client_preferences, dtype=torch.float32,
                         device=self.device)
            if fc.client_preferences is not None else None)

    # ------------------------------------------------------------------
    def _next_key(self) -> torch.Generator:
        """A generator on the device seeded by the main stream's next
        draw: the counterpart of splitting the reference's PRNG key."""
        seed = int(torch.randint(0, 2 ** 63 - 1, (), generator=self._rng))
        return torch.Generator(device=self.device).manual_seed(seed)

    def _sample_participants(self, round_idx: Optional[int] = None
                             ) -> List[int]:
        """This round's participants, from a stream keyed on (seed, round)
        only: the same draw whatever else consumed the main stream."""
        fc = self.fc
        n = max(1, int(round(fc.participation * fc.n_clients)))
        if n >= fc.n_clients:
            return list(range(fc.n_clients))
        r = self._round_idx if round_idx is None else round_idx
        g = torch.Generator().manual_seed(
            hash((self.ec.seed + 1, 0x5ced, r)) % 2 ** 63)
        return sorted(int(i) for i in torch.randperm(fc.n_clients,
                                                     generator=g)[:n])

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
                     gumbel=None, grad_bits=None,
                     sketch_noise=None) -> LocalPhaseResult:
        """K local steps of every participant, all from the broadcast.

        The participants share one config (one cohort): their entry of
        ``client_configs``, with the per-client preference lifted out.  An
        algorithm that exchanges nothing with the server between steps
        (``caps.traced_server_exchange``) runs each client's K steps
        alone: client c's step k takes the k-th prompt block and the
        generation draw [k][c], and the per-step metrics are kept as (K,
        P, ...) and reduced one axis at a time, as the reference's are.
        Any other hands the phase to ``algorithm.exchange_phase``.
        """
        has_pref = self._stacked_pref is not None
        cfc = self._client_fcs[participants[0]]
        if has_pref:
            cfc = dataclasses.replace(cfc, preference=None)
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
            gen_keys = [[self._next_key() for _ in participants]
                        for _ in range(k_steps)]
            prompts = self._prompt_blocks(participants, k_steps, prompts)
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
                    algorithm=self.algorithm, extra=extra)
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
            fedavg.stack_trees([s.trainable for s in states]), rewards_pc)

    def _prompt_blocks(self, participants: List[int], k_steps: int,
                       prompts=None) -> torch.Tensor:
        """The (K, P, B, prompt_len) prompt blocks of the local phase: drawn
        from each participant's stream, or injected as ``prompts``, in
        which case the streams' counts still advance by K."""
        part_ds = [self.datasets[c] for c in participants]
        if prompts is None:
            return torch.stack([sample_prompt_block(part_ds,
                                                    self.fc.batch_size)
                                for _ in range(k_steps)])
        for ds in part_ds:
            ds.count += k_steps
        return prompts

    def _delta_flat(self, stacked, anchor) -> torch.Tensor:
        """All P client deltas against the anchor -> (P, d) f32 rows in
        sorted-key leaf order."""
        return torch.cat([(a - b).float().reshape(a.shape[0], -1)
                          for a, b in zip(trees.tree_leaves(stacked),
                                          trees.tree_leaves(anchor))], dim=1)

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
        params: staleness-weighted FedAvg (uniform at zero staleness)."""
        w = fedavg.staleness_weights(
            torch.as_tensor(staleness, dtype=torch.float32,
                            device=flats.device), staleness_pow)
        agg = codec_lib.flat_to_tree(fedavg.fedavg_flat_weighted(flats, w),
                                     self._delta_spec)
        return trees.tree_map(lambda b, d: b + d, anchor, agg)

    def _summary_stats(self, res: LocalPhaseResult) -> dict:
        """The round's statistics, moved to the host in one transfer."""
        stats = {
            "rewards": res.rewards_mean,
            "lam_mean": res.lams.mean(0),
            "lam_disagreement":
                drift.lambda_disagreement(res.lams)["pairwise_mean"],
            "param_drift": drift.param_drift_stacked(res.stacked_trainable),
            "kl": res.kl_mean,
            "per_client_lam": res.lams,
            "rewards_per_client": res.rewards_pc,
        }
        return {k: v.detach().cpu().numpy() for k, v in stats.items()}

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
        ``sketch_noise`` (K, d, q).  The main stream is read all the same
        (P uplink draws whatever the codec), so later rounds' draws stay
        where the reference's are.
        """
        if participants is None:
            participants = self._sample_participants()
        dl_payload, broadcast = self._broadcast(down_bits)
        for _ in participants:
            self.ledger.send_down(dl_payload)
        res = self._local_phase(participants, broadcast, prompts, gumbel,
                                grad_bits, sketch_noise)
        flat_deltas = self._delta_flat(res.stacked_trainable, broadcast)
        payloads, decoded = self._uplink(participants, flat_deltas, up_bits)
        self.global_trainable = self._aggregate_flat(
            broadcast, decoded, [0.0] * len(participants))
        self.ledger.next_round()
        self._round_idx += 1
        summary = round_summary(
            stats=self._summary_stats(res),
            comm_bytes=self.ledger.total,
            up_bytes=self.ledger.up_bytes,
            down_bytes=self.ledger.down_bytes,
            participants=participants,
            dispatches=ROUND_DISPATCHES_OUTSIDE_PHASE
            + self.algorithm.vec_phase_dispatches(
                self._client_fcs[participants[0]].local_steps),
            up_nbytes=[int(p.nbytes) for p in payloads],
            down_nbytes=comms.measured_bytes(dl_payload),
            local_steps=[self._client_fcs[c].local_steps
                         for c in participants],
            cohorts=1)
        self.history.append(summary)
        return summary

    def run(self, rounds: Optional[int] = None,
            participants: Optional[Sequence[Sequence[int]]] = None
            ) -> List[dict]:
        """``rounds`` rounds (default ``fc.rounds``); returns the history.

        ``participants``, if given, is a schedule of one list of client
        indices a round, each handed to ``run_round``; without it every
        round draws its own.
        """
        rounds = rounds or self.fc.rounds
        if participants is not None and len(participants) != rounds:
            raise ValueError(f"a participant schedule needs one entry a "
                             f"round: {len(participants)} for {rounds} "
                             "rounds")
        for r in range(rounds):
            self.run_round(None if participants is None
                           else list(participants[r]))
        return self.history
