"""Algorithm protocol and registry (counterpart of
``repro.fed.algorithms``).

Every federated algorithm the trainer runs (the paper's FIRM, its beta =
0 ablation, linear scalarisation and the server-centric FedCMOO baseline)
is an ``Algorithm`` object that owns:

* its **local-step machinery**: ``step``, one client's local update (the
  counterpart of the reference's ``traced_step``, which its vectorized
  round vmaps); for an algorithm whose server exchange runs between the
  clients' steps, the whole local phase (``exchange_phase``, the
  counterpart of ``exchange_phase_vectorized``); and the loop executor's
  local phase (``loop_phase``, with ``loop_dispatches_per_client_step``
  for the planner's cost model);
* its **config resolution**: ``resolve_config`` (firm_unreg pins beta =
  0), ``validate`` (fedcmoo rejects per-client local-step counts) and the
  per-client expansion ``client_configs``;
* its declared **capabilities** (``Capabilities``), the only thing the
  trainer dispatches on: it never branches on an algorithm's name.

Capabilities, as the reference declares them:

``vmap_safe``
    The local step can run over a stacked client axis.  The port runs
    the clients one after another either way; the planner
    (``fed.api.resolve_local_mode``) reads it, and False sends the round
    to the loop executor.
``traced_server_exchange``
    The algorithm exchanges nothing with the server during the local
    phase (firm, linear), so each client runs its K ``step``s alone.
    False (fedcmoo: a lambda solve between every two steps) hands the
    local phase to ``exchange_phase``.
``single_cohort_required``
    Every participant advances in lock step (fedcmoo's lambda is global
    per step).
``fusable``
    Eligible for the round-level fused executor; needs
    ``traced_server_exchange`` and ``vmap_safe``, which
    ``register_algorithm`` checks.

The loop executor (``EngineConfig.vectorized_clients=False``, or an
algorithm that is not ``vmap_safe``) runs ``loop_phase`` for a
client-local algorithm: each client-step in the canonical step-major
order (``_step_major``), each under the client's own entry of
``client_configs`` (its preference static, not lifted), through the same
``client_local_steps`` and ``step`` as the vectorized phase.  FedCMOO has
no loop phase of its own: the loop runs its ``exchange_phase``, whose
stacked gradient roundtrip gives the rows, draws and bytes of the
reference's loop, which sends each gradient alone.  The reference's
``local_step_fn`` (a jitted step bound to a client's config) has no
counterpart: ``client_local_steps`` takes the client's config and the
algorithm, which binds ``step`` to it.

FedCMOO's exchange runs three programs of ``obs.jitwatch``
(``fedcmoo_grads`` and ``fedcmoo_apply`` a client-step, ``grads_flat`` a
step); ``programs_per_client_step`` and ``programs_per_step`` give the
plan audit an algorithm's count of programs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from repro_torch.comms import ErrorFeedback
from repro_torch.configs.base import FIRMConfig
from repro_torch.core import fedavg, fedcmoo, firm
from repro_torch.obs import jitwatch
from repro_torch.rlhf import local as local_lib


@dataclasses.dataclass(frozen=True)
class Capabilities:
    """What an algorithm's execution paths can do (see the module
    docstring)."""
    vmap_safe: bool = True
    traced_server_exchange: bool = True
    single_cohort_required: bool = False
    fusable: bool = True


def validate_capabilities(caps: Capabilities, name: str) -> None:
    """Reject internally inconsistent capability declarations."""
    if caps.fusable and not caps.traced_server_exchange:
        raise ValueError(
            f"algorithm {name!r} declares fusable=True but "
            "traced_server_exchange=False: the round-level lax.scan "
            "cannot pause for a host-driven server exchange")
    if caps.fusable and not caps.vmap_safe:
        raise ValueError(
            f"algorithm {name!r} declares fusable=True but "
            "vmap_safe=False: the fused round body vmaps the local step "
            "over the stacked client axis")


class Algorithm:
    """Base protocol; subclasses fill in the hooks their capabilities
    promise: ``step`` when ``traced_server_exchange`` is True,
    ``exchange_phase`` when it is False.  ``kernel`` names the step
    program: algorithms whose steps are one program after
    ``resolve_config`` (firm and firm_unreg) share it."""

    name: str = "algorithm"
    kernel: str = "algorithm"
    caps: Capabilities = Capabilities()
    # the planner's cost model: the reference's jitted dispatches a
    # client-step on the loop executor
    loop_dispatches_per_client_step: int = 3
    # the port's programs (obs.jitwatch) a client-step (generate,
    # ref_logprobs, step) and a local step: the plan audit's count
    programs_per_client_step: int = 3
    programs_per_step: int = 0

    # ---- config resolution -------------------------------------------
    def validate(self, fc: FIRMConfig, ec) -> None:
        """Raise if (fc, ec) cannot run under this algorithm."""

    def resolve_config(self, fc: FIRMConfig) -> FIRMConfig:
        """The FIRMConfig the local step runs with."""
        return fc

    # ---- local-step machinery ----------------------------------------
    def step(self, cfg, cfc: FIRMConfig, state, frozen, batch, pref, extra,
             graphs=None, aux=None):
        """One client's local update: (new state, metrics with at least
        ``lam``, ``rewards`` and ``kl``).  The counterpart of the
        reference's ``traced_step``; ``pref`` is the client's (M,)
        preference or None, ``extra`` what ``traced_extra`` gives.
        ``graphs``, an ``update_graph.UpdateGraphs`` (given for CUDA
        tensors), runs the update as a captured program; None runs it
        eagerly.  ``aux`` is the modality stub of a config with cross
        blocks (an operand of the captured update)."""
        raise NotImplementedError(self.name)

    def traced_extra(self, cfc: FIRMConfig, ec, device=None):
        """The run's constant operand of ``step`` (the linear weights), on
        ``device``; None when unused."""
        return None

    def exchange_phase(self, trainer, cfc: FIRMConfig,
                       participants: List[int], states: list, prompts, *,
                       gumbel=None, grad_bits=None, sketch_noise=None):
        """The local phase of an algorithm with a server exchange between
        steps (the counterpart of ``exchange_phase_vectorized``): K steps
        of every participant from ``states``.  Returns (lams (P, M),
        rewards_mean (M,), kl_mean, rewards_pc (P, M), final states)."""
        raise NotImplementedError(self.name)

    def loop_phase(self, trainer, participants: List[int], states: list, *,
                   prompts=None, gumbel=None) -> List[dict]:
        """The loop executor's local phase of a client-local algorithm:
        every client-step in step-major order (``_step_major``), one
        ``step`` each under the client's own config
        (``trainer._loop_step``).  ``states`` (one per participant) are
        replaced in place; returns one metric dict a client-step, each with
        ``client``, ``lam``, ``rewards`` and ``kl``.  ``prompts`` and
        ``gumbel`` are the injected draws of ``run_round``."""
        metrics = []
        for k, ci, c in _step_major(trainer, participants):
            states[ci], m = trainer._loop_step(c, ci, k, states[ci],
                                               prompts, gumbel)
            m["client"] = c
            metrics.append(m)
        return metrics

    # ---- cost model ----------------------------------------------------
    def vec_phase_dispatches(self, k_steps: int) -> int:
        """The reference's dispatches inside one vectorized local phase
        (without the stack and unstack around it)."""
        return 1

    def uplink_bytes_per_participant(self, fc: FIRMConfig, ul_codec,
                                     d: int) -> int:
        """Exact wire bytes one participant uploads a round."""
        return ul_codec.nbytes_static(d)

    def __repr__(self) -> str:
        return f"<Algorithm {self.name} caps={self.caps}>"


def _step_major(trainer, participants: List[int]):
    """The canonical loop order, as (k, index in participants, client):
    step-major over the participants, each with its own K (clients of a
    smaller ``client_local_steps`` entry finish early and are skipped).
    The cohort phase draws its generation keys in this order too."""
    steps = [trainer._client_fcs[c].local_steps for c in participants]
    for k in range(max(steps)):
        for ci, c in enumerate(participants):
            if k < steps[ci]:
                yield k, ci, c


def _firm_step(cfg, cfc, state, frozen, batch, operands, aux=None):
    # looked up at each call, so that a wrapper put on the module's
    # firm_local_step (a test's spy) is the one captured
    beta, *pref = operands
    return local_lib.firm_local_step(cfg, cfc, state, frozen, batch, aux,
                                     preference=pref[0] if pref else None,
                                     beta=beta)


def _linear_step(cfg, cfc, state, frozen, batch, operands, aux=None):
    (weights,) = operands
    return local_lib.linear_local_step(cfg, cfc, state, frozen, batch,
                                       weights, aux)


class FIRMAlgorithm(Algorithm):
    """Paper Alg. 1: in-client regularized MGDA (client-local)."""

    name = "firm"
    kernel = "firm"
    caps = Capabilities()
    loop_dispatches_per_client_step = 3     # generate, ref logprobs, step

    def step(self, cfg, cfc, state, frozen, batch, pref, extra,
             graphs=None, aux=None):
        if graphs is None:
            return local_lib.firm_local_step(cfg, cfc, state, frozen, batch,
                                             aux, preference=pref)
        dev = state.lam.device
        if pref is None and cfc.preference is not None:
            # the config's preference rides the graph's static operands
            pref = firm.config_tensor(tuple(cfc.preference), dev)
        # so does beta: one graph serves every beta (fedbuff's
        # staleness-scaled ones), each update its own beta's bits
        beta = firm.config_tensor(cfc.beta, dev)
        return graphs.run(self.kernel, _firm_step, cfg, cfc, state, frozen,
                          batch, (beta,) if pref is None else (beta, pref),
                          aux=aux)


class FIRMUnregAlgorithm(FIRMAlgorithm):
    """The beta = 0 ablation (RQ2): FIRM's step with the regulariser off.
    ``kernel`` stays "firm": after ``resolve_config`` it is the same
    step."""

    name = "firm_unreg"

    def resolve_config(self, fc):
        return dataclasses.replace(fc, beta=0.0)


class LinearAlgorithm(Algorithm):
    """Fixed-weight linear scalarisation (the implicit baseline)."""

    name = "linear"
    kernel = "linear"
    caps = Capabilities()
    loop_dispatches_per_client_step = 2     # generate, ref logprobs

    def step(self, cfg, cfc, state, frozen, batch, pref, extra,
             graphs=None, aux=None):
        if graphs is None:
            return local_lib.linear_local_step(cfg, cfc, state, frozen,
                                               batch, extra, aux)
        return graphs.run(self.kernel, _linear_step, cfg, cfc, state, frozen,
                          batch, (extra,), aux=aux)

    def traced_extra(self, cfc, ec, device=None):
        # built once a value and device: a copy from the host every round
        # would make the host wait for the device
        return firm.config_tensor(
            tuple(ec.linear_weights
                  or [1.0 / cfc.n_objectives] * cfc.n_objectives), device)


class FedCMOOAlgorithm(Algorithm):
    """Server-centric MGDA baseline (RQ1, Askin et al. 2024).

    Gradients go up every local step and the server sends one global
    lambda back, between two client phases: hence
    ``traced_server_exchange=False`` (never fused) and
    ``single_cohort_required=True`` (lambda is global per step).
    """

    name = "fedcmoo"
    kernel = "fedcmoo"
    caps = Capabilities(vmap_safe=True, traced_server_exchange=False,
                        single_cohort_required=True, fusable=False)
    loop_dispatches_per_client_step = 2     # generate, ref logprobs
    # generate, ref_logprobs, fedcmoo_grads, fedcmoo_apply; grads_flat
    programs_per_client_step = 4
    programs_per_step = 1

    def validate(self, fc, ec):
        if fc.client_local_steps is not None:
            raise ValueError("fedcmoo needs homogeneous local_steps: its "
                             "server λ exchange is global per local step")

    def vec_phase_dispatches(self, k_steps: int) -> int:
        # per step: sampler, vmapped grads, batched flatten, vmapped apply
        return 4 * k_steps

    def uplink_bytes_per_participant(self, fc, ul_codec, d):
        # M gradient uploads a step ride the EF-stripped inner codec, on
        # top of the end-of-round delta
        grad = self._grad_codec(ul_codec)
        return (ul_codec.nbytes_static(d)
                + fc.n_objectives * fc.local_steps * grad.nbytes_static(d))

    @staticmethod
    def _grad_codec(ul_codec):
        """The codec of the gradient uploads: error feedback is defined
        per client stream, not per objective, so the M gradients take the
        inner codec without it."""
        return ul_codec.inner if isinstance(ul_codec, ErrorFeedback) \
            else ul_codec

    def exchange_phase(self, trainer, cfc, participants, states, prompts, *,
                       gumbel=None, grad_bits=None, sketch_noise=None):
        """Per step k: every participant rolls out and computes its M
        gradients; the (P * M, d) client-major stack goes through the
        gradient codec in one roundtrip, each payload onto the ledger in
        row order; the server solves lambda from what it decoded; every
        participant applies it to its own gradients.

        The main stream is read in the reference's order: per step, for
        each participant one generation draw and M gradient-codec draws,
        then one lambda draw (read whether or not a sketch uses it).
        Injected: ``gumbel`` (K, P, max_new, B, V), ``grad_bits`` (K, P *
        M, ...) the gradient codec's draws, ``sketch_noise`` (K, d, q).
        """
        m = cfc.n_objectives
        p_count = len(participants)
        grad_codec = self._grad_codec(trainer.uplink_codec)
        rew_hist, kl_hist, lam = [], [], None
        for k in range(cfc.local_steps):
            gen_keys, grad_keys = [], []
            for _ in participants:
                gen_keys.append(trainer._next_key())
                grad_keys.extend(trainer._next_key() for _ in range(m))
            phase1 = []
            for ci, c in enumerate(participants):
                batch = trainer._make_batch(
                    c, states[ci].trainable, prompts[k, ci],
                    generator=None if gumbel is not None else gen_keys[ci],
                    gumbel=None if gumbel is None else gumbel[k, ci])
                grads, _, extras = _fedcmoo_grads(
                    trainer.cfg, cfc, states[ci], trainer.frozen, batch)
                phase1.append((grads, extras, batch.rewards.mean(0)))
            gmat = _grads_flat([g for g, _, _ in phase1], m)
            payloads, _, decoded = grad_codec.roundtrip_stacked(
                gmat.reshape(p_count * m, -1), trainer._delta_spec,
                keys=grad_keys,
                bits=None if grad_bits is None else grad_bits[k])
            for gp in payloads:
                trainer.ledger.send_up(gp)
            lam = fedcmoo.fedcmoo_round_lambda_stacked(
                decoded.reshape(p_count, m, -1),
                compress_rank=trainer.ec.fedcmoo_compress_rank,
                generator=trainer._next_key(),
                noise=None if sketch_noise is None else sketch_noise[k])
            for ci, (grads, extras, _) in enumerate(phase1):
                states[ci], met = _fedcmoo_apply(cfc, states[ci], grads, lam,
                                                 extras)
                kl_hist.append(met["kl"])
            rew_hist.append(torch.stack([r for _, _, r in phase1]))
        rew = torch.stack(rew_hist)                           # (K, P, M)
        return (lam[None].repeat(p_count, 1), rew.reshape(-1, m).mean(0),
                torch.stack(kl_hist).mean(), rew.mean(0), states)


def _grads_flat(client_grads: list, m: int) -> torch.Tensor:
    """Every participant's M gradient trees -> (P, M, d) flat rows,
    client-major: the reference's upload order, so that the codec's draws
    and the ledger's bytes line up with it."""
    return fedcmoo.stack_grads_flat(
        [fedavg.stack_trees([g[j] for g in client_grads]) for j in range(m)],
        m)


# FedCMOO's exchange programs (obs.jitwatch)
_fedcmoo_grads = jitwatch.wrap("fedcmoo_grads", local_lib.fedcmoo_local_grads)
_grads_flat = jitwatch.wrap("grads_flat", _grads_flat)
_fedcmoo_apply = jitwatch.wrap("fedcmoo_apply", local_lib.fedcmoo_local_apply)


# ---------------------------------------------------------------- registry
_REGISTRY: Dict[str, Algorithm] = {}


def register_algorithm(algorithm: Algorithm) -> Algorithm:
    """Validate the capability declaration and add the algorithm to the
    registry (a name already there is overwritten, as for codecs)."""
    validate_capabilities(algorithm.caps, algorithm.name)
    _REGISTRY[algorithm.name] = algorithm
    return algorithm


def get_algorithm(name: str) -> Algorithm:
    if name not in _REGISTRY:
        raise ValueError(f"unknown algorithm {name!r}; "
                         f"available: {available_algorithms()}")
    return _REGISTRY[name]


def available_algorithms() -> tuple:
    return tuple(sorted(_REGISTRY))


register_algorithm(FIRMAlgorithm())
register_algorithm(FIRMUnregAlgorithm())
register_algorithm(LinearAlgorithm())
register_algorithm(FedCMOOAlgorithm())


def client_configs(algorithm: Algorithm, fc: FIRMConfig
                   ) -> List[FIRMConfig]:
    """Per-client FIRM configs (per-client preferences and local-step
    counts) expanded from the algorithm-resolved base config."""
    base = algorithm.resolve_config(fc)
    out = []
    for c in range(fc.n_clients):
        cfc = base
        if fc.client_preferences is not None:
            cfc = dataclasses.replace(
                cfc, preference=fc.client_preferences[c])
        if fc.client_local_steps is not None:
            cfc = dataclasses.replace(
                cfc, local_steps=int(fc.client_local_steps[c]))
        out.append(cfc)
    return out
