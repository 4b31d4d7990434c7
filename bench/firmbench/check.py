"""The comparison that decides ``correct``.

The system's two set-up rounds are rounds 1 and 2 of the trainer the
window then times.  ``collect`` keeps what a round produced: each
client-step's rollout (tokens, behaviour and reference logprobs,
rewards) and update (losses, Gram matrix, lambda, Adam's first moment,
the critics, the KL coefficient, the adapters it started from and
reached), the uplink's flat deltas and decoded rows, the new global
adapters and the round's wire bytes.  Once the window has closed and the
system is freed, the plain reference (``firmbench.reference``) works
both rounds out again from the benchmark's own inputs and the generated
tokens, carrying its own clients' state (moments, critics, lambda, KL
coefficient, codec residuals) from round 1 into round 2, and ``judge``
gives one number for each thing compared, each held to its limit in
``bench/limits/<cell>.json``.  Round n's numbers are named ``r<n>.<number>``:

  prompts          prompt tokens the rollout altered (exact: 0)
  token_gap        widest gap by which a generated token's perturbed
                   logit lies below the reference's best (the sampler)
  token_rank       worst rank of a generated token among the reference's
                   perturbed logits at its position (1: its own pick)
  logprob_gap      largest |behaviour logprob - reference's| (decode)
  logprob_mean     mean of the same over the generated tokens
  ref_logprob_gap  largest |reference-policy logprob - reference's|
                   (the teacher-forced forward)
  ref_logprob_mean mean of the same over the generated tokens
  reward_gap       largest |reward - reference's|
  loss_gap         largest |PPO loss - reference's| over the objectives
  gram_gap         largest |Gram entry - reference's| over the largest
                   diagonal entry
  gnorm_gap        largest relative gap of an objective's gradient norm
                   (the square root of the Gram's diagonal)
  lambda_gap       largest |lambda_j - reference's| (after smoothing)
  grad_gap         worst adapter leaf's gap of norms of Adam's first
                   moment as the step takes it (bias-corrected)
  critic_gap       worst critic's gap of norms after the TD step
  kl_coef_gap      largest relative gap of the KL coefficient
  delta_gap        worst adapter leaf's gap of norms of a client's delta
                   over the round (what it uploads)
  codec_gap        largest relative error of the decoded deltas (int8
                   with the drawn offsets and the error feedback of the
                   system's own earlier deltas, of its own deltas) and of
                   FedAvg (of the system's own decoded rows)
  change_gap       worst adapter leaf's gap of norms of the global
                   adapters' change since the start
  comm_bytes       |wire bytes of the round - the codecs' exact count|

A gap of norms is taken leaf by leaf against the reference's norm of
that leaf or the median leaf's, whichever is larger; leaves whose
reference norm is under a thousandth of the median leaf's (``lora_A``
in round 1, whose gradient is zero while ``lora_B`` is) are left out.

The control and the planted faults are reference runs put in the
system's place: ``as_outputs`` gives them the shape ``collect`` gives
the system's, and ``judge`` scores them as it scores the system.
"""
from __future__ import annotations

import math
import statistics

import torch

from firmbench.reference import rlhf
from firmbench.reference import round as ref_round

STEP = ("token_gap", "token_rank", "logprob_gap", "logprob_mean",
        "ref_logprob_gap", "ref_logprob_mean", "reward_gap", "loss_gap",
        "gram_gap", "gnorm_gap", "lambda_gap", "grad_gap", "critic_gap",
        "kl_coef_gap")
ROUND = ("prompts",) + STEP + ("delta_gap", "codec_gap", "change_gap",
                                "comm_bytes")
ROUNDS = 2
ORDER = tuple(f"r{r}.{name}" for r in range(1, ROUNDS + 1)
              for name in ROUND)
ADAM_B1 = 0.9


def _flat(tree, paths) -> torch.Tensor:
    return torch.cat([ref_round.get(tree, p).detach().float().reshape(-1)
                      for p in paths])


def collect(probe, trainer, summary, paths, k_steps: int,
            prev_bytes: int = 0) -> dict:
    """What one round of the system produced, off the probe's keeps (its
    client-steps in order: client by client, K steps each), as plain
    tensors copied off the system."""
    rollouts = [out for _, _, out in probe.kept["rollout"]]
    updates = probe.kept["update"]
    (up_args, _, (payloads, decoded)), = probe.kept["uplink"]
    steps = []
    for batch, (args, _, (state, metrics)) in zip(rollouts, updates):
        count = max(int(state.opt.count), 1)
        steps.append({
            "tokens": batch.tokens.clone(),
            "old_lp": batch.old_logprobs.clone(),
            "ref_lp": batch.ref_logprobs.clone(),
            "rewards": batch.rewards.clone(),
            "losses": metrics["losses"].clone(),
            "gram": metrics["gram"].clone(),
            "lam": metrics["lam"].clone(),
            "grad": _flat(state.opt.mu, paths) / (1 - ADAM_B1 ** count),
            "critic": state.critic["w"].detach().float().clone(),
            "kl_coef": state.kl_coef.detach().float().reshape(1).clone(),
            "start": _flat(args[2].trainable, paths),
            "new": _flat(state.trainable, paths),
        })
    clients = [steps[i:i + k_steps] for i in range(0, len(steps), k_steps)]
    return {"clients": clients,
            "flats": up_args[1].detach().float().clone(),
            "decoded": decoded.detach().float().clone(),
            "global": _flat(trainer.global_trainable, paths),
            "comm_bytes": int(summary["comm_bytes"]) - prev_bytes}


def leaf_gap(got: torch.Tensor, want: torch.Tensor, sizes) -> float:
    """Worst leaf's |norm(got) - norm(want)| over max(norm(want), median
    leaf norm), leaves under 1e-3 of the median left out."""
    g = [float(t.norm()) for t in torch.split(got, sizes)]
    w = [float(t.norm()) for t in torch.split(want, sizes)]
    med = statistics.median(w)
    kept = [(a, b) for a, b in zip(g, w) if b >= 1e-3 * med and med > 0]
    if not kept:
        return float("nan")
    return max(abs(a - b) / max(b, med) for a, b in kept)


def _max(t: torch.Tensor) -> float:
    return float(t.abs().max()) if t.numel() else 0.0


def _mean(t: torch.Tensor) -> float:
    return float(t.abs().mean()) if t.numel() else 0.0


def expected_bytes(traffic: dict, d: int) -> int:
    c = traffic["firm"]["n_clients"]
    return c * rlhf.int8_wire_bytes(d) + c * 4 * d


def gnorm_gap(gram: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |norm of g_j - the reference's| over the reference's."""
    a = torch.sqrt(torch.diagonal(gram).clamp(min=0))
    b = torch.sqrt(torch.diagonal(want).clamp(min=0))
    return float(((a - b).abs() / b.clamp(min=1e-30)).max())


def judge_step(prog: dict, ref: dict, p: int, sizes, cand: int) -> dict:
    """The numbers of one client-step (rollout and update)."""
    m = ref["critic"].shape[0]
    return {
        "token_gap": float(ref["gaps"][cand]),
        "token_rank": float(ref["ranks"][cand]),
        "logprob_gap": _max(prog["old_lp"][:, p:] - ref["old_lp"]),
        "logprob_mean": _mean(prog["old_lp"][:, p:] - ref["old_lp"]),
        "ref_logprob_gap": _max(prog["ref_lp"][:, p:] - ref["ref_lp"][:, p:]),
        "ref_logprob_mean": _mean(prog["ref_lp"][:, p:]
                                  - ref["ref_lp"][:, p:]),
        "reward_gap": _max(prog["rewards"] - ref["rewards"]),
        "loss_gap": _max(prog["losses"] - ref["losses"]),
        "gram_gap": _max(prog["gram"] - ref["gram"])
        / max(float(torch.diagonal(ref["gram"]).max()), 1e-30),
        "gnorm_gap": gnorm_gap(prog["gram"], ref["gram"]),
        "lambda_gap": _max(prog["lam"] - ref["lam"]),
        "grad_gap": leaf_gap(prog["grad"], ref["grad"], sizes),
        "critic_gap": leaf_gap(prog["critic"].reshape(-1),
                               ref["critic"].reshape(-1),
                               [ref["critic"].shape[1]] * m),
        "kl_coef_gap": _max(prog["kl_coef"] - ref["kl_coef"])
        / float(ref["kl_coef"].abs().max()),
    }


def merge(rows) -> dict:
    """The worst of each number over the rows (NaN wins)."""
    out = {}
    for row in rows:
        for k, v in row.items():
            out[k] = v if math.isnan(v) or math.isnan(out.get(k, 0.0)) \
                else max(out.get(k, -math.inf), v)
    return out


def residuals(outputs: dict, draws) -> list:
    """Each round's codec residuals at its start, (C, d) a round, from the
    system's own deltas of the rounds before (zero in round 1)."""
    flats0 = outputs["rounds"][0]["flats"]
    res = [torch.zeros_like(flats0)]
    for out, dr in zip(outputs["rounds"][:-1], draws):
        res.append(torch.stack([
            rlhf.int8_roundtrip(f, r, b)[1] for f, r, b in
            zip(out["flats"], res[-1], dr["up_bits"])]))
    return res


def codec_gap(out: dict, residual: torch.Tensor, bits: torch.Tensor) -> float:
    """A round's decoded rows against int8 with error feedback of its own
    deltas, and its new global adapters against FedAvg of its own
    decoded rows."""
    gaps = []
    for c, flat in enumerate(out["flats"]):
        want, _ = rlhf.int8_roundtrip(flat, residual[c], bits[c])
        gaps.append(_max(out["decoded"][c] - want) / max(_max(want), 1e-30))
    start = out["clients"][0][0]["start"]
    want = start + out["decoded"].mean(0)
    gaps.append(_max(out["global"] - want) / max(_max(want - start), 1e-30))
    return max(gaps)


def run_reference(cfg: dict, traffic: dict, w32: dict, paths, lora0,
                  draws, outputs: dict, *, quant=None, rows=None,
                  candidates=None) -> dict:
    """The reference's rounds on the system's tokens, each client carrying
    its own state from round to round.  ``draws`` are the rounds' drawn
    inputs; ``candidates[r][c][k]`` extra token matrices to judge at
    client-step (c, k) of round r.  Per round: ``clients`` (a list of K
    ``client_step`` dicts a client), ``decoded``, ``global``, ``start``."""
    fc = traffic["firm"]
    p = traffic["prompt_len"]
    n_clients = len(outputs["rounds"][0]["clients"])
    states = [ref_round.init_state(lora0, fc["n_objectives"],
                                   cfg["d_model"], fc["kl_coef_init"],
                                   lora0[0].device)
              for _ in range(n_clients)]
    glob = ref_round.flatten(lora0)
    res = [torch.zeros_like(glob) for _ in range(n_clients)]
    rounds = []
    for r, (dr, out) in enumerate(zip(draws, outputs["rounds"])):
        start, clients, news = glob, [], []
        for c, prog_steps in enumerate(out["clients"]):
            here, steps = start, []
            for k, prog in enumerate(prog_steps):
                step = ref_round.client_step(
                    cfg, fc, w32, paths, lora0, states[c], here,
                    dr["prompts"][k, c], prog["tokens"], dr["gumbel"][k, c],
                    candidates=() if candidates is None
                    else candidates[r][c][k], quant=quant, rows=rows)
                states[c], here = step.pop("state"), step["new"]
                step.update(critic=states[c]["critic"],
                            kl_coef=states[c]["kl_coef"].reshape(1))
                steps.append(step)
            clients.append(steps)
            news.append(here)
        dec, res, glob = ref_round.aggregate(start, news, res, dr["up_bits"])
        rounds.append({"clients": clients, "decoded": dec, "global": glob,
                       "start": start})
    return {"rounds": rounds, "start": ref_round.flatten(lora0), "p": p}


def as_outputs(ref: dict, outputs: dict, traffic: dict, d: int) -> dict:
    """A reference run (the control, or a planted fault) in the shape of
    ``collect``'s outputs, on the system's tokens, with the codecs' exact
    byte count."""
    p = traffic["prompt_len"]
    rounds = []
    for run, prog in zip(ref["rounds"], outputs["rounds"]):
        clients = []
        for steps, psteps in zip(run["clients"], prog["clients"]):
            clients.append([{
                "tokens": ps["tokens"],
                "old_lp": torch.nn.functional.pad(s["old_lp"], (p, 0)),
                "ref_lp": s["ref_lp"], "rewards": s["rewards"],
                "losses": s["losses"], "gram": s["gram"], "lam": s["lam"],
                "grad": s["grad"], "critic": s["critic"],
                "kl_coef": s["kl_coef"], "new": s["new"],
                "start": run["start"] if k == 0 else steps[k - 1]["new"]}
                for k, (s, ps) in enumerate(zip(steps, psteps))])
        rounds.append({
            "clients": clients,
            "flats": torch.stack([steps[-1]["new"] - run["start"]
                                  for steps in run["clients"]]),
            "decoded": run["decoded"], "global": run["global"],
            "comm_bytes": expected_bytes(traffic, d)})
    return {"rounds": rounds}


def judge(cfg: dict, traffic: dict, outputs: dict, ref: dict, draws,
          sizes, cand: int = 0) -> dict:
    """Every number of the rounds (``ORDER``).  ``cand`` is the index of
    the candidate token matrix, among those ``ref`` judged, that stands
    for the outputs' sampled tokens (0: the outputs' own)."""
    p = traffic["prompt_len"]
    start0 = ref["start"]
    res = residuals(outputs, draws)
    nums, finite = {}, True
    for r, (out, run, dr) in enumerate(zip(outputs["rounds"], ref["rounds"],
                                           draws), start=1):
        prompts = sum(int((prog["tokens"][:, :p] != dr["prompts"][k, c])
                          .sum()) for c, steps in enumerate(out["clients"])
                      for k, prog in enumerate(steps))
        row = {"prompts": float(prompts)}
        row.update(merge(judge_step(prog, want, p, sizes, cand)
                         for steps, wants in zip(out["clients"],
                                                 run["clients"])
                         for prog, want in zip(steps, wants)))
        row["delta_gap"] = max(
            leaf_gap(flat, wants[-1]["new"] - run["start"], sizes)
            for flat, wants in zip(out["flats"], run["clients"]))
        row["codec_gap"] = codec_gap(out, res[r - 1], dr["up_bits"])
        row["change_gap"] = leaf_gap(out["global"] - start0,
                                     run["global"] - start0, sizes)
        row["comm_bytes"] = float(abs(out["comm_bytes"] - expected_bytes(
            traffic, sum(sizes))))
        nums.update({f"r{r}.{k}": v for k, v in row.items()})
        finite &= all(bool(torch.isfinite(t).all()) for steps in
                      out["clients"] for prog in steps
                      for t in prog.values())
    out = {k: nums[k] for k in ORDER if k in nums}
    if not finite:
        out["finite"] = 1.0
    return out


def verdict(nums: dict, limits: dict) -> bool:
    """Every number present, finite and within its limit."""
    for name, limit in limits.items():
        v = nums.get(name)
        if v is None or not math.isfinite(v) or v > limit:
            return False
    return "finite" not in nums
