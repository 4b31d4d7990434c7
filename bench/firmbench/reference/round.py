"""The reference's FIRM rounds, in blocks of rows.

``client_step`` works out one client's local step from the benchmark's
inputs alone (the weights it made, the prompts and the sampling noise it
drew), the client's state as the reference carried it from its own
earlier steps, and the tokens the system generated, which it judges but
does not trust:

* the generation, token by token: each new token was sampled as the
  argmax of the tempered logits plus the drawn Gumbel noise, from the
  context the system's decode loop feeds (the prompt, its last token
  once more, then the tokens so far), under the adapters the step starts
  from.  ``gaps`` is, for each candidate token matrix, the widest gap by
  which a candidate's perturbed logit lies below the best one, and
  ``ranks`` its worst rank among them;
* the logprobs of those tokens under the decode context (the behaviour
  policy's) and under the plain sequence (the policy's, and the frozen
  reference policy's: the initial adapters), the rewards, the KL and the
  critics' values that shape the advantages, the M PPO losses and their
  gradients on the adapters, the Gram matrix, lambda (smoothed with the
  client's last), Adam's step from the client's moments, the critics' TD
  step and the KL coefficient's update.

In a client's first round the policy is the frozen reference itself
(``lora_B`` is zero: KL is 0) and the critics are zero; from the second
on the KL, the critics, Adam's moments, lambda's smoothing and the
codec's error feedback all act.  A forward over a block of rows gets the
MoE routing fractions of the whole batch (a forward without gradient
over the batch gives them, with the KL's logprobs and the critics'
features).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from firmbench.reference import model, rlhf

BLOCK_TOKENS = 4096


def trainable_paths(params: dict, prefix=()) -> list:
    """Paths of the LoRA leaves in sorted-key order (the flat layout of
    the adapters on the wire)."""
    out = []
    for k in sorted(params):
        v = params[k]
        if isinstance(v, dict):
            out += trainable_paths(v, prefix + (k,))
        elif k in ("lora_A", "lora_B"):
            out.append(prefix + (k,))
    return out


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def with_leaves(params: dict, paths, leaves) -> dict:
    """A copy of the params dict with the leaves at ``paths`` replaced."""
    out = _copy(params)
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = leaf
    return out


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree


def flatten(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1).float() for t in leaves])


def to_f32(tree, quant: Optional[str] = None, path=()):
    """The weights as float32; with ``quant`` the base matrices rounded to
    fp8 per output column (LoRA factors, norms, the router and the SSM's
    vectors stay float32)."""
    if isinstance(tree, dict):
        return {k: to_f32(v, quant, path + (k,)) for k, v in tree.items()}
    t = tree.float()
    if quant == "fp8" and t.dim() >= 2 and "router" not in path and \
            path[-1] in ("w", "w_gate", "w_up", "w_down"):
        return model._fp8(t, -2)
    return t


def row_blocks(b: int, s: int):
    n = max(1, BLOCK_TOKENS // s)
    return [(i, min(b, i + n)) for i in range(0, b, n)]


def decode_context(prompts: torch.Tensor, tokens: torch.Tensor):
    """The decode loop's input sequence (B, P + T): the prompt, its last
    token again, then every generated token but the last."""
    p = prompts.shape[1]
    return torch.cat([prompts, prompts[:, -1:], tokens[:, p:-1]], dim=1)


@torch.no_grad()
def generation_pass(cfg: dict, w: dict, prompts: torch.Tensor,
                    tokens: torch.Tensor, gumbel: torch.Tensor,
                    candidates: Sequence[torch.Tensor], *,
                    temperature: float = 1.0, quant: Optional[str] = None):
    """The decode context's forward.  Returns (gaps, ranks: one widest
    gap and one worst rank a candidate, logprobs (B, T) of the generated
    tokens, argmax tokens (B, T) of the perturbed logits).  A candidate's
    rank at a position is 1 + the number of tokens whose perturbed logit
    is above its own.  gumbel is (T, B, V)."""
    b, p = prompts.shape
    t = tokens.shape[1] - p
    ctx = decode_context(prompts, tokens)
    segments = [(0, p)] + [(i, i + 1) for i in range(p, p + t)]
    gaps = [torch.zeros((), device=tokens.device) for _ in candidates]
    ranks = [torch.zeros((), device=tokens.device, dtype=torch.long)
             for _ in candidates]
    lps, picks = [], []
    for r0, r1 in row_blocks(b, p + t):
        logits = model.forward(cfg, w, ctx[r0:r1], segments=segments,
                               quant=quant)["logits"][:, p:]
        logits = logits / max(temperature, 1e-6)
        pert = logits + gumbel[:, r0:r1].transpose(0, 1).float()
        best = pert.amax(-1)
        for i, cand in enumerate(candidates):
            got = pert.gather(-1, cand[r0:r1, :, None])
            gaps[i] = torch.maximum(gaps[i], (best - got[..., 0]).amax())
            ranks[i] = torch.maximum(ranks[i],
                                     (pert > got).sum(-1).amax() + 1)
        lps.append(torch.log_softmax(logits, -1).gather(
            -1, tokens[r0:r1, p:, None])[..., 0])
        picks.append(pert.argmax(-1))
        del logits, pert
    return gaps, ranks, torch.cat(lps), torch.cat(picks)


def init_state(lora0: list, m: int, d_model: int, kl_coef: float,
               device) -> dict:
    """A client's state before its first step: Adam's moments at zero, M
    zero critics, lambda uniform, the initial KL coefficient."""
    n = sum(t.numel() for t in lora0)
    return {"mu": torch.zeros(n, device=device),
            "nu": torch.zeros(n, device=device), "count": 0,
            "critic": torch.zeros((m, d_model), device=device),
            "lam": torch.full((m,), 1.0 / m, device=device),
            "kl_coef": torch.tensor(kl_coef, device=device), "step": 0}


def unflatten(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> list:
    return [t.reshape(l.shape) for t, l in
            zip(torch.split(flat, [l.numel() for l in like]), like)]


@torch.no_grad()
def sequence_pass(cfg: dict, w: dict, tokens: torch.Tensor,
                  quant: Optional[str] = None, features: bool = True):
    """A forward over the plain sequences without gradient: (token
    logprobs (B, S), critic features (B, S, d) or None, each MoE layer's
    share of routing choices per expert or None)."""
    b, s = tokens.shape
    lps, feats, total = [], [], None
    for r0, r1 in row_blocks(b, s):
        out = model.forward(cfg, w, tokens[r0:r1], quant=quant)
        lps.append(rlhf.token_logprobs(out["logits"], tokens[r0:r1]))
        if features:
            feats.append(rlhf.features(out["hidden"]))
        counts = out["counts"]
        total = counts if total is None else [a + c for a, c in
                                              zip(total, counts)]
        del out
    fracs = None
    if cfg.get("moe"):
        k = cfg["moe"]["top_k"]
        fracs = [c / (b * s * k) for c in total]
    return torch.cat(lps), torch.cat(feats) if features else None, fracs


def client_step(cfg: dict, fc: dict, w: dict, paths, lora0: list,
                state: dict, start: torch.Tensor, prompts: torch.Tensor,
                tokens: torch.Tensor, gumbel: torch.Tensor, *,
                candidates=(), quant: Optional[str] = None,
                rows: Optional[torch.Tensor] = None) -> dict:
    """One client's local step from the flat adapters ``start`` and its
    ``state`` (``init_state``, or the ``state`` an earlier step returned),
    on the system's ``tokens`` (B, P+T).  ``lora0`` are the initial
    adapters (leaves at ``paths`` of ``w``): the frozen reference policy.

    ``candidates`` are extra (B, T) token matrices whose widest gaps to
    report beside the system's own tokens'.  ``rows`` restricts the
    update to those batch rows (a planted fault: half the batch left
    out, the mean taken over the rest)."""
    b, s = tokens.shape
    p = prompts.shape[1]
    m = fc["n_objectives"]
    pol = with_leaves(w, paths, unflatten(start, lora0))
    gaps, ranks, old_lp, picks = generation_pass(
        cfg, pol, prompts, tokens, gumbel, [tokens[:, p:]] + list(candidates),
        quant=quant)
    mask = torch.zeros((b, s), device=tokens.device)
    mask[:, p:] = 1.0
    rew = rlhf.rewards(tokens, mask, cfg["vocab"], m)
    old_full = torch.nn.functional.pad(old_lp, (p, 0))
    at_ref = bool(torch.equal(start, flatten(lora0)))
    lp_pol, feats, fracs = sequence_pass(cfg, pol, tokens, quant)
    ref_lp = lp_pol if at_ref else sequence_pass(cfg, w, tokens, quant,
                                                 features=False)[0]
    rollout = {"old_lp": old_lp, "ref_lp": ref_lp, "rewards": rew}
    if rows is not None:
        tokens, mask, rew, old_full, lp_pol, ref_lp, feats = (
            t[rows] for t in (tokens, mask, rew, old_full, lp_pol, ref_lp,
                              feats))
        fracs = None if fracs is None else \
            sequence_pass(cfg, pol, tokens, quant, features=False)[2]
        b = tokens.shape[0]
    kl = lp_pol - ref_lp
    r_tok = rlhf.shaped_rewards(rew, mask, kl, state["kl_coef"])
    values = torch.einsum("bsd,md->bsm", feats, state["critic"])
    adv = rlhf.advantages(r_tok, mask, values, fc["gamma"], fc["gae_lambda"])
    n = mask.sum().clamp(min=1.0)
    leaves = [t.detach().clone().float().requires_grad_() for t in
              unflatten(start, lora0)]
    wl = with_leaves(w, paths, leaves)
    grads = torch.zeros((m, start.numel()), device=tokens.device)
    losses = torch.zeros(m, device=tokens.device)
    for r0, r1 in row_blocks(b, s):
        with torch.enable_grad():
            out = model.forward(cfg, wl, tokens[r0:r1], moe_frac=fracs,
                                n_tokens=b * s, quant=quant)
            lp = rlhf.token_logprobs(out["logits"], tokens[r0:r1])
            loss = rlhf.ppo_terms(lp, old_full[r0:r1], adv[r0:r1],
                                  mask[r0:r1], fc["ppo_clip"], n) + out["aux"]
            for j in range(m):
                g = torch.autograd.grad(loss[j], leaves,
                                        retain_graph=j < m - 1,
                                        allow_unused=True)
                grads[j] += flatten([torch.zeros_like(t) if gi is None
                                     else gi for gi, t in zip(g, leaves)])
        losses += loss.detach()
        del out, lp, loss
    G = rlhf.gram(list(grads))
    lam_star = rlhf.mgda_lambda(G, fc["beta"], fc.get("solver_iters", 100))
    eta = 1.0 / (state["step"] + 1) if fc.get("lambda_smoothing") else 1.0
    lam = (1.0 - eta) * state["lam"] + eta * lam_star
    count = state["count"] + 1
    new, mu, nu, m_hat = rlhf.adam_step(lam @ grads, start, state["mu"],
                                        state["nu"], count, fc["actor_lr"])
    kl_mean = (kl * mask).sum() / n
    new_state = {
        "mu": mu, "nu": nu, "count": count, "lam": lam,
        "critic": rlhf.td_update(state["critic"], feats, r_tok, mask,
                                 fc["gamma"], fc["critic_lr"]),
        "kl_coef": rlhf.kl_update(state["kl_coef"], kl_mean,
                                  fc["kl_target"]),
        "step": state["step"] + 1}
    return {"gaps": gaps, "ranks": ranks, **rollout, "losses": losses,
            "gram": G, "lam": lam, "grad": m_hat, "new": new,
            "picks": picks, "state": new_state}


def aggregate(start: torch.Tensor, news: Sequence[torch.Tensor],
              residuals: Sequence[torch.Tensor], bits: torch.Tensor):
    """The uplink and FedAvg of a round: each client's delta through int8
    with error feedback (its residual carried from its last round), then
    the equal-weight mean added to the broadcast.  Returns (decoded (C,
    d), the new residuals, the new global (d,))."""
    dec, res = [], []
    for c, new in enumerate(news):
        d, r = rlhf.int8_roundtrip(new - start, residuals[c], bits[c])
        dec.append(d)
        res.append(r)
    dec = torch.stack(dec)
    return dec, res, start + dec.mean(0)
