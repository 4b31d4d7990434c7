"""Plain float32 versions of the rest of a FIRM round.

Written from the paper's Algorithm 1 and Appendix A (arXiv:2412.xxxx is
not needed: every formula is stated here) as the system defines it:

* synthetic rewards: helpfulness ``sqrt(frac in the helpful band)``,
  harmlessness ``clip(1 - 2 frac in the harmful band)`` over the response
  tokens, bands (0.25, 0.50) and (0.45, 0.55) of the vocabulary;
* per-token shaped rewards ``-kl_coef KL`` plus the sequence reward at the
  last response token, GAE (gamma 0.99, lambda 0.95) on linear critics,
  advantages whitened per objective over the response tokens; the
  critics' TD step and the adaptive KL coefficient (target 0.03);
* clipped PPO (0.2) per objective, plus the MoE load-balance loss;
* the Gram matrix of the M gradients, trace-normalised, plus (beta/2) I,
  minimised over the simplex by 100 steps of projected gradient;
* lambda smoothed as (1 - eta_t) lambda + eta_t lambda*, eta_t = 1/t;
* Adam (0.9, 0.999, 1e-8) after clipping the direction to global norm 1;
* int8 blockwise stochastic quantization of the (C, d) deltas in blocks
  of 1024 with error feedback, and FedAvg with equal weights.
"""
from __future__ import annotations

import torch

BLOCK = 1024


# ------------------------------------------------------------------ rewards
def bands(vocab: int):
    return ((int(vocab * 0.25), int(vocab * 0.50)),
            (int(vocab * 0.45), int(vocab * 0.55)))


def rewards(tokens: torch.Tensor, mask: torch.Tensor, vocab: int,
            m: int) -> torch.Tensor:
    """(B, S) tokens, (B, S) response mask -> (B, M) rewards (M <= 2)."""
    helpful, harmful = bands(vocab)
    n = mask.sum(-1).clamp(min=1.0)

    def frac(band):
        inb = ((tokens >= band[0]) & (tokens < band[1])).float()
        return (inb * mask).sum(-1) / n

    cols = [torch.sqrt(frac(helpful).clamp(0.0, 1.0)),
            (1.0 - 2.0 * frac(harmful)).clamp(0.0, 1.0)]
    return torch.stack(cols[:m], dim=-1)


# ---------------------------------------------------------------- advantages
def shaped_rewards(rewards_seq: torch.Tensor, mask: torch.Tensor,
                   kl: torch.Tensor, kl_coef: torch.Tensor) -> torch.Tensor:
    """(B, S, M) per-token rewards: ``-kl_coef KL`` on every response
    token plus the sequence reward at the last one."""
    s = mask.shape[1]
    last = torch.argmax(mask * torch.arange(s, device=mask.device), dim=-1)
    return (-kl_coef * kl * mask)[..., None] + \
        torch.nn.functional.one_hot(last, s).float()[..., None] * \
        rewards_seq[:, None, :]


def _next(x: torch.Tensor) -> torch.Tensor:
    """x shifted one position left along dim 1, zero at the end."""
    return torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], 1)


def advantages(r_tok: torch.Tensor, mask: torch.Tensor,
               values: torch.Tensor, gamma: float,
               lam: float) -> torch.Tensor:
    """Whitened GAE advantages (B, S, M) of the shaped rewards."""
    s = mask.shape[1]
    next_mask = _next(mask)[..., None]
    delta = r_tok + gamma * _next(values) * next_mask - values
    adv = torch.zeros_like(delta)
    run = torch.zeros_like(delta[:, 0])
    for t in range(s - 1, -1, -1):
        run = delta[:, t] + gamma * lam * next_mask[:, t] * run
        adv[:, t] = run
    n = mask.sum().clamp(min=1.0)
    mean = (adv * mask[..., None]).sum((0, 1)) / n
    var = (((adv - mean) ** 2) * mask[..., None]).sum((0, 1)) / n
    return (adv - mean) / torch.sqrt(var + 1e-8)


# ------------------------------------------------------------------ critics
def features(hidden: torch.Tensor) -> torch.Tensor:
    """The critics' features: the final hidden state over max(its norm,
    1)."""
    h = hidden.detach().float()
    return h / h.norm(dim=-1, keepdim=True).clamp(min=1.0)


def td_update(w: torch.Tensor, feats: torch.Tensor, r_tok: torch.Tensor,
              mask: torch.Tensor, gamma: float, lr: float,
              r_w: float = 20.0) -> torch.Tensor:
    """One TD(0) ascent step of the M linear critics (M, d), each then
    scaled back into the ball of radius ``r_w`` (2 r_max / 0.1)."""
    v = torch.einsum("bsd,md->bsm", feats, w)
    delta = (r_tok + gamma * _next(v) * _next(mask)[..., None] - v) * \
        mask[..., None]
    w = w + lr * torch.einsum("bsm,bsd->md", delta, feats) / \
        mask.sum().clamp(min=1.0)
    n = w.norm(dim=-1, keepdim=True)
    return w * torch.clamp(r_w / n.clamp(min=1e-12), max=1.0)


def kl_update(coef: torch.Tensor, kl: torch.Tensor,
              target: float) -> torch.Tensor:
    """The adaptive KL coefficient: coef (1 + clip(kl / target - 1,
    +-0.2)), clipped to [1e-4, 10]."""
    err = torch.clamp(kl / target - 1.0, -0.2, 0.2)
    return torch.clamp(coef * (1.0 + err), 1e-4, 10.0)


def token_logprobs(logits: torch.Tensor, tokens: torch.Tensor):
    """log p(tokens[t] | logits[t-1]); 0 at position 0.  (B, S)."""
    lp = torch.log_softmax(logits[:, :-1], dim=-1).gather(
        -1, tokens[:, 1:, None])[..., 0]
    return torch.nn.functional.pad(lp, (1, 0))


def ppo_terms(lp, old_lp, adv, mask, clip: float, n: float):
    """(M,) sums over these rows of the clipped PPO objective, over the
    batch's response-token count ``n``."""
    ratio = torch.exp(torch.clamp(lp - old_lp, -20.0, 20.0))
    clipped = torch.clamp(ratio, 1.0 - clip, 1.0 + clip)
    pg = -torch.minimum(ratio[..., None] * adv, clipped[..., None] * adv)
    return (pg * mask[..., None]).sum((0, 1)) / n


# ------------------------------------------------------------------- MGDA
def gram(grads) -> torch.Tensor:
    """(M, M) inner products of M flat gradients."""
    g = torch.stack(grads)
    return g @ g.T


def project_simplex(v: torch.Tensor) -> torch.Tensor:
    u = torch.sort(v, descending=True).values
    css = torch.cumsum(u, 0)
    k = torch.arange(1, v.numel() + 1, dtype=v.dtype, device=v.device)
    rho = int((u + (1.0 - css) / k > 0).sum())
    theta = (css[rho - 1] - 1.0) / rho
    return torch.clamp(v - theta, min=0.0)


def mgda_lambda(G: torch.Tensor, beta: float, iters: int = 100):
    m = G.shape[0]
    Q = G / torch.clamp(torch.trace(G) / m, min=1e-12) + \
        0.5 * beta * torch.eye(m, device=G.device)
    lam = torch.full((m,), 1.0 / m, device=G.device)
    step = 1.0 / (2.0 * torch.linalg.matrix_norm(Q) + 1e-9)
    for _ in range(iters):
        lam = project_simplex(lam - step * (2.0 * Q @ lam))
    return lam


# ------------------------------------------------------------------- Adam
def adam_step(direction: torch.Tensor, params: torch.Tensor,
              mu: torch.Tensor, nu: torch.Tensor, count: int, lr: float,
              max_norm: float = 1.0, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8):
    """Adam step ``count`` (from 1) on a flat direction clipped to global
    norm ``max_norm``.  Returns (new params, new mu, new nu, the first
    moment as the step takes it, bias-corrected)."""
    norm = torch.linalg.vector_norm(direction)
    g = direction * torch.clamp(max_norm / norm.clamp(min=1e-12), max=1.0)
    mu = b1 * mu + (1 - b1) * g
    nu = b2 * nu + (1 - b2) * g * g
    m_hat = mu / (1 - b1 ** count)
    step = m_hat / (torch.sqrt(nu / (1 - b2 ** count)) + eps)
    return params - lr * step, mu, nu, m_hat


# ------------------------------------------------------------------ codec
def blocks(flat: torch.Tensor) -> torch.Tensor:
    d = flat.shape[-1]
    rows = -(-d // BLOCK)
    return torch.nn.functional.pad(flat, (0, rows * BLOCK - d)).reshape(
        rows, BLOCK)


def int8_roundtrip(flat: torch.Tensor, residual: torch.Tensor,
                   bits: torch.Tensor):
    """Error-feedback int8: (decoded (d,), new residual (d,)).  ``bits``
    (rows, 1024) int32 are the rounding offsets' uint32 patterns: the
    offset is their unsigned value over 2**32, and a code is floor(x /
    scale + offset) clipped to +-127, scale = absmax of the row / 127."""
    d = flat.shape[-1]
    x = blocks(flat + residual)
    absmax = x.abs().amax(-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax * (1.0 / 127.0),
                        torch.ones_like(absmax))
    offset = (bits.long() & 0xFFFFFFFF).double() / 2.0 ** 32
    codes = torch.clamp(torch.floor(x / scale + offset.float()), -127, 127)
    decoded = (codes * scale).reshape(-1)[:d]
    new_residual = (x.double() - codes.double() * scale.double()).float()
    return decoded, new_residual.reshape(-1)[:d]


def int8_wire_bytes(d: int) -> int:
    """Codes (one byte a padded parameter) and one f32 scale a row."""
    rows = -(-d // BLOCK)
    return rows * BLOCK + 4 * rows
