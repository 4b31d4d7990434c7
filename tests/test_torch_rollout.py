"""The port's rollout (prompts, generate, rewards, reference logprobs)
against the JAX package, on the CPU at a tiny size.

The port cannot reproduce threefry's numbers, so JAX's own draws are
injected: ``jax.random.categorical(k, logits)`` is ``argmax(logits +
jax.random.gumbel(k, logits.shape))``, and that Gumbel noise is handed to
the port.  In f32 the generated tokens and the mask must be equal, the
logprobs and reference logprobs agree within 1e-4, the helpfulness and
harmlessness rewards are bit-identical (sums of 0/1 counts, one division,
one sqrt: exact on both sides) and conciseness agrees within 1e-6 (a sum
of fractions in another order).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import prompts as jprompts  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.rlhf import ppo as jppo, rewards as jrewards  # noqa: E402
from repro.rlhf.sampling import generate as jgenerate  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import partition, prompts  # noqa: E402
from repro_torch.fed.engine import rollout_batch  # noqa: E402
from repro_torch.rlhf import ppo, rewards  # noqa: E402
from repro_torch.rlhf.sampling import generate  # noqa: E402

B, P, MAX_NEW, M = 2, 4, 8, 2
LENGTH_TOL = max(4, MAX_NEW // 2)       # the engine's choice


def _cfgs():
    jcfg = dataclasses.replace(
        jax_get_config("llama-3.2-1b").reduced(n_layers=2, d_model=64,
                                               vocab=256), n_kv_heads=2)
    tcfg = dataclasses.replace(
        get_config("llama-3.2-1b").reduced(n_layers=2, d_model=64,
                                           vocab=256), n_kv_heads=2)
    return jcfg, tcfg


def _params(seed: int):
    """f32 parameters with non-zero lora_B, as (JAX tree, torch tree)."""
    jcfg, _ = _cfgs()
    tree = jax.tree_util.tree_map(
        np.asarray, jT.init_params(jcfg, jax.random.PRNGKey(seed),
                                   dtype=jnp.float32))
    rng = np.random.default_rng(seed)

    def lora_b(t):
        if isinstance(t, dict):
            return {k: (rng.normal(0, 0.05, v.shape).astype(np.float32)
                        if k == "lora_B" else lora_b(v))
                    for k, v in t.items()}
        return t

    tree = lora_b(tree)
    return jax.tree_util.tree_map(jnp.asarray, tree), \
        bridge.to_torch(tree, device="cpu")


def _gumbel(key, n: int, shape) -> np.ndarray:
    """The noise ``n`` successive jax.random.categorical draws add."""
    return np.stack([np.asarray(jax.random.gumbel(k, shape))
                     for k in jax.random.split(key, n)])


def _prompts(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (B, P)).astype(
        np.int32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------- generate
def test_generate_with_injected_gumbel_matches_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(0)
    prompt = _prompts(1)
    key = jax.random.PRNGKey(7)
    jtok, jlp, jmask = jgenerate(jcfg, jp, jnp.asarray(prompt), key,
                                 max_new=MAX_NEW)
    noise = _gumbel(key, MAX_NEW, (B, tcfg.vocab))
    ttok, tlp, tmask = generate(tcfg, tp, _t(prompt), max_new=MAX_NEW,
                                gumbel=_t(noise))
    assert ttok.shape == (B, P + MAX_NEW)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp),
                               rtol=1e-4, atol=1e-4)


def test_generate_needs_one_noise_source():
    _, tcfg = _cfgs()
    _, tp = _params(0)
    with pytest.raises(ValueError, match="exactly one"):
        generate(tcfg, tp, _t(_prompts(1)), max_new=2)


def test_generate_is_deterministic_given_the_generator():
    _, tcfg = _cfgs()
    _, tp = _params(0)
    outs = [generate(tcfg, tp, _t(_prompts(2)), max_new=4,
                     generator=torch.Generator().manual_seed(3))[0]
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    assert int(outs[0].min()) >= 0 and int(outs[0].max()) < tcfg.vocab


# ---------------------------------------------------------------- rewards
@pytest.mark.parametrize("variant", ["default", "alt"])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_rewards_match_jax(variant, m):
    rng = np.random.default_rng(m)
    tokens = rng.integers(0, 256, (4, 12)).astype(np.int32)
    tokens[:, 8:] = tokens[:, 4:8]               # some repeats
    mask = np.concatenate([np.zeros((4, 4)), np.ones((4, 8))],
                          1).astype(np.float32)
    mask[3, 10:] = 0.0                            # a shorter response
    jh, jx = jrewards.variant_bands(256, variant)
    th, tx = rewards.variant_bands(256, variant)
    assert (tuple(np.asarray(jh)), tuple(np.asarray(jx))) == (th, tx)
    want = np.asarray(jrewards.score_batch_banded(
        jh, jx, jnp.asarray(tokens), jnp.asarray(mask), m, LENGTH_TOL))
    got = rewards.score_batch_banded(th, tx, _t(tokens), _t(mask), m,
                                     LENGTH_TOL).numpy()
    assert got.shape == (4, m)
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    fns = rewards.make_reward_fns(256, m, variant, LENGTH_TOL)
    np.testing.assert_array_equal(
        rewards.score_batch(fns, _t(tokens), _t(mask)).numpy(), got)


def test_token_logprobs_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 6, 32), dtype=np.float32)
    tokens = rng.integers(0, 32, (2, 6)).astype(np.int32)
    want = jppo.token_logprobs(jnp.asarray(logits), jnp.asarray(tokens))
    got = ppo.token_logprobs(_t(logits), _t(tokens))
    assert got[:, 0].abs().max() == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------- the whole slice
def test_rollout_batch_matches_jax_engine_path():
    """rollout_batch == the JAX engine's generate, score_batch_banded,
    reference forward_seq and token_logprobs, with a policy that differs
    from the reference."""
    jcfg, tcfg = _cfgs()
    jpol, tpol = _params(0)
    jref, tref = _params(5)
    prompt = _prompts(3)
    key = jax.random.PRNGKey(11)
    jh, jx = jrewards.variant_bands(256, "alt")
    jtok, jlp, jmask = jgenerate(jcfg, jpol, jnp.asarray(prompt), key,
                                 max_new=MAX_NEW)
    jr = jrewards.score_batch_banded(jh, jx, jtok, jmask, M, LENGTH_TOL)
    jref_lp = jppo.token_logprobs(
        jT.forward_seq(jcfg, jref, jtok)["logits"], jtok)

    th, tx = rewards.variant_bands(256, "alt")
    batch = rollout_batch(tcfg, tpol, tref, _t(prompt), th, tx,
                          n_objectives=M, max_new=MAX_NEW,
                          length_tol=LENGTH_TOL,
                          gumbel=_t(_gumbel(key, MAX_NEW, (B, tcfg.vocab))))
    assert isinstance(batch, ppo.PPOBatch)
    np.testing.assert_array_equal(batch.tokens.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(batch.response_mask.numpy(),
                                  np.asarray(jmask))
    np.testing.assert_allclose(batch.old_logprobs.numpy(), np.asarray(jlp),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(batch.ref_logprobs.numpy(),
                               np.asarray(jref_lp), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(batch.rewards.numpy(), np.asarray(jr))
    assert batch.rewards.shape == (B, M)


# ---------------------------------------------------------------- prompts
def test_prompts_with_injected_draws_match_jax():
    vocab, seed = 256, 4
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                         (prompts.N_TOPICS, vocab)))
    want_table = np.asarray(jprompts.topic_logits(vocab, seed=seed))
    table = prompts.topic_logits(vocab, noise=_t(noise), device="cpu")
    np.testing.assert_array_equal(table.numpy(), want_table)

    topics = np.array([0, 3, 7], np.int32)
    key = jax.random.PRNGKey(9)
    want = jprompts.sample_prompts(key, jnp.asarray(topics), 6, vocab,
                                   seed=seed)
    got = prompts.sample_prompts(table, _t(topics), 6,
                                 gumbel=_t(_gumbel(key, 6, (3, vocab))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prompt_dataset_streams():
    mix = np.zeros(prompts.N_TOPICS, np.float32)
    mix[2] = 1.0
    ds = prompts.PromptDataset(256, 5, mix,
                               generator=torch.Generator().manual_seed(0),
                               device="cpu")
    a, b = ds.next_batch(64), ds.next_batch(64)
    assert a.shape == (64, 5) and a.dtype == torch.int64
    assert not torch.equal(a, b)
    band = 256 // prompts.N_TOPICS
    in_band = ((a >= 2 * band) & (a < 3 * band)).float().mean()
    # topic 2's band holds 32 e^2 / (32 e^2 + 224) ~ 0.51 of the mass,
    # against 32 / 256 = 0.125 for a flat distribution
    assert 0.35 < in_band < 0.67


def test_dirichlet_mixtures_moments():
    g = torch.Generator().manual_seed(0)
    alpha, t = 0.3, prompts.N_TOPICS
    mix = partition.dirichlet_topic_mixtures(4000, alpha, generator=g,
                                             device="cpu")
    assert mix.shape == (4000, t) and bool((mix >= 0).all())
    np.testing.assert_allclose(mix.sum(-1).numpy(), 1.0, atol=1e-5)
    # Dir(alpha * 1): mean 1/T, var (1/T)(1 - 1/T) / (T alpha + 1)
    var = (1 / t) * (1 - 1 / t) / (t * alpha + 1)
    np.testing.assert_allclose(mix.mean(0).numpy(), 1 / t, atol=0.01)
    np.testing.assert_allclose(mix.var(0).numpy(), var, rtol=0.15)
    ds = partition.make_client_datasets(3, 256, 4, generator=g, device="cpu")
    assert [d.next_batch(2).shape for d in ds] == [(2, 4)] * 3
