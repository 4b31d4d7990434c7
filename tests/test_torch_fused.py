"""The port's fused multi-round executor
(``FederatedTrainer.run_rounds_fused``) and the codecs' traced contract
(``roundtrip_traced*``) against the port's per-round path and the JAX
package, on the CPU at a tiny size.

* (a) the traced roundtrip of every codec spec of the reference's
  ``test_nbytes_static_matches_measured`` is the host roundtrip bit for
  bit, the state threaded over three steps, and both are the JAX host
  roundtrip's as ``tests/test_torch_codec.py`` holds it: bit for bit
  given the same rounding bits, the low-rank codec within 1e-5 of its
  scale given the same omega;
* (b) ``nbytes_static`` is the measured ``Payload.nbytes`` and the JAX
  ``nbytes_static``, exactly;
* (c) the stacked traced roundtrip is the host stacked roundtrip, the
  states (error-feedback residuals, delta references) included, and each
  row is the one-row traced roundtrip;
* (d) ``Payload.nbytes_entropy`` is the JAX payload's, exactly;
* (e) on the port alone, fused chunks are the per-round rounds bit for
  bit: summaries (but ``dispatches`` and ``fused``), the global adapters,
  every client state, the codec states, the prompt streams and the main
  stream; and a chunk after the first reads nothing back to the host;
* (f) what the fused executor cannot run raises and runs per round;
* (g) a fused chunk of the port against the JAX fused chunk of the same
  tiny llama, the JAX draws replayed from its key and injected: the
  summaries within the tolerances of ``tests/test_torch_round.py``;
* (h) ``round_summary`` with the ``fused`` key is the reference's.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.comms import make_codec as jmake_codec  # noqa: E402
from repro.configs.base import FIRMConfig as JFIRMConfig  # noqa: E402
from repro.data.partition import sample_prompt_block  # noqa: E402
from repro.fed import engine as jengine  # noqa: E402
from repro.obs import records as jrecords  # noqa: E402
from repro_torch import bridge, trees  # noqa: E402
from repro_torch.comms import lowrank as tlowrank  # noqa: E402
from repro_torch.comms import make_codec  # noqa: E402
from repro_torch.configs import FIRMConfig, get_config  # noqa: E402
from repro_torch.fed import api  # noqa: E402
from repro_torch.fed.engine import EngineConfig, FederatedTrainer  # noqa
from repro_torch.obs import records  # noqa: E402
from repro_torch.rlhf import local  # noqa: E402
from repro_torch.rlhf.update_graph import _state_leaves  # noqa: E402
from test_torch_codec import _bits_t, _spec, _t, assert_same_bits  # noqa
from test_torch_round import (  # noqa: E402
    KL_ATOL, STEP_TOL, TOL, _cfgs, _f32_model, _snapshot, assert_close)

# the reference's test_nbytes_static_matches_measured specs
SPECS = ["identity", "int8", "int4", "topk:0.05", "lowrank:4", "int8+ef",
         "int4+ef", "topk:0.05+ef", "delta+int8", "delta+int8+ef"]
D = 5000


# ------------------------------------------------------------ the codecs
def _draw(spec: str, key, d: int):
    """The port's injected form of the draw the JAX codec makes from
    ``key`` for a d-element vector: rounding bits, omega or nothing."""
    if "lowrank" in spec:
        _, b = tlowrank._matrix_shape(d)
        return _t(np.asarray(jax.random.normal(key, (b, 4), jnp.float32)))
    if "int" in spec:
        return _bits_t(np.asarray(jax.random.bits(
            key, (-(-d // 1024), 1024), jnp.uint32)))
    return None


def _same_state(got, want):
    """Codec states bit for bit; a host None is a state of zeros."""
    if isinstance(want, tuple) or isinstance(got, tuple):
        for g, w in zip(got, want, strict=True):
            _same_state(g, w)
    elif got is None or want is None:
        other = want if got is None else got
        assert other is None or not bool(other.any())
    else:
        assert_same_bits(got, want)


def _close(got, want, what):
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(g - w).max())
    assert err <= 1e-5 * float(np.abs(w).max()), (what, err)


@pytest.mark.parametrize("spec", SPECS)
def test_traced_roundtrip_is_the_host_roundtrip_and_the_references(spec):
    """(a) Three steps, the state threaded on each path."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(D) * 0.01).astype(np.float32)
    jspec, tspec = _spec(D)
    jc, tc = jmake_codec(spec), make_codec(spec)
    host, jstate = None, None
    traced = tc.init_state_traced(D, None, device="cpu")
    for t in range(3):
        x = x + (rng.standard_normal(D) * 0.005).astype(np.float32)
        key = jax.random.PRNGKey(100 + t)
        draw = _draw(spec, key, D)
        _, host, dec_h = tc.roundtrip_flat(_t(x), tspec, host, bits=draw)
        dec_t, traced = tc.roundtrip_traced(_t(x), traced, bits=draw)
        assert_same_bits(dec_t, dec_h, f"step {t} decoded")
        _same_state(tc.state_to_host(traced), host)
        _, jstate, dec_j = jc.roundtrip_flat(jnp.asarray(x), jspec, jstate,
                                             key=key)
        if "lowrank" in spec:
            _close(dec_h, dec_j, f"step {t} decoded")
        else:
            assert_same_bits(dec_h, np.asarray(dec_j), f"step {t} decoded")
            _same_state(host, jax.tree_util.tree_map(
                lambda a: _t(np.asarray(a)), jstate))


@pytest.mark.parametrize("spec", SPECS)
def test_nbytes_static_is_the_measured_bytes_and_the_references(spec):
    """(b)"""
    tc = make_codec(spec)
    for d in (1000, 4096, 50000):
        flat = torch.from_numpy((np.random.default_rng(d).standard_normal(
            d) * 0.01).astype(np.float32))
        payload, _, _ = tc.roundtrip_flat(flat, _spec(d)[1])
        assert tc.nbytes_static(d) == payload.nbytes == \
            jmake_codec(spec).nbytes_static(d), d


@pytest.mark.parametrize("spec", SPECS)
def test_stacked_traced_roundtrip_is_the_host_stacked_roundtrip(spec):
    """(c) C = 3 rows from carried states (residuals, references)."""
    c = 3
    rng = np.random.default_rng(2)
    flats = _t((rng.standard_normal((c, D)) * 0.01).astype(np.float32))
    _, tspec = _spec(D)
    tc = make_codec(spec)

    def vec():
        return _t((rng.standard_normal(D) * 1e-4).astype(np.float32))
    residual = (lambda: vec()) if spec.endswith("+ef") else (lambda: None)
    host = [((vec(), residual()) if spec.startswith("delta+")
             else residual()) for _ in range(c)]
    keys = [jax.random.PRNGKey(200 + i) for i in range(c)]
    draws = [_draw(spec, k, D) for k in keys]
    bits = None if draws[0] is None else torch.stack(draws)
    traced = tc.init_states_traced(D, host, device="cpu")
    _, new_host, dec_h = tc.roundtrip_stacked(flats, tspec, host, bits=bits)
    dec_t, new_traced = tc.roundtrip_traced_stacked(flats, traced, bits=bits)
    assert_same_bits(dec_t, dec_h, "decoded")
    for i, (g, w) in enumerate(zip(tc.states_to_host(new_traced, c),
                                   new_host, strict=True)):
        _same_state(g, w)
        row, _ = tc.roundtrip_traced(
            flats[i], tc.init_state_traced(D, host[i], device="cpu"),
            bits=draws[i])
        assert_same_bits(row, dec_t[i], f"row {i}")


def test_nbytes_entropy_is_the_references():
    """(d) The reference's data: a delta with most of its mass at zero."""
    rng = np.random.default_rng(3)
    d = 50000
    flat = (rng.standard_normal(d) * 0.01
            * (rng.uniform(size=d) < 0.2)).astype(np.float32)
    jspec, tspec = _spec(d)
    key = jax.random.PRNGKey(3)
    for spec in ("int8", "int4", "topk:0.05", "identity"):
        jp, _, _ = jmake_codec(spec).roundtrip_flat(jnp.asarray(flat), jspec,
                                                    None, key=key)
        tp, _, _ = make_codec(spec).roundtrip_flat(
            _t(flat), tspec, None, bits=_draw(spec, key, d))
        assert type(tp.nbytes_entropy) is int
        assert tp.nbytes_entropy == jp.nbytes_entropy, spec
        if spec == "identity":
            assert tp.nbytes_entropy == tp.nbytes
        else:
            assert 0 < tp.nbytes_entropy < tp.nbytes


# ------------------------------------------- fused against per round
def _trainer(*, algorithm="firm", up="int8+ef", down="identity",
             n_clients=2, participation=1.0, steps=None, fused_rounds=1,
             zamba2=False, vectorized=True):
    _, tcfg = _cfgs()
    if zamba2:
        tcfg = get_config("zamba2-1.2b").reduced(n_layers=2, d_model=64,
                                                 vocab=64)
    fc = dataclasses.replace(FIRMConfig(), n_clients=n_clients,
                             local_steps=1, batch_size=2, n_objectives=2,
                             participation=participation,
                             client_local_steps=steps)
    ec = EngineConfig(algorithm=algorithm, prompt_len=4, max_new=4,
                      uplink_codec=up, downlink_codec=down,
                      fused_rounds=fused_rounds,
                      vectorized_clients=vectorized)
    return FederatedTrainer(tcfg, fc, ec, device="cpu")


def _same_trainer(a, b):
    """Bit for bit: the global adapters, every client state, the codec
    states, the prompt streams, the main stream, the round count and the
    ledger."""
    for x, y in zip(trees.tree_leaves(a.global_trainable),
                    trees.tree_leaves(b.global_trainable), strict=True):
        assert torch.equal(x, y)
    for sa, sb in zip(a.client_states, b.client_states, strict=True):
        for x, y in zip(_state_leaves(sa), _state_leaves(sb), strict=True):
            assert torch.equal(x, y)
    for x, y in zip(a._uplink_state, b._uplink_state, strict=True):
        _same_state(x, y)
    _same_state(a._downlink_state, b._downlink_state)
    assert [ds.count for ds in a.datasets] == [ds.count for ds in b.datasets]
    assert torch.equal(a._rng.get_state(), b._rng.get_state())
    assert a._round_idx == b._round_idx
    assert a.ledger == b.ledger


FUSED_CASES = {
    "firm identity": (dict(up="identity"), 3, 3),
    "firm int8+ef": (dict(), 3, 3),
    "linear identity": (dict(algorithm="linear", up="identity"), 3, 3),
    "linear int8+ef": (dict(algorithm="linear"), 3, 3),
    "delta+int8 down": (dict(down="delta+int8"), 3, 3),
    "mobile": (dict(up="int4+ef", down="int8"), 2, 2),
    "participation 0.5 of 4": (dict(n_clients=4, participation=0.5), 3, 3),
    "tail of 1": (dict(), 2, 3),
    "client_local_steps 2,2": (dict(steps=(2, 2)), 2, 2),
    "zamba2": (dict(zamba2=True), 2, 2),
}


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_chunks_are_the_per_round_rounds_bit_for_bit(case):
    """(e) ``run(R)`` with ``fused_rounds`` against ``run(R)`` per round
    from the same seed."""
    kw, chunk, rounds = FUSED_CASES[case]
    per_round, fused = _trainer(**kw), _trainer(fused_rounds=chunk, **kw)
    assert fused.plan.executor == "fused"
    hp, hf = per_round.run(rounds), fused.run(rounds)
    _same_trainer(per_round, fused)
    for r, (sp, sf) in enumerate(zip(hp, hf, strict=True)):
        in_chunk = r < rounds - rounds % chunk or rounds % chunk > 1
        assert list(sf) == list(sp) + (["fused"] if in_chunk else [])
        for key in sp:
            if key != "dispatches":
                np.testing.assert_array_equal(np.asarray(sf[key]),
                                              np.asarray(sp[key]), key)
        if in_chunk:
            assert sf["fused"] == chunk and sf["cohorts"] == 1
            assert sf["dispatches"] == 3.0 / chunk
        else:
            assert sf["dispatches"] == sp["dispatches"]
    if case == "participation 0.5 of 4":
        assert all(len(s["participants"]) == 2 for s in hf)
        assert [s["participants"] for s in hf] == [
            fused._sample_participants(round_idx=r) for r in range(rounds)]
    if case == "client_local_steps 2,2":
        assert hf[0]["local_steps"] == [2, 2]


class _HostReads(TorchDispatchMode):
    """Records every op that reads a tensor back to the host or makes one
    from host data (on the card: a copy from the host), outside the
    trainer's host-side main stream."""

    BANNED = {torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero,
              torch.ops.aten.item, torch.ops.aten.equal,
              torch.ops.aten.lift_fresh}

    def __init__(self):
        super().__init__()
        self.found, self.paused = [], False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in self.BANNED and not self.paused:
            self.found.append(str(func))
        return func(*args, **(kwargs or {}))


def test_a_chunk_after_the_first_reads_nothing_back():
    """(e) The second chunk (the first makes the run's constants) of a
    ``wan`` trainer makes no host read and no tensor from host data, but
    for the main stream's draws (host-side by design) and the
    participants, worked out before the chunk's rounds."""
    tr = _trainer(n_clients=4, participation=0.5, fused_rounds=2)
    tr.run_rounds_fused(2)
    spy = _HostReads()

    def paused(fn):
        def run(*a, **kw):
            spy.paused = True
            try:
                return fn(*a, **kw)
            finally:
                spy.paused = False
        return run
    tr._next_key = paused(tr._next_key)
    tr._sample_participants = paused(tr._sample_participants)
    with spy:
        tr.run_rounds_fused(2)
    assert spy.found == []


def test_a_chunk_that_raises_leaves_the_trainer_as_run_round_would():
    """A round that raises in the middle of a chunk: the rounds before it
    are on the record, and the trainer is where the same rounds through
    ``run_round`` leave it, the last one raising at the same point; both
    then carry on alike."""
    per_round, fused = _trainer(), _trainer(fused_rounds=3)
    for tr in (per_round, fused):
        def failing(*a, _phase=tr._local_phase, _calls=[], **kw):
            _calls.append(None)
            if len(_calls) == 2:
                raise RuntimeError("a failed round")
            return _phase(*a, **kw)
        tr._local_phase = failing
    per_round.run_round()
    with pytest.raises(RuntimeError, match="a failed round"):
        per_round.run_round()
    with pytest.raises(RuntimeError, match="a failed round"):
        fused.run_rounds_fused(3)
    assert [s["fused"] for s in fused.history] == [3]
    _same_trainer(per_round, fused)
    hp, hf = per_round.run(2), fused.run(2)
    _same_trainer(per_round, fused)
    assert [s["fused"] for s in hf] == [3, 2, 2]
    for sp, sf in zip(hp, hf, strict=True):
        for key in sp:
            if key != "dispatches":
                np.testing.assert_array_equal(np.asarray(sf[key]),
                                              np.asarray(sp[key]), key)


# ------------------------------------------------------------- the gating
@pytest.mark.parametrize("kw", [dict(algorithm="fedcmoo"),
                                dict(vectorized=False),
                                dict(steps=(1, 2))],
                         ids=["fedcmoo", "loop", "heterogeneous K"])
def test_what_cannot_fuse_raises_and_runs_per_round(kw):
    """(f)"""
    tr = _trainer(fused_rounds=4, **kw)
    assert not tr._fused_mode()[0] and tr.plan.executor != "fused"
    with pytest.raises(ValueError, match="fused_rounds"):
        tr.run_rounds_fused(2)
    assert tr.history == [] and tr.ledger.total == 0
    hist = tr.run(2)
    assert len(hist) == 2 and all("fused" not in s for s in hist)
    assert _trainer()._fused_mode()[0]


# --------------------------------------------------- against the JAX chunk
C, K, B, P, MAX_NEW, M, R = 2, 1, 2, 4, 8, 2, 3


def _split(r):
    out = jax.random.split(r)
    return out[0], out[1]


def _chunk_draws(jtr, jcfg, rounds):
    """The draws of the JAX trainer's next ``rounds`` rounds, replayed
    from its key in ``run_round``'s order (the downlink key, K x C
    generation keys step-major, C uplink keys), as the port's injected
    draws: one dict a round."""
    rng, counts = jtr._rng, [ds._count for ds in jtr.datasets]
    rows = -(-jtr.d_trainable // 1024)
    idx = jnp.arange(C, dtype=jnp.int32)
    out = []
    for _ in range(rounds):
        rng, _down = _split(rng)
        gen = [[None] * C for _ in range(K)]
        for k in range(K):
            for c in range(C):
                rng, gen[k][c] = _split(rng)
        up = []
        for _ in range(C):
            rng, kk = _split(rng)
            up.append(kk)
        c0 = jnp.asarray(counts, jnp.int32)
        prompts = np.stack([np.asarray(sample_prompt_block(
            jtr._seeds_all[idx], c0 + k, jtr._probs_all[idx], B, P,
            jcfg.vocab)) for k in range(K)])
        gumbel = np.stack([np.stack([np.stack([
            np.asarray(jax.random.gumbel(s, (B, jcfg.vocab)))
            for s in jax.random.split(gen[k][c], MAX_NEW)])
            for c in range(C)]) for k in range(K)])
        out.append({
            "prompts": torch.from_numpy(prompts).long(),
            "gumbel": torch.from_numpy(gumbel),
            "up_bits": torch.from_numpy(np.stack([np.asarray(
                jax.random.bits(kk, (rows, 1024), jnp.uint32)).view(
                    np.int32) for kk in up]))})
        counts = [n + K for n in counts]
    return out


def test_fused_chunk_matches_the_jax_fused_chunk():
    """(g) R = 3 rounds of ``wan`` (C = 2, K = 1) as one chunk on each
    side from the same f32 state, the JAX draws injected.  Held as
    ``test_round_matches_jax_vectorized_round`` holds a round: bytes,
    participants, ``dispatches``, ``fused`` and rewards exact; drift 1e-4
    of its scale; KL 1e-6 absolute; lambda 1e-4 and the global adapters'
    move over actor_lr 1e-2 of their scale, each over min(1, D), D the
    smallest MGDA curvature of the chunk's client-steps (from the port's
    Gram matrices)."""
    jcfg, tcfg = _cfgs()
    jfc = dataclasses.replace(JFIRMConfig(), n_clients=C, local_steps=K,
                              batch_size=B, n_objectives=M)
    tfc = dataclasses.replace(FIRMConfig(), n_clients=C, local_steps=K,
                              batch_size=B, n_objectives=M)
    kw = dict(prompt_len=P, max_new=MAX_NEW, uplink_codec="int8+ef",
              fused_rounds=R)
    jtr = jengine.FederatedTrainer(jcfg, jfc, jengine.EngineConfig(**kw))
    params = bridge.to_torch(jax.tree_util.tree_map(np.asarray,
                                                    _f32_model(jtr)),
                             device="cpu")
    ttr = FederatedTrainer(tcfg, tfc, EngineConfig(**kw), device="cpu",
                           params=params)
    bridge.load_trainer_state(ttr, _snapshot(jtr))
    draws = _chunk_draws(jtr, jcfg, R)
    grams, step = [], local.firm_local_step

    def spy(*a, **k):
        st, met = step(*a, **k)
        grams.append(met["gram"].double().numpy())
        return st, met
    j0 = np.concatenate([np.asarray(x, np.float32).reshape(-1) for x in
                         jax.tree_util.tree_leaves(jtr.global_trainable)])
    t0 = np.concatenate([t.reshape(-1).numpy() for t in
                         trees.tree_leaves(ttr.global_trainable)])
    want = jtr.run_rounds_fused(R)
    local.firm_local_step = spy
    try:
        got = ttr.run_rounds_fused(R, draws=draws)
    finally:
        local.firm_local_step = step
    curv = [(q[0, 0] + q[1, 1] - 2 * q[0, 1]) for q in (
        g / (np.trace(g) / M) + 0.5 * tfc.beta * np.eye(M) for g in grams)]
    slack = 1 / min(1.0, min(curv))
    for r, (g, w) in enumerate(zip(got, want, strict=True)):
        assert list(g) == list(w)
        for key in ("comm_bytes", "up_bytes", "down_bytes", "participants",
                    "dispatches", "up_nbytes", "down_nbytes", "local_steps",
                    "cohorts", "fused"):
            assert g[key] == w[key], (r, key)
        np.testing.assert_array_equal(g["rewards_per_client"],
                                      w["rewards_per_client"])
        np.testing.assert_array_equal(g["rewards"], w["rewards"])
        assert_close(g["param_drift"], w["param_drift"], TOL, "drift")
        assert abs(g["kl"] - w["kl"]) <= KL_ATOL, (r, g["kl"], w["kl"])
        for key in ("lam_mean", "per_client_lam", "lam_disagreement"):
            assert_close(g[key], w[key], TOL * slack, key)
    lr = tfc.actor_lr
    j1 = np.concatenate([np.asarray(x, np.float32).reshape(-1) for x in
                         jax.tree_util.tree_leaves(jtr.global_trainable)])
    t1 = np.concatenate([t.reshape(-1).numpy() for t in
                         trees.tree_leaves(ttr.global_trainable)])
    assert_close((t1 - t0) / lr, (j1 - j0) / lr, STEP_TOL * slack,
                 "the chunk's global move")
    assert got[-1]["fused"] == R and got[-1]["dispatches"] == 3 / R


def test_round_summary_with_fused_is_the_references():
    """(h)"""
    stats = {"rewards": np.ones(2), "lam_mean": np.ones(2) / 2,
             "lam_disagreement": np.float32(0.1), "param_drift": 2.0,
             "kl": np.float32(-0.5), "per_client_lam": np.ones((2, 2)) / 2,
             "rewards_per_client": np.ones((2, 2))}
    kw = dict(comm_bytes=10, up_bytes=4, down_bytes=6, participants=(0, 1),
              dispatches=1.5, up_nbytes=(2, 2), down_nbytes=3,
              local_steps=(1, 1), cohorts=1)
    for fused in (3, None):
        got = records.round_summary(stats=stats, fused=fused, **kw)
        want = jrecords.round_summary(stats=stats, fused=fused, **kw)
        assert list(got) == list(want)
        assert ("fused" in got) == (fused is not None)
        for key, val in want.items():
            assert type(got[key]) is type(val), key
            np.testing.assert_array_equal(got[key], val)
    plan = api.plan(api.RunSpec(_cfgs()[1], FIRMConfig(n_clients=2),
                                EngineConfig(fused_rounds=2)))
    assert plan.dispatches_per_round == 1.5
