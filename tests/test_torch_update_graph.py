"""The local update as a captured program (``rlhf/update_graph.py``) and the
host reads it had to lose, on the CPU at a tiny size.

On the card ``fed.algorithms``' ``firm`` and ``linear`` steps run through
``update_graph.UpdateGraphs``, which captures one update as a CUDA graph
and replays it.  Here the same runner is driven through a stand-in graph
(``_StandInGraph``): its capture runs the step and hands back outputs that
hold nothing yet (a capture executes nothing), and its replay runs the step
again into those outputs, leaving the kernels' launch counters where they
were (a replay runs no Python).  The counters are moved by a counting plain
rmsnorm and Gram (on the CPU nothing launches).  ``chip_smoke.py``'s
``update_graph`` phase holds the real graph to the eager step on the card
at full width.

Configs: llama-3.2-1b and zamba2-1.2b ``reduced(n_layers=2, d_model=64)``
as in ``test_torch_training.py`` (llama: vocab 256, 2 KV heads) and
``test_torch_hybrid_training.py`` (zamba2: vocab 64, SSD chunk 16), with
the JAX model's parameters (non-zero ``lora_B``) carried over by
``bridge``.  Tolerances against the JAX package as
``test_torch_training.py``'s: f32 within 1e-4 of the compared tensor's
scale, bf16 within 2e-2, the adapters' Adam steps within 1e-2 (where |g|
is near Adam's eps the step turns on the last bits of g).  Within the
port, bit for bit: the runner against the eager step, and the repaired
solver and reward formulas against the formulas they replace.
"""
import ast
import dataclasses
import gc
import inspect
import textwrap

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import FIRMConfig as JFIRMConfig  # noqa: E402
from repro.core import mgda as jmgda  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.rlhf import local as jlocal, ppo as jppo  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import FIRMConfig, get_config  # noqa: E402
from repro_torch.core import firm, mgda  # noqa: E402
from repro_torch.fed import algorithms  # noqa: E402
from repro_torch.fed.engine import EngineConfig, FederatedTrainer  # noqa
from repro_torch.kernels import counters, ops, ref  # noqa: E402
from repro_torch.kernels import gram as gram_mod  # noqa: E402
from repro_torch.kernels import rmsnorm as rn_mod  # noqa: E402
from repro_torch.models import attention, common, moe, transformer  # noqa
from repro_torch.rlhf import critic, kl, local, ppo  # noqa: E402
from repro_torch.rlhf import sampling, update_graph  # noqa: E402
from repro_torch.train import optim  # noqa: E402

B, P, NEW, M = 2, 4, 8, 2
S = P + NEW
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TOL = {"f32": 1e-4, "bf16": 2e-2}
MODELS = ("llama", "zamba2")
# the JAX side's op-by-op update on the 19-slot zamba2 takes a minute on
# the CPU: its parity runs on three slots, a Mamba2 layer before the
# shared block (no gradient) and one after it (its input's gradient), as
# test_torch_hybrid_training.py's rounds do
ZAMBA2_JAX_PATTERN = ("mamba2", "shared_attn", "mamba2")


def _cfgs(model: str):
    if model == "llama":
        return tuple(dataclasses.replace(
            get("llama-3.2-1b").reduced(n_layers=2, d_model=64, vocab=256),
            n_kv_heads=2) for get in (jax_get_config, get_config))
    if model == "mixtral":
        # a window of 8 that the batches' S crosses
        return tuple(dataclasses.replace(
            get("mixtral-8x7b").reduced(n_layers=2, d_model=64, vocab=64),
            sliding_window=8) for get in (jax_get_config, get_config))
    pattern = ZAMBA2_JAX_PATTERN if model == "zamba2, 3 slots" else None
    return tuple(dataclasses.replace(
        get("zamba2-1.2b").reduced(n_layers=2, d_model=64, vocab=64),
        ssm_chunk=16, **({} if pattern is None else dict(
            pattern=pattern, n_layers=len(pattern))))
        for get in (jax_get_config, get_config))


def _fcs(**kw):
    return (dataclasses.replace(JFIRMConfig(), n_objectives=M, batch_size=B,
                                **kw),
            dataclasses.replace(FIRMConfig(), n_objectives=M, batch_size=B,
                                **kw))


def _with_lora_b(tree, rng):
    if isinstance(tree, dict):
        return {k: (rng.normal(0, 0.05, v.shape).astype(np.float32)
                    if k == "lora_B" else _with_lora_b(v, rng))
                for k, v in tree.items()}
    return tree


def _setup(model: str, dt: str = "f32", seed: int = 0):
    """(jcfg, tcfg, JAX params, port params) holding the same values."""
    jcfg, tcfg = _cfgs(model)
    tree = jax.tree_util.tree_map(
        np.asarray, jT.init_params(jcfg, jax.random.PRNGKey(seed),
                                   dtype=JDT[dt]))
    tree = _with_lora_b(tree, np.random.default_rng(seed))
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
            bridge.to_torch(tree, device="cpu"))


def _batches(jcfg, jparams, n: int, seed: int = 0):
    """``n`` PPO batches as (JAX batch, port batch) pairs, made on the JAX
    side as ``test_torch_training.py`` makes them: random tokens, a ragged
    response mask, and the JAX model's logprobs plus noise as the
    behaviour and reference logprobs."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
        mask = np.concatenate([np.zeros((B, P)), np.ones((B, NEW))],
                              1).astype(np.float32)
        mask[1, -2:] = 0.0
        lp = np.asarray(jppo.token_logprobs(
            jT.forward_seq(jcfg, jparams, jnp.asarray(tokens))["logits"],
            jnp.asarray(tokens)), np.float32)
        old = (lp + rng.normal(0, 0.05, lp.shape) * mask).astype(np.float32)
        refl = (lp + rng.normal(0, 0.1, lp.shape) * mask).astype(np.float32)
        r = rng.uniform(0, 1, (B, M)).astype(np.float32)
        arrays = (tokens, mask, old, refl, r)
        out.append((jppo.PPOBatch(*map(jnp.asarray, arrays)),
                    ppo.PPOBatch(torch.from_numpy(tokens).long(),
                                 *map(torch.from_numpy, arrays[1:]))))
    return out


def _states(jtrain, d_model: int, seed: int = 0):
    """One client state on both sides, with a non-zero critic, lam and
    step so that every field of the update is exercised."""
    js = jlocal.init_client_state(jtrain, M, d_model, kl_coef=0.1)
    rng = np.random.default_rng(seed)
    js = js._replace(
        critic={"w": jnp.asarray(rng.normal(0, 0.3, (M, d_model)),
                                 jnp.float32)},
        lam=jnp.asarray([0.3, 0.7], jnp.float32),
        step=jnp.asarray(2 + seed, jnp.int32))
    return js, bridge.client_state_to_torch(
        jax.tree_util.tree_map(np.asarray, js), device="cpu")


def _flat(out) -> list:
    """(new state, metrics) -> the runner's flat order."""
    new_state, metrics = out
    return (update_graph._state_leaves(new_state)
            + [metrics[k] for k in sorted(metrics)])


def _same(got, want) -> bool:
    g, w = _flat(got), _flat(want)
    return len(g) == len(w) and all(
        a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
        for a, b in zip(g, w))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def assert_close(got, want, tol, what=""):
    """|got - want| <= tol * max(1, max|want|), element for element."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    limit = tol * max(1.0, float(np.abs(w).max()) if w.size else 1.0)
    err = float(np.abs(g - w).max()) if w.size else 0.0
    assert err <= limit, f"{what}: max abs err {err} > {limit}"


def assert_trees_close(got, want, tol, what=""):
    gl, wl = common.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        assert_close(g, w, tol, f"{what} leaf {i}")


# ---------------------------------------------------------------- stand-in
class _StandInGraph:
    """What a CUDA graph does, on the CPU: ``capture`` runs the step (so
    that Python runs and the counters move) but hands back outputs that
    hold only a sentinel, as a real capture computes nothing; ``replay``
    runs it again and writes the results into those outputs, leaving the
    launch counters where they were, as a real replay runs no Python."""

    def __init__(self, device):
        assert torch.device(device).type == "cpu"
        self.warms = self.captures = self.replays = 0

    def warm(self, fn):
        self.warms += 1
        return fn()

    def capture(self, fn):
        self.captures += 1
        outs, names = fn()
        self._fn = fn
        self._outs = [torch.full_like(t, 7) for t in outs]
        return self._outs, names

    def replay(self):
        self.replays += 1
        before = counters.read()
        outs, _ = self._fn()
        counters.add(counters.since(before), -1)
        update_graph._copy(self._outs, outs)


class _GCRecordingGraph(_StandInGraph):
    """Records whether Python's garbage collector was on in its capture."""

    def capture(self, fn):
        self.gc_in_capture = gc.isenabled()
        return super().capture(fn)


class _FailingGraph(_StandInGraph):
    def capture(self, fn):
        raise RuntimeError("operation not permitted when stream is capturing")


@pytest.fixture
def counting_kernels(monkeypatch):
    """The plain rmsnorm and Gram, counted as the kernels' wrappers
    count."""
    def rms(x, g, eps=1e-5, *, use_kernel=True):
        rn_mod.launches += 1
        return ref.rmsnorm(x, g, eps)

    def gram(x, *, use_kernel=True):
        gram_mod.launches += 1
        return ref.gram(x)

    monkeypatch.setattr(ops, "rmsnorm", rms)
    monkeypatch.setattr(ops, "gram", gram)
    counters.zero()
    yield
    counters.zero()


def _client(model: str, seed: int = 0, dt: str = "f32"):
    """(tcfg, tfc, frozen, states A and B, 3 batches) on the port's side."""
    jcfg, tcfg, jp, tp = _setup(model, dt, seed)
    train, frozen = common.split_trainable(tp)
    _, tfc = _fcs()
    a = local.init_client_state(train, M, tcfg.d_model, device="cpu")
    b = local.init_client_state(
        common.tree_map(lambda t: t * 0.5, train), M, tcfg.d_model,
        device="cpu")._replace(critic={"w": torch.full((M, tcfg.d_model),
                                                       0.01)})
    batches = [tb for _, tb in _batches(jcfg, jp, 3, seed)]
    return tcfg, tfc, frozen, a, b, batches


def _step(alg_name, tcfg, tfc, state, frozen, batch, graphs, pref=None):
    alg = algorithms.get_algorithm(alg_name)
    extra = alg.traced_extra(tfc, EngineConfig(linear_weights=(0.6, 0.4)),
                             device="cpu")
    return alg.step(tcfg, alg.resolve_config(tfc), state, frozen, batch,
                    pref, extra, graphs)


# ------------------------------------------------------------------ runner
@pytest.mark.parametrize("alg_name", ["firm", "linear"])
@pytest.mark.parametrize("model", MODELS)
def test_runner_matches_the_eager_step_bit_for_bit(model, alg_name,
                                                   counting_kernels):
    """Clients A and B take three carried updates in the order A, B, A:
    through the runner (warm, capture and replay, replay) they are the
    eager step's bit for bit, new states and every metric, and the launch
    counters come out equal to the eager steps': the capture's taken
    back, a replay's added each replay."""
    tcfg, tfc, frozen, a, b, batches = _client(model)
    order = (("A", 0), ("B", 1), ("A", 2))
    want, states = [], {"A": a, "B": b}
    for name, k in order:
        out = _step(alg_name, tcfg, tfc, states[name], frozen, batches[k],
                    None)
        states[name] = out[0]
        want.append(out)
    want_counts = counters.read()
    assert want_counts["rmsnorm"] > 0
    assert want_counts["gram"] == (3 if alg_name == "firm" else 0)
    counters.zero()
    graphs = update_graph.UpdateGraphs(_StandInGraph)
    got, states = [], {"A": a, "B": b}
    for name, k in order:
        out = _step(alg_name, tcfg, tfc, states[name], frozen, batches[k],
                    graphs)
        states[name] = out[0]
        got.append(out)
    assert counters.read() == want_counts
    assert [_same(g, w) for g, w in zip(got, want)] == [True] * 3
    g = graphs.graph(alg_name, tcfg, tfc, a, frozen, batches[0],
                     (firm.config_tensor(tfc.beta, a.lam.device),)
                     if alg_name == "firm" else (torch.zeros(M),))
    assert (g.warms, g.captures, g.replays) == (1, 1, 2)
    assert graphs.captures == 1


@pytest.mark.parametrize("model,dt", [("llama", "f32"), ("llama", "bf16"),
                                      ("zamba2, 3 slots", "f32")])
def test_three_carried_steps_match_jax(model, dt):
    """Three carried updates through the runner against JAX's
    firm_local_step on the same states and batches."""
    jcfg, tcfg, jp, tp = _setup(model, dt, seed=1)
    jtrain, jfrozen = jcommon.split_trainable(jp)
    _, tfrozen = common.split_trainable(tp)
    jfc, tfc = _fcs()
    js, ts = _states(jtrain, jcfg.d_model, seed=1)
    graphs = update_graph.UpdateGraphs(_StandInGraph)
    firm_alg = algorithms.get_algorithm("firm")
    for k, (jb, tb) in enumerate(_batches(jcfg, jp, 3, seed=1)):
        js_prev, ts_prev = js, ts
        js, jm = jlocal.firm_local_step(jcfg, jfc, js, jfrozen, jb)
        ts, tm = firm_alg.step(tcfg, tfc, ts, tfrozen, tb, None, None,
                               graphs)
        tol = TOL[dt]
        for key in ("lam", "lam_star", "gram", "losses", "kl", "td_err",
                    "grad_norm", "rewards"):
            assert_close(tm[key], jm[key], tol, f"step {k} {key}")
        assert_trees_close(ts.opt.mu, js.opt.mu, tol, f"step {k} mu")
        assert_trees_close(ts.opt.nu, js.opt.nu, tol, f"step {k} nu")
        assert_close(ts.critic["w"], js.critic["w"], tol, f"step {k} critic")
        assert_close(ts.kl_coef, js.kl_coef, tol, f"step {k} kl_coef")
        assert int(ts.step) == int(js.step) and int(ts.opt.count) == int(
            js.opt.count)
        if dt == "bf16":
            # in bf16 the gradients agree to 2e-2 only, and Adam's early
            # steps are ~sign(g): where g is near 0 they flip, so the
            # adapters themselves are held to the bf16 tolerance
            assert_trees_close(ts.trainable, js.trainable, tol,
                               f"step {k} adapters")
            continue
        for i, (n, o, jn, jo) in enumerate(zip(
                common.tree_leaves(ts.trainable),
                common.tree_leaves(ts_prev.trainable),
                jax.tree_util.tree_leaves(js.trainable),
                jax.tree_util.tree_leaves(js_prev.trainable))):
            assert_close((n.float() - o.float()) / tfc.actor_lr,
                         (_np(jn) - _np(jo)) / jfc.actor_lr, 1e-2,
                         f"step {k} Adam step {i}")
    assert graphs.captures == 1


def test_the_callers_state_and_the_shared_broadcast_are_untouched():
    """Two clients adopt the same broadcast adapters, as the round's
    participants do: after each one's update through the runner, the
    broadcast and every input state hold their values."""
    tcfg, tfc, frozen, a, b, batches = _client("llama")
    broadcast = a.trainable
    states = [a, b._replace(trainable=broadcast)]
    before = [[t.clone() for t in update_graph._state_leaves(s)]
              for s in states]
    graphs = update_graph.UpdateGraphs(_StandInGraph)
    for k in range(4):
        _step("firm", tcfg, tfc, states[k % 2], frozen, batches[k % 3],
              graphs)
    for s, bef in zip(states, before):
        assert all(torch.equal(x, y) for x, y in zip(
            update_graph._state_leaves(s), bef))
    assert all(x is y for x, y in zip(common.tree_leaves(broadcast),
                                      common.tree_leaves(a.trainable)))


def test_tensors_handed_back_do_not_change_at_the_next_call():
    """The outputs of a replayed call are fresh tensors: the next replay
    leaves them as they were, and none of them is a static buffer."""
    tcfg, tfc, frozen, a, b, batches = _client("llama")
    graphs = update_graph.UpdateGraphs(_StandInGraph)
    _step("firm", tcfg, tfc, a, frozen, batches[0], graphs)
    out = _step("firm", tcfg, tfc, b, frozen, batches[1], graphs)
    kept = [t.clone() for t in _flat(out)]
    _step("firm", tcfg, tfc, a, frozen, batches[2], graphs)
    assert all(torch.equal(x, y) for x, y in zip(_flat(out), kept))
    (entry,) = graphs._entries.values()
    static = {t.data_ptr() for t in entry.inputs + entry.outputs}
    assert not static & {t.data_ptr() for t in _flat(out)}


@pytest.mark.parametrize("change", ["new frozen tree", "trace_normalize",
                                    "solver_iters", "algorithm",
                                    "batch shape"])
def test_what_changes_the_program_means_a_new_capture(change):
    """A new frozen tree (the same values at new addresses), a field the
    update reads, another algorithm or another batch shape is another
    key: two more calls capture a second graph."""
    tcfg, tfc, frozen, a, b, batches = _client("llama")
    graphs = update_graph.UpdateGraphs(_StandInGraph)
    for k in range(2):
        _step("firm", tcfg, tfc, a, frozen, batches[k], graphs)
    alg_name, batch = "firm", batches[2]
    if change == "new frozen tree":
        frozen = common.tree_map(lambda t: t.clone(), frozen)
    elif change == "trace_normalize":
        tfc = dataclasses.replace(tfc, trace_normalize=False)
    elif change == "solver_iters":
        tfc = dataclasses.replace(tfc, solver_iters=7)
    elif change == "algorithm":
        alg_name = "linear"
    else:
        batch = ppo.PPOBatch(*(t[:1] for t in batch))
    want = _step(alg_name, tcfg, tfc, b, frozen, batch, None)
    for _ in range(2):
        got = _step(alg_name, tcfg, tfc, b, frozen, batch, graphs)
    assert graphs.captures == 2 and len(graphs._entries) == 2
    assert _same(got, want)


@pytest.mark.parametrize("change", ["local_steps", "client_local_steps",
                                    "n_clients and rounds",
                                    "a second client's preference",
                                    "beta",
                                    "in-place write to frozen"])
def test_what_leaves_the_program_alone_needs_no_capture(change):
    """Fields the update never reads (K, the cohort's K, the client count),
    a second client with its own preference, another beta (an operand,
    as the preference is) and an in-place write to a leaf of the frozen
    tree replay the graph as it is, and the result is the eager step's on
    the new inputs."""
    tcfg, tfc, frozen, a, b, batches = _client("llama")
    graphs = update_graph.UpdateGraphs(_StandInGraph)
    # beta is read only without a preference
    pref = None if change == "beta" else torch.tensor([0.7, 0.3])
    for k in range(2):
        _step("firm", tcfg, tfc, a, frozen, batches[k], graphs, pref)
    cfc = tfc
    if change == "local_steps":
        cfc = dataclasses.replace(tfc, local_steps=5)
    elif change == "client_local_steps":
        cfc = dataclasses.replace(tfc, client_local_steps=(1, 2))
    elif change == "n_clients and rounds":
        cfc = dataclasses.replace(tfc, n_clients=3, rounds=9)
    elif change == "a second client's preference":
        pref = torch.tensor([0.2, 0.8])
    elif change == "beta":
        cfc = dataclasses.replace(tfc, beta=0.5)
    else:
        leaf = common.tree_leaves(frozen["final_norm"])[0]
        leaf.mul_(1.5)
    want = _step("firm", tcfg, cfc, b, frozen, batches[2], None, pref)
    got = _step("firm", tcfg, cfc, b, frozen, batches[2], graphs, pref)
    assert graphs.captures == 1 and len(graphs._entries) == 1
    assert _same(got, want)


def test_a_static_preference_rides_the_operand():
    """The loop executor's clients carry their preference in the config:
    two clients of different static preferences share one graph, and each
    gets its own preference's update."""
    tcfg, tfc, frozen, a, b, batches = _client("llama")
    graphs = update_graph.UpdateGraphs(_StandInGraph)
    fcs = [dataclasses.replace(tfc, preference=p)
           for p in ((0.7, 0.3), (0.2, 0.8), (0.5, 0.5))]
    for k, cfc in enumerate(fcs):
        want = _step("firm", tcfg, cfc, a, frozen, batches[k], None)
        got = _step("firm", tcfg, cfc, a, frozen, batches[k], graphs)
        assert _same(got, want), cfc.preference
    assert graphs.captures == 1


def test_a_failed_capture_raises():
    """A capture that fails raises out of the runner and leaves no graph
    behind; the module's only handler re-raises: nothing falls back to
    the eager step."""
    tcfg, tfc, frozen, a, b, batches = _client("llama")
    graphs = update_graph.UpdateGraphs(_FailingGraph)
    _step("firm", tcfg, tfc, a, frozen, batches[0], graphs)
    with pytest.raises(RuntimeError, match="capturing"):
        _step("firm", tcfg, tfc, a, frozen, batches[1], graphs)
    assert not graphs._entries and graphs.captures == 0
    tree = ast.parse(inspect.getsource(update_graph))
    handlers = [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]
    assert handlers
    for node in handlers:
        assert isinstance(node.body[-1], ast.Raise)
        assert node.body[-1].exc is None


def test_no_garbage_collection_runs_during_a_capture():
    """A graph freed mid-capture (a dropped trainer's, collected with its
    reference cycles) would end the capture: the update's and the decode
    step's captures run with the collector off, and it is on again after,
    also after a capture that fails."""
    tcfg, tfc, frozen, a, b, batches = _client("llama")
    graphs = update_graph.UpdateGraphs(_GCRecordingGraph)
    for k in range(2):
        _step("firm", tcfg, tfc, a, frozen, batches[k], graphs)
    (entry,) = graphs._entries.values()
    assert entry.graph.gc_in_capture is False and gc.isenabled()
    failing = update_graph.UpdateGraphs(_FailingGraph)
    _step("firm", tcfg, tfc, a, frozen, batches[0], failing)
    with pytest.raises(RuntimeError):
        _step("firm", tcfg, tfc, a, frozen, batches[1], failing)
    assert gc.isenabled()

    class DecodeGraph:
        def warm(self, step, state):
            step(state)

        def capture(self, step, state):
            self.gc_in_capture = gc.isenabled()
            step({k: v.clone() if torch.is_tensor(v) else v
                  for k, v in state.items()})

        def replay(self):
            pass

    params = transformer.init_params(
        tcfg, generator=torch.Generator().manual_seed(0), device="cpu",
        dtype=torch.float32)
    prompt = torch.zeros((B, P), dtype=torch.long)
    _, cache = transformer.prefill(tcfg, params, prompt, cache_len=P + 3)
    g = DecodeGraph()
    sampling._decode(tcfg, params, cache, prompt[:, -1:], max_new=3,
                     temperature=1.0, generator=torch.Generator(), graph=g)
    assert g.gc_in_capture is False and gc.isenabled()


@pytest.mark.parametrize("executor", ["vectorized", "loop", "cohorts"])
def test_trainer_rounds_through_the_runner_match_eager(executor):
    """Two rounds of a trainer whose updates go through the runner (as on
    the card) equal, bit for bit, the rounds of a trainer stepping
    eagerly: every executor reaches the graph through ``algorithm.step``;
    one graph serves every client and both cohorts."""
    _, tcfg = _cfgs("llama")
    fc = dataclasses.replace(
        FIRMConfig(), n_clients=2, local_steps=1, batch_size=B,
        n_objectives=M,
        client_local_steps=(1, 2) if executor == "cohorts" else None,
        client_preferences=((0.7, 0.3), (0.4, 0.6))
        if executor == "loop" else None)
    ec = EngineConfig(prompt_len=P, max_new=NEW, uplink_codec="int8+ef",
                      vectorized_clients=executor != "loop")
    trainers = [FederatedTrainer(tcfg, fc, ec, device="cpu")
                for _ in range(2)]
    trainers[1].update_graphs = update_graph.UpdateGraphs(_StandInGraph)
    hist = [tr.run(2) for tr in trainers]
    for got, want in zip(hist[1], hist[0]):
        for key in ("per_client_lam", "rewards", "kl", "param_drift"):
            assert np.array_equal(got[key], want[key]), key
        assert got["comm_bytes"] == want["comm_bytes"]
    for x, y in zip(common.tree_leaves(trainers[1].global_trainable),
                    common.tree_leaves(trainers[0].global_trainable)):
        assert torch.equal(x, y)
    assert trainers[1].update_graphs.captures == 1
    assert trainers[0].update_graphs is None


# -------------------------------------------------------------- host reads
class _NoHostReads(TorchDispatchMode):
    """Fails on every op that reads a tensor back to the host."""

    BANNED = {torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero,
              torch.ops.aten.item}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in self.BANNED:
            raise AssertionError(f"the update read a tensor on the host: "
                                 f"{func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("alg_name", ["firm", "linear"])
@pytest.mark.parametrize("model", MODELS + ("mixtral",))
def test_the_update_reads_no_tensor_on_the_host(model, alg_name):
    """One firm_local_step and one linear_local_step make no host read of
    a tensor (before the repairs: 100 in the pgd projection, one a
    Frank-Wolfe iteration, 2 in the shaped rewards' one_hot), the reduced
    mixtral's MoE routing and window included."""
    tcfg, tfc, frozen, a, b, batches = _client(model)
    for solver in ("pgd", "frank_wolfe"):
        cfc = dataclasses.replace(tfc, solver=solver)
        with _NoHostReads():
            out = _step(alg_name, tcfg, cfc, a, frozen, batches[0], None)
        assert _same(out, _step(alg_name, tcfg, cfc, a, frozen, batches[0],
                                None))


def _update_functions():
    """Every function of the port that one local update runs, the runner
    included."""
    return [
        local.firm_local_step, local._apply, local.fedcmoo_local_grads,
        local.fedcmoo_local_apply, local.linear_local_step,
        ppo.per_objective_grads, ppo.multi_objective_losses,
        ppo.token_logprobs, ppo.shaped_rewards, ppo.gae, ppo.masked_mean,
        firm.resolve, firm.eta_schedule, mgda.solve, mgda.regularize,
        mgda.project_simplex, mgda.solve_qp_pgd, mgda.solve_qp_m2,
        mgda.solve_qp_frank_wolfe, mgda.combine, ops.gram_from_pytrees,
        ops.gram, optim.adam_update, optim.global_norm,
        optim.clip_by_global_norm, critic.features, critic.values,
        critic.project, critic.td_update, kl.adaptive_kl_update,
        transformer.forward_seq, transformer.block_seq,
        transformer._self_attention, transformer._window, transformer._ffn,
        attention.chunked_attention, moe.moe_ffn, moe.capacity,
        moe._round_up, moe._one_hot, algorithms._firm_step, algorithms._linear_step,
        algorithms.FIRMAlgorithm.step, algorithms.LinearAlgorithm.step,
        update_graph.UpdateGraphs.run, update_graph.UpdateGraphs._unflatten,
        update_graph._state_leaves, update_graph._state_like,
        update_graph._copy, update_graph._key, update_graph.UpdateGraph.warm,
        update_graph.UpdateGraph.capture, update_graph.UpdateGraph.replay]


HOST_READS = {"item", "tolist", "cpu", "numpy", "synchronize", "nonzero"}


def test_the_update_has_no_host_sync_in_its_source():
    """No ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``.nonzero()`` or ``synchronize``, no ``int(``/``float(``/``bool(`` of
    anything but a constant, and no indexing by a tensor's ``argmin``/
    ``argmax`` in any function a local update runs."""
    found = []
    for fn in _update_functions():
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        for node in ast.walk(tree):
            if isinstance(node, ast.Subscript) and any(
                    isinstance(n, ast.Attribute)
                    and n.attr in ("argmin", "argmax")
                    for n in ast.walk(node.slice)):
                found.append((fn.__qualname__, "index by arg-extremum"))
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in HOST_READS:
                found.append((fn.__qualname__, f.attr))
            if isinstance(f, ast.Name) and f.id in ("int", "float", "bool"):
                arg = node.args[0] if node.args else None
                if not isinstance(arg, ast.Constant):
                    found.append((fn.__qualname__, f.id))
    assert not found, found


# ---------------------------------------------------------------- repairs
def _old_project_simplex(v):
    """The projection before the repair (``css[rho - 1]`` read rho on the
    host)."""
    m = v.shape[-1]
    u = torch.sort(v, descending=True).values
    css = torch.cumsum(u, dim=-1)
    k = torch.arange(1, m + 1, dtype=v.dtype, device=v.device)
    rho = torch.sum(u + (1.0 - css) / k > 0, dim=-1)
    theta = (css[rho - 1] - 1.0) / rho.to(v.dtype)
    return torch.clamp(v - theta, min=0.0)


def _old_frank_wolfe(Q, iters=100):
    """Frank-Wolfe before the repair (``eye[argmin]``)."""
    m = Q.shape[0]
    lam = torch.full((m,), 1.0 / m, dtype=torch.float32, device=Q.device)
    eye = torch.eye(m, dtype=torch.float32, device=Q.device)
    for _ in range(iters):
        d = eye[torch.argmin(2.0 * Q @ lam)] - lam
        denom = d @ Q @ d
        gamma = torch.where(
            denom > 1e-12,
            torch.clamp(-(lam @ Q @ d) / torch.clamp(denom, min=1e-12),
                        0.0, 1.0),
            torch.zeros_like(denom))
        lam = lam + gamma * d
    return lam


def _old_shaped_rewards(kl_, mask, rewards, kl_coef):
    """The shaped rewards before the repair (``one_hot`` checked its
    indices on the host)."""
    s = mask.shape[1]
    pos = torch.arange(s, device=mask.device, dtype=mask.dtype)
    last_idx = torch.argmax(mask * pos[None], dim=-1)
    last = torch.nn.functional.one_hot(last_idx, s).to(torch.float32)
    r = -kl_coef * kl_[..., None] * mask[..., None]
    return r + last[..., None] * rewards[:, None, :]


def _simplex_inputs(m: int):
    rng = np.random.default_rng(m)
    return {"random": rng.normal(0, 1, m),
            "ties": np.repeat([0.3, -0.1], (m + 1) // 2)[:m],
            "a vertex": np.eye(m)[m - 1],
            "all equal": np.full(m, 0.25),
            "on the simplex": np.full(m, 1.0 / m),
            "large": rng.normal(0, 1e4, m),
            "negative": -np.abs(rng.normal(0, 1, m))}


@pytest.mark.parametrize("m", [2, 3, 8])
def test_project_simplex_repair_gives_the_same_bits(m):
    for name, v in _simplex_inputs(m).items():
        t = torch.tensor(v, dtype=torch.float32)
        got = mgda.project_simplex(t)
        assert torch.equal(got, _old_project_simplex(t)), name
        assert_close(got, jmgda.project_simplex(jnp.asarray(v, jnp.float32)),
                     1e-6, name)


def _qp_inputs(m: int):
    rng = np.random.default_rng(10 + m)
    a = rng.normal(0, 1, (m, m + 3))
    return {"random": a @ a.T + 0.005 * np.eye(m),
            "ties": np.ones((m, m)) + np.eye(m),
            "all equal": np.ones((m, m)),
            "a vertex": np.diag(np.arange(1, m + 1, dtype=np.float64)[::-1])
            * np.where(np.arange(m) == m - 1, 1e-3, 1.0)}


@pytest.mark.parametrize("m", [2, 3, 8])
def test_frank_wolfe_repair_gives_the_same_bits(m):
    for name, q in _qp_inputs(m).items():
        t = torch.tensor(q, dtype=torch.float32)
        got = mgda.solve_qp_frank_wolfe(t, iters=50)
        assert torch.equal(got, _old_frank_wolfe(t, iters=50)), name
        want = jmgda.solve_qp_frank_wolfe(jnp.asarray(q, jnp.float32),
                                          iters=50)
        assert_close(got, want, 1e-5, name)


@pytest.mark.parametrize("m", [2, 3])
def test_shaped_rewards_repair_gives_the_same_bits(m):
    rng = np.random.default_rng(m)
    masks = {"ragged": np.concatenate([np.zeros((3, 4)), np.ones((3, 6))],
                                      1),
             "empty row": np.zeros((3, 10)),
             "full": np.ones((3, 10))}
    masks["ragged"][1, -3:] = 0.0
    for name, mask in masks.items():
        kl_ = rng.normal(0, 0.1, mask.shape).astype(np.float32)
        rw = rng.uniform(0, 1, (3, m)).astype(np.float32)
        args = [torch.from_numpy(a) for a in (kl_, mask.astype(np.float32),
                                              rw)]
        coef = torch.tensor(0.1)
        got = ppo.shaped_rewards(*args, coef)
        assert torch.equal(got, _old_shaped_rewards(*args, coef)), name
        want = jppo.shaped_rewards(*(jnp.asarray(a.numpy()) for a in args),
                                   jnp.asarray(0.1, jnp.float32))
        assert_close(got, want, 1e-6, name)


def test_config_tensor_is_built_once():
    """The config's preference and eta0 are one tensor per value and
    device, whoever asks."""
    a = firm.config_tensor((0.7, 0.3), torch.device("cpu"))
    assert a is firm.config_tensor((0.7, 0.3), torch.device("cpu"))
    assert a.dtype == torch.float32 and a.tolist() == pytest.approx([0.7,
                                                                     0.3])
    assert firm.config_tensor(1.0, torch.device("cpu")).shape == ()
