"""The port's plan audit, program spans and debug switches
(``obs/audit``, ``obs/jitwatch``, ``obs/debug``) on the CPU at a tiny size
(the llama of ``tests/test_torch_obs.py``: 2 layers, d_model 64, vocab
256; B = 2, P = 4, 6 new tokens), against the JAX package's where it has a
counterpart:

* jitwatch: the case of ``tests/test_obs.py``'s wrap test through both
  packages' ``wrap``/``record`` (the same spans, counts and nesting), and
  each log's own window of kernel launches;
* audit: the cases of ``tests/test_obs.py``'s audits (per-round identity,
  a partial fused chunk, ``PlanDriftError``, the {identity, int8+ef} x
  {per round, fused} matrix), the port's report against the reference's
  ``audit_run`` on the same spec: check names, ``enforced``, bytes, host
  transfers and recompiles equal; the two dispatch counts each stated
  (the port's programs, the reference's jitted dispatches);
* the port's program count predicted and observed equal for every
  algorithm x executor it runs, reported without enforcement for the
  deadline and fedbuff policies; a stage called twice and an update-graph
  capture after the warm-up (a stand-in graph) each raise
  ``PlanDriftError``;
* debug: the environment switches against the reference's; the NaN check
  raising ``FloatingPointError`` at the op that made the NaN (forward,
  backward, a kernel's output) and never at ``empty``; nothing captured
  while it is on; a round under it the plain round bit for bit; an f64
  default leaving the client state with the reference's dtypes (the
  reference's own round raises under ``jax_enable_x64``, in decode's
  ``dynamic_update_slice``: the dtypes are its local update's);
* a sync ``ScheduledTrainer`` run under ``jitwatch.record()`` exporting a
  trace with its host spans (``export_trace(host_spans=...)``), valid.

Every switch and JAX config flag a test turns is restored in ``finally``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import FIRMConfig as JFIRMConfig  # noqa: E402
from repro.fed.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.fed.engine import FederatedTrainer as JFederatedTrainer  # noqa
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.obs import audit_run as jaudit_run  # noqa: E402
from repro.obs import debug as jdebug, jitwatch as jjitwatch  # noqa: E402
from repro.rlhf import local as jlocal, ppo as jppo  # noqa: E402
from repro_torch import trees  # noqa: E402
from repro_torch.configs import FIRMConfig, get_config  # noqa: E402
from repro_torch.configs.base import SchedConfig  # noqa: E402
from repro_torch.fed import algorithms, api  # noqa: E402
from repro_torch.fed.engine import (EngineConfig, FederatedTrainer,  # noqa
                                    client_local_steps)
from repro_torch.kernels import counters, nancheck  # noqa: E402
from repro_torch.obs import (PlanDriftError, audit_run, debug,  # noqa: E402
                             jitwatch, validate_trace)
from repro_torch.obs.audit import predicted_dispatches  # noqa: E402
from repro_torch.rlhf import sampling, update_graph  # noqa: E402
from test_torch_update_graph import _StandInGraph  # noqa: E402

PROGRAMS = {"generate", "ref_logprobs", "step[firm]", "stack_trees",
            "delta_flat", "flat_aggregate", "summary_device"}


def _cfg():
    return get_config("llama-3.2-1b").reduced(n_layers=2, d_model=64,
                                              vocab=256)


def _fc(n_clients=2, **kw):
    return FIRMConfig(n_objectives=2, n_clients=n_clients, local_steps=1,
                      batch_size=2, beta=0.05, **kw)


def _ec(**kw):
    return EngineConfig(max_new=6, prompt_len=4, seed=0, **kw)


def _trainer(n_clients=2, fc_kw=None, **kw):
    return FederatedTrainer(_cfg(), _fc(n_clients, **(fc_kw or {})),
                            _ec(**kw), device="cpu")


# the reference's reports, one a spec, made once for the file
_JREPORTS = {}


def _jreport(codec: str, fused: int) -> dict:
    if (codec, fused) not in _JREPORTS:
        jcfg = jget_config("llama-3.2-1b").reduced(n_layers=2, d_model=64,
                                                   vocab=256)
        jfc = JFIRMConfig(n_objectives=2, n_clients=2, local_steps=1,
                          batch_size=2, beta=0.05)
        jtr = JFederatedTrainer(jcfg, jfc, JEngineConfig(
            max_new=6, prompt_len=4, seed=0, uplink_codec=codec,
            fused_rounds=fused))
        _JREPORTS[codec, fused] = jaudit_run(jtr).raise_on_drift().to_json()
    return _JREPORTS[codec, fused]


# ------------------------------------------------------------ jitwatch
class _Captures:
    """Stands in for a program with a graph cache: its capture count grows
    on the first call of each input shape, as a jit cache grows on the
    first call of each shape (``_cache_size`` is the reference's view of
    the same count)."""

    def __init__(self):
        self.shapes = set()

    def __call__(self, x):
        self.shapes.add(tuple(np.shape(x)))
        return x + 1

    def captures(self) -> int:
        return len(self.shapes)

    _cache_size = captures


def test_jitwatch_wrap_counts_captures_and_nests_as_the_reference():
    """``tests/test_obs.py``'s wrap case through both packages."""
    runs = {}
    for name, mod, wrap in (
            ("port", jitwatch,
             lambda fn: jitwatch.wrap("f", fn, captures=fn.captures)),
            ("reference", jjitwatch, lambda fn: jjitwatch.wrap("f", fn))):
        f = wrap(_Captures())
        f(np.zeros(3))                    # inactive: no recorder, no span
        with mod.record() as outer:
            f(np.zeros(4))                # a new shape: captures
            with mod.record() as inner:
                f(np.zeros(4))            # cached: no capture
            f(np.zeros(4))
        assert not mod.active()
        runs[name] = ([(s.name, s.compiled) for s in outer.spans],
                      [(s.name, s.compiled) for s in inner.spans],
                      outer.call_count, outer.compile_count,
                      inner.call_count, inner.compile_count,
                      outer.calls_by_name(), outer.compiles_by_name(),
                      inner.compiles_by_name())
    assert runs["port"] == runs["reference"]
    assert runs["port"][0] == [("f", True), ("f", False), ("f", False)]
    assert runs["port"][7] == {"f": 1}


def test_a_log_reads_the_kernel_launches_of_its_own_window():
    before = counters.read()
    try:
        with jitwatch.record() as outer:
            counters.add({"rmsnorm": 3})
            with jitwatch.record() as inner:
                counters.add({"rmsnorm": 2, "gram": 1})
            counters.add({"quantize": 1})
        assert inner.launches == {"rmsnorm": 2, "gram": 1}
        assert outer.launches == {"rmsnorm": 5, "gram": 1, "quantize": 1}
        assert outer.spans == inner.spans == []
    finally:
        counters.add(counters.since(before), -1)
    assert counters.read() == before


# ------------------------------------------------------------- audits
@pytest.mark.parametrize("fused", [1, 2])
@pytest.mark.parametrize("codec", ["identity", "int8+ef"])
def test_audit_matches_the_reference_audit(codec, fused):
    """The smoke matrix: the port's report and the reference's on the
    same spec give the same check names, enforcement, bytes, recompiles
    and host transfers; the port's programs a round are predicted
    exactly, and the reference's count is kept beside them."""
    report = audit_run(_trainer(uplink_codec=codec,
                                fused_rounds=fused)).raise_on_drift()
    got, want = report.to_json(), _jreport(codec, fused)
    assert report.executor == want["executor"] == (
        "fused" if fused > 1 else "vectorized")
    for key in ("algorithm", "policy", "uplink_codec", "downlink_codec",
                "rounds", "ok"):
        assert got[key] == want[key], key
    gc_, wc = ({c["name"]: c for c in r["checks"]} for r in (got, want))
    assert list(gc_) == list(wc)
    for name, c in wc.items():
        assert gc_[name]["enforced"] == c["enforced"], name
        if name != "dispatches_per_round":
            assert (gc_[name]["predicted"], gc_[name]["observed"]) == (
                c["predicted"], c["observed"]), name
    # two counts, each stated: the port's programs (2 client-steps of 3,
    # one stack, delta, aggregate, summary) and the reference's dispatches
    disp = gc_["dispatches_per_round"]
    assert disp["predicted"] == disp["observed"] == 10
    assert got["reference_dispatches_per_round"] == \
        wc["dispatches_per_round"]["predicted"] == \
        wc["dispatches_per_round"]["observed"] == (6 if fused == 1 else 1.5)
    assert gc_["host_transfers_per_round"]["observed"] == 1.0 / fused
    assert got["decode_captures_per_round"] == 0        # no decode graph
    assert got["launches_per_round"] == {}              # no kernel here
    assert got["jit_calls"] == 10 * report.rounds
    assert got["compiles_by_name"] == {} and got["seconds"] > 0


def test_audit_rejects_a_partial_fused_chunk():
    with pytest.raises(ValueError, match="multiple of the fused chunk"):
        audit_run(_trainer(fused_rounds=2), rounds=3)


def test_plan_drift_error_raises():
    report = audit_run(_trainer(), rounds=2)
    assert report.ok
    object.__setattr__(report.checks[0], "predicted", 999.0)
    assert not report.ok
    with pytest.raises(PlanDriftError, match="dispatches_per_round"):
        report.raise_on_drift()


MODES = {"vec": {}, "cohort": dict(fc_kw=dict(client_local_steps=(1, 2))),
         "loop": dict(vectorized_clients=False),
         "fused": dict(fused_rounds=2)}
MATRIX = [(a, m) for a in ("firm", "firm_unreg", "linear") for m in MODES] \
    + [("fedcmoo", "vec"), ("fedcmoo", "loop")]


@pytest.mark.parametrize("alg,mode", MATRIX,
                         ids=[f"{a}-{m}" for a, m in MATRIX])
def test_the_programs_a_round_are_predicted(alg, mode):
    """The port's dispatch prediction equals its observation in every
    algorithm and executor it runs; for firm outside cohorts it is the
    reference loop executor's formula."""
    tr = _trainer(algorithm=alg, **MODES[mode])
    want_exec = {"fused": "fused", "loop": "loop"}.get(mode, "vectorized")
    assert tr.plan.executor == want_exec
    report = audit_run(tr).raise_on_drift()
    check = report.checks[0]
    assert check.name == "dispatches_per_round" and check.enforced
    assert check.predicted == check.observed == predicted_dispatches(tr.plan)
    a = algorithms.get_algorithm(alg)
    n_steps = 3 if mode == "cohort" else 2          # client-steps a round
    want = (a.programs_per_client_step * n_steps + a.programs_per_step
            + (3 if mode == "cohort" else 1) + 3)
    assert check.observed == want
    if a.kernel == "firm" and mode != "cohort":
        assert want == api._dispatch_estimate(
            a, "loop", "loop", (), algorithms.client_configs(a, tr.fc), 2, 1)


@pytest.mark.parametrize("policy", ["deadline", "fedbuff"])
def test_scheduled_policies_are_reported_not_enforced(policy):
    sc = SchedConfig(policy=policy, profile="homogeneous", profile_seed=0,
                     overselect=1.0, deadline_quantile=None, buffer_size=2)
    st = api.plan(api.RunSpec(_cfg(), _fc(), _ec(), sched=sc)).build(
        device="cpu")
    report = audit_run(st)
    assert report.policy == policy and report.executor == "vectorized"
    enforced = {c.name: c.enforced for c in report.checks}
    assert enforced == {"dispatches_per_round": False,
                        "up_bytes_per_round": False,
                        "down_bytes_per_round": False,
                        "recompiles_after_warmup": True,
                        "host_transfers_per_round": False}
    got = {c.name: c.observed for c in report.checks}
    if policy == "deadline":          # every client kept: the sync round
        assert got["dispatches_per_round"] == 10
        assert got["host_transfers_per_round"] == 1
    else:                             # a dispatch of both, one aggregation
        assert got["dispatches_per_round"] == 9
        assert got["host_transfers_per_round"] == 0   # _to_host: no count
    assert report.ok


def test_a_stage_called_twice_is_drift():
    tr = _trainer()
    delta = tr._delta_flat

    def twice(stacked, anchor):
        delta(stacked, anchor)
        return delta(stacked, anchor)
    tr._delta_flat = twice
    with pytest.raises(PlanDriftError, match="dispatches_per_round"):
        audit_run(tr).raise_on_drift()


def test_a_capture_after_the_warmup_is_drift():
    """A new frozen tree after the warm-up is a new update-graph key: its
    second client-step captures inside the audited window."""
    tr = _trainer()
    tr.update_graphs = update_graph.UpdateGraphs(_StandInGraph)
    run = tr.run

    def run_after_moving_frozen(rounds=None, participants=None):
        if rounds == 2:                                # the audited window
            tr.frozen = trees.tree_map(lambda t: t.clone(), tr.frozen)
        return run(rounds, participants)
    tr.run = run_after_moving_frozen
    report = audit_run(tr)
    recap = {c.name: c for c in report.checks}["recompiles_after_warmup"]
    assert recap.observed == 1 and tr.update_graphs.captures == 2
    assert report.compiles_by_name == {"step[firm]": 1}
    with pytest.raises(PlanDriftError, match="recompiles_after_warmup"):
        report.raise_on_drift()


def test_the_warmup_runs_until_every_key_is_captured():
    """C = 1, K = 1: one warm-up round only warms the key; a second
    captures it, and the audited rounds replay."""
    tr = _trainer(n_clients=1)
    tr.update_graphs = update_graph.UpdateGraphs(_StandInGraph)
    calls = []
    run = tr.run

    def counted(rounds=None, participants=None):
        calls.append(rounds)
        return run(rounds, participants)
    tr.run = counted
    report = audit_run(tr).raise_on_drift()
    assert calls == [1, 1, 2]
    (entry,) = tr.update_graphs._entries.values()
    assert tr.update_graphs.captures == 1 and entry.graph.replays == 3
    assert tr.update_graphs.uncaptured() == 0


# ------------------------------------------------------------- debug
def test_debug_toggles_from_env_as_the_reference():
    nans0, x640 = jax.config.jax_debug_nans, jax.config.jax_enable_x64
    applied0, japplied0 = debug._applied, jdebug._applied
    try:
        env = {"REPRO_DEBUG_NANS": "on", "REPRO_X64": "0"}
        applied = debug.configure_from_env(env, force=True)
        japplied = jdebug.configure_from_env(env, force=True)
        assert applied == {"debug_nans": True, "float64": False}
        assert japplied == {"jax_debug_nans": True, "jax_enable_x64": False}
        assert debug.nans_enabled() and torch.is_anomaly_enabled()
        assert torch.get_default_dtype() == torch.float32
        assert debug.configure_from_env({}, force=True) == {} == \
            jdebug.configure_from_env({}, force=True)
        for mod in (debug, jdebug):
            with pytest.raises(ValueError, match="REPRO_X64"):
                mod.configure_from_env({"REPRO_X64": "maybe"}, force=True)
        assert debug.configure_from_env({"REPRO_X64": "yes"},
                                        force=True) == {"float64": True}
        assert torch.get_default_dtype() == torch.float64
    finally:
        debug.set_debug_nan(False)
        debug.set_x64(False)
        jdebug.set_debug_nan(nans0)
        jdebug.set_x64(x640)
        debug._applied, jdebug._applied = applied0, japplied0
    assert not torch.is_anomaly_enabled()


def test_the_nan_check_raises_at_the_op_that_made_the_nan():
    def log_of(x):
        return torch.log(x)

    def norm_grad(x):
        x = x.clone().requires_grad_(True)
        return torch.autograd.grad(torch.linalg.vector_norm(x), x)[0]

    def uninitialised(n):
        return (torch.empty(n), torch.empty_like(torch.ones(n)),
                torch.empty_strided((n,), (1,)))

    progs = {name: jitwatch.wrap(name, fn) for name, fn in (
        ("log_of", log_of), ("norm_grad", norm_grad),
        ("uninitialised", uninitialised))}
    nan = torch.full((4,), float("nan"))
    assert torch.isnan(progs["log_of"](torch.tensor([-1.0]))).all()
    debug.set_debug_nan(True)
    try:
        with pytest.raises(FloatingPointError,
                           match=r"aten\.log\.default \(program log_of\)"):
            progs["log_of"](torch.tensor([-1.0]))
        # the backward's 0 / 0: the dispatch mode or the anomaly mode
        with pytest.raises(FloatingPointError, match="norm_grad"):
            progs["norm_grad"](torch.zeros(3))
        for _ in range(3):                 # freed NaNs never count
            del nan
            nan = torch.full((4096,), float("nan"))
            progs["uninitialised"](4096)
        with pytest.raises(FloatingPointError, match="kernel rmsnorm"):
            nancheck.check_output("rmsnorm", torch.ones(2), nan)
        nancheck.check_output("rmsnorm", torch.ones(2), None)
        assert jitwatch._live and not jitwatch.active()
    finally:
        debug.set_debug_nan(False)
    nancheck.check_output("rmsnorm", nan)
    assert not jitwatch._live


def test_the_kernel_layer_imports_nothing_of_obs():
    """The kernels' NaN check lives under ``kernels/``: importing a kernel
    wrapper runs nothing of ``obs`` (no switch is applied as a side
    effect), and ``set_debug_nan`` is what turns the check on."""
    import ast
    import pathlib
    kdir = pathlib.Path(counters.__file__).parent
    for path in sorted(kdir.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.startswith("repro_torch.obs") for n in names), \
                path.name
    try:
        debug.set_debug_nan(True)
        assert nancheck.enabled
    finally:
        debug.set_debug_nan(False)
    assert not nancheck.enabled


def _client_steps(tr, graphs, k=2):
    gens = [torch.Generator().manual_seed(40 + i) for i in range(k)]
    prompts = torch.stack([tr.datasets[0].next_batch(2) for _ in range(k)])
    return client_local_steps(
        tr.cfg, tr.fc, tr.client_states[0], tr.frozen, tr.ref_params,
        *tr._bands[0], k_steps=k, max_new=tr.ec.max_new,
        length_tol=tr._length_tol, prompts=prompts, generators=gens,
        graphs=graphs)


def _same_steps(a, b) -> bool:
    la = update_graph._state_leaves(a[0]) + [a[1][k] for k in sorted(a[1])]
    lb = update_graph._state_leaves(b[0]) + [b[1][k] for k in sorted(b[1])]
    return all(torch.equal(x, y) for x, y in zip(la, lb, strict=True))


def test_nothing_is_captured_while_the_nan_check_is_on():
    """The update runs without its graphs, decode has no step graph and
    the fused executor refuses; turned off, the graphs capture again and
    give the eager steps' bits."""
    eager = _client_steps(_trainer(), None)
    graphs = update_graph.UpdateGraphs(_StandInGraph)
    debug.set_debug_nan(True)
    try:
        checked = _client_steps(_trainer(), graphs)
        assert not graphs._entries and graphs.captures == 0
        assert sampling.step_graph("cuda") is None
        with pytest.raises(ValueError, match="NaN check"):
            _trainer(fused_rounds=2).run_rounds_fused(2)
    finally:
        debug.set_debug_nan(False)
    replayed = _client_steps(_trainer(), graphs)
    assert graphs.captures == 1 and graphs.uncaptured() == 0
    assert sampling.step_graph("cpu") is None
    assert _same_steps(checked, eager) and _same_steps(replayed, eager)


def test_a_round_under_the_nan_check_is_the_plain_round():
    plain, checked = _trainer(), _trainer()
    want = plain.run_round()
    debug.set_debug_nan(True)
    try:
        got = checked.run_round()
    finally:
        debug.set_debug_nan(False)
    assert list(got) == list(want)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    assert all(torch.equal(a, b) for a, b in zip(
        trees.tree_leaves(checked.global_trainable),
        trees.tree_leaves(plain.global_trainable), strict=True))


def _jax_x64_step_dtypes() -> list:
    """The client state's dtypes after the reference's local update under
    ``jax_enable_x64``, in the state's leaf order."""
    jcfg = jget_config("llama-3.2-1b").reduced(n_layers=2, d_model=64,
                                               vocab=256)
    jfc = JFIRMConfig(n_objectives=2, n_clients=2, local_steps=1,
                      batch_size=2, beta=0.05)
    trainable, frozen = jcommon.split_trainable(
        jT.init_params(jcfg, jax.random.PRNGKey(0)))
    state = jlocal.init_client_state(trainable, 2, jcfg.d_model,
                                     kl_coef=jfc.kl_coef_init)
    rng = np.random.default_rng(0)
    s = 4 + 6
    batch = jppo.PPOBatch(
        jnp.asarray(rng.integers(0, jcfg.vocab, (2, s)), jnp.int32),
        jnp.asarray(np.repeat([[0.0] * 4 + [1.0] * 6], 2, 0), jnp.float32),
        jnp.zeros((2, s), jnp.float32), jnp.zeros((2, s), jnp.float32),
        jnp.asarray(rng.uniform(0, 1, (2, 2)), jnp.float32))
    new, _ = jax.jit(lambda st, fr, b: jlocal.firm_local_step(
        jcfg, jfc, st, fr, b))(state, frozen, batch)
    return [str(leaf.dtype) for leaf in jax.tree_util.tree_leaves(new)]


def test_an_f64_default_keeps_the_reference_dtypes():
    x640 = jax.config.jax_enable_x64
    try:
        jax.config.update("jax_enable_x64", True)
        want = _jax_x64_step_dtypes()
        debug.set_x64(True)
        tr = _trainer()
        summary = tr.run_round()
    finally:
        debug.set_x64(False)
        jax.config.update("jax_enable_x64", x640)
    assert np.isfinite(summary["kl"])
    for c in range(2):
        got = [str(t.dtype).removeprefix("torch.")
               for t in update_graph._state_leaves(tr.client_states[c])]
        assert got == want
    assert {str(t.dtype) for t in trees.tree_leaves(
        tr.global_trainable)} == {"torch.float32"}


# ------------------------------------------------------------- trace
def test_a_sync_run_exports_its_host_spans(tmp_path):
    """The reference's ``export_trace`` use: the programs' spans of a
    recorded run on the trace's host process, validated."""
    st = api.plan(api.RunSpec(_cfg(), _fc(), _ec(), sched=SchedConfig(
        policy="sync", profile="homogeneous", profile_seed=0))).build(
        device="cpu")
    with jitwatch.record() as log:
        st.run(2)
    trace = st.export_trace(str(tmp_path / "sync.trace.json"),
                            host_spans=log.spans)
    validate_trace(trace)
    host = [e for e in trace["traceEvents"]
            if e["pid"] == 2 and e["ph"] == "X"]
    assert len(host) == len(log.spans) == 20
    assert {e["name"] for e in host} == PROGRAMS
    assert log.calls_by_name() == {
        "generate": 4, "ref_logprobs": 4, "step[firm]": 4, "stack_trees": 2,
        "delta_flat": 2, "flat_aggregate": 2, "summary_device": 2}
    assert dataclasses.asdict(log.spans[0]).keys() == {
        "name", "t0", "dur", "compiled"}
