"""The port's front door (``repro_torch.fed.api``: ``RunSpec``, ``plan()``,
``ExecutionPlan``) against the JAX package's, on the CPU.

* The ten golden plans of ``tests/golden_plans.json`` (read, never
  written): the port's ``RunSpec`` built from the arguments of
  ``tests/test_plan.py:golden_matrix`` at the reduced llama, its
  ``plan(spec).summary()`` equal to the file's entry and to the JAX
  planner's live summary, exactly.
* ``test_plan.py``'s other checks, on the port: the executor matrix, the
  trainer's own resolution equal to the plan's (port trainers on the CPU),
  participation counts, fused chunking, the errors ``validate`` raises and
  the two capability-validation errors.
* Full-width plans (llama-3.2-1b under every codec preset, ``fedcmoo`` at
  K = 2, heterogeneous K at participation 0.5) equal to the JAX planner's
  summaries, each planned on the meta device: no tensor of the model is
  materialised.
"""
import dataclasses
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import FIRMConfig as JFIRMConfig  # noqa: E402
from repro.configs.base import SchedConfig as JSchedConfig  # noqa: E402
from repro.fed import api as japi  # noqa: E402
from repro_torch import trees  # noqa: E402
from repro_torch.configs import FIRMConfig, get_config  # noqa: E402
from repro_torch.configs.base import CODEC_PRESETS, SchedConfig  # noqa
from repro_torch.fed import api  # noqa: E402
from repro_torch.fed import algorithms as alg  # noqa: E402
from repro_torch.fed.api import EngineConfig, RunSpec  # noqa: E402
from repro_torch.fed.engine import FederatedTrainer  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

GOLDEN = pathlib.Path(__file__).parent / "golden_plans.json"


def _cfg(port=True, full=False):
    cfg = (get_config if port else jget_config)("llama-3.2-1b")
    return cfg if full else cfg.reduced(n_layers=2, d_model=64, vocab=256)


def _spec(algorithm="firm", *, n_clients=2, local_steps=1, m=2, seed=0,
          sched=None, rounds=None, port=True, full=False, **kw):
    """Both packages' RunSpec from the arguments of ``test_plan._spec``."""
    fc_kw = {k: kw.pop(k) for k in ("client_preferences", "participation",
                                    "client_local_steps") if k in kw}
    fcls = FIRMConfig if port else JFIRMConfig
    fc = fcls(n_objectives=m, n_clients=n_clients, local_steps=local_steps,
              batch_size=2, beta=0.05, **fc_kw)
    ecls = EngineConfig if port else japi.EngineConfig
    ec = ecls(algorithm=algorithm, max_new=6, prompt_len=4, seed=seed, **kw)
    if sched is not None:
        sched = (SchedConfig if port else JSchedConfig)(**sched)
    return (api.RunSpec if port else japi.RunSpec)(
        model=_cfg(port, full), firm=fc, engine=ec, sched=sched,
        rounds=rounds)


# test_plan.golden_matrix's arguments, name -> (algorithm, keywords)
MATRIX = {
    "firm_fused": ("firm", dict(n_clients=4, fused_rounds=4, rounds=8)),
    "firm_per_round": ("firm", dict(n_clients=4)),
    "firm_loop": ("firm", dict(n_clients=4, vectorized_clients=False)),
    "firm_het_k": ("firm", dict(n_clients=4, fused_rounds=4,
                                client_local_steps=(1, 2, 1, 2))),
    "firm_unreg_fused": ("firm_unreg", dict(n_clients=2, fused_rounds=2)),
    "linear_int8ef_fused": ("linear", dict(n_clients=2, fused_rounds=2,
                                           uplink_codec="int8+ef")),
    "fedcmoo_no_fused": ("fedcmoo", dict(n_clients=4, local_steps=2,
                                         fused_rounds=4)),
    "firm_deadline": ("firm", dict(n_clients=4, fused_rounds=4, sched=dict(
        policy="deadline", overselect=1.5, deadline_quantile=0.5))),
    "firm_fedbuff_int8ef": ("firm", dict(n_clients=4,
                                         uplink_codec="int8+ef", sched=dict(
                                             policy="fedbuff",
                                             buffer_size=2))),
    "firm_partial_participation": ("firm", dict(n_clients=4,
                                                participation=0.5,
                                                fused_rounds=4)),
}


def _matrix_spec(name, port=True):
    algorithm, kw = MATRIX[name]
    return _spec(algorithm, port=port, **kw)


def test_the_matrix_is_the_golden_files():
    assert sorted(MATRIX) == sorted(json.loads(GOLDEN.read_text()))


@pytest.mark.parametrize("name", sorted(MATRIX))
def test_golden_plan_summary(name):
    """The port's summary equals the golden file's entry and the JAX
    planner's live summary, key for key and byte for byte."""
    want = json.loads(GOLDEN.read_text())[name]
    got = api.plan(_matrix_spec(name)).summary()
    assert got == want, json.dumps(got, indent=1, sort_keys=True)
    assert got == japi.plan(_matrix_spec(name, port=False)).summary()
    assert json.loads(json.dumps(got)) == got


@pytest.mark.parametrize("name,expected_executor,expected_cohorts", [
    ("firm_fused", "fused", 1),
    ("firm_per_round", "vectorized", 1),
    ("firm_loop", "loop", 0),
    ("firm_het_k", "vectorized", 2),        # het-K -> multi-cohort, no fuse
    ("firm_unreg_fused", "fused", 1),
    ("linear_int8ef_fused", "fused", 1),
    ("fedcmoo_no_fused", "vectorized", 1),  # host exchange -> never fused
    ("firm_deadline", "vectorized", 1),     # clock-driven -> per-round
    ("firm_fedbuff_int8ef", "vectorized", 1),
    ("firm_partial_participation", "fused", 1),
])
def test_executor_matrix(name, expected_executor, expected_cohorts):
    p = api.plan(_matrix_spec(name))
    assert p.executor == expected_executor, p.reasons
    assert len(p.cohorts) == expected_cohorts


@pytest.mark.parametrize("name", ["firm_fused", "fedcmoo_no_fused",
                                  "firm_het_k", "firm_loop"])
def test_trainer_resolves_what_the_plan_says(name):
    """The port's trainer, on the CPU, resolves the plan's executor
    through its own capability probes, and keeps the plan it built."""
    spec = _matrix_spec(name)
    p = api.plan(spec)
    tr = FederatedTrainer(spec.model, spec.firm, spec.engine, device="cpu")
    mode, cohorts = tr._local_phase_mode(list(range(spec.firm.n_clients)))
    fused = tr.ec.fused_rounds > 1 and api.resolve_fused(
        tr.algorithm, mode, tr.uplink_codec, tr.downlink_codec)[0]
    want = "fused" if fused else "loop" if mode == "loop" else "vectorized"
    assert p.executor == want, (name, p.reasons)
    # the trainer's own plan has no RunSpec.rounds: the rest is the same
    horizon = ("rounds", "fused_chunks")
    assert {k: v for k, v in tr.plan.summary().items()
            if k not in horizon} == \
        {k: v for k, v in p.summary().items() if k not in horizon}
    assert p.build(device="cpu").plan is p
    assert tr.plan.local_mode == mode
    assert len(cohorts or ()) == len(p.cohorts)


def test_plan_partial_participation_counts():
    p = api.plan(_matrix_spec("firm_partial_participation"))
    assert p.n_clients == 4
    assert p.participants_per_round == 2


def test_plan_fused_chunking_partial_tail():
    p = api.plan(_spec("firm", fused_rounds=3, rounds=7))
    assert p.fused_chunks == (3, 3, 1)
    assert p.summary()["dispatches_per_round"] == 1.0


@pytest.mark.parametrize("algorithm,kw,match", [
    ("fedcmoo", dict(n_clients=2, client_local_steps=(1, 2)), "fedcmoo"),
    ("fedcmoo", dict(sched=dict(policy="fedbuff")), "fedbuff"),
    ("firm", dict(sched=dict(policy="psychic")), "policy"),
    ("adam", {}, "unknown algorithm"),
])
def test_plan_validates_like_execution(algorithm, kw, match):
    with pytest.raises(ValueError, match=match) as got:
        api.plan(_spec(algorithm, **kw))
    with pytest.raises(ValueError) as want:
        japi.plan(_spec(algorithm, port=False, **kw))
    assert str(got.value) == str(want.value)


def test_fusable_requires_traced_server_exchange():
    class Bad(alg.Algorithm):
        name = "bad_fusable"
        kernel = "bad_fusable"
        caps = alg.Capabilities(fusable=True, traced_server_exchange=False,
                                single_cohort_required=True)

    with pytest.raises(ValueError, match="traced_server_exchange"):
        alg.register_algorithm(Bad())
    assert "bad_fusable" not in alg.available_algorithms()


def test_fusable_requires_vmap_safe():
    class Bad(alg.Algorithm):
        name = "bad_vmap"
        kernel = "bad_vmap"
        caps = alg.Capabilities(fusable=True, vmap_safe=False)

    with pytest.raises(ValueError, match="vmap_safe"):
        alg.register_algorithm(Bad())
    assert "bad_vmap" not in alg.available_algorithms()


def test_non_vmap_safe_algorithm_plans_the_loop():
    """An algorithm declaring vmap_safe=False resolves to the loop
    executor (and never fuses) from its capabilities alone, as the
    reference's does."""
    class LoopOnly(alg.Algorithm):
        name = "_test_loop_only"
        kernel = "_test_loop_only"
        caps = alg.Capabilities(vmap_safe=False, fusable=False)

    alg.register_algorithm(LoopOnly())
    try:
        p = api.plan(_spec("_test_loop_only", fused_rounds=4))
        assert (p.executor, p.local_mode) == ("loop", "loop")
        assert p.reasons[0] == ("local phase: loop (_test_loop_only: local "
                                "step is not vmap-safe)")
    finally:
        alg._REGISTRY.pop("_test_loop_only")


# ------------------------------------------------------------ full width
def _meta_only(monkeypatch):
    """Record the device of every tree ``init_params`` builds while
    planning; clear the planner's cache so that it builds one."""
    seen = []
    init = transformer.init_params

    def spy(cfg, **kw):
        params = init(cfg, **kw)
        seen.append({t.device.type for t in trees.tree_leaves(params)})
        return params
    monkeypatch.setattr(transformer, "init_params", spy)
    api.trainable_size.cache_clear()
    return seen


FULL = {
    **{f"llama_{preset}": ("firm", dict(
        n_clients=8, local_steps=3, uplink_codec=CODEC_PRESETS[preset][0],
        downlink_codec=CODEC_PRESETS[preset][1]))
       for preset in ("wan", "extreme", "mobile", "powersgd", "datacenter")},
    "llama_fedcmoo_k2": ("fedcmoo", dict(n_clients=2, local_steps=2,
                                         uplink_codec="int8+ef")),
    "llama_het_k_participation_half": ("firm", dict(
        n_clients=4, participation=0.5, client_local_steps=(1, 2, 1, 2),
        uplink_codec="int8+ef")),
}


@pytest.mark.parametrize("name", sorted(FULL))
def test_full_width_plan_matches_jax_without_allocating(name, monkeypatch):
    algorithm, kw = FULL[name]
    seen = _meta_only(monkeypatch)
    got = api.plan(_spec(algorithm, full=True, **kw)).summary()
    assert seen == [{"meta"}]
    want = japi.plan(_spec(algorithm, port=False, full=True, **kw)).summary()
    assert got == want
    assert got["d_trainable"] == 3_407_872


def test_the_full_width_loop_and_cohort_plans_of_the_chip_run():
    """The two plans the card's ``executors`` phase runs (llama-3.2-1b,
    ``wan``, C = 2): the loop executor at K = 1, and cohorts of K = 1 and
    K = 2; each equal to the JAX planner's."""
    wan = dict(uplink_codec="int8+ef", downlink_codec="identity")
    loop = dict(n_clients=2, vectorized_clients=False, **wan)
    cohorts = dict(n_clients=2, client_local_steps=(1, 2), **wan)
    for kw, executor, mode, cos in ((loop, "loop", "loop", []),
                                    (cohorts, "vectorized", "cohort",
                                     [[1, 1], [1, 2]])):
        got = api.plan(_spec("firm", full=True, **kw)).summary()
        assert got == japi.plan(_spec("firm", port=False, full=True,
                                      **kw)).summary()
        assert (got["executor"], got["local_mode"], got["cohorts"]) == \
            (executor, mode, cos)
        assert got["dispatches_per_round"] == 10
        assert (got["up_bytes_per_round"], got["down_bytes_per_round"]) == \
            (6_842_368, 27_262_976)


@pytest.mark.parametrize("arch,d", [("llama-3.2-1b", 3_407_872),
                                    ("zamba2-1.2b", 262_144)])
def test_trainable_size_builds_on_the_meta_device(arch, d, monkeypatch):
    seen = _meta_only(monkeypatch)
    assert api.trainable_size(get_config(arch)) == d
    assert seen == [{"meta"}]
    # cached on the frozen config: a second call builds nothing
    assert api.trainable_size(get_config(arch)) == d and len(seen) == 1


def test_the_reduced_trainable_size_is_the_golden_one():
    assert api.trainable_size(_cfg()) == 16_384 == \
        FederatedTrainer(_cfg(), FIRMConfig(n_clients=1),
                         device="cpu").d_trainable


def test_sched_config_is_the_references_field_for_field():
    got = [(f.name, f.default) for f in dataclasses.fields(SchedConfig)]
    want = [(f.name, f.default) for f in dataclasses.fields(JSchedConfig)]
    assert got == want
    assert api.POLICIES == ("deadline", "fedbuff", "sync")
