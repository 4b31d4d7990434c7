"""The port's observability (``obs/records``, ``obs/metrics``,
``obs/trace``), the analytic and time models of ``core/comms`` and the
engine's emission, on the CPU at a tiny size (the llama of
``tests/test_sched.py``: 2 layers, d_model 64, vocab 256; B = 2, P = 4,
6 new tokens).

* the cases of ``tests/test_obs.py`` (records, sinks, the pipeline, the
  round summary, the trace) against the port's modules;
* the port against the JAX package on the same inputs, exactly: the
  records of engine, sync, deadline and fedbuff summaries made from a
  numpy seed (names, kinds, labels, values), the JSONL and CSV files
  byte for byte, ``TraceBuilder`` call sequences, and every byte and
  time model over every ``CODEC_PRESETS`` codec at the tiny d and at
  llama-3.2-1b's full-width d (3,407,872);
* the engine: a record set a round through a sink, one host transfer a
  round (and one a fused chunk), fused records bit for bit the per-round
  records, and no host read inside a fused chunk with a sink attached.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import numpy as np  # noqa: E402

from repro.configs.base import CODEC_PRESETS as JCODEC_PRESETS  # noqa
from repro.core import comms as jcomms  # noqa: E402
from repro.fed.sched import profiles as jprofiles  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import records as jrecords  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro_torch.configs import FIRMConfig, get_config  # noqa: E402
from repro_torch.configs.base import CODEC_PRESETS  # noqa: E402
from repro_torch.core import comms  # noqa: E402
from repro_torch.fed import api  # noqa: E402
from repro_torch.fed.engine import EngineConfig, FederatedTrainer  # noqa
from repro_torch.fed.sched import profiles  # noqa: E402
from repro_torch.obs import (SCHEMA_VERSION, MetricRecord,  # noqa: E402
                             MetricsPipeline, TraceBuilder, counter, gauge,
                             make_sink, records_from_round, series,
                             span_seconds_by_track, validate_trace)
from repro_torch.obs import metrics, records, trace  # noqa: E402
from test_torch_fused import _HostReads  # noqa: E402

FULL_D = 3_407_872


def _cfg():
    return get_config("llama-3.2-1b").reduced(n_layers=2, d_model=64,
                                              vocab=256)


def _trainer(n_clients=2, seed=0, **kw):
    fc = FIRMConfig(n_objectives=2, n_clients=n_clients, local_steps=1,
                    batch_size=2, beta=0.05)
    ec = EngineConfig(max_new=6, prompt_len=4, seed=seed, **kw)
    return FederatedTrainer(_cfg(), fc, ec, device="cpu")


# ------------------------------------------------------------ records
def test_record_kinds_and_schema_stamp():
    r = counter("comm/up_bytes", 1024, 3, policy="sync")
    assert r.kind == "counter" and r.schema == SCHEMA_VERSION
    assert r.to_json() == {"schema": SCHEMA_VERSION, "kind": "counter",
                           "name": "comm/up_bytes", "value": 1024,
                           "round": 3, "labels": {"policy": "sync"}}
    assert gauge("x", np.float32(1.5)).to_json()["value"] == 1.5
    assert series("y", np.arange(3)).to_json()["value"] == [0, 1, 2]
    assert series("y", torch.arange(3)).to_json()["value"] == [0, 1, 2]
    with pytest.raises(ValueError):
        MetricRecord("histogram", "x", 1)


def test_make_sink_specs(tmp_path):
    assert make_sink("memory").kind == "memory"
    assert make_sink(f"jsonl:{tmp_path}/a.jsonl").kind == "jsonl"
    assert make_sink(f"csv:{tmp_path}/a.csv").kind == "csv"
    for bad in ("jsonl", "csv:", "parquet:x"):
        with pytest.raises(ValueError):
            make_sink(bad)


def test_jsonl_and_csv_sinks_roundtrip(tmp_path):
    jpath, cpath = tmp_path / "m.jsonl", tmp_path / "m.csv"
    with MetricsPipeline.from_spec(f"jsonl:{jpath},csv:{cpath}") as pipe:
        pipe.emit(gauge("round/kl", 0.25, 0))
        pipe.emit(series("round/rewards", [1.0, 2.0], 0, policy="sync"))
    lines = [json.loads(x) for x in jpath.read_text().splitlines()]
    assert [x["name"] for x in lines] == ["round/kl", "round/rewards"]
    assert all(x["schema"] == SCHEMA_VERSION for x in lines)
    rows = cpath.read_text().splitlines()
    assert rows[0] == "schema,kind,name,round,value,labels"
    assert len(rows) == 3 and "round/rewards" in rows[2]
    # the memory sink is always attached beside the file sinks
    assert pipe.values("round/kl") == [0.25]


def test_pipeline_select_and_values():
    pipe = MetricsPipeline()
    for i in range(3):
        pipe.emit(gauge("round/kl", 0.1 * i, i))
    pipe.emit(gauge("round/param_drift", 9.0, 0))
    assert pipe.values("round/kl") == [0.0, pytest.approx(0.1),
                                       pytest.approx(0.2)]
    assert [r.round for r in pipe.select("round/kl")] == [0, 1, 2]


def _stats():
    return {"rewards": np.array([1.0, 2.0], np.float32),
            "lam_mean": np.array([0.5, 0.5], np.float32),
            "lam_disagreement": np.float32(0.01),
            "param_drift": np.float32(0.002),
            "kl": np.float32(0.3),
            "per_client_lam": np.zeros((2, 2), np.float32),
            "rewards_per_client": np.ones((2, 2), np.float32)}


def _engine_summary(mod, stats=None, **kw):
    return mod.round_summary(
        stats=_stats() if stats is None else stats, comm_bytes=300,
        up_bytes=100, down_bytes=200, participants=[0, 1], dispatches=6,
        up_nbytes=[50, 50], down_nbytes=200, local_steps=[1, 1], cohorts=1,
        **kw)


def test_records_from_round_names_and_sched_filter():
    s = _engine_summary(records)
    names = [r.name for r in records_from_round(s, round=0)]
    assert names == ["round/rewards", "round/lam_mean",
                     "round/lam_disagreement", "round/param_drift",
                     "round/kl", "round/dispatches", "round/cohorts",
                     "round/local_steps", "comm/total_bytes",
                     "comm/up_bytes", "comm/down_bytes", "comm/up_nbytes",
                     "comm/down_nbytes"]
    s.update(policy="sync", sim_time=2.0, round_duration=1.0, dropped=[],
             client_seconds=[1.0, 0.5])
    pipe = MetricsPipeline()
    pipe.emit_schedule(s, round=0)
    assert {r.name for r in pipe.records} == {
        "sched/sim_time", "sched/round_duration", "sched/client_seconds",
        "sched/dropped"}
    assert all(dict(r.labels)["policy"] == "sync" for r in pipe.records)


# ----------------------------------------- the records against the JAX's
def _summaries(mod, seed: int = 0):
    """An engine summary, a sync and a deadline annotation of it, a fused
    one and a fedbuff summary, their statistics drawn from ``seed``."""
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return rng.normal(0, 1, shape).astype(np.float32)

    def stats():
        return {"rewards": f32(2), "lam_mean": f32(2),
                "lam_disagreement": f32(), "param_drift": f32(),
                "kl": f32(), "per_client_lam": f32(3, 2),
                "rewards_per_client": f32(3, 2)}

    plain = _engine_summary(mod, stats())
    sync = mod.annotate_schedule(
        _engine_summary(mod, stats()), policy="sync",
        sim_time=float(rng.uniform(1, 9)),
        round_duration=float(rng.uniform(0, 1)), dropped=[],
        client_seconds=list(rng.uniform(0, 1, 2)))
    deadline = mod.annotate_schedule(
        _engine_summary(mod, stats()), policy="deadline",
        sim_time=float(rng.uniform(1, 9)),
        round_duration=float(rng.uniform(0, 1)), dropped=[2],
        client_seconds=list(rng.uniform(0, 1, 2)), selected=[0, 1, 2],
        deadline=float(rng.uniform(0, 1)))
    fused = _engine_summary(mod, stats(), fused=2)
    rpc = f32(2, 2)
    fedbuff = mod.fedbuff_summary(
        version=3, sim_time=float(rng.uniform(1, 9)),
        round_duration=float(rng.uniform(0, 1)), participants=[2, 0],
        staleness=[1, 0], staleness_weights=f32(2), rewards=rpc.mean(0),
        rewards_per_client=rpc, comm_bytes=900, up_bytes=300,
        down_bytes=600)
    return [plain, sync, deadline, fused, fedbuff]


def test_summaries_and_records_are_the_references():
    """Each summary's keys and values, and the records of every kind of
    summary through ``records_from_round`` (with and without a policy
    label) and ``emit_schedule``: names, kinds, labels, rounds and values,
    exactly."""
    for r, (got, want) in enumerate(zip(_summaries(records),
                                        _summaries(jrecords))):
        assert list(got) == list(want)
        for key in want:
            np.testing.assert_array_equal(np.asarray(got[key]),
                                          np.asarray(want[key]), key)
        for policy in (None, "sync"):
            g = records_from_round(got, round=r, policy=policy)
            w = jrecords.records_from_round(want, round=r, policy=policy)
            assert [x.to_json() for x in g] == [x.to_json() for x in w]
            assert [(x.kind, x.name, x.labels, x.round) for x in g] == [
                (x.kind, x.name, x.labels, x.round) for x in w]
        pipe, jpipe = MetricsPipeline(), jmetrics.MetricsPipeline()
        pipe.emit_schedule(got, round=r)
        jpipe.emit_schedule(want, round=r)
        assert [x.to_json() for x in pipe.records] == [
            x.to_json() for x in jpipe.records]


def test_sink_files_are_the_references_byte_for_byte(tmp_path):
    """The JSONL and CSV files the port's pipeline writes for the
    summaries are the JAX pipeline's, byte for byte."""
    files = {}
    for side, mod, summaries in (("port", metrics, _summaries(records, 1)),
                                 ("jax", jmetrics, _summaries(jrecords, 1))):
        j, c = tmp_path / f"{side}.jsonl", tmp_path / f"{side}.csv"
        with mod.MetricsPipeline.from_spec(f"jsonl:{j},csv:{c}") as pipe:
            for r, s in enumerate(summaries):
                pipe.emit_round(s, round=r)
                pipe.emit_schedule(s, round=r, policy="deadline")
        files[side] = (j.read_bytes(), c.read_bytes())
    assert files["port"] == files["jax"]
    assert files["port"][0].count(b"\n") > 50


# -------------------------------------------------------------- trace
def test_trace_builder_shape_and_track_sums():
    tb = TraceBuilder()
    end = tb.client_span(0, 0.0, [("download", 1.0), ("compute", 2.0),
                                  ("upload", 0.5)], round_idx=0)
    assert end == 3.5
    tb.server_span("round", 0.0, 3.5)
    tb.instant("aggregate", 3.5)
    fid = tb.flow_start("upload", 3.0, client=0)
    tb.flow_end("upload", 3.5, fid)
    tb.counter("in flight", 1.0, {"depth": 1})
    d = tb.to_dict()
    validate_trace(d)
    assert d["displayTimeUnit"] == "ms"
    sums = span_seconds_by_track(d)
    assert sums[(1, 1)] == pytest.approx(3.5)       # client 0's track
    assert sums[(1, 0)] == pytest.approx(3.5)       # the server's
    names = {e["name"] for e in d["traceEvents"] if e["ph"] == "M"}
    assert {"process_name", "thread_name"} <= names


def test_validate_trace_rejects_malformed():
    with pytest.raises(ValueError):
        validate_trace({"events": []})
    with pytest.raises(ValueError):
        validate_trace({"traceEvents": [{"ph": "X", "pid": 1, "tid": 0,
                                         "name": "x", "ts": 0}]})
    with pytest.raises(ValueError):
        validate_trace({"traceEvents": [{"ph": "f", "bp": "e", "pid": 1,
                                         "tid": 0, "name": "u", "ts": 0,
                                         "id": 7}]})
    with pytest.raises(ValueError):
        validate_trace({"traceEvents": [{"ph": "X", "pid": 1, "tid": 0,
                                         "name": "x", "ts": -1, "dur": 1}]})


def test_trace_write_validates_and_roundtrips(tmp_path):
    tb = TraceBuilder()
    tb.client_span(1, 0.0, [("compute", 1.0)])
    path = tmp_path / "t.trace.json"
    tb.write(str(path))
    validate_trace(json.loads(path.read_text()))


@dataclasses.dataclass
class _HostSpan:
    name: str
    t0: float
    dur: float
    compiled: bool


def _trace_calls(tb, seed: int):
    """One sequence of every ``TraceBuilder`` call, its times from
    ``seed``."""
    rng = np.random.default_rng(seed)
    t = 0.0
    for rnd in range(3):
        segs = [(p, float(rng.uniform(0, 2))) for p in
                ("download", "compute", "upload")]
        end = tb.client_span(rnd % 2, t, segs, round_idx=rnd,
                             extra={"version": rnd} if rnd else None)
        fid = tb.flow_start("upload", end, client=rnd % 2,
                            args={"version": rnd})
        tb.counter("uploads in flight", end, {"in_flight": rnd + 1})
        tb.instant("deadline missed", end, client=3,
                   args={"predicted_seconds": 1.5})
        tb.server_span(f"buffer v{rnd}", t, end - t, {"arrivals": 2})
        tb.flow_end("upload", end, fid, args={"staleness": rnd})
        tb.instant("aggregate", end, args={"round": rnd})
        t = end
    tb.add_host_spans([_HostSpan("round", 10.0 + i, 0.25 * i, i == 0)
                       for i in range(3)])
    return tb.to_dict()


def test_trace_dicts_are_the_references(tmp_path):
    got = _trace_calls(trace.TraceBuilder(), 3)
    assert got == _trace_calls(jtrace.TraceBuilder(), 3)
    validate_trace(got)
    jtrace.validate_trace(got)
    assert span_seconds_by_track(got) == jtrace.span_seconds_by_track(got)
    paths = [tmp_path / "port.json", tmp_path / "jax.json"]
    trace.TraceBuilder().write(str(paths[0]))
    jtrace.TraceBuilder().write(str(paths[1]))
    assert paths[0].read_bytes() == paths[1].read_bytes()


# ------------------------------------------------------- the comms models
@pytest.mark.parametrize("d", ["tiny", "full width"])
def test_comms_models_are_the_references(d):
    """Every analytic byte model and time model, over every codec preset,
    at the tiny llama's d and at llama-3.2-1b's full-width d: exact."""
    d = api.trainable_size(_cfg()) if d == "tiny" else FULL_D
    assert CODEC_PRESETS == JCODEC_PRESETS
    specs = sorted({s for pair in CODEC_PRESETS.values() for s in pair})
    for spec in specs:
        assert comms.codec_bytes_per_param(spec, d) == \
            jcomms.codec_bytes_per_param(spec, d), spec
    for up, down in CODEC_PRESETS.values():
        for c, k in ((2, 1), (4, 2), (8, 3)):
            assert comms.firm_round_bytes_codec(d, c, up, down, k) == \
                jcomms.firm_round_bytes_codec(d, c, up, down, k)
            assert comms.fedcmoo_round_bytes_codec(d, c, 2, k, up, down) \
                == jcomms.fedcmoo_round_bytes_codec(d, c, 2, k, up, down)
    for c, k, rank in ((2, 1, 0), (4, 2, 8), (8, 3, 64)):
        assert comms.firm_round_bytes(d, c, k) == \
            jcomms.firm_round_bytes(d, c, k)
        assert comms.fedcmoo_round_bytes(d, c, 3, k, rank) == \
            jcomms.fedcmoo_round_bytes(d, c, 3, k, rank)
    assert comms.local_phase_tokens(2, 16, 256) == \
        jcomms.local_phase_tokens(2, 16, 256) == 8192
    for preset in profiles.PROFILE_PRESETS:
        for p, jp in zip(profiles.sample_profiles(4, preset, 5),
                         jprofiles.sample_profiles(4, preset, 5)):
            for nbytes in (d // 4, d, 4 * d):
                assert comms.transmission_seconds(
                    nbytes, p.up_bytes_per_sec) == \
                    jcomms.transmission_seconds(nbytes, jp.up_bytes_per_sec)
            assert comms.compute_seconds(4096, p.tokens_per_sec) == \
                jcomms.compute_seconds(4096, jp.tokens_per_sec)
            assert comms.client_round_segments(p, 4 * d, d, 2, 16, 256) \
                == jcomms.client_round_segments(jp, 4 * d, d, 2, 16, 256)
    assert comms.transmission_seconds(10, 0) == \
        jcomms.transmission_seconds(10, 0)


# ------------------------------------------------ the engine's emission
def test_engine_emits_records_per_round(tmp_path):
    jpath = tmp_path / "run.jsonl"
    tr = _trainer(metrics_sink=f"jsonl:{jpath}")
    tr.run(2)
    assert tr.host_transfers == 2
    assert tr.obs.values("round/kl") == [h["kl"] for h in tr.history]
    assert [r.round for r in tr.obs.select("round/rewards")] == [0, 1]
    assert tr.obs.values("comm/up_bytes") == [h["up_bytes"]
                                              for h in tr.history]
    tr.obs.close()
    lines = [json.loads(x) for x in jpath.read_text().splitlines()]
    assert len(lines) == len(tr.obs.records) == 2 * 13
    # the summary's keys, the shared builder's exactly
    assert list(tr.history[0]) == [
        "rewards", "lam_mean", "lam_disagreement", "param_drift", "kl",
        "comm_bytes", "up_bytes", "down_bytes", "participants",
        "per_client_lam", "rewards_per_client", "dispatches", "up_nbytes",
        "down_nbytes", "local_steps", "cohorts"]


def test_fused_records_match_per_round_records():
    """A fused chunk's records are the per-round rounds' bit for bit
    (the port's chunk is the per-round body), but ``round/dispatches``
    (the reference's 3 / R); the chunk takes one host transfer."""
    a, b = _trainer(uplink_codec="int8+ef"), \
        _trainer(uplink_codec="int8+ef", fused_rounds=2)
    a.run(2), b.run(2)
    assert (a.host_transfers, b.host_transfers) == (2, 1)
    ra = [r.to_json() for r in a.obs.records]
    rb = [r.to_json() for r in b.obs.records]
    assert [r["name"] for r in ra] == [r["name"] for r in rb]
    for x, y in zip(ra, rb):
        if x["name"] == "round/dispatches":
            assert y["value"] == 1.5
        else:
            assert x == y, x["name"]


def test_a_fused_chunk_with_a_sink_reads_nothing_back(tmp_path):
    """With a JSONL and a CSV sink attached, a fused chunk after the first
    makes no host read and no tensor from host data but for the main
    stream's draws and the participants (``test_torch_fused.py``'s
    check): the records come from the chunk's one copy."""
    tr = _trainer(n_clients=4, uplink_codec="int8+ef", fused_rounds=2,
                  metrics_sink=f"jsonl:{tmp_path}/m.jsonl,"
                               f"csv:{tmp_path}/m.csv")
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
    n0 = len(tr.obs.records)
    with spy:
        tr.run_rounds_fused(2)
    assert spy.found == []
    assert tr.host_transfers == 2
    assert [r.round for r in tr.obs.records[n0:]
            if r.name == "round/kl"] == [2, 3]
