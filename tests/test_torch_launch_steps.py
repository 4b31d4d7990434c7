"""The port's step functions and per-device cost counter
(``repro_torch.launch.steps``, ``hlo_cost``, ``dryrun``) against the
reference's, on the CPU.

Steps: at a tiny f32 llama (2 layers, d_model 64, vocab 256, 4 query and
2 KV heads), ``make_train_step``, ``make_prefill_step``,
``make_serve_step`` and ``make_federated_round`` (2 pods, K = 2) are held
against the reference's jitted functions on the same inputs, carried over
by ``bridge``.  Tolerance: the f32 rule, ``|got - want| <= 1e-4 *
max(1, max|want|)``; the bf16 K/V caches by the bf16 rule, 2e-2 of the
scale (``test_torch_models.py``).  The federated round's FedAvg runs on a
world-1 ``gloo`` group (``mesh.make_host_mesh("cpu")``), as on one card.

Counter: the reference's cases (``tests/test_hlo_cost.py``) on the
port's counter, exactly: a matmul's flops; a 10-step and a 6x5 loop count
10x and 30x one step; an in-place update counts its slice, not the
buffer; one f32[1024] all-reduce counts 1 and 4096 bytes.  A kernel's
plain version counts once, with the card kernel's costs
(``kernels.costs``).  On a (2, 2, 2) fake mesh, a tiny federated round's
only collectives over 'pod' are FedAvg's all-reduces of the trainables.
The dry-run CLI runs in a subprocess and writes records that
``benchmarks/roofline_report.py`` reads unchanged.

Every test that starts a process group tears it down.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.distributed._functional_collectives as funcol  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import FIRMConfig as JFIRMConfig  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import common as jcommon, transformer as jT  # noqa: E402
from repro.rlhf import local as jlocal, ppo as jppo  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import FIRMConfig, get_config  # noqa: E402
from repro_torch.kernels import costs, ops  # noqa: E402
from repro_torch.launch import dryrun, hlo_cost  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import sharding as sh, steps  # noqa: E402
from repro_torch.rlhf import ppo  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, S, M, K, PODS = 2, 12, 2, 2, 2
F32, BF16 = 1e-4, 2e-2


def _cfgs():
    def tiny(cfg):
        return dataclasses.replace(
            cfg.reduced(n_layers=2, d_model=64, vocab=256), n_kv_heads=2)
    return (tiny(jax_get_config("llama-3.2-1b")),
            tiny(get_config("llama-3.2-1b")))


def _fcs():
    return (JFIRMConfig(n_objectives=M, local_steps=K, batch_size=B),
            FIRMConfig(n_objectives=M, local_steps=K, batch_size=B))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def assert_close(got, want, tol, what=""):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    limit = tol * max(1.0, float(np.abs(w).max()) if w.size else 1.0)
    err = float(np.abs(g - w).max()) if w.size else 0.0
    assert err <= limit, f"{what}: max abs err {err} > {limit}"


def assert_trees_close(got, want, tol, what=""):
    gl, wl = sh.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        assert_close(g, w, tol, f"{what} leaf {i}")


def _params(seed=0):
    """(JAX params, port params): f32, lora_B non-zero."""
    jcfg, _ = _cfgs()
    tree = jax.tree_util.tree_map(np.asarray, jT.init_params(
        jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32))
    rng = np.random.default_rng(seed)

    def lora_b(t):
        if isinstance(t, dict):
            return {k: (rng.normal(0, 0.05, v.shape).astype(np.float32)
                        if k == "lora_B" else lora_b(v))
                    for k, v in t.items()}
        return t
    tree = lora_b(tree)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            bridge.to_torch(tree, device="cpu"))


def _states(jparams):
    """(JAX ClientState, frozen), (port ClientState, frozen)."""
    jcfg, _ = _cfgs()
    jtrain, jfrozen = jcommon.split_trainable(jparams)
    jstate = jlocal.init_client_state(jtrain, M, jcfg.d_model, 0.1)
    np_state = jax.tree_util.tree_map(np.asarray, jstate)
    frozen = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jfrozen),
                             device="cpu")
    return (jstate, jfrozen), (bridge.client_state_to_torch(np_state, "cpu"),
                               frozen)


def _batch(rng, lead=()):
    """A PPO batch of numpy leaves with leading axes ``lead``."""
    shape = lead + (B, S)
    mask = np.zeros(shape, np.float32)
    mask[..., S // 2:] = 1.0
    return (rng.integers(0, 256, shape).astype(np.int32), mask,
            -rng.random(shape).astype(np.float32),
            -rng.random(shape).astype(np.float32),
            rng.normal(size=lead + (B, M)).astype(np.float32))


def _both_batches(np_batch):
    return (jppo.PPOBatch(*(jnp.asarray(a) for a in np_batch)),
            ppo.PPOBatch(*(torch.from_numpy(a.copy()) for a in np_batch)))


@pytest.fixture
def host_group():
    """A world-1 gloo group on the CPU (``make_host_mesh``), torn down."""
    mesh = mesh_lib.make_host_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


# ------------------------------------------------------------------ steps
def test_train_step_matches_the_reference():
    jcfg, tcfg = _cfgs()
    jfc, tfc = _fcs()
    jparams, _ = _params()
    (jstate, jfrozen), (state, frozen) = _states(jparams)
    jb, tb = _both_batches(_batch(np.random.default_rng(1)))
    want_state, want_m = jax.jit(jsteps.make_train_step(jcfg, jfc))(
        jstate, jfrozen, jb, None)
    got_state, got_m = steps.make_train_step(tcfg, tfc)(state, frozen, tb)
    assert sorted(got_m) == sorted(want_m)
    for k in want_m:
        assert_close(got_m[k], want_m[k], F32, k)
    assert_trees_close(got_state, want_state, F32, "state")


def test_prefill_step_matches_the_reference():
    jcfg, tcfg = _cfgs()
    jparams, params = _params()
    tokens = np.random.default_rng(2).integers(0, 256, (B, S)).astype(
        np.int32)
    want_logits, want_cache = jax.jit(jsteps.make_prefill_step(jcfg))(
        jparams, jnp.asarray(tokens), None)
    got_logits, got_cache = steps.make_prefill_step(tcfg)(
        params, torch.from_numpy(tokens))
    assert_close(got_logits, want_logits, F32, "last logits")
    assert tuple(got_logits.shape) == (B, tcfg.vocab)
    assert int(got_cache["pos"]) == int(want_cache["pos"]) == S
    for name in ("k", "v"):
        assert_close(got_cache["slots"]["0"][name],
                     want_cache["slots"]["0"][name], BF16, name)


def test_serve_step_matches_the_reference():
    jcfg, tcfg = _cfgs()
    jparams, params = _params()
    tokens = np.random.default_rng(3).integers(0, 256, (B, S)).astype(
        np.int32)
    _, jcache = jT.prefill(jcfg, jparams, jnp.asarray(tokens),
                           cache_len=S + 4, cache_dtype=jnp.float32)
    cache = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jcache),
                            device="cpu")
    token = tokens[:, -1:]
    want_logits, want_cache = jax.jit(jsteps.make_serve_step(jcfg))(
        jparams, jcache, jnp.asarray(token))
    got_logits, got_cache = steps.make_serve_step(tcfg)(
        params, cache, torch.from_numpy(token.copy()))
    assert_close(got_logits, want_logits, F32, "logits")
    assert int(got_cache["pos"]) == int(want_cache["pos"]) == S + 1
    assert_trees_close(got_cache, want_cache, F32, "cache")


def test_federated_round_matches_the_reference(host_group):
    """2 pods, K = 2: each pod's K local steps on its own batches, then
    FedAvg's mean of the trainables on every pod."""
    jcfg, tcfg = _cfgs()
    jfc, tfc = _fcs()
    jparams, _ = _params()
    (jstate, jfrozen), (state, frozen) = _states(jparams)
    np_batches = _batch(np.random.default_rng(4), lead=(PODS, K))
    jb, tb = _both_batches(np_batches)
    jstacked = jax.tree_util.tree_map(lambda x: jnp.stack([x] * PODS),
                                      jstate)
    stacked = sh.tree_map(lambda x: torch.stack([x] * PODS), state)
    want_state, want_m = jax.jit(jsteps.make_federated_round(
        jcfg, jfc, PODS))(jstacked, jfrozen, jb, None)
    got_state, got_m = steps.make_federated_round(tcfg, tfc, PODS)(
        stacked, frozen, tb)
    assert sorted(got_m) == sorted(want_m)
    for k in want_m:
        assert tuple(got_m[k].shape[:2]) == (PODS, K)
        assert_close(got_m[k], want_m[k], F32, k)
    assert_trees_close(got_state, want_state, F32, "stacked state")
    for leaf in sh.tree_leaves(got_state.trainable):
        assert torch.equal(leaf[0], leaf[1])
    # FedAvg is the mean of the pods' solo K steps, bit for bit
    solo = []
    for p in range(PODS):
        s = state
        for k in range(K):
            s, _ = steps.make_train_step(tcfg, tfc)(
                s, frozen, ppo.PPOBatch(*(t[p, k] for t in tb)))
        solo.append(s.trainable)
    for got, a, b in zip(sh.tree_leaves(got_state.trainable),
                         sh.tree_leaves(solo[0]), sh.tree_leaves(solo[1])):
        assert torch.equal(got[0], torch.stack([a, b]).mean(0))


def test_federated_round_needs_a_group():
    _, tcfg = _cfgs()
    _, tfc = _fcs()
    jparams, _ = _params()
    _, (state, frozen) = _states(jparams)
    stacked = sh.tree_map(lambda x: torch.stack([x] * PODS), state)
    _, tb = _both_batches(_batch(np.random.default_rng(5), lead=(PODS, K)))
    with pytest.raises(RuntimeError, match="process group"):
        steps.make_federated_round(tcfg, tfc, PODS)(stacked, frozen, tb)


def test_host_mesh(host_group):
    assert host_group.mesh_dim_names == ("data", "model")
    assert tuple(host_group.shape) == (1, 1)
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1


def test_host_mesh_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_lib.make_host_mesh()
    assert not dist.is_initialized()


# ------------------------------------------------ the counter: reference's
def _rand(*shape):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(0))


def test_dot_flops_exact():
    a, b = _rand(64, 256), _rand(256, 32)
    t = hlo_cost.analyze(lambda: a @ b)
    assert t["flops"] == 2 * 64 * 256 * 32
    assert t["bytes"] == 4 * (64 * 256 + 256 * 32 + 64 * 32)


def _step(x, w):
    return torch.tanh(x @ w)


def test_scan_matches_unrolled():
    """A loop of 10 counts 10 times its body (the reference's walker
    multiplies while bodies by their trip count)."""
    w, x = _rand(128, 128), _rand(32, 128)

    def loop():
        y = x
        for _ in range(10):
            y = _step(y, w)
        return y
    one = hlo_cost.analyze(_step, x, w)
    ten = hlo_cost.analyze(loop)
    assert one["flops"] == 2 * 32 * 128 * 128 + 32 * 128
    assert ten["flops"] == 10 * one["flops"]
    assert ten["bytes"] == 10 * one["bytes"]


def test_nested_scan_multiplies():
    w, x = _rand(64, 64), _rand(16, 64)

    def nested():
        y = x
        for _ in range(6):
            for _ in range(5):
                y = _step(y, w)
        return y
    t = hlo_cost.analyze(nested)
    assert t["flops"] == 30 * (2 * 16 * 64 * 64 + 16 * 64)


def test_unrolled_bytes_exact():
    """tanh(a @ a) @ a: operands and results of each operation, 8 MB."""
    a = _rand(512, 512)
    t = hlo_cost.analyze(lambda: torch.tanh(a @ a) @ a)
    assert t["bytes"] == 8 * 512 * 512 * 4


def test_dus_counted_in_place():
    """100 one-row updates of a 4 MB buffer: twice each row's 4 KB (and
    its index), not the buffer."""
    buf, upd = torch.zeros(1024, 1024), _rand(1, 1024)

    def by_slice():
        for i in range(100):
            buf[i] = upd[0]

    def by_index():
        for i in range(100):
            buf.index_copy_(0, torch.tensor([i]), upd)
    t1 = hlo_cost.analyze(by_slice)
    t2 = hlo_cost.analyze(by_index)
    assert t1["bytes"] == 100 * 2 * 4096 < 100e6
    assert t2["bytes"] == 100 * 2 * (4096 + 8) < 100e6


def test_collective_counted(host_group):
    x = torch.ones(1024)
    for fn in (lambda: funcol.all_reduce(x, "sum", dist.group.WORLD).wait(),
               lambda: dist.all_reduce(x)):
        t = hlo_cost.analyze(fn)
        assert t["collectives"]["all-reduce"] == {"count": 1, "bytes": 4096}
        assert t["collective_bytes"] == 4096


# ------------------------------------------------- kernels count once
def test_flash_counts_once_with_the_kernels_costs():
    """The plain attention's S x S scores are not counted: one call of the
    kernel with its operations and bytes, and one backward call."""
    q = _rand(2, 64, 4, 16).requires_grad_()
    k, v = _rand(2, 64, 2, 16), _rand(2, 64, 2, 16)
    with hlo_cost.CostCounter() as c:
        o = ops.flash_attention(q, k, v, causal=True)
        fwd = c.totals()
        (g,) = torch.autograd.grad(o.sum(), (q,))
    t = c.totals()
    assert fwd["kernels"] == {"flash_attention": 1}
    f_bytes, f_ops, _ = costs.flash_attention(q, k, v, causal=True)
    b_bytes, b_ops, _ = costs.flash_attention_bwd(q, k, v, causal=True)
    assert fwd["flops"] == f_ops == 4 * 16 * 2 * 4 * (64 * 65 // 2)
    assert fwd["bytes"] == f_bytes
    assert t["kernels"] == {"flash_attention": 1, "flash_attention_bwd": 1}
    assert t["flops_by_op"]["flash_attention_bwd"] == b_ops
    # the counted path is the plain version's value and gradient
    want = torch.autograd.grad(ops.ref.flash_attention(q, k, v).sum(), (q,))
    assert torch.allclose(g, want[0], atol=1e-5)


def test_rmsnorm_and_gram_count_once():
    x = _rand(8, 64).requires_grad_()
    g = torch.ones(64, requires_grad=True)
    with hlo_cost.CostCounter() as c:
        y = ops.rmsnorm(x, g)
        torch.autograd.grad(y.sum(), (x, g))
        ops.gram(_rand(2, 1000))
    t = c.totals()
    assert t["kernels"] == {"rmsnorm": 1, "rmsnorm_bwd": 1, "gram": 1}
    assert t["flops_by_op"]["rmsnorm"] == 4 * 8 * 64
    assert t["flops_by_op"]["rmsnorm_bwd"] == 22 * 8 * 64   # with dg
    assert t["flops_by_op"]["gram"] == 2 * 2 * 2 * 1000


def test_attention_pairs():
    assert costs.attention_pairs(5, 5, True, 0) == 15
    assert costs.attention_pairs(3, 7, False, 0) == 21
    assert costs.attention_pairs(6, 6, True, 2) == 11
    assert costs.attention_pairs(4, 4, False, 2) == sum(
        1 for i in range(4) for j in range(4) if i - j < 2)


# --------------------------------------- the pod axis on a fake mesh
def test_fake_mesh_round_collectives_over_pod():
    """A tiny round on a (2, 2, 2) fake mesh of meta shards: the only
    collectives over 'pod' are FedAvg's all-reduces, one a trainable
    leaf, totalling this device's shards of the trainables (DTensor's
    rules may leave an updated adapter sharded over 'data' or 'model')."""
    from torch.distributed.device_mesh import init_device_mesh
    _, tcfg = _cfgs()
    _, tfc = _fcs()
    from repro_torch.launch import specs
    from repro_torch.configs.base import InputShape
    shape = InputShape("tiny", S, 2 * PODS, "train")
    spec = dryrun._multi_pod_train_spec(tcfg, tfc, shape)
    with dryrun.fake_world(8):
        mesh = init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
        shardings = dryrun._shardings_for("train", tcfg, shape, mesh, spec,
                                          True, tfc)
        args = [sh.place(spec[k], s) for k, s in zip(
            ("state", "frozen", "batch", "aux"), shardings)]
        with hlo_cost.CostCounter(mesh) as c:
            new, metrics = steps.make_federated_round(tcfg, tfc, PODS)(*args)
        t = c.totals()
        leaves = sh.tree_leaves(new.trainable)
        assert all(tuple(x.shape)[0] == PODS and x.to_local().shape[0] == 1
                   for x in leaves)
        n_bytes = sum(costs.nbytes(x) for x in leaves)
    trainables = sh.tree_leaves(specs.state_specs(tcfg, tfc)[0].trainable)
    assert len(leaves) == len(trainables)
    assert 0 < n_bytes <= sum(costs.nbytes(x) for x in trainables)
    assert t["collectives_by_dim"]["pod"] == {
        "all-reduce": {"count": len(trainables), "bytes": n_bytes}}
    assert tuple(metrics["lam"].shape) == (PODS, K, M)


def test_dtensor_index_copy_on_a_sharded_dim_relabels_it():
    """What ``launch.rules``' shard-local write works round: DTensor's
    ``index_copy_`` into a tensor sharded on the index dim returns it
    relabelled ``Replicate()`` with its local shard unchanged (a local
    shape that no longer matches the placement).  If torch starts to
    write the shard instead, this fails and the rule can go."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with dryrun.fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        cache = distribute_tensor(torch.zeros(4, 8, 2, 3, device="meta"),
                                  mesh, [Shard(0), Shard(1)],
                                  src_data_rank=None)
        src = distribute_tensor(torch.zeros(4, 1, 2, 3, device="meta"),
                                mesh, [Shard(0), Replicate()],
                                src_data_rank=None)
        idx = distribute_tensor(torch.zeros(1, dtype=torch.long,
                                            device="meta"), mesh,
                                [Replicate(), Replicate()],
                                src_data_rank=None)
        out = cache.index_copy_(1, idx, src)
        assert out.placements == (Shard(0), Replicate())
        assert tuple(out.to_local().shape) == (2, 4, 2, 3)


# --------------------------------------------------------- the dry-run
def test_dryrun_cli_writes_what_roofline_report_reads(tmp_path):
    """Two ok pairs (prefill and decode at 1 layer: the decode step
    writes its slot into a sequence-sharded cache) and two skipped ones,
    read by the unchanged ``roofline_report.py``."""
    out = tmp_path / "dryrun.json"
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    one_layer = ["--override", "n_layers=1", "--override", "n_periods=1"]
    for shape, mesh, rc in (("prefill_32k", "single", 0),
                            ("decode_32k", "single", 0),
                            ("long_500k", "both", 0)):
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "llama-3.2-1b", "--shape", shape, "--mesh", mesh, "--out",
             str(out)] + (one_layer if shape != "long_500k" else []),
            env=env, capture_output=True, timeout=600)
        assert run.returncode == rc, run.stdout[-2000:]
    recs = json.loads(out.read_text())
    assert [(r["shape"], r["mesh"], r["status"]) for r in recs] == [
        ("prefill_32k", "16x16", "ok"), ("decode_32k", "16x16", "ok"),
        ("long_500k", "16x16", "skipped"),
        ("long_500k", "2x16x16", "skipped")]
    assert recs[1]["kernel_calls"] == {"rmsnorm": 3}
    ok = recs[0]
    assert ok["devices"] == 256 and ok["overrides"] == {"n_layers": 1,
                                                        "n_periods": 1}
    for key in ("flops_per_device", "bytes_per_device",
                "collective_bytes_per_device", "model_flops_per_device",
                "useful_flop_ratio", "params_total", "params_active",
                "trace_s"):
        assert ok[key] >= 0, key
    assert set(ok["memory"]) == {"argument_bytes", "output_bytes",
                                 "temp_bytes"}
    assert ok["dominant_term"] in ok["roofline"]
    assert ok["kernel_calls"] == {"rmsnorm": 3, "flash_attention": 1}
    report = subprocess.run(
        [sys.executable, "-c",
         "from benchmarks.roofline_report import bench_roofline_table, "
         "bench_roofline_per_pair; print(bench_roofline_table()); "
         "print(len(bench_roofline_per_pair()))"],
        check=True, env=dict(env, DRYRUN_JSON=str(out), JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    lines = report.stdout.strip().splitlines()
    assert lines[0].startswith("roofline_table,")
    assert '"pairs_ok": 2' in lines[0] and '"pairs_skipped": 2' in lines[0]
    assert lines[-1] == "2"


def test_pair_time_limit():
    """A pair still tracing after its limit raises ``PairTimeout``, which
    ``main`` records as the pair's error."""
    import time
    with pytest.raises(dryrun.PairTimeout, match="within 1 s"):
        with dryrun._time_limit(1):
            time.sleep(5)
