"""What ``launch.rules`` repairs, on the CPU: the steps that DTensor's own
rules refused.

The write into a sequence-sharded cache, with real values: four ``gloo``
processes on a (2, 2) ('data', 'model') mesh run a tiny f32 model with a
full-attention slot (12 slots) and a sliding-window slot (a ring of 6),
prefilled with 5 tokens, through 3 serve steps on a cache laid out by
``cache_shardings``: at B = 2 the slots on 'model', at B = 1 the full
slot's over both mesh dims.  Positions 5, 6 and 7 cross a shard boundary
of the full slot and wrap the ring (slots 5, 0, 1).  The logits and the
gathered cache match the plain serve step's within 1e-5 (f32: ``|got -
want| <= 1e-5 * max(1, max|want|)``).

A write the rule does not handle (an uneven split of the slots, a
Partial cache, two indices) raises.  On small fake meshes (``dryrun.
fake_world``, meta shards) a tiny MoE model whose experts do not divide
the 'model' axis and a tiny xLSTM whose 4 heads do not divide it run the
steps DTensor refused, each with its collectives charged to the mesh
dims expected.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import (DTensor, Partial, Replicate,  # noqa: E402
                                      Shard, distribute_tensor)

from repro_torch.configs import FIRMConfig, get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import dryrun, hlo_cost, rules  # noqa: E402
from repro_torch.launch import sharding as sh, specs, steps  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

P, STEPS, CACHE, WINDOW, TOL = 5, 3, 12, 6, 1e-5


def _cfg():
    cfg = get_config("llama-3.2-1b").reduced(n_layers=2, d_model=64,
                                             vocab=256)
    return dataclasses.replace(cfg, pattern=("attn", "swa"), n_layers=2,
                               n_periods=1, n_kv_heads=2,
                               sliding_window=WINDOW)


def _close(got, want, what):
    limit = TOL * max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= limit, f"{what}: max abs err {err} > {limit}"


def _write_rank(rank: int, store: str, batch: int):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=4)
    try:
        cfg = _cfg()
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        params = transformer.init_params(
            cfg, generator=torch.Generator().manual_seed(0), device="cpu",
            dtype=torch.float32)
        g = torch.Generator().manual_seed(1)
        prompt = torch.randint(0, cfg.vocab, (batch, P), generator=g)
        tokens = torch.randint(0, cfg.vocab, (STEPS, batch, 1), generator=g)
        _, cache = transformer.prefill(cfg, params, prompt, cache_len=CACHE,
                                       cache_dtype=torch.float32)
        c_sh = sh.cache_shardings(cfg, cache, mesh, batch)
        k_full = c_sh["slots"]["0"]["k"].placements
        k_ring = c_sh["slots"]["1"]["k"].placements
        # the layouts this case is for: B = 2 slots on 'model'; B = 1 the
        # full slot's over ('data', 'model'), the ring's (6) on 'model'
        if batch == 2:
            assert k_full == k_ring == (Shard(1), Shard(2))
        else:
            assert k_full == (Shard(2), Shard(2))
            assert k_ring == (Replicate(), Shard(2))
        placed = sh.place(sh.tree_map(lambda t: t.clone(), cache), c_sh)
        dparams = sh.place(params, sh.head_split_shardings(
            cfg, sh.param_shardings(params, mesh)))
        step = steps.make_serve_step(cfg)
        for i in range(STEPS):
            want, cache = step(params, cache, tokens[i])
            tok = sh.place(tokens[i], sh.Sharding(
                mesh, sh.batch_spec(tuple(tokens[i].shape), mesh)))
            got, placed = step(dparams, placed, tok)
            assert isinstance(got, DTensor)
            _close(got.full_tensor(), want, f"logits of step {i}")
        assert int(placed["pos"].full_tensor()) == P + STEPS
        for slot in ("0", "1"):
            for name in ("k", "v"):
                t = placed["slots"][slot][name]
                assert t.placements == c_sh["slots"][slot][name].placements
                _close(t.full_tensor(), cache["slots"][slot][name],
                       f"cache {slot}/{name}")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("batch", [2, 1])
def test_serve_steps_write_a_sequence_sharded_cache(tmp_path, batch):
    mp.spawn(_write_rank, args=(str(tmp_path / "store"), batch), nprocs=4,
             join=True)


# ---------------------------------------------------------- refusals
def _meta(shape, mesh, placements, dtype=torch.float32):
    return distribute_tensor(torch.zeros(shape, dtype=dtype, device="meta"),
                             mesh, placements, src_data_rank=None)


def test_a_write_the_rule_does_not_handle_raises():
    with dryrun.fake_world(4):
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
        src = _meta((2, 1, 3), mesh, [Replicate()])
        one = _meta((1,), mesh, [Replicate()], torch.long)
        uneven = _meta((2, 6, 3), mesh, [Shard(1)])
        with pytest.raises(NotImplementedError, match="do not split"):
            with rules.StepRules(decode=True):
                uneven.index_copy_(1, one, src)
        partial = DTensor.from_local(torch.zeros(2, 8, 3, device="meta"),
                                     mesh, [Partial()], run_check=False)
        with pytest.raises(NotImplementedError, match="Partial"):
            rules.shard_local_index_copy(partial, 1, one, src)
        even = _meta((2, 8, 3), mesh, [Shard(1)])
        two = _meta((2,), mesh, [Replicate()], torch.long)
        with pytest.raises(NotImplementedError, match="2 indices"):
            with rules.StepRules(decode=True):
                even.index_copy_(1, two, _meta((2, 2, 3), mesh,
                                               [Replicate()]))
        # an index dim that no mesh dim shards is DTensor's own write
        rep = _meta((2, 8, 3), mesh, [Replicate()])
        with rules.StepRules(decode=True):
            assert rep.index_copy_(1, one, src) is rep


def test_block_offsets_follow_dtensor_placement():
    """The rule's block of a dim sharded over two mesh dims is the one
    DTensor's own layout puts on this rank (rank 0 of a fake world; a
    real world in the write test above)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset as local_and_offset
    with dryrun.fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        x = _meta((1, 12, 2), mesh, [Shard(1), Shard(1)])
        shape, offset = local_and_offset(x.shape, mesh, x.placements)
        assert rules._block(x, [0, 1]) * shape[1] == offset[1]


# ----------------------------------------- steps on small fake meshes
def _run(cfg, kind, shape, dims, multi=False):
    """A step of ``kind`` on a fake mesh of ``dims``, as the dry-run lays
    it out; the counter's totals."""
    names = ("pod", "data", "model")[-len(dims):]
    fc = FIRMConfig(n_objectives=2, local_steps=2)
    if multi:
        spec = dryrun._multi_pod_train_spec(cfg, fc, shape)
        fn = steps.make_federated_round(cfg, fc, n_pods=2)
        args = (spec["state"], spec["frozen"], spec["batch"], spec["aux"])
    else:
        spec = specs.input_specs(cfg, shape, fc)
        fn, args = steps.step_and_args(cfg, kind, fc, spec)
    n = 1
    for d in dims:
        n *= d
    with dryrun.fake_world(n):
        mesh = init_device_mesh("cpu", dims, mesh_dim_names=names)
        in_sh = tuple(sh.head_split_shardings(cfg, s) for s in
                      dryrun._shardings_for(spec["kind"], cfg, shape, mesh,
                                            spec, multi, fc))
        args = tuple(sh.place(a, s) for a, s in zip(args, in_sh))
        with hlo_cost.CostCounter(mesh) as counter:
            fn(*args)
        return counter.totals()


def _moe_cfg():
    cfg = get_config("mixtral-8x7b").reduced(n_layers=1, d_model=64,
                                             vocab=256)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=3, top_k=2), sliding_window=8)


def _xlstm_cfg():
    return get_config("xlstm-125m").reduced(n_layers=3, d_model=64,
                                            vocab=256)


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_moe_steps_with_experts_that_do_not_divide(kind):
    """3 experts over 2 'model' shards (d_ff sharded instead): the MoE
    products run as planned einsums; the collectives of the train step
    and the prefill reach 'model' (the experts' and the heads' sums) and
    'data' (the gradients' and the router loss's means)."""
    cfg = _moe_cfg()
    assert cfg.moe.n_experts % 2
    t = _run(cfg, kind, InputShape("tiny", 16, 4, kind), (2, 2))
    assert t["collective_bytes_by_dim"].get("model", 0) > 0
    if kind == "train":
        assert t["collective_bytes_by_dim"].get("data", 0) > 0
    assert t["kernels"]["rmsnorm"] > 0 and t["flops"] > 0


def test_moe_round_on_two_pods():
    """The two-pod round of the same MoE model: FedAvg's all-reduces the
    only collectives over 'pod'."""
    t = _run(_moe_cfg(), "train", InputShape("tiny", 16, 8, "train"),
             (2, 2, 2), multi=True)
    assert set(t["collectives_by_dim"]["pod"]) == {"all-reduce"}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_xlstm_steps_with_heads_that_do_not_divide(kind):
    """4 heads over 8 'model' shards: the per-head projections run
    whole on 'model' (``head_split_shardings``), the sLSTM's reshapes
    and forget gate's gradient (``aten.log_sigmoid_backward``, its
    strategy registered by ``launch.rules``) pass; the train step's
    gradients meet over 'data'."""
    cfg = _xlstm_cfg()
    assert cfg.n_heads % 8
    t = _run(cfg, kind, InputShape("tiny", 16, 4, kind), (2, 8))
    assert t["flops"] > 0
    if kind == "train":
        assert t["collective_bytes_by_dim"].get("data", 0) > 0


def test_decode_softmax_reduces_over_the_slot_shards(monkeypatch):
    """The decode step on a (2, 2) fake mesh with its slots on 'model':
    the attention's softmax over the sharded slots is two all-reduces a
    layer over 'model' (its max and its sum, B / 2 x Hq f32 each) in
    place of DTensor's all-gather of the scores, which the same step
    without the rule does."""
    cfg = _cfg()
    shape = InputShape("tiny", CACHE, 4, "decode")
    with_rule = _run(cfg, "decode", shape, (2, 2))
    monkeypatch.setattr(rules, "_SOFTMAX", set())
    without = _run(cfg, "decode", shape, (2, 2))
    got, dt = (t["collectives_by_dim"]["model"] for t in (with_rule,
                                                            without))
    layers, floats = len(cfg.pattern), 4 // 2 * cfg.n_heads
    assert got["all-reduce"]["count"] - dt.get("all-reduce", {}).get(
        "count", 0) == 2 * layers
    assert got["all-reduce"]["bytes"] - dt.get("all-reduce", {}).get(
        "bytes", 0) == 2 * layers * floats * 4
    scores = layers * floats * (CACHE // 2 + WINDOW // 2) // 2 * 4
    assert dt["all-gather"]["bytes"] - got["all-gather"]["bytes"] >= scores
