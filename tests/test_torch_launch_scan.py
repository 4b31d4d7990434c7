"""``common.scan``, the port's ``jax.lax.scan``, and ``launch.rules``
running it over DTensors on their shards, on the CPU.

(a) The xLSTM's three recurrences through ``common.scan`` are the Python
loops they replaced, written out here: outputs, final states and the
gradients of a scalar loss bit for bit, f32 and bf16, at the tiny xLSTM
config (``get_config("xlstm-125m").reduced(n_layers=3, d_model=64,
vocab=256)``).  ``scan`` itself is held to ``jax.lax.scan`` on the same
body and numpy inputs: f32, ``|got - want| <= 1e-6 * max(1, max|want|)``.

(b) On small fake meshes (``dryrun.fake_world``, meta shards), laid out
as the dry-run lays its pairs out, the cost counter's totals with the
scans run on the shards (their middle steps replayed, ``launch.replay``)
equal those of the same steps with every scan run as its loop of
DTensor operations (``rules.scan_on_shards`` replaced in the test):
flops, bytes, collectives by mesh dim and kind, kernel calls, flops by
operation and, for the sLSTM with every DTensor operation run, the
tracked peak, for ``train`` and ``prefill`` on (2, 8) and the two-pod
round on (2, 2, 2).  Each test says why it leaves the peak out where it
does.  DTensor caches its sharding decisions by spec, and the first run
to meet a spec also counts what DTensor runs to decide it, so both paths
are compared after a run of each.  Replayed steps hold everything the
steps they replay hold, the peak too, against the loop on plain meta
tensors.

(c) The DTensor operations the counter handles in an sLSTM layer (its
forward and backward) do not grow with S on the shards, where the loop of
DTensor operations grows with every step.

(d) Four ``gloo`` processes on a (2, 2) ('data', 'model') mesh run an
sLSTM layer, batch on 'data', forward and backward, with real values:
output and every gradient within 1e-5 of the plain layer's (f32, ``|got
- want| <= 1e-5 * max(1, max|want|)``), on the shards and as the loop of
DTensor operations (where the recurrent einsum's weight gradient, summed
over the batch's shards, must come out Partial).
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import (DTensor, Replicate, Shard,  # noqa: E402
                                      distribute_tensor)
from torch.distributed.tensor.experimental import \
    implicit_replication  # noqa: E402

from repro.models import xlstm as jx  # noqa: E402
from repro_torch.configs import FIRMConfig, get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import dryrun, hlo_cost, replay, rules  # noqa: E402
from repro_torch.launch import sharding as sh, specs, steps  # noqa: E402
from repro_torch.models import common, xlstm  # noqa: E402


def _cfg():
    return get_config("xlstm-125m").reduced(n_layers=3, d_model=64,
                                            vocab=256)


# --------------------------------------------- (a) the loops it replaced
def _slstm_loop(p, cfg, x):
    b, s, d = x.shape
    wx = xlstm._slstm_in(p, cfg, x)
    z = torch.zeros((b, d), dtype=torch.float32, device=x.device)
    state, hs = (z, z, z, z), []
    for t in range(s):
        state, h = xlstm._slstm_step(p, d, state, wx[:, t])
        hs.append(h)
    out = x + common.linear(p["out_proj"],
                            torch.stack(hs, dim=1).to(x.dtype))
    return out, dict(zip(("c", "n", "h", "m"), state))


def _mlstm_recurrent_loop(p, cfg, x):
    b, s, _ = x.shape
    q, k, v, i_log, f_log, o = xlstm._mlstm_qkvg(p, cfg, x)
    state = xlstm._zero_state(b, cfg.n_heads, cfg.head_dim, x.device)
    hs = []
    for t in range(s):
        state, h = xlstm._mlstm_step(state, q[:, t], k[:, t], v[:, t],
                                     i_log[:, t], f_log[:, t])
        hs.append(h)
    return xlstm._mlstm_out(p, x, torch.stack(hs, dim=1), o, state, True)


def _mlstm_chunked_loop(p, cfg, x, chunk):
    import math
    b, s, _ = x.shape
    hh, dh = cfg.n_heads, cfg.head_dim
    q, k, v, i_log, f_log, o = xlstm._mlstm_qkvg(p, cfg, x)
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i_log = F.pad(i_log, (0, 0, 0, pad), value=-1e30)
        f_log = F.pad(f_log, (0, 0, 0, pad))
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()[None, :, :, None]
    C, n, m = xlstm._zero_state(b, hh, dh, x.device)
    hs = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        qk, kk, vk, ik, fk = q[:, sl], k[:, sl], v[:, sl], i_log[:, sl], \
            f_log[:, sl]
        F_ = torch.cumsum(fk, dim=1)
        a_intra = F_[:, :, None, :] - F_[:, None, :, :] + ik[:, None, :, :]
        a_intra = torch.where(causal, a_intra, -math.inf)
        m_intra = a_intra.amax(dim=2)
        m_inter = F_ + m[:, None, :]
        m_comb = torch.clamp(torch.maximum(m_intra, m_inter), min=-1e30)
        w = torch.exp(a_intra - m_comb[:, :, None, :])
        qkd = torch.einsum("bihe,bjhe->bijh", qk, kk)
        h_num = torch.einsum("bijh,bjhe->bihe", w * qkd, vk)
        n_dot = torch.einsum("bijh,bjhe,bihe->bih", w, kk, qk)
        scale_i = torch.exp(m_inter - m_comb)
        h_num = h_num + torch.einsum("bihe,bhed->bihd", qk, C) * \
            scale_i[..., None]
        n_dot = n_dot + torch.einsum("bihe,bhe->bih", qk, n) * scale_i
        hs.append(h_num / torch.clamp(torch.abs(n_dot), min=1.0)[..., None])
        F_last = F_[:, -1:, :]
        g = F_last - F_ + ik
        m_state = torch.maximum(F_last[:, 0] + m, g.amax(dim=1))
        wS = torch.exp(g - m_state[:, None, :])
        decay = torch.exp(F_last[:, 0] + m - m_state)
        C = C * decay[..., None, None] + \
            torch.einsum("bjh,bjhe,bjhd->bhed", wS, kk, vk)
        n = n * decay[..., None] + torch.einsum("bjh,bjhe->bhe", wS, kk)
        m = m_state
    hs = torch.cat(hs, dim=1)[:, :s]
    return xlstm._mlstm_out(p, x, hs, o, (C, n, m), True)


CASES = {
    "slstm": (xlstm.init_slstm, _slstm_loop,
              lambda p, cfg, x: xlstm.slstm_seq(p, cfg, x, True)),
    "mlstm_recurrent": (
        xlstm.init_mlstm, _mlstm_recurrent_loop,
        lambda p, cfg, x: xlstm.mlstm_seq_recurrent(p, cfg, x, True)),
    "mlstm_chunked_5": (
        xlstm.init_mlstm, lambda p, cfg, x: _mlstm_chunked_loop(p, cfg, x, 5),
        lambda p, cfg, x: xlstm.mlstm_seq_chunked(p, cfg, x, True, chunk=5)),
    "mlstm_chunked_8": (
        xlstm.init_mlstm, lambda p, cfg, x: _mlstm_chunked_loop(p, cfg, x, 8),
        lambda p, cfg, x: xlstm.mlstm_seq_chunked(p, cfg, x, True, chunk=8)),
}


def _forward_and_grads(fn, p, cfg, x):
    leaves = [t for t in sh.tree_leaves(p) if t.is_floating_point()]
    inputs = [x] + leaves
    inputs = [t.detach().requires_grad_() for t in inputs]
    it = iter(inputs[1:])
    params = sh.tree_map(lambda t: next(it) if t.is_floating_point() else t,
                         p)
    out, state = fn(params, cfg, inputs[0])
    loss = (out.float() ** 2).sum() + sum((v.float() ** 2).sum()
                                          for v in state.values())
    grads = torch.autograd.grad(loss, inputs)
    return out.detach(), {k: v.detach() for k, v in state.items()}, grads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_scan_is_the_loop_it_replaced(case, dtype):
    """S = 13: the chunked form at 5 has a ragged tail of 2, at 8 one of
    3."""
    cfg = _cfg()
    init, loop, scanned = CASES[case]
    g = torch.Generator().manual_seed(0)
    p = init(cfg, generator=g, device="cpu", dtype=dtype)
    x = torch.randn(2, 13, cfg.d_model, generator=g).to(dtype)
    want = _forward_and_grads(loop, p, cfg, x)
    got = _forward_and_grads(scanned, p, cfg, x)
    assert torch.equal(got[0], want[0])
    assert set(got[1]) == set(want[1])
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k]), k
    assert len(got[2]) == len(want[2])
    for a, b in zip(got[2], want[2]):
        assert torch.equal(a, b)


def _close(got, want, tol, what=""):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    limit = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= limit, f"{what}: max abs err {err} > {limit}"


def test_scan_matches_lax_scan_on_the_slstm_cell():
    """The sLSTM cell of each package, scanned over 13 steps along dim 1
    of the same (B, S, 4d) numpy input: the final state and the stacked
    outputs (moved to dim 1 on the JAX side)."""
    rng = np.random.default_rng(0)
    b, s, d, hh = 2, 13, 64, 4
    r = (rng.standard_normal((hh, d // hh, 4 * d // hh)) / 4).astype(
        np.float32)
    bias = (rng.standard_normal(4 * d) * 0.1).astype(np.float32)
    wx = rng.standard_normal((b, s, 4 * d)).astype(np.float32)
    jp = {"r": jnp.asarray(r), "b": jnp.asarray(bias)}
    z = jnp.zeros((b, d), jnp.float32)
    (jstate, jhs) = jax.lax.scan(lambda c, x: jx._slstm_step(jp, d, c, x),
                                 (z, z, z, z), jnp.moveaxis(jnp.asarray(wx),
                                                            1, 0))
    tp = {"r": torch.from_numpy(r), "b": torch.from_numpy(bias)}
    tz = torch.zeros((b, d))
    tstate, ths = common.scan(functools.partial(xlstm._slstm_step, tp, d),
                              (tz, tz, tz, tz), torch.from_numpy(wx), dim=1)
    _close(ths.numpy(), np.moveaxis(np.asarray(jhs), 0, 1), 1e-6, "hs")
    for name, got, want in zip("cnhm", tstate, jstate):
        _close(got.numpy(), np.asarray(want), 1e-6, name)


def test_scan_matches_lax_scan_with_tuples_on_dim_0():
    """A body of two xs and two ys, scanned along dim 0 as ``lax.scan``
    scans: ``c' = 0.9 c + a * tanh(b)``, ys ``(c'.sum(-1), c' * a)``."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((7, 3, 5)).astype(np.float32)
    bb = rng.standard_normal((7, 3, 5)).astype(np.float32)
    c0 = rng.standard_normal((3, 5)).astype(np.float32)

    def jbody(c, xs):
        x, y = xs
        c = 0.9 * c + x * jnp.tanh(y)
        return c, (c.sum(-1), c * x)

    def tbody(c, xs):
        x, y = xs
        c = 0.9 * c + x * torch.tanh(y)
        return c, (c.sum(-1), c * x)
    jc, (j1, j2) = jax.lax.scan(jbody, jnp.asarray(c0),
                                (jnp.asarray(a), jnp.asarray(bb)))
    tc, (t1, t2) = common.scan(tbody, torch.from_numpy(c0),
                               (torch.from_numpy(a), torch.from_numpy(bb)))
    assert t1.shape == (7, 3) and t2.shape == (7, 3, 5)
    for got, want in ((tc, jc), (t1, j1), (t2, j2)):
        _close(got.numpy(), np.asarray(want), 1e-6)


def test_scan_takes_part_in_the_function_protocol():
    """A ``TorchFunctionMode`` sees one ``common.scan`` call, with the
    tensors the body binds among its operands; without a mode the loop
    runs."""
    from torch.overrides import TorchFunctionMode
    seen = []

    class Spy(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is common.scan:
                seen.append(len(common.scan_operands(*args)))
            return func(*args, **(kwargs or {}))
    w = torch.ones(3)
    body = functools.partial(lambda w, c, x: (c + w * x, c), w)
    with Spy():
        c, ys = common.scan(body, torch.zeros(3), torch.ones(4, 3))
    assert seen == [3]                 # w, the carry, the xs
    assert torch.equal(c, torch.full((3,), 4.0)) and ys.shape == (4, 3)


# ----------------------------------------- (b) counts on fake meshes
def _run(cfg, kind, shape, dims, multi=False):
    """A step of ``kind`` on a fake mesh of ``dims``, laid out as the
    dry-run lays it out; the counter's totals."""
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


KEYS = ("flops", "bytes", "collectives_by_dim", "kernels", "peak_bytes",
        "flops_by_op")


def _compare(monkeypatch, cfg, kind, dims, batch, s, memo):
    """The counter's totals of a step with every scan on the shards and
    with every scan as its loop of DTensor operations (each after a run
    of both); ``memo=False`` runs every DTensor operation where the
    counter would replay its record (``CostCounter._memo``)."""
    multi = kind == "round"
    shape = InputShape("tiny", s, batch, "train" if multi else kind)
    if not memo:
        monkeypatch.setattr(hlo_cost.CostCounter, "_dtensor_op",
                            lambda self, func, args, kwargs: None)
        monkeypatch.setattr(hlo_cost, "memoized", lambda tag, fn, *a: fn(*a))
    on_shards = rules.scan_on_shards
    ran = []

    def spy(*args, **kwargs):
        out = on_shards(*args, **kwargs)
        ran.append(out is not None)
        return out

    def per_op(*args, **kwargs):
        return None
    totals = {}
    for rule in (per_op, spy, per_op, spy):
        monkeypatch.setattr(rules, "scan_on_shards", rule)
        totals[rule] = _run(cfg, kind, shape, dims, multi)
    return totals[spy], totals[per_op], ran


@pytest.mark.parametrize("memo", [False, True],
                         ids=["each-operation-run", "records-replayed"])
@pytest.mark.parametrize("kind,dims,batch,s", [
    ("train", (2, 8), 4, 32), ("prefill", (2, 8), 4, 32),
    ("round", (2, 2, 2), 8, 16)])
def test_slstm_on_the_shards_counts_what_the_dtensor_loop_counts(
        monkeypatch, kind, dims, batch, s, memo):
    """The sLSTM's S steps on the shards, the middle ones replayed
    (``launch.replay``); the mLSTM's one chunk of 128 as before.  With
    every DTensor operation run, every total equal, the tracked peak too.
    With the counter's records of DTensor operations replayed, all but
    the peak: a record keeps the peak its first run reached above the
    bytes then held, which is not the peak of a later call, so the two
    paths, which replay different operations, part there."""
    got, want, ran = _compare(monkeypatch, _cfg(), kind, dims, batch, s,
                              memo)
    assert True in ran                 # the sLSTM's scan ran on the shards
    for k in KEYS:
        if k != "peak_bytes" or not memo:
            assert got[k] == want[k], k


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_mlstm_chunks_on_the_shards_count_what_the_dtensor_loop_counts(
        monkeypatch, kind):
    """Chunks of 3 at S = 24: eight chunks on the shards, the middle ones
    replayed, every DTensor operation run: flops, bytes, collectives,
    kernel calls and flops by operation equal.  The tracked peak is not
    compared: the counter follows the life of the tensor objects that
    operations make, and a DTensor operation's shard lives as long as its
    DTensor, which the rules and autograd hold otherwise than the plain
    tensors of the same operations on the shards; this body shows it (a
    few percent at this size), the sLSTM's does not (above), and the
    replayed steps hold what the steps they replay hold (below)."""
    cfg = dataclasses.replace(_cfg(), mlstm_chunk=3)
    got, want, ran = _compare(monkeypatch, cfg, kind, (2, 8), 4, 24, False)
    assert ran and all(ran)
    for k in KEYS:
        if k != "peak_bytes":
            assert got[k] == want[k], k


def _slstm_scan(grad):
    d, b, s = 64, 2, 24
    r = torch.empty(4, d // 4, d, device="meta").requires_grad_(grad)
    bias = torch.empty(4 * d, device="meta").requires_grad_(grad)
    wx = torch.empty(b, s, 4 * d, device="meta").requires_grad_(grad)
    z = torch.zeros(b, d, device="meta")
    return (functools.partial(xlstm._slstm_step, {"r": r, "b": bias}, d),
            (z,) * 4, wx, [wx, r, bias])


def _mlstm_chunk_scan(grad):
    b, nc, ch, h, dh = 2, 10, 16, 4, 16
    xs = tuple(torch.empty(b, nc, ch, h, dh, device="meta")
               .requires_grad_(grad) for _ in range(3)) + tuple(
        torch.empty(b, nc, ch, h, device="meta").requires_grad_(grad)
        for _ in range(2))
    causal = torch.ones((ch, ch), dtype=torch.bool,
                        device="meta").tril()[None, :, :, None]
    return (functools.partial(xlstm._mlstm_chunk_step, causal),
            xlstm._zero_state(b, h, dh, "meta"), xs, list(xs))


@pytest.mark.parametrize("grad", [True, False], ids=["train", "no-grad"])
@pytest.mark.parametrize("make", [_slstm_scan, _mlstm_chunk_scan],
                         ids=["slstm", "mlstm-chunks"])
def test_replayed_steps_count_what_the_loop_counts(make, grad):
    """An sLSTM scan of 24 steps and an mLSTM scan of 10 chunks on plain
    meta tensors under the counter, the middle steps replayed
    (``replay.counted_scan``) against the loop: flops, bytes, flops by
    operation, the peak and the bytes still held after the forward and
    after two backward pulls (the second releasing the graph), equal."""
    results = []
    for counted in (False, True):
        body, carry, xs, wrt = make(grad)
        with torch.set_grad_enabled(grad), \
                hlo_cost.CostCounter() as counter:
            base = counter.live_bytes
            state, hs = (replay.counted_scan(counter, body, carry, xs, 1,
                                             0, []) if counted else
                         common.scan_loop(body, carry, xs, 1))
            del state, carry, body
            held = [counter.live_bytes - base]
            if grad:
                loss = hs.sum()
                for j in range(2):
                    torch.autograd.grad(loss, wrt, retain_graph=j == 0)
                del loss
                held.append(counter.live_bytes - base)
            del hs
        results.append((counter.flops, counter.bytes, counter.flops_by_op,
                        counter.peak_bytes, held))
    assert results[1] == results[0]


# ------------------------------------ (c) dispatches do not grow with S
class _Dispatches(hlo_cost.CostCounter):
    """A ``CostCounter`` that counts the DTensor operations it handles."""

    def __init__(self, mesh):
        super().__init__(mesh)
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types) and not self._below:
            self.n += 1
        return super().__torch_dispatch__(func, types, args, kwargs)


def _slstm_dispatches(s: int) -> int:
    cfg = _cfg()
    with dryrun.fake_world(16):
        mesh = init_device_mesh("cpu", (2, 8),
                                mesh_dim_names=("data", "model"))
        p = xlstm.init_slstm(cfg, generator=torch.Generator().manual_seed(0),
                             device="meta", dtype=torch.float32)
        p = sh.tree_map(lambda t: distribute_tensor(
            t, mesh, [Replicate(), Replicate()],
            src_data_rank=None).requires_grad_(), p)
        x = distribute_tensor(torch.zeros(4, s, cfg.d_model, device="meta"),
                              mesh, [Shard(0), Replicate()],
                              src_data_rank=None).requires_grad_()
        with implicit_replication(), rules.StepRules(), \
                _Dispatches(mesh) as counter:
            out = xlstm.slstm_seq(p, cfg, x)
            torch.autograd.grad(out.sum(), [x, p["r"]])
        return counter.n


def test_slstm_dispatches_do_not_grow_with_the_sequence(monkeypatch):
    on_shards = (_slstm_dispatches(16), _slstm_dispatches(64))
    assert on_shards[0] == on_shards[1]
    monkeypatch.setattr(rules, "scan_on_shards", lambda *a, **k: None)
    per_op = (_slstm_dispatches(16), _slstm_dispatches(64))
    assert per_op[1] > per_op[0] + 48 > on_shards[1]


def test_layouts_the_rule_does_not_run_on_the_shards():
    """A bound weight sharded (on 'model'), or xs sharded on a dim other
    than the batch: ``scan_on_shards`` runs nothing and says so."""
    cfg = _cfg()
    with dryrun.fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))

        def meta(shape, pl):
            return distribute_tensor(torch.zeros(shape, device="meta"), mesh,
                                     pl, src_data_rank=None)
        d = cfg.d_model
        r = meta((4, d // 4, d), [Replicate(), Replicate()])
        bias = meta((4 * d,), [Replicate(), Replicate()])
        wx = meta((4, 6, 4 * d), [Shard(0), Replicate()])
        z = torch.zeros(4, d, device="meta")
        mode = rules.StepRules()

        def body(r_, b_):
            return functools.partial(xlstm._slstm_step, {"r": r_, "b": b_}, d)
        assert rules.scan_on_shards(
            mode, body(meta((4, d // 4, d), [Replicate(), Shard(0)]), bias),
            (z,) * 4, wx, dim=1) is None
        assert rules.scan_on_shards(
            mode, body(r, bias), (z,) * 4,
            meta((4, 6, 4 * d), [Shard(2), Replicate()]), dim=1) is None
        assert rules.scan_on_shards(mode, body(r, bias), (z,) * 4, wx,
                                    dim=0) is None


# ------------------------------------------- (d) real values, four ranks
TOL = 1e-5


def _rank(rank: int, store: str):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=4)
    try:
        cfg = _cfg()
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        g = torch.Generator().manual_seed(0)
        p = xlstm.init_slstm(cfg, generator=g, device="cpu",
                             dtype=torch.float32)
        x = torch.randn(4, 6, cfg.d_model, generator=g)
        leaves = {"x": x, "w": p["w"]["w"], "r": p["r"], "b": p["b"],
                  "g": p["ln"]["g"], "out": p["out_proj"]["w"]}

        def layer(v):
            q = {"ln": {"g": v["g"]}, "w": {"w": v["w"]}, "r": v["r"],
                 "b": v["b"], "out_proj": {"w": v["out"]}}
            out, state = xlstm.slstm_seq(q, cfg, v["x"], return_state=True)
            return out, state
        plain = {k: t.clone().requires_grad_() for k, t in leaves.items()}
        out, state = layer(plain)
        loss = (out ** 2).sum() + (state["c"] ** 2).sum()
        want = dict(zip(plain, torch.autograd.grad(loss, list(
            plain.values()))))
        for per_op in (False, True):
            if per_op:
                rules.scan_on_shards = lambda *a, **k: None
            placed = {k: distribute_tensor(
                t, mesh, [Shard(0), Replicate()] if k == "x" else
                [Replicate(), Replicate()]).requires_grad_()
                for k, t in leaves.items()}
            with implicit_replication(), rules.StepRules():
                dout, dstate = layer(placed)
                dloss = (dout ** 2).sum() + (dstate["c"] ** 2).sum()
                got = dict(zip(placed, torch.autograd.grad(
                    dloss, list(placed.values()))))
            what = "per-op" if per_op else "on the shards"
            for a, b, name in ((dout, out, "out"), (dstate["c"], state["c"],
                                                    "c")):
                a = a.full_tensor()
                assert float((a - b).abs().max()) <= TOL * max(
                    1.0, float(b.abs().max())), f"{what}: {name}"
            for k in leaves:
                a = got[k].full_tensor()
                b = want[k]
                assert float((a - b).abs().max()) <= TOL * max(
                    1.0, float(b.abs().max())), f"{what}: d{k}"
    finally:
        dist.destroy_process_group()


def test_slstm_on_four_ranks_matches_the_plain_layer(tmp_path):
    mp.spawn(_rank, args=(str(tmp_path / "store"),), nprocs=4, join=True)
