"""The last public helpers of the JAX package, ported, against the
reference functions on the CPU.

Each function gets the same numpy-seeded inputs on both sides (JAX
trees carried over by ``bridge``); where the reference draws randomness,
its draws are injected.  Tolerances: f32 1e-5 (``|got - want| <= 1e-5 *
max(1, max|want|)``), exact for integers, counts, tree sizes and tokens.

  rlhf/rewards     init_learned_rm, learned_rm_score
  core/drift       gradient_bound_R, lemma_f6_check
  core/fedavg      fedavg, fedavg_weighted, fedavg_collective (a world-1
                   gloo group and a world of 2 gloo processes)
  data/partition   heterogeneity_stat
  train/optim      sgd_update, cosine_lr
  models/common    tree_size, tree_bytes, is_lora_path
  models/transformer  init_block (every block kind's tree)
  rlhf/sampling    generate_stacked (the reference's own case,
                   test_fed_vectorized.py::test_generate_stacked_matches_per_client)
  comms/registry   register (a user codec, by name, with +ef)
"""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro.comms import registry as jregistry  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import drift as jdrift, fedavg as jfedavg  # noqa: E402
from repro.data import partition as jpartition  # noqa: E402
from repro.models import common as jcommon, transformer as jT  # noqa: E402
from repro.rlhf import rewards as jrewards, sampling as jsampling  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch import bridge, trees  # noqa: E402
from repro_torch.comms import codec as codec_lib, registry  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import drift, fedavg  # noqa: E402
from repro_torch.data import partition  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import common, transformer as T  # noqa: E402
from repro_torch.rlhf import rewards, sampling  # noqa: E402
from repro_torch.train import optim  # noqa: E402

F32 = 1e-5


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def assert_close(got, want, what=""):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    limit = F32 * max(1.0, float(np.abs(w).max()) if w.size else 1.0)
    err = float(np.abs(g - w).max()) if w.size else 0.0
    assert err <= limit, f"{what}: max abs err {err} > {limit}"


def _trees(rng, n: int, dtype=np.float32):
    """n trees of one structure (nested dicts, a None slot as
    ``split_trainable`` leaves), as numpy leaves."""
    def one():
        return {"a": {"w": rng.normal(size=(5, 4)).astype(dtype),
                      "lora_A": rng.normal(size=(4, 2)).astype(dtype)},
                "b": rng.normal(size=(7,)).astype(dtype)}
    return [one() for _ in range(n)]


def _both(tree):
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            bridge.to_torch(tree, device="cpu"))


# ------------------------------------------------------------- rewards
def test_learned_rm_matches_the_reference():
    """The reference's drawn head, injected, scores the same batch; the
    port's own draw has the reference's shapes, dtypes and scales."""
    vocab, d = 256, 64
    jp = jrewards.init_learned_rm(jax.random.PRNGKey(3), vocab, d)
    p = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, vocab, (6, 12)).astype(np.int32)
    mask = (rng.random((6, 12)) < 0.6).astype(np.float32)
    mask[0] = 0.0                              # an empty response: 1 floor
    want = jrewards.learned_rm_score(jp, jnp.asarray(tokens),
                                     jnp.asarray(mask))
    got = rewards.learned_rm_score(p, torch.from_numpy(tokens).long(),
                                   torch.from_numpy(mask))
    assert_close(got, want, "learned RM scores")
    mine = rewards.init_learned_rm(vocab, d, device="cpu",
                                   generator=torch.Generator().manual_seed(3))
    again = rewards.init_learned_rm(vocab, d, device="cpu",
                                    generator=torch.Generator().manual_seed(3))
    for k in ("embed", "w"):
        assert mine[k].shape == tuple(jp[k].shape)
        assert mine[k].dtype == torch.float32 and jp[k].dtype == jnp.float32
        assert torch.equal(mine[k], again[k])
    assert abs(float(mine["embed"].std()) - 0.05) < 0.005
    assert abs(float(mine["w"].std()) - 0.3) < 0.1


# --------------------------------------------------------------- drift
def test_gradient_bound_and_lemma_f6_match_the_reference():
    rng = np.random.default_rng(2)
    g1, g2 = _trees(rng, 3), _trees(rng, 3)
    lam1 = rng.dirichlet(np.ones(3)).astype(np.float32)
    lam2 = rng.dirichlet(np.ones(3)).astype(np.float32)
    j1, t1 = zip(*(_both(g) for g in g1))
    j2, t2 = zip(*(_both(g) for g in g2))
    assert_close(drift.gradient_bound_R(list(t1)),
                 jdrift.gradient_bound_R(list(j1)), "R")
    want = jdrift.lemma_f6_check(list(j1), list(j2), jnp.asarray(lam1),
                                 jnp.asarray(lam2), 0.5)
    got = drift.lemma_f6_check(list(t1), list(t2), torch.from_numpy(lam1),
                               torch.from_numpy(lam2), 0.5)
    assert sorted(got) == sorted(want) == ["R", "lhs", "max_grad_diff",
                                           "rhs"]
    for k in want:
        assert_close(got[k], want[k], k)
    assert float(got["lhs"]) <= float(got["rhs"])


# -------------------------------------------------------------- fedavg
def test_fedavg_and_fedavg_weighted_match_the_reference():
    rng = np.random.default_rng(3)
    js, ts = zip(*(_both(t) for t in _trees(rng, 3)))
    for got, want in ((fedavg.fedavg(list(ts)), jfedavg.fedavg(list(js))),
                      (fedavg.fedavg_weighted(list(ts), [1.0, 3.0, 0.5]),
                       jfedavg.fedavg_weighted(list(js), [1.0, 3.0, 0.5]))):
        gl, wl = trees.tree_leaves(got), jax.tree_util.tree_leaves(want)
        assert len(gl) == len(wl) == 3
        for g, w in zip(gl, wl):
            assert_close(g, w, "fedavg")


@pytest.fixture
def host_group():
    """A world-1 gloo group on the CPU (``make_host_mesh``), torn down."""
    mesh = mesh_lib.make_host_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


def test_fedavg_collective_on_one_rank(host_group):
    """On a world-1 group: the mean of one tree is the tree, and with
    ``count`` the rank's sum over that many clients is FedAvg's mean, bit
    for bit ``fedavg``; by the mesh's 'model' group the same."""
    rng = np.random.default_rng(4)
    js, ts = zip(*(_both(t) for t in _trees(rng, 2)))
    summed = trees.tree_map(lambda a, b: a + b, *ts)
    got = fedavg.fedavg_collective(summed, dist.group.WORLD, count=2)
    for g, w in zip(trees.tree_leaves(got),
                    trees.tree_leaves(fedavg.fedavg(list(ts)))):
        assert torch.equal(g, w)
    for g, w in zip(trees.tree_leaves(got),
                    jax.tree_util.tree_leaves(jfedavg.fedavg(list(js)))):
        assert_close(g, w, "fedavg_collective")
    one = fedavg.fedavg_collective(ts[0], mesh=host_group, dim="model")
    for g, w in zip(trees.tree_leaves(one), trees.tree_leaves(ts[0])):
        assert torch.equal(g, w)


def _collective_rank(rank: int, path: str, out: str):
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank,
                            world_size=2)
    try:
        tree = bridge.to_torch(_trees(np.random.default_rng(5), 2)[rank],
                               device="cpu")
        mean = fedavg.fedavg_collective(tree)
        torch.save(trees.tree_map(lambda t: t.clone(), mean),
                   f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def test_fedavg_collective_over_two_processes(tmp_path):
    """Two gloo processes, one client tree each: every rank holds the
    mean, which is ``fedavg`` of the two trees (bit for bit: one sum, one
    division) and the reference's within 1e-5."""
    out = str(tmp_path / "mean")
    mp.spawn(_collective_rank, args=(str(tmp_path / "store"), out),
             nprocs=2, join=True)
    np_trees = _trees(np.random.default_rng(5), 2)
    want = fedavg.fedavg([bridge.to_torch(t, device="cpu")
                          for t in np_trees])
    jwant = jfedavg.fedavg([_both(t)[0] for t in np_trees])
    for rank in range(2):
        got = torch.load(f"{out}.{rank}")
        for g, w in zip(trees.tree_leaves(got), trees.tree_leaves(want)):
            assert torch.equal(g, w)
        for g, w in zip(trees.tree_leaves(got),
                        jax.tree_util.tree_leaves(jwant)):
            assert_close(g, w, "two-process mean")


# ----------------------------------------------------------- partition
def test_heterogeneity_stat_matches_the_reference():
    rng = np.random.default_rng(6)
    for alpha in (0.1, 100.0):
        mix = rng.dirichlet(np.full(8, alpha), size=5).astype(np.float32)
        assert_close(partition.heterogeneity_stat(torch.from_numpy(mix)),
                     jpartition.heterogeneity_stat(jnp.asarray(mix)),
                     f"alpha {alpha}")


# --------------------------------------------------------------- optim
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sgd_update_matches_the_reference(dtype):
    rng = np.random.default_rng(7)
    p_np, g_np = _trees(rng, 2)
    jp, tp = _both(p_np)
    jg, tg = _both(g_np)
    if dtype == "bf16":
        jp = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jp)
        tp = trees.tree_map(lambda x: x.to(torch.bfloat16), tp)
    want = joptim.sgd_update(jg, jp, lr=0.3)
    got = optim.sgd_update(tg, tp, lr=0.3)
    for g, w in zip(trees.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        if dtype == "bf16":
            assert np.array_equal(_np(g), _np(w))     # one f32 op, one cast
        else:
            assert_close(g, w, "sgd")


def test_cosine_lr_matches_the_reference():
    steps = np.arange(0, 130, dtype=np.int32)
    for warmup, total in ((10, 100), (0, 50), (5, 5)):
        want = joptim.cosine_lr(3e-4, warmup, total)(jnp.asarray(steps))
        got = optim.cosine_lr(3e-4, warmup, total)(torch.from_numpy(steps))
        assert got.dtype == torch.float32
        assert_close(got, want, f"cosine_lr({warmup}, {total})")


# -------------------------------------------------------- model trees
def test_tree_helpers_match_the_reference():
    jcfg = jax_get_config("llama-3.2-1b").reduced(n_layers=2, d_model=64,
                                                  vocab=256)
    jparams = jT.init_params(jcfg, jax.random.PRNGKey(0))
    params = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    assert common.tree_size(params) == jcommon.tree_size(jparams)
    assert common.tree_bytes(params) == jcommon.tree_bytes(jparams)
    jflags = [jcommon.is_lora_path(path) for path, _ in
              jax.tree_util.tree_flatten_with_path(jparams)[0]]
    names = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        else:
            names.append(path)
    walk(params, ())
    assert [common.is_lora_path(p) for p in names] == jflags
    assert any(jflags) and not all(jflags)
    # JAX key paths (objects with a ``key``) read the same
    assert [common.is_lora_path(path) for path, _ in
            jax.tree_util.tree_flatten_with_path(jparams)[0]] == jflags


KINDS = ("attn", "swa", "moe", "moe_swa", "cross", "enc_attn", "mamba2",
         "mlstm", "slstm", "shared_attn")


@pytest.mark.parametrize("kind", KINDS)
def test_init_block_matches_the_reference_tree(kind):
    """The block's tree: the reference's paths, shapes and dtypes; its
    constant leaves (norm gains, zero LoRA B, biases) equal; the random
    ones drawn from the generator, the same twice."""
    arch = {"moe": "mixtral-8x7b", "moe_swa": "mixtral-8x7b",
            "mamba2": "zamba2-1.2b", "shared_attn": "zamba2-1.2b",
            "mlstm": "xlstm-125m", "slstm": "xlstm-125m",
            "cross": "llama-3.2-vision-90b",
            "enc_attn": "whisper-large-v3"}.get(kind, "llama-3.2-1b")
    small = dict(n_layers=2, d_model=64, vocab=256)
    jcfg = jax_get_config(arch).reduced(**small)
    tcfg = get_config(arch).reduced(**small)
    want = jax.tree_util.tree_map(
        np.asarray, jT.init_block(jax.random.PRNGKey(1), kind, jcfg,
                                  jnp.float32))
    got = T.init_block(kind, tcfg, device="cpu", dtype=torch.float32,
                       generator=torch.Generator().manual_seed(1))
    again = T.init_block(kind, tcfg, device="cpu", dtype=torch.float32,
                         generator=torch.Generator().manual_seed(1))
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    gl = trees.tree_leaves(got)
    assert len(gl) == len(wl) == len(trees.tree_leaves(again))
    for g, a, (path, w) in zip(gl, trees.tree_leaves(again), wl):
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
        assert torch.equal(g, a), path
        if np.all(w == w.flat[0]):             # a constant leaf
            assert torch.equal(g, torch.from_numpy(w.copy())), path


# ------------------------------------------------------------ sampling
def test_generate_stacked_matches_the_reference():
    """The reference's case (2 clients x 3 prompts of 4, 5 new tokens, f32
    parameters): each client's rows of the port's ``generate_stacked`` are
    its per-client ``generate`` with the same draws bit for bit (the
    reference holds its own to 1e-5); against JAX's ``generate_stacked``
    given JAX's own Gumbel draws, tokens and mask exactly and logprobs by
    the bf16 rule, 2e-2 of their scale (both sides cache K/V in bf16, as
    ``generate`` does by default)."""
    jcfg = jax_get_config("llama-3.2-1b").reduced(n_layers=2, d_model=64,
                                                  vocab=256)
    tcfg = get_config("llama-3.2-1b").reduced(n_layers=2, d_model=64,
                                              vocab=256)
    key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, 2)
    jparams = [jT.init_params(jcfg, k, dtype=jnp.float32) for k in keys]
    prompts = jax.random.randint(jax.random.fold_in(key, 2), (2, 3, 4), 0,
                                 jcfg.vocab)
    gkeys = jax.random.split(jax.random.fold_in(key, 3), 2)
    max_new = 5
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jparams)
    want = jsampling.generate_stacked(jcfg, stacked, prompts, gkeys,
                                      max_new=max_new)
    gumbel = torch.from_numpy(np.stack([np.stack([
        np.asarray(jax.random.gumbel(k, (3, jcfg.vocab)))
        for k in jax.random.split(g, max_new)]) for g in gkeys]))
    tparams = bridge.to_torch(jax.tree_util.tree_map(np.asarray, stacked),
                              device="cpu")
    tprompts = torch.from_numpy(np.asarray(prompts)).long()
    got = sampling.generate_stacked(tcfg, tparams, tprompts,
                                    max_new=max_new, gumbel=gumbel)
    assert tuple(got[0].shape) == (2, 3, 4 + max_new)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    err = float(np.abs(_np(got[1]) - _np(want[1])).max())
    assert err <= 2e-2 * max(1.0, float(np.abs(_np(want[1])).max())), err
    for c in range(2):
        one = sampling.generate(tcfg, trees.tree_map(lambda t: t[c],
                                                     tparams),
                                tprompts[c], max_new=max_new,
                                gumbel=gumbel[c])
        for a, b in zip(one, got):
            assert torch.equal(a, b[c])
    with pytest.raises(ValueError, match="exactly one"):
        sampling.generate_stacked(tcfg, tparams, tprompts, max_new=max_new)


# ------------------------------------------------------------ registry
class _Half(codec_lib.Codec):
    """A user codec: the flat vector in bf16."""

    name = "half"

    def encode_flat(self, flat, *, key=None, bits=None):
        return {"values": flat.to(torch.bfloat16)}, {}

    def decode_flat(self, payload):
        return payload.arrays["values"].float()

    def bits_per_param(self, d: int) -> float:
        return 16.0

    def nbytes_static(self, d: int) -> int:
        return 2 * d


def test_register_resolves_a_user_codec_as_the_reference_does():
    """``register`` adds a name that ``make_codec`` resolves as the
    reference's registry resolves its own registration (bare, ``+ef``,
    ``delta+``); the codec's roundtrip decodes the bf16 values and its
    error feedback carries the rounding; unregistered afterwards, so
    ``available()`` stays the reference's."""
    before = registry.available()
    try:
        registry.register("half")(lambda arg: _Half())
        jregistry.register("half")(
            lambda arg: jregistry.QuantizeCodec(bits=8, stochastic=False))
        assert "half" in registry.available()
        assert registry.available() == jregistry.available()
        assert isinstance(registry.make_codec("half"), _Half)
        assert isinstance(jregistry.make_codec("half"),
                          jregistry.QuantizeCodec)
        for spec in ("half+ef", "delta+half", "delta+half+ef"):
            got, want = registry.make_codec(spec), jregistry.make_codec(spec)
            assert type(got).__name__ == type(want).__name__, spec
        flat = torch.from_numpy(np.random.default_rng(8).normal(
            size=300).astype(np.float32))
        tree = {"x": flat}
        payload, _, decoded = registry.make_codec("half").roundtrip(tree)
        assert torch.equal(decoded["x"], flat.to(torch.bfloat16).float())
        assert payload.nbytes == 600
        _, residual, decoded = registry.make_codec("half+ef").roundtrip(
            tree, None)
        assert torch.equal(residual, flat - decoded["x"])
    finally:
        registry._FACTORIES.pop("half", None)
        jregistry._FACTORIES.pop("half", None)
    assert registry.available() == before == jregistry.available()
    with pytest.raises(ValueError, match="unknown codec"):
        registry.make_codec("half")


def test_every_public_name_of_the_reference_is_ported():
    """An ``ast`` comparison of the two packages' module-level public
    names (definitions and assignments; on the port's side also the
    names a module imports, a re-export) leaves only what the port does
    not carry by design: the HLO
    text readers, the removed ``FusedCarry``, the Pallas kernels' tile
    constants and entry names, and ``ATTN_KINDS``."""
    import ast
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1] / "src"

    def names(pkg, imports: bool):
        out = {}
        for p in (root / pkg).rglob("*.py"):
            body = ast.parse(p.read_text()).body
            got = set()
            for n in body:
                if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
                    got.add(n.name)
                elif imports and isinstance(n, ast.ImportFrom):
                    got |= {a.asname or a.name for a in n.names}
                elif isinstance(n, ast.Assign):
                    got |= {t.id for t in n.targets
                            if isinstance(t, ast.Name)}
            out[str(p.relative_to(root / pkg))] = {
                x for x in got if not x.startswith("_")}
        return out
    ref, port = names("repro", False), names("repro_torch", True)
    missing = {f: sorted(ref[f] - port.get(f, set())) for f in ref
               if ref[f] - port.get(f, set())}
    assert missing == {
        "fed/engine.py": ["FusedCarry"],
        "kernels/flash_attention.py": ["BLOCK_K", "BLOCK_Q", "NEG_INF"],
        "kernels/gram.py": ["M_PAD", "TILE_D", "gram_pallas"],
        "kernels/quantize.py": ["ROWS_PER_STEP"],
        "kernels/rmsnorm.py": ["BLOCK_ROWS"],
        "kernels/ssd.py": ["NEG_INF"],
        "launch/dryrun.py": ["parse_collective_bytes"],
        "launch/hlo_cost.py": ["HloCostModel", "Instr"],
        "models/transformer.py": ["ATTN_KINDS"],
    }
