"""The port's production layout (``repro_torch.launch``: mesh, sharding,
specs) against the reference's, on the CPU.

Every (arch x shape x mesh) pair of the dry-run: the port's shape
stand-ins (``meta`` tensors) equal ``jax.eval_shape``'s trees in paths,
shapes and dtypes, and the port's partition specs equal the reference's
spec for spec on every leaf, at full width, on the abstract 16x16 and
2x16x16 meshes.  Under torch's ``fake`` process group of 256 and 512
ranks, every leaf placed as a DTensor has the local shape JAX's
``NamedSharding.shard_shape`` gives.  The reference's own sharding cases
(``tests/test_sharding.py``, which fails to import under this jax, and
``tests/test_system.py``) are ported as the same assertions.

The reference's dry-run module is not imported (it sets ``XLA_FLAGS`` at
import): its ``_shardings_for`` and ``_multi_pod_train_spec`` are copied
below as ``_ref_shardings_for`` and ``_ref_multi_pod_train_spec``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh as JMesh  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from repro.configs import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import FIRMConfig as JFIRMConfig  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.configs.base import FIRMConfig  # noqa: E402
from repro_torch.launch import dryrun, sharding as sh  # noqa: E402
from repro_torch.launch import mesh as mesh_lib, specs  # noqa: E402
from repro_torch.models.common import split_trainable  # noqa: E402

ARCHS = list_archs()
SHAPES = list(INPUT_SHAPES)
MESHES = ("16x16", "2x16x16")
JMESH = {"16x16": JMesh((16, 16), ("data", "model")),
         "2x16x16": JMesh((2, 16, 16), ("pod", "data", "model"))}
TMESH = {"16x16": mesh_lib.AbstractMesh((16, 16), ("data", "model")),
         "2x16x16": mesh_lib.AbstractMesh((2, 16, 16),
                                          ("pod", "data", "model"))}
JDTYPE = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32,
          torch.int32: jnp.int32}


# ----------------------------------------------------------------- helpers
def _jax_leaves(tree, is_leaf=None) -> dict:
    """path names (the reference's ``_path_names``) -> leaf."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {tuple(jsh._path_names(p)): leaf for p, leaf in flat}


def _port_leaves(tree) -> dict:
    out = {}
    sh.tree_map_with_path(lambda p, leaf: out.__setitem__(tuple(p), leaf),
                          tree)
    return out


def _assert_same_shapes(port_tree, jax_tree, what):
    got, want = _port_leaves(port_tree), _jax_leaves(jax_tree)
    assert sorted(got) == sorted(want), what
    for path, leaf in got.items():
        assert tuple(leaf.shape) == tuple(want[path].shape), (what, path)
        assert leaf.device.type == "meta", (what, path)
        assert JDTYPE[leaf.dtype] == want[path].dtype, (what, path)


def _assert_same_specs(port_sh, jax_sh, what):
    got = {p: s.spec for p, s in _port_leaves(port_sh).items()}
    want = {p: tuple(s.spec) for p, s in _jax_leaves(
        jax_sh, is_leaf=lambda x: isinstance(x, NamedSharding)).items()}
    assert sorted(got) == sorted(want), what
    for path in got:
        want_spec = want[path] + (None,) * (len(got[path]) - len(want[path]))
        assert got[path] == want_spec, (what, path, got[path], want[path])


def _ref_multi_pod_train_spec(cfg, fc, shape, n_pods=2):
    """``repro.launch.dryrun._multi_pod_train_spec``."""
    per_pod = dataclasses.replace(shape, global_batch=max(
        1, shape.global_batch // n_pods))
    base = jspecs.input_specs(cfg, per_pod, fc)

    def stack(tree, lead):
        return jax.tree_util.tree_map(
            lambda s: jax.ShapeDtypeStruct(lead + s.shape, s.dtype), tree)

    return {"kind": "train", "state": stack(base["state"], (n_pods,)),
            "frozen": base["frozen"],
            "batch": stack(base["batch"], (n_pods, fc.local_steps)),
            "aux": (stack(base["aux"], (n_pods, fc.local_steps))
                    if base["aux"] is not None else None)}


def _ref_shardings_for(kind, cfg, shape, mesh, spec, multi_pod):
    """``repro.launch.dryrun._shardings_for``."""
    tp = cfg.tensor_parallel
    data_axes = ("data",) if tp else ("data", "model")
    if multi_pod:
        data_axes = ("pod",) + data_axes
    if kind == "train":
        if multi_pod:
            state_sh = jsh.param_shardings(spec["state"], mesh,
                                           extra_leading=1,
                                           leading_axis="pod",
                                           tensor_parallel=tp)
            b_axes = ("data",) if tp else ("data", "model")
            batch_sh = jsh.batch_shardings(spec["batch"], mesh,
                                           extra_leading_axes=("pod", None),
                                           data_axes=b_axes)
            aux_sh = (jsh.batch_shardings(spec["aux"], mesh,
                                          extra_leading_axes=("pod", None),
                                          data_axes=b_axes)
                      if spec["aux"] is not None else None)
        else:
            state_sh = jsh.param_shardings(spec["state"], mesh,
                                           tensor_parallel=tp)
            batch_sh = jsh.batch_shardings(spec["batch"], mesh,
                                           data_axes=data_axes)
            aux_sh = (jsh.batch_shardings(spec["aux"], mesh,
                                          data_axes=data_axes)
                      if spec["aux"] is not None else None)
        frozen_sh = jsh.param_shardings(spec["frozen"], mesh,
                                        tensor_parallel=tp)
        return (state_sh, frozen_sh, batch_sh, aux_sh)
    if kind == "prefill":
        p_sh = jsh.param_shardings(spec["params"], mesh, tensor_parallel=tp)
        t_sh = jsh.batch_shardings(spec["tokens"], mesh, data_axes=data_axes)
        a_sh = (jsh.batch_shardings(spec["aux"], mesh, data_axes=data_axes)
                if spec["aux"] is not None else None)
        return (p_sh, t_sh, a_sh)
    p_sh = jsh.param_shardings(spec["params"], mesh, tensor_parallel=tp)
    c_sh = jsh.cache_shardings(cfg, spec["cache"], mesh,
                               shape.global_batch, data_axes=data_axes)
    t_sh = jsh.batch_shardings(spec["token"], mesh, data_axes=data_axes)
    return (p_sh, c_sh, t_sh)


def _pair_specs(arch, shape_name, mesh_name):
    """(port spec dict, reference spec dict) of the dry-run's step inputs
    for one pair, as ``run_pair`` builds them."""
    multi = mesh_name == "2x16x16"
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    shape, jshape = INPUT_SHAPES[shape_name], J_SHAPES[shape_name]
    fc, jfc = FIRMConfig(local_steps=2), JFIRMConfig(local_steps=2)
    if multi and shape.kind == "train":
        return (dryrun._multi_pod_train_spec(cfg, fc, shape),
                _ref_multi_pod_train_spec(jcfg, jfc, jshape))
    return (specs.input_specs(cfg, shape, fc),
            jspecs.input_specs(jcfg, jshape, jfc))


def _args(spec):
    keys = {"train": ("state", "frozen", "batch", "aux"),
            "prefill": ("params", "tokens", "aux"),
            "decode": ("params", "cache", "token")}[spec["kind"]]
    return [spec[k] for k in keys]


# ---------------------------------------------------- every pair, all leaves
@pytest.mark.parametrize("shape_name", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_eval_shape(arch, shape_name):
    """Every input of every (arch x shape) step: the same paths, shapes
    and dtypes as ``jax.eval_shape``'s, all on ``meta``, and the
    multi-pod train spec likewise."""
    got, want = _pair_specs(arch, shape_name, "16x16")
    assert got["kind"] == want["kind"]
    for g, w in zip(_args(got), _args(want)):
        _assert_same_shapes(g, w, (arch, shape_name))
    if INPUT_SHAPES[shape_name].kind == "train":
        got, want = _pair_specs(arch, shape_name, "2x16x16")
        for g, w in zip(_args(got), _args(want)):
            _assert_same_shapes(g, w, (arch, shape_name, "multi"))


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("shape_name", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_shardings_equal_the_references(arch, shape_name, mesh_name):
    """``param_spec`` (params, client state, frozen tree), ``batch_spec``
    and ``cache_shardings`` through the dry-run's ``_shardings_for``: the
    reference's spec on every leaf."""
    multi = mesh_name == "2x16x16"
    got, want = _pair_specs(arch, shape_name, mesh_name)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    port = dryrun._shardings_for(got["kind"], cfg, shape, TMESH[mesh_name],
                                 got, multi, FIRMConfig())
    ref = _ref_shardings_for(want["kind"], jcfg, J_SHAPES[shape_name],
                             JMESH[mesh_name], want, multi)
    for g, w in zip(port, ref):
        if w is None:
            assert g is None
            continue
        _assert_same_specs(g, w, (arch, shape_name, mesh_name))


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_head_split_shardings_replicate_only_unsplittable_heads(arch,
                                                               mesh_name):
    """``head_split_shardings`` over the train pair's shardings: a wq, wk
    or wv weight, or the sLSTM's input projection ``w``, sharded on
    'model' loses 'model' exactly when the heads its output is viewed by
    (the KV heads; the sLSTM's heads) do not divide by its shards; every
    other leaf keeps the reference's spec."""
    cfg = get_config(arch)
    got, _ = _pair_specs(arch, "train_4k", mesh_name)
    mesh = TMESH[mesh_name]
    msize = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
    base = dryrun._shardings_for(got["kind"], cfg, INPUT_SHAPES["train_4k"],
                                 mesh, got, mesh_name == "2x16x16",
                                 FIRMConfig())

    viewed = {"wq": cfg.n_kv_heads, "wk": cfg.n_kv_heads,
              "wv": cfg.n_kv_heads, "w": cfg.n_heads}

    def one(names, old, s):
        heads = (viewed.get(names[-2], 0) if len(names) >= 2
                 and names[-1] == "w" else 0)
        if heads and old.spec and old.spec[-1] == "model" and heads % msize:
            assert s.spec == old.spec[:-1] + (None,), names
        else:
            assert s.spec == old.spec, names

    for tree in base:
        if tree is not None:
            sh.tree_map_with_path(one, tree,
                                  sh.head_split_shardings(cfg, tree))


@pytest.mark.parametrize("arch", ARCHS)
def test_rep_tree_and_replicated_equal_the_references(arch):
    """``rep_tree`` with and without a leading axis, over the multi-pod
    client state, and ``replicated``."""
    got, want = _pair_specs(arch, "train_4k", "2x16x16")
    for lead in (None, "pod"):
        _assert_same_specs(
            sh.rep_tree(got["state"], TMESH["2x16x16"], leading_axis=lead),
            jsh.rep_tree(want["state"], JMESH["2x16x16"], leading_axis=lead),
            (arch, lead))
    assert sh.replicated(TMESH["16x16"]).spec == tuple(
        jsh.replicated(JMESH["16x16"]).spec) == ()


# ------------------------------------------------ the reference's own cases
MESH = TMESH["16x16"]


def _leaf(shape):
    return specs.sds(shape, torch.bfloat16)


def test_embed_vocab_sharded():
    assert sh.param_spec(("embed",), _leaf((128256, 8192)), MESH) == \
        ("model", None)


def test_column_and_row_parallel():
    assert sh.param_spec(("slots", "0", "attn", "wq", "w"),
                         _leaf((16, 4096, 4096)), MESH) == \
        (None, None, "model")
    assert sh.param_spec(("slots", "0", "attn", "wo", "w"),
                         _leaf((16, 4096, 4096)), MESH) == \
        (None, "model", None)


def test_lora_replicated():
    assert sh.param_spec(("slots", "0", "attn", "wq", "lora_A"),
                         _leaf((16, 4096, 16)), MESH) == (None, None, None)


def test_expert_parallel_when_divisible():
    path = ("slots", "0", "moe", "experts", "w_gate")
    assert sh.param_spec(path, _leaf((48, 64, 2048, 1408)), MESH) == \
        (None, "model", None, None)
    # 8 experts don't divide 16 -> fall back to d_ff tensor parallel
    assert sh.param_spec(path, _leaf((32, 8, 4096, 14336)), MESH) == \
        (None, None, None, "model")
    assert sh.param_spec(("slots", "0", "moe", "experts", "w_down"),
                         _leaf((32, 8, 14336, 4096)), MESH) == \
        (None, None, "model", None)


def test_divisibility_guard_replicates():
    assert sh.param_spec(("slots", "0", "attn", "wq", "w"),
                         _leaf((4, 512, 100)), MESH) == (None, None, None)


def test_batch_spec_data_axes():
    assert sh.batch_spec((256, 4096), MESH) == ("data", None)
    assert sh.batch_spec((1, 4096), MESH) == (None, None)
    assert sh.batch_spec((64, 128), TMESH["2x16x16"],
                         data_axes=("pod", "data")) == \
        (("pod", "data"), None)


@pytest.mark.parametrize("shape_name", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_build_for_every_pair(arch, shape_name):
    """The reference's ``test_input_specs_build_for_every_pair``; the
    port builds long_500k for the full-attention archs too (the dry-run
    skips them, as the reference's does)."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    spec = specs.input_specs(cfg, shape, FIRMConfig())
    assert sh.tree_leaves(_args(spec))
    if spec["kind"] == "train":
        assert spec["batch"].tokens.shape[0] == shape.global_batch
    elif spec["kind"] == "decode":
        assert tuple(spec["token"].shape) == (shape.global_batch, 1)
        assert len(spec["cache"]["slots"]) == len(cfg.pattern)


def test_cache_shardings_rules():
    cfg = get_config("mistral-large-123b")
    cache = specs.cache_specs(cfg, INPUT_SHAPES["decode_32k"])
    shd = sh.cache_shardings(cfg, cache, MESH, batch=128)
    assert shd["slots"]["0"]["k"].spec == (None, "data", "model", None, None)
    # B=1 long context -> seq sharded over both axes
    cfg2 = get_config("zamba2-1.2b")
    cache2 = specs.cache_specs(cfg2, INPUT_SHAPES["long_500k"])
    shd2 = sh.cache_shardings(cfg2, cache2, MESH, batch=1)
    i = cfg2.pattern.index("shared_attn")
    assert shd2["slots"][str(i)]["k"].spec == \
        (None, None, ("data", "model"), None, None)


def test_param_shardings_cover_full_tree():
    cfg = get_config("mixtral-8x7b").reduced()
    params = specs.param_specs(cfg)
    shd = sh.param_shardings(params, MESH)
    assert len(sh.tree_leaves(params)) == len(sh.tree_leaves(shd))


def test_lora_only_communication():
    """``tests/test_system.py``'s case: the adapters are under 1% of
    llama-3.2-1b, counted on the meta device."""
    cfg = get_config("llama-3.2-1b")
    trainable, _ = split_trainable(specs.param_specs(cfg))
    d_adapters = sum(t.numel() for t in sh.tree_leaves(trainable))
    assert d_adapters == 3_407_872
    assert d_adapters < 0.01 * cfg.param_count()


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    multi = TMESH["2x16x16"]
    assert sh.placements((("pod", "data"), None, "model"), multi) == \
        (Shard(0), Shard(0), Shard(2))
    assert sh.placements((), multi) == (Replicate(),) * 3
    assert sh.Sharding(multi, (("pod", "data"), None, "model")).shard_shape(
        (64, 3, 32)) == (2, 3, 2)


# --------------------------------------- DTensor local shapes, fake groups
@pytest.fixture(params=MESHES)
def fake_mesh(request):
    """A production mesh over torch's fake group of 256 or 512 ranks,
    torn down after the test."""
    multi = request.param == "2x16x16"
    with dryrun.fake_world(512 if multi else 256):
        yield request.param, mesh_lib.make_production_mesh(multi_pod=multi)


@pytest.mark.parametrize("arch", ARCHS)
def test_local_shapes_equal_shard_shape(fake_mesh, arch):
    """Every leaf of the train, prefill and decode_32k steps' inputs laid
    out as DTensors (the dry-run's ``sh.place``): its local shard has
    ``NamedSharding(...).shard_shape``'s shape."""
    mesh_name, mesh = fake_mesh
    multi = mesh_name == "2x16x16"
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
        got, want = _pair_specs(arch, shape_name, mesh_name)
        port = dryrun._shardings_for(got["kind"], cfg,
                                     INPUT_SHAPES[shape_name], mesh, got,
                                     multi, FIRMConfig())
        ref = _ref_shardings_for(want["kind"], jcfg, J_SHAPES[shape_name],
                                 JMESH[mesh_name], want, multi)
        for arg, p_sh, j_sh in zip(_args(got), port, ref):
            if arg is None:
                continue
            placed = _port_leaves(sh.place(arg, p_sh))
            j_leaves = _jax_leaves(j_sh, is_leaf=lambda x: isinstance(
                x, NamedSharding))
            assert sorted(placed) == sorted(j_leaves)
            for path, t in placed.items():
                full = tuple(t.shape)
                assert tuple(t.to_local().shape) == \
                    j_leaves[path].shard_shape(full), (shape_name, path)


def test_make_production_mesh_needs_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.make_production_mesh()


def test_fake_world_refuses_a_second_group():
    with dryrun.fake_world(4):
        with pytest.raises(RuntimeError, match="exists already"):
            with dryrun.fake_world(4):
                pass
    assert not dist.is_initialized()


def test_importing_launch_starts_no_group():
    import subprocess
    import sys
    code = ("import torch.distributed as d, repro_torch.launch, "
            "repro_torch.launch.dryrun, repro_torch.launch.hlo_cost; "
            "print(d.is_initialized())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "False"


def test_h100_constants():
    assert (mesh_lib.PEAK_FLOPS_BF16, mesh_lib.HBM_BW,
            mesh_lib.ICI_BW_PER_LINK) == (989e12, 3.35e12, 450e9)

