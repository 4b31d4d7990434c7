"""Rules the port keeps: no JAX and nothing of ``repro`` in its code, no
silent fall-back to the CPU, no try around a kernel launch or the build,
and a bridge that carries every leaf bit for bit."""
import ast
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

from repro_torch import bridge  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    banned = [m for m in _imported_modules(path)
              if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not banned, f"{path.name} imports {banned}"


def test_importing_the_port_leaves_jax_out():
    code = ("import sys, repro_torch.fed.engine, repro_torch.launch.serve, "
            "repro_torch.launch.train, repro_torch.bridge, "
            "repro_torch.core.mgda, repro_torch.core.drift, "
            "repro_torch.core.fedavg, repro_torch.comms, "
            "repro_torch.obs.records, repro_torch.train.checkpoint, "
            "repro_torch.kernels.gram, repro_torch.kernels.quantize, "
            "repro_torch.comms.sparsify, repro_torch.comms.lowrank, "
            "repro_torch.models.ssm, repro_torch.kernels.ssd; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]"


def test_no_try_in_the_kernel_modules():
    """A launch or a build that fails raises; nothing catches it to fall
    back to another implementation."""
    for path in sorted((PORT / "kernels").glob("*.py")):
        tree = ast.parse(path.read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), \
            path.name


def _skip_if_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points would run")


def test_serve_raises_without_a_card():
    _skip_if_card()
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main([])


def test_init_params_defaults_to_cuda_and_raises_without_a_card():
    _skip_if_card()
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    cfg = get_config("llama-3.2-1b").reduced(n_layers=2, d_model=64,
                                             vocab=256)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_params(cfg, generator=torch.Generator())


def test_other_entry_points_default_to_cuda():
    _skip_if_card()
    from repro_torch.data import partition, prompts
    g = torch.Generator()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prompts.topic_logits(64, generator=g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        partition.dirichlet_topic_mixtures(2, generator=g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.to_torch({"a": np.zeros(2, np.float32)})


def test_trainer_and_train_cli_default_to_cuda_and_raise_without_a_card():
    _skip_if_card()
    from repro_torch.configs import FIRMConfig, get_config
    from repro_torch.fed.engine import FederatedTrainer
    from repro_torch.launch import train
    cfg = get_config("llama-3.2-1b").reduced(n_layers=2, d_model=64,
                                             vocab=256)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FederatedTrainer(cfg, FIRMConfig(n_clients=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--rounds", "1"])


@pytest.mark.parametrize("spec", ["topk:0.05", "topk:0.05+ef", "lowrank:4",
                                  "delta+int8"])
def test_unported_codecs_raise_and_never_become_identity(spec):
    """These codecs are ported at the host boundary and build themselves,
    never the identity; their traced contract (the fused executor's) is
    ported too, and decodes what the host boundary decodes, never the
    identity either."""
    from repro_torch.comms import IdentityCodec, make_codec
    from repro_torch.comms.codec import tree_to_flat
    cd = make_codec(spec)
    assert cd.name == spec and not isinstance(cd, IdentityCodec)
    flat = torch.linspace(-1, 1, 3000)
    _, spec_ = tree_to_flat({"a": flat})
    payload, _, dec = cd.roundtrip_flat(flat, spec_)
    assert payload.kind != "identity" and payload.nbytes < 4 * flat.numel()
    assert not torch.equal(dec, flat)
    traced, _ = cd.roundtrip_traced(
        flat, cd.init_state_traced(flat.numel(), None, device="cpu"))
    assert torch.equal(traced, dec)


def test_quantize_wrappers_refuse_cpu_tensors_before_any_launch():
    """The wrappers launch on CUDA tensors or raise: a CPU tensor never
    reaches the plain version through them, and nothing is counted."""
    from repro_torch.kernels import quantize as q_mod
    before = (q_mod.quantize_launches, q_mod.dequantize_launches)
    x = torch.zeros(2, 1024)
    with pytest.raises(ValueError, match="CUDA"):
        q_mod.quantize(x, torch.zeros(2, 1024, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        q_mod.dequantize(torch.zeros(2, 1024, dtype=torch.int8),
                         torch.ones(2, 1))
    assert (q_mod.quantize_launches, q_mod.dequantize_launches) == before


def test_threshold_wrappers_refuse_cpu_tensors_before_any_launch():
    """The threshold kernels' wrappers launch on CUDA tensors or raise; the
    plain versions are reached only through ``kernels.ops`` with a CPU
    tensor, and nothing is counted."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import quantize as q_mod
    before = (q_mod.threshold_count_launches, q_mod.threshold_mask_launches)
    x, t = torch.ones(2, 3, 1024), torch.zeros(2)
    with pytest.raises(ValueError, match="CUDA"):
        q_mod.abs_threshold_count(x, t)
    with pytest.raises(ValueError, match="CUDA"):
        q_mod.abs_threshold_mask(x, t)
    assert torch.equal(ops.abs_threshold_count(x, t), torch.full((2,), 3072.))
    assert torch.equal(ops.abs_threshold_mask(x, t), x)
    lo, hi = ops.topk_threshold(x, 5)
    assert lo.shape == hi.shape == (2,) and bool((lo <= 1).all())
    assert (q_mod.threshold_count_launches,
            q_mod.threshold_mask_launches) == before


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def test_bridge_round_trip_is_bit_identical():
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    f32[0, :4] = [np.inf, -np.inf, np.float32(1e-40), -0.0]  # + a subnormal
    bf16 = np.asarray(jnp.asarray(rng.standard_normal((2, 7)),
                                  jnp.bfloat16))
    tree = {"w": f32, "nested": {"g": bf16, "i": np.arange(4, dtype=np.int32)},
            "stack": [f32[:1]]}
    t = bridge.to_torch(tree, device="cpu")
    assert t["nested"]["g"].dtype == torch.bfloat16
    assert t["w"].dtype == torch.float32
    back = bridge.to_numpy(t)
    assert back["nested"]["g"].dtype == bf16.dtype
    np.testing.assert_array_equal(_bits(back["nested"]["g"]), _bits(bf16))
    np.testing.assert_array_equal(_bits(back["w"]), _bits(f32))
    np.testing.assert_array_equal(back["nested"]["i"], tree["nested"]["i"])
    np.testing.assert_array_equal(_bits(back["stack"][0]), _bits(f32[:1]))
    # the tensors own their memory: writing them leaves the source alone
    t["w"].zero_()
    assert f32[1, 0] != 0
    # a zamba2 tree (bf16 Mamba2 slots stacked over periods, f32 A_log, D
    # and dt_bias, one unstacked shared block with f32 adapters)
    from repro.configs import get_config as jax_get_config
    from repro.models import transformer as jT
    jcfg = jax_get_config("zamba2-1.2b").reduced(n_layers=2, d_model=64,
                                                 vocab=64)
    ztree = jax.tree_util.tree_map(np.asarray, jT.init_params(
        jcfg, jax.random.PRNGKey(3)))
    zt = bridge.to_torch(ztree, device="cpu")
    assert zt["slots"]["0"]["in_proj"]["w"].dtype == torch.bfloat16
    assert zt["slots"]["0"]["A_log"].dtype == torch.float32
    assert zt["shared"]["attn"]["wq"]["lora_A"].dtype == torch.float32
    zback = bridge.to_numpy(zt)
    got, want = (jax.tree_util.tree_leaves_with_path(t)
                 for t in (zback, ztree))
    assert [p for p, _ in got] == [p for p, _ in want] and len(want) > 100
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(_bits(g), _bits(w))


# ------------------------------------------------- containers and order
def test_bridge_keeps_namedtuples_and_none_slots():
    from repro_torch.train.optim import AdamState
    st = AdamState(mu={"a": np.ones(2, np.float32), "b": None},
                   nu={"a": np.zeros(2, np.float32), "b": None},
                   count=np.asarray(3, np.int32))
    t = bridge.to_torch(st, device="cpu")
    assert type(t) is AdamState and t.mu["b"] is None
    assert t.count.dtype == torch.int32 and int(t.count) == 3
    back = bridge.to_numpy(t)
    assert type(back) is AdamState and back.nu["b"] is None
    np.testing.assert_array_equal(back.mu["a"], st.mu["a"])
    assert bridge.to_torch(None, device="cpu") is None


def _llama_tiny():
    import dataclasses
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    return (dataclasses.replace(jax_get_config("llama-3.2-1b").reduced(
                n_layers=2, d_model=64, vocab=256), n_kv_heads=2),
            dataclasses.replace(get_config("llama-3.2-1b").reduced(
                n_layers=2, d_model=64, vocab=256), n_kv_heads=2))


def test_flat_lora_tree_is_laid_out_as_jax():
    """The port flattens trees in sorted-key order, as jax.tree_util does:
    the flat LoRA row of bridged params equals JAX's element for element,
    and a freshly initialised tree has its leaves in the same order."""
    from repro.models import common as jcommon
    from repro.models import transformer as jT
    from repro_torch.models import common, transformer
    jcfg, tcfg = _llama_tiny()
    rng = np.random.default_rng(0)
    jp = jax.tree_util.tree_map(np.asarray, jT.init_params(
        jcfg, jax.random.PRNGKey(0), dtype=jnp.float32))
    jp = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype), jp)
    jtrain, _ = jcommon.split_trainable(jp)
    want = np.concatenate([np.asarray(x).reshape(-1)
                           for x in jax.tree_util.tree_leaves(jtrain)])
    ttrain, _ = common.split_trainable(bridge.to_torch(jp, device="cpu"))
    got = torch.cat([t.reshape(-1) for t in common.tree_leaves(ttrain)])
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    fresh, _ = common.split_trainable(transformer.init_params(
        tcfg, generator=torch.Generator().manual_seed(0), device="cpu"))
    assert [tuple(t.shape) for t in common.tree_leaves(fresh)] == \
        [x.shape for x in jax.tree_util.tree_leaves(jtrain)]


def test_client_state_round_trips_bit_for_bit():
    from repro.models import common as jcommon
    from repro.models import transformer as jT
    from repro.rlhf import local as jlocal
    from repro_torch.rlhf import local
    jcfg, _ = _llama_tiny()
    jp = jT.init_params(jcfg, jax.random.PRNGKey(1), dtype=jnp.bfloat16)
    jtrain, _ = jcommon.split_trainable(jp)
    js = jlocal.init_client_state(jtrain, 3, jcfg.d_model, kl_coef=0.25)
    rng = np.random.default_rng(0)
    js = js._replace(
        critic={"w": jnp.asarray(rng.standard_normal((3, jcfg.d_model)),
                                 jnp.float32)},
        opt=js.opt._replace(mu=jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype),
            js.opt.mu), count=jnp.asarray(7, jnp.int32)),
        step=jnp.asarray(5, jnp.int32))
    np_state = jax.tree_util.tree_map(np.asarray, js)
    ts = bridge.client_state_to_torch(np_state, device="cpu")
    assert isinstance(ts, local.ClientState)
    assert ts.trainable["embed"] is None and ts.opt.nu["embed"] is None
    assert int(ts.step) == 5 and int(ts.opt.count) == 7
    back = bridge.client_state_to_numpy(ts)
    assert back._fields == js._fields and back.opt._fields == js.opt._fields
    got = jax.tree_util.tree_leaves(back)
    want = jax.tree_util.tree_leaves(np_state)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(_bits(np.atleast_1d(g)),
                                      _bits(np.atleast_1d(w)))
    # and into JAX's own classes, to run the reference on
    rebuilt = jlocal.ClientState(*back[:2], type(js.opt)(*back.opt),
                                 *back[3:])
    assert jax.tree_util.tree_structure(rebuilt) == \
        jax.tree_util.tree_structure(np_state)


def test_rmsnorm_function_refuses_a_gradient_for_g():
    """(The name is from when g had no gradient; it is kept so the test's
    id stays the same.  What it checks now: the backward passes a dg
    request on to the kernel.)  g is frozen on the LoRA path but trained
    where a model has no adapters: asked for dg, the backward hands it to
    the kernel's call (``want_dg``), which takes CUDA tensors only and
    refuses CPU ones before it launches anything; the plain version's dg is
    held to JAX's in ``test_torch_xlstm.py``."""
    import types
    from repro_torch.kernels import rmsnorm as rn_mod
    seen = []

    def spy(x, g, dy, eps=1e-5, *, want_dg=False):
        seen.append(want_dg)
        return real(x, g, dy, eps, want_dg=want_dg)
    real = rn_mod.rmsnorm_bwd
    rn_mod.rmsnorm_bwd = spy
    try:
        for needs_dg in (True, False):
            ctx = types.SimpleNamespace(
                needs_input_grad=(True, needs_dg, False), eps=1e-5,
                saved_tensors=(torch.ones(2, 8), torch.ones(8)))
            before = rn_mod.bwd_launches
            with pytest.raises(ValueError, match="CUDA"):
                rn_mod.RMSNorm.backward(ctx, torch.ones(2, 8))
            assert rn_mod.bwd_launches == before
    finally:
        rn_mod.rmsnorm_bwd = real
    assert seen == [True, False]
