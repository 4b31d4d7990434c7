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
    code = ("import sys, repro_torch.fed.engine, repro_torch.launch.serve; "
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
